"""bigdl_tpu_torch.obs: the metric registry and the span tracer (port
of ``bigdl_tpu/obs``'s ``registry`` and ``tracer``; the time-series
sampler, flight recorder, stall watchdog and memory ledger wait for
their slice).

    from bigdl_tpu_torch import obs
    obs.get_registry().counter("app/requests").add(1)
    tr = obs.get_tracer()          # BIGDL_TPU_TRACE=1, or tr.enable()
    with tr.span("my_phase", cat="app", rows=1024):
        ...
    tr.export_chrome("TRACE_app.json")
"""
from bigdl_tpu_torch.obs.registry import (Counter, FnGauge, Gauge, Histogram,
                                          MetricRegistry, get_registry,
                                          percentile_from_counts)
from bigdl_tpu_torch.obs.tracer import (Tracer, clear_request_context,
                                        get_request_context, get_tracer,
                                        mint_request_id, set_request_context)

__all__ = ["Counter", "FnGauge", "Gauge", "Histogram", "MetricRegistry",
           "get_registry", "percentile_from_counts", "Tracer", "get_tracer",
           "mint_request_id", "set_request_context", "get_request_context",
           "clear_request_context"]
