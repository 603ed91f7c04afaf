"""bigdl_tpu_torch.obs: observability (port of ``bigdl_tpu/obs``).

- :mod:`~bigdl_tpu_torch.obs.registry`: the process-wide metric registry
  (counters, gauges, histograms);
- :mod:`~bigdl_tpu_torch.obs.tracer`: request-scoped spans over a ring
  buffer, exported as Chrome trace JSON (``BIGDL_TPU_TRACE=1``);
- :mod:`~bigdl_tpu_torch.obs.timeseries`: a background sampler of the
  registry into a bounded ring;
- :mod:`~bigdl_tpu_torch.obs.flight`: one correlated incident bundle per
  incident (``BIGDL_TPU_FLIGHT=1``; off by default);
- :mod:`~bigdl_tpu_torch.obs.watchdog`: rolling-median stall detection
  (``BIGDL_TPU_WATCHDOG``, on by default);
- :mod:`~bigdl_tpu_torch.obs.ledger`: device byte attribution reconciled
  against the CUDA allocator, and the ``mem_pressure`` watermark.

    from bigdl_tpu_torch import obs
    obs.get_registry().counter("app/requests").add(1)
    tr = obs.get_tracer()          # BIGDL_TPU_TRACE=1, or tr.enable()
    with tr.span("my_phase", cat="app", rows=1024):
        ...
    tr.export_chrome("TRACE_app.json")
"""
from bigdl_tpu_torch.obs.ledger import MemoryLedger, get_ledger, set_ledger
from bigdl_tpu_torch.obs.registry import (Counter, FnGauge, Gauge, Histogram,
                                          MetricRegistry, get_registry,
                                          percentile_from_counts)
from bigdl_tpu_torch.obs.timeseries import (TimeSeriesSampler, get_sampler,
                                            set_sampler)
from bigdl_tpu_torch.obs.tracer import (Tracer, clear_request_context,
                                        get_request_context, get_tracer,
                                        mint_request_id, set_request_context)
from bigdl_tpu_torch.obs.watchdog import (StallWatchdog, env_watchdog_enabled,
                                          env_watchdog_kwargs,
                                          shared_watchdog, thread_stacks)

# flight names resolve lazily (PEP 562), so `python -m
# bigdl_tpu_torch.obs.flight` does not find the module imported already
_FLIGHT_NAMES = ("FlightRecorder", "get_flight_recorder", "note_shed")


def __getattr__(name):
    if name in _FLIGHT_NAMES:
        from bigdl_tpu_torch.obs import flight
        return getattr(flight, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Counter", "FnGauge", "Gauge", "Histogram", "MetricRegistry",
           "get_registry", "percentile_from_counts", "Tracer", "get_tracer",
           "mint_request_id", "set_request_context", "get_request_context",
           "clear_request_context", "TimeSeriesSampler", "get_sampler",
           "set_sampler", "FlightRecorder", "get_flight_recorder",
           "note_shed", "MemoryLedger", "get_ledger", "set_ledger",
           "StallWatchdog", "env_watchdog_enabled", "env_watchdog_kwargs",
           "shared_watchdog", "thread_stacks"]
