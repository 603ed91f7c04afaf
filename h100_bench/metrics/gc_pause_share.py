"""The collector's share of the window: the summed ``py/gc`` spans (one
a pass of Python's garbage collector, on whichever thread ran it; a pass
stops every Python thread) of the window before the profiler starts
(``bench/rounds.py`` says why), over that part's length.  A program
that records no ``lm/round`` span there predates the collector's span
too, and gives no reading.

It also logs the tracer's ``dropped`` count (events a full ring evicted
while the window was traced; 0 for every reading to be whole) and the
spans recorded a second of the window."""
from h100_bench.bench import rounds
from h100_bench.bench.common import log


def _log_ring(ctx) -> None:
    from bigdl_tpu_torch.obs import get_tracer
    t0, t1 = ctx["window"]
    epoch = ctx["run"].tracer_epoch
    n = sum(1 for e in ctx["events"] if e.get("ph") == "X"
            and t0 <= epoch + e["ts"] / 1e6 < t1)
    log(f"[tracer] dropped {getattr(get_tracer(), 'dropped', None)} "
        f"events; {n} spans in the window, {n / (t1 - t0):.1f} a second")


def read(ctx):
    if ctx["kind"] != "serve" or ctx["window"] is None:
        return None
    _log_ring(ctx)
    found = rounds.spans(ctx, ("lm/round", "py/gc"))
    if not rounds.in_window(ctx, found["lm/round"]):
        return None
    t0, t1 = rounds.read_part(ctx)
    paused = sum(s.seconds for s in rounds.in_window(ctx, found["py/gc"]))
    return 100.0 * paused / (t1 - t0)
