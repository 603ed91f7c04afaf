"""The engine worker's time off the CPU in its rounds: over the
``lm/round`` spans of the window before the profiler starts, stalls left
out (``bench/rounds.py`` says why), 100 x (1 - CPU time / wall time),
each from the rounds less their ``lm/fetch`` spans (a fetch waits for
the device by design).  CPU time is each span's ``cpu_us``, the worker
thread's own; the rest it waited for the interpreter lock, a lock, the
collector run by another thread, or the device outside a fetch.

Where the thread's CPU clock advances in scheduler ticks (10 ms on the
card's host), each ``cpu_us`` counts the ticks that fell in the span,
and the reading is an estimate from some hundreds of ticks: the reader
logs the tick (the smallest CPU time a span read above 0) and the
reading's standard error, 100 x sqrt(ticks) x tick / wall."""
import math

from h100_bench.bench import rounds
from h100_bench.bench.common import log


def read(ctx):
    if ctx["kind"] != "serve" or ctx["window"] is None:
        return None
    found = rounds.spans(ctx, ("lm/round", "lm/fetch"))
    fetches = rounds.Children(found["lm/fetch"])
    rows = []
    for r in rounds.in_window(ctx, found["lm/round"]):
        held = fetches.of(r)
        rows.append((r.seconds - sum(f.seconds for f in held), r,
                     (r.args["cpu_us"] - sum(f.args["cpu_us"]
                                             for f in held)) / 1e6))
    rows = rounds.without_stalls(ctx, "host_offcpu_share", rows)
    wall = sum(r[0] for r in rows)
    cpu = sum(r[2] for r in rows)
    if wall <= 0:
        return None
    read_cpu = [s.args["cpu_us"] for s in found["lm/round"] + found["lm/fetch"]
                if s.args["cpu_us"] > 0]
    if read_cpu and cpu > 0:
        tick = min(read_cpu) / 1e6
        log(f"[host_offcpu_share] CPU clock tick {1e3 * tick:.3f} ms; "
            f"{cpu / tick:.0f} ticks over {wall:.3f} s off the fetches: "
            f"standard error {100 * math.sqrt(cpu / tick) * tick / wall:.2f}"
            f" points")
    return 100.0 * (1.0 - cpu / wall)
