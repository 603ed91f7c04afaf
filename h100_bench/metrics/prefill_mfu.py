"""The prefill step's share of the float32 peak, from the device trace:
the model operations of the real prompt tokens of each prefill in the
profiled slice (the benchmark's own count, padding left out), over the
device time from the first to the last operation of the graph that
prefill's ``lm/prefill`` span launched, over 165 TFLOP/s.

The span times the graph's launch, and the device does the work after
it.  A span's graph is the one graph launch the host made inside the
span (give or take twice the clock fit's tolerance), and its operations
are those that carry that launch's correlation id; it counts only if it
runs the flash forward kernel and no paged decode kernel, as a prefill
does and a decode step does not.  A span with no such launch, or with
more than one, is left out, and the log counts it."""
from h100_bench.bench import flops, reads
from h100_bench.bench.common import log
from h100_bench.bench.devtrace import MAX_CLOCK_US

#: how far outside its span a launch may read, in seconds
TOL_S = 2 * MAX_CLOCK_US / 1e6


def is_prefill(graph) -> bool:
    names = [o.name for o in graph if o.cat == "kernel"]
    return (any("flash_fwd" in n for n in names)
            and not any("paged_" in n for n in names))


def read(ctx):
    if ctx["kind"] != "serve" or ctx["devtrace"] is None:
        return None
    s = ctx["sizes"]
    tr = ctx["devtrace"]
    pre = reads.in_slice(ctx, reads.spans(ctx, "lm/prefill"))
    work = busy = 0.0
    used = 0
    for a, b, args in pre:
        graphs = [g for g in tr.graphs_in(a - TOL_S, b + TOL_S) if g]
        if len(graphs) != 1 or not is_prefill(graphs[0]):
            continue
        graph = graphs[0]
        p = int(args["prefix_len"])
        n = min(int(args["prompt_len"]) - p, int(args["bucket"]))
        work += flops.prefill_flops(s, p + n, p)
        busy += max(o.end for o in graph) - min(o.start for o in graph)
        used += 1
    log(f"[prefill_mfu] {used} of {len(pre)} prefills tied to their graph")
    if not busy:
        return None
    return 100.0 * work / busy / flops.FP32_PEAK
