"""The scheduler round's own host time: the mean, over the engine's
``lm/round`` spans of the window before the profiler starts, stalls
left out (``bench/rounds.py`` says why), of each round's duration less
what the spans it holds on its thread cover (the decode step, the
prefill, the fetches, the token pick and the graphs' staging and
replay): admission, the lifecycle sweep, building a step's inputs, the
condition variable's lock, and whatever else the round waits for."""
from h100_bench.bench import rounds
from h100_bench.bench.flops import union_seconds

CHILDREN = ("lm/decode_step", "lm/prefill", "lm/fetch", "lm/token_pick",
            "graph/stage", "graph/replay")


def read(ctx):
    if ctx["kind"] != "serve" or ctx["window"] is None:
        return None
    found = rounds.spans(ctx, ("lm/round",) + CHILDREN)
    held = rounds.Children(s for n in CHILDREN for s in found[n])
    own = []
    for r in rounds.in_window(ctx, found["lm/round"]):
        covered = union_seconds((max(c.start, r.start), min(c.end, r.end))
                                for c in held.of(r))
        own.append((r.seconds - covered, r))
    ms = rounds.steady_mean(ctx, "round_self_ms", own)
    return None if ms is None else 1e3 * ms
