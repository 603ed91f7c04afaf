"""How long a decode step takes to put its graph on the stream: the mean,
over the ``lm/decode_step`` spans of the window before the profiler
starts, stalls left out (``bench/rounds.py`` says why), of the time from
the step's start to the end of the ``graph/replay`` span inside it on
the same thread (the inputs' staging and the replay's launch).  Steps
without a replay (an eager engine) are left out."""
from h100_bench.bench import rounds


def read(ctx):
    if ctx["kind"] != "serve" or ctx["window"] is None:
        return None
    found = rounds.spans(ctx, ("lm/decode_step", "graph/replay"))
    replays = rounds.Children(found["graph/replay"])
    launch = []
    for step in rounds.in_window(ctx, found["lm/decode_step"]):
        inside = replays.of(step)
        if inside:
            launch.append((max(r.end for r in inside) - step.start, step))
    ms = rounds.steady_mean(ctx, "decode_launch_ms", launch)
    return None if ms is None else 1e3 * ms
