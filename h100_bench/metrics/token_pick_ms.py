"""The host's token pick a decode step: the mean duration of the
engine's ``lm/token_pick`` spans (each slot's ``pick_token`` and emit,
then the step's bookkeeping and retirements) of the window before the
profiler starts, stalls left out (``bench/rounds.py`` says why)."""
from h100_bench.bench import rounds


def read(ctx):
    if ctx["kind"] != "serve" or ctx["window"] is None:
        return None
    picks = rounds.in_window(
        ctx, rounds.spans(ctx, ["lm/token_pick"])["lm/token_pick"])
    ms = rounds.steady_mean(ctx, "token_pick_ms",
                            [(s.seconds, s) for s in picks])
    return None if ms is None else 1e3 * ms
