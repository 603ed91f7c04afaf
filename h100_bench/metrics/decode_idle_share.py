"""The device's idle share inside the decode steps: the part of the
``lm/decode_step`` spans of the profiled slice in which no device
operation ran."""
from h100_bench.bench import reads


def read(ctx):
    if ctx["kind"] != "serve" or ctx["devtrace"] is None:
        return None
    steps = reads.in_slice(ctx, reads.spans(ctx, "lm/decode_step"))
    total = sum(b - a for a, b, _ in steps)
    if not total:
        return None
    busy = ctx["devtrace"].busy_in([(a, b) for a, b, _ in steps])
    return 100.0 * (1.0 - busy / total)
