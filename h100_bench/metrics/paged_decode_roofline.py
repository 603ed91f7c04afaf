"""The paged decode kernel's share of its roofline: the keys and values
the decode steps inside the profiled slice read, each row once a step
(a prefix several requests share in the cache once), float32, against
3.35 TB/s, or their attention operations against 165 TFLOP/s if that
bound is higher, over the summed device time of the ``paged_*`` kernels
that started between the first of those steps' start and the last
one's end (only decode steps launch them)."""
from h100_bench.bench import flops, reads


def read(ctx):
    if ctx["kind"] != "serve" or ctx["devtrace"] is None:
        return None
    s = ctx["sizes"]
    steps = reads.in_slice(ctx, reads.spans(ctx, "lm/decode_step"))
    if not steps:
        return None
    a, b = steps[0][0], steps[-1][1]
    kernel = sum(o.seconds for o in ctx["devtrace"].overlapping(a, b)
                 if o.cat == "kernel" and "paged_" in o.name
                 and a <= o.start <= b)
    positions = reads.decode_positions(ctx, steps)
    if not kernel or not positions:
        return None
    nbytes = flops.kv_bytes(s, reads.unique_kv_rows(ctx, steps))
    ops = sum(flops.paged_attention_flops(s, p) for p in positions)
    least, _ = flops.roofline_seconds(ops, nbytes)
    return 100.0 * least / kernel
