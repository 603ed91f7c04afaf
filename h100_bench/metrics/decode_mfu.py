"""The decode step's share of the float32 peak: the model operations of
every decode token of the run at its position (the benchmark's own
count, from the tokens each request received), over the summed
``lm/decode_step`` spans (each waits for its logits on the host, so it
covers the step's device work), over 165 TFLOP/s."""
from h100_bench.bench import flops, reads


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["events"]:
        return None
    s = ctx["sizes"]
    steps = reads.spans(ctx, "lm/decode_step")
    seconds = sum(b - a for a, b, _ in steps)
    work = 0.0
    for r in ctx["records"]:
        t = len(r.req.prompt)
        # token 1 comes from the prefill; token k + 1 from position t + k - 1
        for k in range(1, len(r.tokens)):
            work += flops.decode_flops(s, t + k - 1)
    if not seconds or not work:
        return None
    return 100.0 * work / seconds / flops.FP32_PEAK
