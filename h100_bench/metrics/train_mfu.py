"""The training step's share of the float32 peak: the model operations
of every step of the window (products, causal attention and the head,
forward and backward), over the window's time, over 165 TFLOP/s."""
from h100_bench.bench import flops


def read(ctx):
    if ctx["kind"] != "train":
        return None
    run = ctx["run"]
    t0, t1 = ctx["window"]
    if not run.steps_window or t1 <= t0:
        return None
    work = flops.train_flops_per_step(ctx["sizes"], run.batch, run.seq_len)
    return 100.0 * work * run.steps_window / (t1 - t0) / flops.FP32_PEAK
