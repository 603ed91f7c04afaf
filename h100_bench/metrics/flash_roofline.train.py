"""The flash kernels' share of their roofline in training: the
operations (and bytes) the causal forward, dK/dV and dQ need at the
step's shapes, for as many steps as the profiled slice holds forward
launches of (one a layer a step), over the summed device time of the
three kernels; the bound is the operations at 165 TFLOP/s or the bytes
at 3.35 TB/s, whichever is longer."""
from h100_bench.bench import flops

KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def read(ctx):
    tr = ctx["devtrace"]
    if ctx["kind"] != "train" or tr is None or tr.t1 is None:
        return None
    run, s = ctx["run"], ctx["sizes"]
    seconds, _ = tr.kernel_seconds(*KERNELS)
    _, n_fwd = tr.kernel_seconds("flash_fwd_kernel")
    steps = n_fwd / s["layers"]
    if not seconds or not steps:
        return None
    ops, nbytes = flops.flash_train_counts(s, run.batch, run.seq_len)
    least, _ = flops.roofline_seconds(ops * steps, nbytes * steps)
    return 100.0 * least / seconds
