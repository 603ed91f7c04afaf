"""The device's idle share over the profiled training steps: the part
of the slice (whole steps) in which no device operation ran."""


def read(ctx):
    tr = ctx["devtrace"]
    if ctx["kind"] != "train" or tr is None or tr.t1 is None:
        return None
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
