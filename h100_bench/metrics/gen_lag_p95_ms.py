"""The load generator's lateness: the 95th percentile of submit time
minus due time over every request, on the harness's own clock."""
from h100_bench.bench.common import percentile


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    lags = [(r.submitted - r.due) * 1e3 for r in ctx["records"]
            if r.submitted is not None]
    return percentile(lags, 95.0) if lags else None
