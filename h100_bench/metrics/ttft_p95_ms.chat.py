"""Time to first token, read per layer: the 95th percentile, on the
client's clock, of each request's time from its due time to its first
token (a shed or failed request counts as the whole wait), over every
request of the window, as the serving runner takes it."""
from h100_bench.bench.common import percentile


def read(ctx):
    if ctx["kind"] != "serve" or ctx["window"] is None:
        return None
    ttfts = ctx["run"].ttfts_ms()
    return percentile(ttfts, 95.0) if ttfts else None
