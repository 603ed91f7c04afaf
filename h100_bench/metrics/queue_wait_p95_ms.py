"""The engine scheduler's queue wait: the 95th percentile of the
``lm/queue_wait`` spans (submit to admission) of every request."""
from h100_bench.bench import reads
from h100_bench.bench.common import percentile


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["events"]:
        return None
    waits = [(b - a) * 1e3 for a, b, _ in reads.spans(ctx, "lm/queue_wait")]
    return percentile(waits, 95.0) if waits else None
