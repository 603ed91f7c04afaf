"""The prefix cache's share of the prompt tokens: prompt tokens the radix
served from cache (its ``prefill_tokens_saved`` counter, over the run)
over the prompt tokens of every request submitted."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None

    def saved(stats):
        pc = (stats.get("kvcache") or {}).get("prefix_cache")
        return None if pc is None else pc["prefill_tokens_saved"]

    a, b = saved(ctx["stats_before"]), saved(ctx["stats_after"])
    total = sum(len(r.req.prompt) for r in ctx["records"]
                if r.stream is not None)
    if a is None or b is None or not total:
        return None
    return 100.0 * (b - a) / total
