"""What the per-layer readers share: the program's spans on the host
clock, the requests by id, and the decode tokens of a set of steps."""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple


def spans(ctx: dict, name: str) -> List[Tuple[float, float, dict]]:
    """The program's spans named ``name``: (start, end, args) on the host
    clock, by start."""
    run = ctx["run"]
    epoch = run.tracer_epoch
    out = []
    for e in ctx["events"]:
        if e.get("ph") == "X" and e.get("name") == name:
            a = epoch + e["ts"] / 1e6
            out.append((a, a + e["dur"] / 1e6, e.get("args", {})))
    out.sort(key=lambda x: x[0])
    return out


def in_slice(ctx: dict, items):
    """The spans that lie wholly inside the profiled slice."""
    tr = ctx["devtrace"]
    return [x for x in items if x[0] >= tr.t0 and x[1] <= tr.t1]


def prompt_lens(ctx: dict) -> Dict[str, int]:
    """Each submitted request's prompt length, by the id its stream
    carries."""
    return {r.stream.request_id: len(r.req.prompt) for r in ctx["records"]
            if r.stream is not None}


def matched_tokens(ctx: dict) -> Dict[str, int]:
    """The prompt tokens each request took from the prefix cache (the
    engine's ``lm/radix_match`` instants), by request id."""
    return {e["args"]["request_id"]: int(e["args"]["matched_tokens"])
            for e in ctx["events"]
            if e.get("name") == "lm/radix_match" and "args" in e}


def decode_tokens(ctx: dict, steps) -> List[Tuple[int, str, int]]:
    """Every decode token computed in ``steps`` (``lm/decode_step``
    spans) as (step index, request id, 0-based position): each
    ``lm/decode_round`` span (one a slot a step) whose middle lies in a
    step gives its request's prompt length plus the tokens it had
    decoded."""
    lens = prompt_lens(ctx)
    bounds = sorted((a, b) for a, b, _ in steps)
    starts = [a for a, _ in bounds]
    out = []
    for a, b, args in spans(ctx, "lm/decode_round"):
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= bounds[k][1]:
            rid = args.get("request_id")
            if rid in lens:
                out.append((k, rid, lens[rid] + int(args.get("step", 0))))
    return out


def decode_positions(ctx: dict, steps) -> List[int]:
    """The positions of :func:`decode_tokens`."""
    return [p for _, _, p in decode_tokens(ctx, steps)]


def unique_kv_rows(ctx: dict, steps) -> int:
    """The K/V rows (positions) the decode steps read, each row once a
    step: a request's own positions, and a cached prefix that several
    requests of one session matched counted once, unless a request of
    the session that matched nothing (the one whose prefill put those
    blocks in the cache) reads them itself in that step."""
    matched = matched_tokens(ctx)
    session = {r.stream.request_id: r.req.session for r in ctx["records"]
               if r.stream is not None}
    total = 0
    shared: Dict[Tuple[int, int], int] = {}
    owners = set()
    for k, rid, pos in decode_tokens(ctx, steps):
        m = matched.get(rid, 0)
        total += pos + 1 - m
        key = (k, session.get(rid, -1))
        if m:
            shared[key] = max(shared.get(key, 0), m)
        else:
            owners.add(key)
    return total + sum(m for key, m in shared.items() if key not in owners)
