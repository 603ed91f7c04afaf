"""Open-loop serving sessions (after ``bigdl_tpu_torch/traffic/
loadgen.py``'s design): a mix is a stream of sessions.  A session holds
an optional shared prefix (a document) and one or more asks; each ask
appends its own distinct tail (a question, or the whole prompt when
there is no prefix) and asks for a number of output tokens.  Sessions
start by the arrival process the mix names, at ``rate_rps / asks``; a
session's later asks follow its first by drawn gaps.  Every ask due
inside the window is a request, timed from its due time.

The sessions' sizes pair up the same way for every seed; the seed
orders the sessions over the start times, orders the gaps between
those times, and draws the ids and the sampling keys.  So every seed
sends the same set of requests in another order and at other instants
drawn from one set of gaps (a session whose later asks would fall past
the window's end loses them, so the count of asks can differ by a
few).  Ids are 1-based, drawn uniformly from the vocabulary: two
prompts share a prefix only where the mix says so.

The mix's keys:

- ``rate_rps``: asks a second, offered; ``arrivals``: ``{"process":
  <name>, ...}``, the module ``h100_bench/traffic/arrivals/<name>.py``
  and its parameters;
- ``asks``: asks a session (default 1), and ``ask_gap_s``, the
  distribution of the gap from one ask of a session to its next;
- ``prefix`` (optional): the shared prefix's length distribution;
- ``tail``: each ask's own prompt tokens; ``output``: tokens generated;
- ``temperature`` (default 0, greedy) and ``greedy_share`` (default 1):
  a sampled mix sends that share of its asks greedy, for the check.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from h100_bench.bench.common import ROOT, plugin
from h100_bench.bench.loadgen import Request, quantiles, rng


def schedule(traffic: dict, seed: int, seconds: float, vocab: int,
             rate_rps: Optional[float] = None, root=ROOT) -> List[Request]:
    """Every ask of ``traffic`` due in a window of ``seconds``, by due
    time (``rate_rps`` overrides the mix's rate, as the sweep does)."""
    rate = float(traffic["rate_rps"] if rate_rps is None else rate_rps)
    asks = int(traffic.get("asks", 1))
    n_sessions = max(1, int(round(rate / asks * seconds)))
    # the sessions' sizes pair up the same way for every seed
    fixed = rng(0, 0)
    prefix = (quantiles(traffic["prefix"], n_sessions, fixed)
              if traffic.get("prefix") else np.zeros(n_sessions, np.int64))
    n_asks = n_sessions * asks
    tails = quantiles(traffic["tail"], n_asks, fixed)
    outs = quantiles(traffic["output"], n_asks, fixed)
    gaps = (quantiles(traffic["ask_gap_s"], n_sessions * (asks - 1), fixed,
                      integer=False)
            if asks > 1 else np.zeros((0,)))
    temp = float(traffic.get("temperature", 0.0))
    n_greedy = (n_asks if not temp else
                int(round(float(traffic.get("greedy_share", 1.0)) * n_asks)))
    greedy = np.zeros(n_asks, bool)
    greedy[fixed.permutation(n_asks)[:n_greedy]] = True
    arrivals = dict(traffic["arrivals"])
    process = plugin("traffic/arrivals", arrivals.pop("process"), root)
    starts = process.starts(arrivals, n_sessions, rate / asks, seed)
    order = rng(seed, 1).permutation(n_sessions)
    ids = rng(seed, 2)
    keys = rng(seed, 6).integers(0, 2 ** 31, size=n_asks)
    out: List[Request] = []
    for k, s in enumerate(order):
        shared = ids.integers(1, vocab + 1, size=int(prefix[s]),
                              dtype=np.int64).astype(np.int32)
        due = float(starts[k])
        for a in range(asks):
            if a:
                due += float(gaps[s * (asks - 1) + a - 1])
            j = s * asks + a
            tail = ids.integers(1, vocab + 1, size=int(tails[j]),
                                dtype=np.int64).astype(np.int32)
            if due < seconds:
                out.append(Request(
                    0, due, np.concatenate([shared, tail]), int(outs[j]),
                    int(s), a, int(prefix[s]),
                    temperature=0.0 if greedy[j] else temp,
                    rng=None if greedy[j] else int(keys[j])))
    out.sort(key=lambda r: (r.due_s, r.session, r.ask))
    for i, r in enumerate(out):
        r.index = i
    return out
