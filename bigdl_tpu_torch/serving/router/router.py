"""RadixRouter: prefix-affinity replica scoring (port of
``bigdl_tpu/serving/router/router.py``).

Least-loaded dispatch is blind to the caches: a returning session lands
wherever the queue is shortest and prefills again what another replica
holds.  The router scores replicas over their
:class:`~bigdl_tpu_torch.serving.router.summary.RadixSummary` sets:

    score(r) = w * matched_blocks(r) / prompt_blocks
             - (1 - w) * inflight(r) / (1 + max_inflight)

``w`` (``affinity_weight``) trades affinity against load.  When no
replica matches at least ``min_match_blocks`` (a cold prompt) the
router declines and the caller's least-loaded fallback runs; exact ties
break least-loaded by ``(inflight, dispatched)``.  It is shaped as a
``ReplicaSetCore`` dispatch policy, ``pick(healthy, ctx)`` with
``ctx["prompt_sigs"]``; every decision counts in ``serving/router/*``.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

from bigdl_tpu_torch.obs import get_registry, get_tracer
from bigdl_tpu_torch.serving.router.summary import RadixSummary

log = logging.getLogger("bigdl_tpu_torch.serving")
_tracer = get_tracer()


class RadixRouter:
    """Score replicas by longest-prefix match vs live load.

    Args:
        affinity_weight: ``w`` above, in [0, 1] (default 0.7: affinity
            dominates until the load skew is severe).
        min_match_blocks: smallest prefix match (whole blocks) that
            counts as affinity; prompts matching less everywhere are
            cold dispatches (least-loaded fallback).
    """

    def __init__(self, *, affinity_weight: float = 0.7,
                 min_match_blocks: int = 1):
        if not 0.0 <= affinity_weight <= 1.0:
            raise ValueError("affinity_weight must be in [0, 1]")
        self.affinity_weight = float(affinity_weight)
        self.min_match_blocks = max(1, int(min_match_blocks))
        self._summaries: Dict[str, RadixSummary] = {}
        reg = get_registry()
        self._affinity_hits = reg.counter("serving/router/affinity_hits")
        self._cold = reg.counter("serving/router/cold_dispatches")
        self.affinity_hits = 0
        self.cold_dispatches = 0

    # -- summary registry ------------------------------------------------ #
    def register(self, name: str, summary: RadixSummary) -> None:
        self._summaries[name] = summary

    def unregister(self, name: str) -> None:
        self._summaries.pop(name, None)

    # -- the dispatch policy (ReplicaSetCore contract) ------------------- #
    def pick(self, healthy: List, ctx: dict) -> Optional[object]:
        """Choose among HEALTHY candidates; None ⇒ caller falls back to
        least-loaded.  Candidates follow the ``_Replica`` protocol
        (``name`` / ``inflight`` / ``dispatched``)."""
        sigs = ctx.get("prompt_sigs")
        if not sigs:
            return None     # un-fingerprinted dispatch: least-loaded
        matches = []
        for r in healthy:
            s = self._summaries.get(r.name)
            m = s.match_blocks(sigs) if s is not None else 0
            matches.append((r, m))
        best_m = max(m for _, m in matches)
        if best_m < self.min_match_blocks:
            self.cold_dispatches += 1
            self._cold.add(1)
            self._instant(ctx, None, 0, len(sigs), cold=True)
            return None
        w = self.affinity_weight
        n = len(sigs)
        max_in = max(r.inflight for r, _ in matches)
        best, best_key = None, None
        for r, m in matches:
            score = w * (m / n) - (1.0 - w) * (r.inflight / (1 + max_in))
            # max score; exact ties fall to the core's least-loaded key
            key = (-score, r.inflight, r.dispatched)
            if best_key is None or key < best_key:
                best, best_key, best_m = r, key, m
        self.affinity_hits += 1
        self._affinity_hits.add(1)
        self._instant(ctx, best, best_m, n, cold=False)
        return best

    __call__ = pick

    def _instant(self, ctx: dict, rep, matched: int, n_blocks: int,
                 *, cold: bool) -> None:
        rid = ctx.get("rid")
        if rid is None or not _tracer.sampled(rid):
            return
        _tracer.instant(
            "router/dispatch", cat="serve", request_id=rid,
            replica=(rep.name if rep is not None else None),
            matched_blocks=matched, prompt_blocks=n_blocks, cold=cold)

    def stats(self) -> dict:
        return {
            "affinity_weight": self.affinity_weight,
            "min_match_blocks": self.min_match_blocks,
            "affinity_hits": self.affinity_hits,
            "cold_dispatches": self.cold_dispatches,
            "summaries": {n: s.stats()
                          for n, s in self._summaries.items()},
        }
