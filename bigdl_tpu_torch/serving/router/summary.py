"""Per-replica radix summaries: the router's view of a replica's trie
(port of ``bigdl_tpu/serving/router/summary.py``).

The router answers "which replica already holds this prompt's prefix?"
without touching any replica's :class:`RadixCache` (its lock belongs to
the serving worker).  Each :class:`LMServingEngine` publishes a
:class:`RadixSummary`: the set of 64-bit cumulative prefix fingerprints
(:func:`~bigdl_tpu_torch.serving.kvcache.radix.prefix_signatures`) of
every node of its trie, kept by the trie's per-node insert and evict
hooks (O(1) each, one walk at attach time).  The hooks fire under the
trie lock, so a summary never advertises a chain the trie dropped; the
summary only biases placement, and the engine's own ``radix.match`` at
admission stays the authority.
"""
from __future__ import annotations

import threading
from typing import List, Optional


class RadixSummary:
    """Compact prefix-fingerprint set mirroring one replica's trie.

    Wire with :meth:`RadixCache.attach_summary`; query with
    :meth:`match_blocks` against a prompt's cumulative sigs.  All
    methods are thread-safe (router threads query while the serving
    worker mutates).
    """

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self._lock = threading.Lock()
        self._sigs: set = set()
        self.version = 0        # bumps on every mutation (test/obs hook)
        self.inserts = 0
        self.evicts = 0

    # -- trie-side (called under the trie lock; keep O(1)) ------------- #
    def on_insert(self, sig: int) -> None:
        with self._lock:
            self._sigs.add(sig)
            self.version += 1
            self.inserts += 1

    def on_evict(self, sig: int) -> None:
        with self._lock:
            self._sigs.discard(sig)
            self.version += 1
            self.evicts += 1

    # -- router-side ---------------------------------------------------- #
    def match_blocks(self, prompt_sigs: List[int]) -> int:
        """Longest cached prefix, in whole blocks: the largest ``m``
        such that every cumulative sig of blocks ``[0, m)`` is present.
        The trie evicts leaves-first, so presence of ``sig_i`` implies
        its ancestors — the walk stops at the first gap."""
        m = 0
        with self._lock:
            for sig in prompt_sigs:
                if sig not in self._sigs:
                    break
                m += 1
        return m

    def __len__(self) -> int:
        with self._lock:
            return len(self._sigs)

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "sigs": len(self._sigs),
                    "version": self.version, "inserts": self.inserts,
                    "evicts": self.evicts}
