"""Radix prefix cache: token-prefix trie over refcounted block chains
(host-only port of ``bigdl_tpu/serving/kvcache/radix.py``).

The trie is **block-granular**: one node per full block of
``block_len`` tokens, keyed by that block's token tuple, so a match is
always a whole number of blocks.  Matching is capped at
``(t - 1) // block_len`` blocks: the final prompt token is always
prefilled, so the request has logits to pick its first token from.

Reference protocol (one pool refcount per holder):

- ``match`` retains every matched block for the caller, which releases
  them with the rest of its table when the stream finishes;
- ``insert`` retains each block it adopts into a NEW node; a prefix
  already in the trie keeps its blocks, the caller's duplicates stay
  private to the caller;
- ``evict`` releases blocks whose ONLY reference is the trie
  (refcount 1), least recently used first, leaves first.

Every eviction goes through one path: the optional ``on_evict(path,
block)`` callback fires per victim, ``path`` the tuple of block
token-keys from the root down to the victim, BEFORE the trie's
reference is released, so the block's rows are still allocated and
gatherable (the engine's host-tier demotion hook).  A callback that
raises is logged and the eviction proceeds as a plain drop.

Every node also carries a 64-bit FNV-1a fingerprint of its whole
root-to-node block-key path (:func:`prefix_signatures`), plain integer
arithmetic, so the port's fingerprints equal the reference's bit for
bit.  An attached router summary (:meth:`RadixCache.attach_summary`)
gets ``on_insert(sig)`` / ``on_evict(sig)`` for every node added or
dropped, under the trie lock, so it never advertises an evicted chain.

The serving worker is the only mutator; counters are lock-guarded so
stats reads (and a foreign thread's ``match``) are consistent.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

from bigdl_tpu_torch.serving.kvcache.blocks import BlockPool

log = logging.getLogger("bigdl_tpu_torch.serving")

_SIG_ROOT = 0xCBF29CE484222325     # FNV-1a 64-bit offset basis
_FNV_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def _sig_extend(sig: int, key: Tuple[int, ...]) -> int:
    """Fold one block's token tuple into a cumulative prefix
    fingerprint (block keys have a fixed length, so no separator)."""
    h = sig
    for tok in key:
        h = ((h ^ (int(tok) & _U64)) * _FNV_PRIME) & _U64
    return h


def prefix_signatures(tokens0, block_len: int,
                      cap: Optional[int] = None) -> List[int]:
    """Cumulative block-prefix fingerprints of a prompt (0-based ids):
    ``out[i]`` covers blocks ``[0, i]``, at most ``(t - 1) // block_len``
    of them (the bound :meth:`RadixCache.match` uses) or ``cap``."""
    n = max(0, (len(tokens0) - 1) // block_len)
    if cap is not None:
        n = min(n, int(cap))
    out: List[int] = []
    sig = _SIG_ROOT
    for i in range(n):
        sig = _sig_extend(sig, tuple(
            int(x) for x in tokens0[i * block_len:(i + 1) * block_len]))
        out.append(sig)
    return out


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used", "sig")

    def __init__(self, key: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["_Node"], last_used: int,
                 sig: int = _SIG_ROOT):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = last_used
        self.sig = sig              # fingerprint of the root->node path


class RadixCache:
    """Longest-prefix block reuse over a :class:`BlockPool`."""

    def __init__(self, pool: BlockPool,
                 on_evict: Optional[Callable[[Tuple[Tuple[int, ...], ...],
                                              int], None]] = None):
        self.pool = pool
        self.block_len = pool.block_len
        #: the eviction funnel, ``on_evict(path, block)`` per victim
        #: before release (reassignable live)
        self.on_evict = on_evict
        #: the router's summary (``on_insert(sig)``/``on_evict(sig)``
        #: per node), wired by :meth:`attach_summary`
        self.summary = None
        self._lock = threading.Lock()
        self._root = _Node(None, None, None, 0)
        self._clock = 0
        self.nodes = 0
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0   # == prefill tokens saved
        self.inserted_blocks = 0
        self.evictions = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _block_key(self, tokens0, i: int) -> Tuple[int, ...]:
        B = self.block_len
        return tuple(int(x) for x in tokens0[i * B:(i + 1) * B])

    def match(self, tokens0) -> List[int]:
        """Longest cached prefix of ``tokens0`` (0-based ids), in whole
        blocks, leaving at least the last prompt token to prefill.
        Matched blocks are retained for the caller."""
        cap = max(0, (len(tokens0) - 1) // self.block_len)
        out: List[int] = []
        with self._lock:
            self.lookups += 1
            node = self._root
            now = self._tick()
            for i in range(cap):
                child = node.children.get(self._block_key(tokens0, i))
                if child is None:
                    break
                child.last_used = now
                out.append(child.block)
                node = child
            if out:
                self.hits += 1
                self.matched_tokens += len(out) * self.block_len
                self.pool.retain(out)
        return out

    def peek(self, tokens0) -> int:
        """How many blocks :meth:`match` would match now, with nothing
        retained, counted or made recent: a forwarded hop sizes its
        payload by it without touching the trie, whose every rank of a
        tensor-parallel slot must stay alike."""
        cap = max(0, (len(tokens0) - 1) // self.block_len)
        n = 0
        with self._lock:
            node = self._root
            for i in range(cap):
                node = node.children.get(self._block_key(tokens0, i))
                if node is None:
                    break
                n += 1
        return n

    def record_saved(self, n_tokens: int) -> None:
        """Count ``n_tokens`` of prefill saved outside :meth:`match` (the
        host tier's promoted blocks), as a trie hit counts them."""
        with self._lock:
            self.matched_tokens += int(n_tokens)

    def insert(self, tokens0, blocks: List[int]) -> int:
        """Register a prefilled chain: ``blocks[i]`` holds tokens
        ``[i*B, (i+1)*B)`` of ``tokens0``.  Returns the number of nodes
        added."""
        added = 0
        with self._lock:
            node = self._root
            now = self._tick()
            for i, blk in enumerate(blocks):
                key = self._block_key(tokens0, i)
                child = node.children.get(key)
                if child is None:
                    child = _Node(key, int(blk), node, now,
                                  sig=_sig_extend(node.sig, key))
                    node.children[key] = child
                    self.pool.retain([int(blk)])
                    self.nodes += 1
                    self.inserted_blocks += 1
                    added += 1
                    if self.summary is not None:
                        self.summary.on_insert(child.sig)
                else:
                    child.last_used = now
                node = child
        return added

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    @staticmethod
    def _path_of(node: _Node) -> Tuple[Tuple[int, ...], ...]:
        """Block token-keys from the root down to ``node``: the
        host-tier identity of its block."""
        keys: List[Tuple[int, ...]] = []
        while node.key is not None:
            keys.append(node.key)
            node = node.parent
        return tuple(reversed(keys))

    def _evict_node(self, v: _Node) -> None:
        """THE eviction path: ``on_evict`` while the block is still
        allocated, then the trie's reference is released."""
        hook = self.on_evict
        if hook is not None:
            try:
                hook(self._path_of(v), int(v.block))
            except Exception:  # noqa: BLE001 - a failing demotion
                # target degrades the eviction to a plain drop
                log.exception("radix on_evict hook failed; dropping "
                              "block %d", v.block)
        del v.parent.children[v.key]
        self.pool.release([v.block])
        self.nodes -= 1
        self.evictions += 1
        if self.summary is not None:
            self.summary.on_evict(v.sig)

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU leaf nodes
        whose block has no holder but the trie.  Returns how many blocks
        were freed."""
        target = max(1, int(n_blocks))
        freed = 0
        with self._lock:
            while freed < target:
                victims = [n for n in self._leaves()
                           if self.pool.refcount(n.block) == 1]
                if not victims:
                    break
                self._evict_node(min(victims, key=lambda n: n.last_used))
                freed += 1
        return freed

    def attach_summary(self, summary) -> None:
        """Attach a router summary and replay the current trie into it
        (one walk here; every later change is the per-node hook)."""
        with self._lock:
            self.summary = summary
            stack = list(self._root.children.values())
            while stack:
                n = stack.pop()
                summary.on_insert(n.sig)
                stack.extend(n.children.values())

    def hit_rate(self) -> Optional[float]:
        with self._lock:
            return (self.hits / self.lookups) if self.lookups else None

    def stats(self) -> dict:
        with self._lock:
            return {
                "nodes": self.nodes,
                "lookups": self.lookups,
                "hits": self.hits,
                "hit_rate": (self.hits / self.lookups
                             if self.lookups else None),
                "prefill_tokens_saved": self.matched_tokens,
                "inserted_blocks": self.inserted_blocks,
                "evictions": self.evictions,
            }
