"""Paged KV memory: one device-resident block arena + a host-side free
list (port of ``bigdl_tpu/serving/kvcache/blocks.py``).

KV memory is ONE pair of tensors of fixed-size blocks

    k, v : (L, num_blocks, H, block_len, D)

on the engine's device, and a sequence is a host-side list of block ids
(its block table).  The tensors never change shape: prefill scatters
rows into blocks and decode reads them through a padded int32 table,
both in place.  Allocation, refcounts and sharing live on the host.

With ``kv_quant="int8"`` the arenas hold int8 rows and two float32
scale arenas ``ks``/``vs`` of shape (L, num_blocks, H, block_len), one
scale per (position, head) row; the dense gather dequantizes them (the
paged kernel reads float arenas only).

Block 0 is reserved as **scratch**: padded table entries and padded
scatter targets point at it, so garbage lands in (or comes from) it and
is always masked by the position mask.  It is never allocated or freed.
Refcounts make chains shareable: a block is freed when its last holder
releases it.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from bigdl_tpu_torch.serving.errors import PoolExhausted

SCRATCH_BLOCK = 0


class BlockPool:
    """Refcounted free-list allocator over one paged k/v arena.

    Args:
        n_layers / n_heads / head_dim: model geometry (L, H, D).
        block_len: tokens per block (the page size).
        num_blocks: total blocks INCLUDING the scratch block 0.
        dtype: arena dtype (float32 by default) of a float pool.
        device: where the arenas live.
        kv_quant: ``None`` (float arenas) or ``"int8"``: int8 arenas
            plus the float32 scale arenas ``ks``/``vs`` (L, N, H, B).
            About 4x the positions in the same memory, less the scales'
            1/D; lossy, so streams are not bit-exact against a float
            pool.  Chain export/adopt waits for disaggregated serving
            (ROADMAP Queue 1 item 11.4).
    """

    def __init__(self, *, n_layers: int, n_heads: int, head_dim: int,
                 block_len: int, num_blocks: int,
                 dtype: Optional[torch.dtype] = None, device="cpu",
                 kv_quant: Optional[str] = None):
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}")
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is scratch), got "
                f"{num_blocks}")
        self.block_len = int(block_len)
        self.num_blocks = int(num_blocks)
        self.shape = (int(n_layers), self.num_blocks, int(n_heads),
                      self.block_len, int(head_dim))
        self.kv_quant = kv_quant
        if kv_quant == "int8":
            dt = torch.int8
            # per-(position, head) scales, block-major like the arenas
            self.ks = torch.zeros(self.shape[:4], dtype=torch.float32,
                                  device=device)
            self.vs = torch.zeros(self.shape[:4], dtype=torch.float32,
                                  device=device)
        else:
            dt = dtype if dtype is not None else torch.float32
            self.ks = self.vs = None
        self.k = torch.zeros(self.shape, dtype=dt, device=device)
        self.v = torch.zeros(self.shape, dtype=dt, device=device)
        self.dtype = dt
        self._lock = threading.Lock()
        # pop() from the tail hands out ascending ids first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks

    # -- capacity -------------------------------------------------------- #
    @property
    def capacity(self) -> int:
        """Usable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def kv_arena_bytes(self) -> int:
        """Device footprint of the k + v data arenas alone."""
        return 2 * self.k.numel() * self.k.element_size()

    @property
    def scale_arena_bytes(self) -> int:
        """Device footprint of the int8 pool's scale arenas (0 for a
        float pool)."""
        if self.ks is None:
            return 0
        return 2 * self.ks.numel() * self.ks.element_size()

    @property
    def arena_bytes(self) -> int:
        """Device footprint of the k + v arenas, scale arenas included."""
        return self.kv_arena_bytes + self.scale_arena_bytes

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.block_len)

    # -- alloc / refcount ------------------------------------------------ #
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks at refcount 1; all-or-nothing."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                raise PoolExhausted(
                    f"need {n} blocks, {len(self._free)} free "
                    f"(capacity {self.capacity})")
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
        return out

    def retain(self, blocks: Sequence[int]) -> None:
        """Add one reference to each (already-live) block."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(f"retain of free block {b}")
                self._ref[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference; a block at zero returns to the free
        list."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(f"release of free block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
        return {
            "num_blocks": self.num_blocks,
            "block_len": self.block_len,
            "capacity": self.capacity,
            "free_blocks": free,
            "used_blocks": self.capacity - free,
            "utilization": ((self.capacity - free) / self.capacity
                            if self.capacity else 0.0),
            "arena_bytes": self.arena_bytes,
            "kv_quant": self.kv_quant or "none",
        }
