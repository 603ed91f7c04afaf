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

A chain moves between the arenas and the host as a **block-major wire
payload** ``{"k", "v": (n, L, H, block_len, D)}`` (plus ``"ks"``/``"vs"``
``(n, L, H, block_len)`` float32 scales for an int8 pool, always with
their rows): :meth:`BlockPool.export_chain` gathers it to the host in
slices of at most 32 MB, :meth:`BlockPool.adopt_chain` allocates blocks
all-or-nothing and writes a payload back over
:func:`~bigdl_tpu_torch.utils.transfer.chunked_device_put`.  Both work
IN PLACE on the arenas (``index_select`` and ``index_copy_``): the
arena tensors are never rebound, since captured CUDA graphs hold their
addresses.  The host KV tier (``serving/kvtier``) and the disaggregated
coordinator's migration (``serving/disagg``) move chains this way;
:meth:`BlockPool.warmup_adopt` runs the adopt path once per wire width
before traffic.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.serving.errors import PoolExhausted
from bigdl_tpu_torch.utils.transfer import (DEFAULT_CHUNK_BYTES,
                                            chunked_device_put)

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
            pool.  Exported chains carry their scale rows.
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

    def utilization(self) -> float:
        """Used share of the usable blocks (host free list only)."""
        with self._lock:
            free = len(self._free)
        return (self.capacity - free) / self.capacity if self.capacity \
            else 0.0

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

    # -- chain export / adopt (host KV tier) ----------------------------- #
    @property
    def block_bytes(self) -> int:
        """Bytes of one block's k (== v) rows across all layers."""
        L, _, H, B, D = self.shape
        return L * H * B * D * self.k.element_size()

    @property
    def scale_block_bytes(self) -> int:
        """Bytes of one block's k (== v) scale rows; 0 for a float
        pool."""
        if self.ks is None:
            return 0
        L, _, H, B, _ = self.shape
        return L * H * B * self.ks.element_size()

    @property
    def wire_block_bytes(self) -> int:
        """Wire bytes of one block's k (== v) leg with its scale rows:
        the unit the chunkers budget on."""
        return self.block_bytes + self.scale_block_bytes

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        # numpy has no bfloat16: its payload travels as the bit pattern
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()

    def export_chain(self, blocks: Sequence[int], *,
                     chunk_bytes: Optional[int] = None) -> dict:
        """Gather ``blocks``' k/v rows to the host as a block-major wire
        payload ``{"k", "v": (n, L, H, block_len, D), "blocks": n}``; an
        int8 pool adds ``"ks"``/``"vs"`` ``(n, L, H, block_len)`` float32
        scales, so an adopted block is bit-identical to the exported one.

        The gather (``index_select``) runs on the caller's current
        stream, after whatever that stream enqueued before (the last
        step that wrote the blocks); each slice of at most
        ``chunk_bytes`` (scales counted) comes back with a synchronous
        copy, so the returned arrays are complete.  Refcounts are not
        touched."""
        cb = int(chunk_bytes) if chunk_bytes else DEFAULT_CHUNK_BYTES
        n = len(blocks)
        L, _, H, B, D = self.shape
        quant = self.kv_quant is not None
        wire_dt = np.int16 if self.dtype == torch.bfloat16 else \
            torch.empty((), dtype=self.dtype).numpy().dtype
        host = {"k": np.empty((n, L, H, B, D), wire_dt),
                "v": np.empty((n, L, H, B, D), wire_dt)}
        arenas = {"k": self.k, "v": self.v}
        if quant:
            host["ks"] = np.empty((n, L, H, B), np.float32)
            host["vs"] = np.empty((n, L, H, B), np.float32)
            arenas.update(ks=self.ks, vs=self.vs)
        if n:
            rows = max(1, cb // max(1, self.wire_block_bytes))
            for i in range(0, n, rows):
                idx = torch.as_tensor(list(blocks[i:i + rows]),
                                      dtype=torch.long, device=self.k.device)
                for name, arena in arenas.items():
                    # (L, r, ...) -> block-major (r, L, ...)
                    part = arena.index_select(1, idx).movedim(1, 0)
                    host[name][i:i + rows] = self._to_host(part)
        out = dict(host)
        out["blocks"] = n
        return out

    def warmup_adopt(self, widths: Sequence[int]) -> int:
        """Run the adopt path once per wire width in ``widths`` (the
        pinned staging, the copies and the in-place ``index_copy_``)
        with a zero payload aimed entirely at the scratch block, whose
        rows are always masked, so the first real migration of that
        width pays no first use.  No block is allocated and the arenas
        keep their addresses.  Returns the number of widths run."""
        L, _, H, B, D = self.shape
        dev = self.k.device
        legs = [(self.k, (L, H, B, D), self.dtype),
                (self.v, (L, H, B, D), self.dtype)]
        if self.kv_quant is not None:
            legs += [(self.ks, (L, H, B), torch.float32),
                     (self.vs, (L, H, B), torch.float32)]
        n = 0
        for w in widths:
            w = int(w)
            if w < 1:
                continue
            idx = torch.full((w,), SCRATCH_BLOCK, dtype=torch.long,
                             device=dev)
            for arena, row, dt in legs:
                wire = self._to_host(torch.zeros((w,) + row, dtype=dt))
                staged = chunked_device_put(wire, dt, device=dev)
                arena.index_copy_(1, idx, staged.movedim(0, 1))
            n += 1
        return n

    def adopt_chain(self, k_wire, v_wire, ks_wire=None, vs_wire=None, *,
                    extra_blocks: int = 0,
                    chunk_bytes: Optional[int] = None) -> List[int]:
        """Adopt an exported chain into THIS pool: allocate ``n_wire +
        extra_blocks`` blocks (all-or-nothing), stage the payload over
        ``chunked_device_put`` and write it into the first ``n_wire`` of
        them in place (``index_copy_``; the arenas keep their storage).
        Returns the new block ids, each at refcount 1.

        An int8 pool requires the matching ``ks_wire``/``vs_wire``
        scales; data and scales land together.  ``extra_blocks``
        reserves the generation tail in the same allocation.  On any
        failure every allocated block is released before the error
        propagates; :class:`PoolExhausted` propagates untouched."""
        k_wire = np.asarray(k_wire)
        v_wire = np.asarray(v_wire)
        n = int(k_wire.shape[0]) if k_wire.ndim else 0
        if v_wire.shape != k_wire.shape:
            raise ValueError(
                f"k/v wire shapes differ: {k_wire.shape} vs {v_wire.shape}")
        L, _, H, B, D = self.shape
        if n and k_wire.shape[1:] != (L, H, B, D):
            raise ValueError(f"wire blocks {k_wire.shape[1:]} do not match "
                             f"the pool's {(L, H, B, D)}")
        quant = self.kv_quant is not None
        if quant and n and (ks_wire is None or vs_wire is None):
            raise ValueError(
                "adopting into a quantized pool (kv_quant='int8') "
                "requires the ks/vs scale arrays exported with the "
                "chain: data without scales cannot dequantize")
        if not quant and (ks_wire is not None or vs_wire is not None):
            raise ValueError(
                "scale arrays supplied for a full-precision pool")
        if quant and n:
            ks_wire = np.asarray(ks_wire, np.float32)
            vs_wire = np.asarray(vs_wire, np.float32)
            want = (n, L, H, B)
            if ks_wire.shape != want or vs_wire.shape != want:
                raise ValueError(
                    f"scale wire shapes {ks_wire.shape} / "
                    f"{vs_wire.shape} do not match blocks {want}")
        ids = self.alloc(n + max(0, int(extra_blocks)))
        if n == 0:
            return ids
        cb = int(chunk_bytes) if chunk_bytes else DEFAULT_CHUNK_BYTES
        # a data slice and its scale slice together stay under ``cb``
        data_cb = max(1, cb * self.block_bytes
                      // max(1, self.wire_block_bytes))
        dev = self.k.device
        try:
            legs = [(self.k, k_wire, self.dtype, data_cb),
                    (self.v, v_wire, self.dtype, data_cb)]
            if quant:
                scale_cb = max(1, cb - data_cb)
                legs += [(self.ks, ks_wire, torch.float32, scale_cb),
                         (self.vs, vs_wire, torch.float32, scale_cb)]
            staged = [(arena, chunked_device_put(wire, dt, device=dev,
                                                 chunk_bytes=c))
                      for arena, wire, dt, c in legs]
            idx = torch.as_tensor(ids[:n], dtype=torch.long, device=dev)
            for arena, w in staged:
                arena.index_copy_(1, idx, w.movedim(0, 1))
        except BaseException:
            self.release(ids)
            raise
        return ids

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
