"""Paged decode attention: a hand-written CUDA kernel and its plain
PyTorch version (port of ``bigdl_tpu/ops/paged_attention.py``).

``csrc/paged_decode.cu`` replaces the Pallas TPU kernel
``_paged_kernel`` (``bigdl_tpu/ops/paged_attention.py:34``): one query
token per slot attends its own KV chain, read in place from the block
arenas through the slot's row of the block table.  Semantics, shared by
kernel and plain version: float32 ``q . k`` divided by sqrt(D) (divide,
not multiply, as the dense gather path), keys at positions > ``pos[s]``
masked, softmax, float32 ``w . v``; the output is float32 for float32
and bfloat16 arenas alike, shaped like ``q``.

The kernel splits each (slot, head)'s context into chunks of
``CHUNK_KEYS`` keys (rounded to whole KV blocks), one thread block a
chunk, and merges the chunks' float32 partials in a second kernel behind
the same C entry point (one launch a call); the wrapper allocates the
partials' workspace.

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bigdl_tpu_torch.ops._build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

PAGED_DECODE = Kernel(
    "paged_decode", "bigdl_paged_decode",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

CHUNK_KEYS = 64  # keys a thread block of the kernel attends


def split_count(table_width: int, block_len: int, chunk_keys: int) -> int:
    """Chunks a (slot, head) is split into: ``ceil(M / chunk_blocks)``
    with ``chunk_blocks = max(1, chunk_keys // block_len)`` table entries
    a chunk."""
    chunk_blocks = max(1, chunk_keys // block_len)
    return -(-table_width // chunk_blocks)


def paged_decode_attention_reference(q, k_arena, v_arena, tables, pos):
    """The dense-gather version: materialize ``arena[tables]`` and run
    plain attention over it (the decode path's ``"gather"`` math)."""
    squeeze = q.dim() == 4
    q4 = q if squeeze else q[:, :, None, :]
    s, m = tables.shape
    blk = k_arena.shape[2]
    ctx = m * blk
    h, d = q4.shape[1], q4.shape[3]
    tables = tables.long()
    mask = (torch.arange(ctx, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    kg = k_arena[tables].permute(0, 2, 1, 3, 4).reshape(s, h, ctx, d)
    vg = v_arena[tables].permute(0, 2, 1, 3, 4).reshape(s, h, ctx, d)
    scores = torch.matmul(q4.float(), kg.float().transpose(-1, -2))
    scores = scores / math.sqrt(d)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    o = torch.matmul(w, vg.float())
    return o if squeeze else o[:, :, 0, :]


def paged_decode_attention(q, k_arena, v_arena, tables, pos):
    """One decode step of paged attention, reading KV blocks in place.

    q: (S, H, 1, D) or (S, H, D); k_arena/v_arena: (N, H, block_len, D)
    block pools (float32 or bfloat16); tables: (S, M) int32 block ids,
    padded with the scratch block 0; pos: (S,) int32 position of each
    slot's current token, ``pos < M * block_len``.  Returns float32
    attention output shaped like q.  On the card, keys past ``pos[s]``
    and their blocks are never read."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_arena, v_arena,
                                                tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    squeeze = q.dim() == 4
    q3 = q[:, :, 0, :] if squeeze else q
    s, h, d = q3.shape
    n, _, blk, _ = k_arena.shape
    m = tables.shape[1]
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena),
                    ("tables", tables), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k_arena.dtype not in _DTYPES or v_arena.dtype != k_arena.dtype:
        raise ValueError(f"paged kernel takes float32 or bfloat16 arenas "
                         f"of one dtype, got {k_arena.dtype}/{v_arena.dtype}")
    if d not in (64, 128):
        raise ValueError(f"paged kernel takes head_dim 64 or 128, got {d}")
    if (k_arena.shape != (n, h, blk, d) or v_arena.shape != k_arena.shape
            or tables.shape != (s, m) or pos.shape != (s,)):
        raise ValueError("paged kernel shapes disagree: q "
                         f"{tuple(q.shape)}, arenas {tuple(k_arena.shape)}, "
                         f"tables {tuple(tables.shape)}, pos {tuple(pos.shape)}")
    if not (k_arena.is_contiguous() and v_arena.is_contiguous()):
        raise ValueError("paged kernel reads contiguous arenas")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("paged kernel reads 16-byte aligned arenas")
    qf = q3.float().contiguous()
    tables = tables.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    if s:
        n_split = split_count(m, blk, CHUNK_KEYS)
        # per chunk (m, l, acc[D]); chunks past pos are never written or read
        ws = torch.empty((s, h, n_split, d + 2), dtype=torch.float32,
                         device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        PAGED_DECODE.launch(qf.data_ptr(), k_arena.data_ptr(),
                            v_arena.data_ptr(), tables.data_ptr(),
                            pos.data_ptr(), out.data_ptr(), ws.data_ptr(), s,
                            h, blk, d, m, n_split, _DTYPES[k_arena.dtype],
                            stream)
    return out[:, :, None, :] if squeeze else out
