"""Float32 weight products on the tensor cores: a hand-written CUDA
kernel (``csrc/f32_gemm.cu``) and its plain version.

``matmul_f32(a, b)`` is ``a @ b`` for float32 ``a`` (..., K) and ``b``
(K, N).  On CUDA tensors it runs the kernel, which splits each operand
into TF32 hi and lo parts in registers and adds lo*hi, hi*lo and hi*hi
into float32 accumulators (3xTF32: float32's accuracy at the tensor
cores' rate); it replaces no TPU kernel (the JAX package leaves these
products to XLA).  It is differentiable: the backward runs the same
kernel for ``dA = dC B^T`` and ``dB = A^T dC``, reading the transposed
operands in place through their strides, and returns ``dB`` in ``b``'s
own layout.  On CPU tensors it is ``torch.matmul``, bit for bit; any
other device raises.

The kernel reads a matrix whose rows or whose columns are contiguous
(any leading dimension); other strides are copied once.  The wrapper
allocates the output and, when K is split across thread blocks, the
partials' workspace with ``torch.empty``, and never synchronises, so a
call can be captured in a CUDA graph once the library is loaded.  The
tile shape and the split of K follow (M, N, K) and the card's SM count
(:func:`plan`).

:func:`weight_matmul` is the seam the TransformerLM's weight products go
through (``quant.qmatmul``'s plain branch, ``TransformerLM.head_logits``):
plain float32 CUDA operands take ``matmul_f32``; everything else takes
``torch.matmul`` as before and is counted by the first reason that holds
(:func:`decline_reason`: ``dtensor``, ``dtype``, ``cpu``; ``qmatmul``
counts its quantized weights as ``qtensor``) in :func:`stats`.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from bigdl_tpu_torch.ops._build import Kernel

F32_GEMM = Kernel(
    "f32_gemm", "bigdl_f32_gemm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
F32_GEMM_REDUCE = Kernel(
    "f32_gemm", "bigdl_f32_gemm_reduce",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p])

#: the kernel's tiles by id: (rows, columns, blocks an SM holds at once,
#: float32-equivalent operations a second an SM, measured on an H100 at the
#: main-path shapes): 0 the warpgroup kernel, 1 the mma.sync one
TILES = {0: (128, 128, 1, 0.59e12), 1: (64, 128, 2, 0.34e12)}
BK = 32            # K columns a stage; a split of K is a multiple of it
MAX_SPLIT = 32
# what the planner assumes besides: device bytes a second, the start of a
# wave of blocks (its first loads), one more launch
_BYTES_S = 3.0e12
_WAVE_S = 3e-6
_LAUNCH_S = 3e-6

DECLINE_REASONS = ("cpu", "dtype", "dtensor", "qtensor")
_stats_lock = threading.Lock()
_routed = 0
_declined = dict.fromkeys(DECLINE_REASONS, 0)


def stats() -> dict:
    """``{"routed": n, "declined": {reason: n}}``: the products
    :func:`weight_matmul` sent to the kernel, and those it left to
    ``torch.matmul`` (and ``qmatmul``'s quantized products), by reason."""
    with _stats_lock:
        return {"routed": _routed, "declined": dict(_declined)}


def reset_stats() -> None:
    global _routed
    with _stats_lock:
        _routed = 0
        for reason in _declined:
            _declined[reason] = 0


def decline(reason: str) -> None:
    """Count one product left to another path, for ``reason``."""
    with _stats_lock:
        _declined[reason] += 1


def _route() -> None:
    global _routed
    with _stats_lock:
        _routed += 1


def decline_reason(x, w):
    """Why ``x @ w`` does not take the kernel, or None when it does."""
    if type(x).__name__ == "DTensor" or type(w).__name__ == "DTensor":
        return "dtensor"
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        return "dtype"
    if x.device.type != "cuda" or w.device.type != "cuda":
        return "cpu"
    return None


def weight_matmul(x, w):
    """``x @ w`` for a weight ``w`` (K, N): :func:`matmul_f32` when both
    are plain float32 CUDA tensors, else ``torch.matmul``, counted."""
    reason = decline_reason(x, w)
    if reason is not None:
        decline(reason)
        return torch.matmul(x, w)
    _route()
    return matmul_f32(x, w)


def matmul_f32(a, b):
    """``a @ b`` for float32 ``a`` (..., K) and ``b`` (K, N): the kernel
    on CUDA tensors (differentiable in both), ``torch.matmul`` on CPU
    tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return torch.matmul(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_f32 runs on cuda or cpu tensors of one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"matmul_f32 takes float32 operands, got "
                         f"{a.dtype} and {b.dtype}")
    if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"matmul_f32 takes a (..., K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return _MatmulF32.apply(a, b)


class _MatmulF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        a2 = a.reshape(-1, a.shape[-1])
        ctx.save_for_backward(a2, b)
        ctx.a_shape = a.shape
        return gemm(a2, b).reshape(a.shape[:-1] + (b.shape[1],))

    @staticmethod
    def backward(ctx, g):
        a2, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = gemm(g2, b.T).reshape(ctx.a_shape)
        if ctx.needs_input_grad[1]:
            if b.stride(0) == 1 and b.stride(1) != 1:
                # a column-major b (a transposed weight): its gradient in
                # the same layout, as the transpose of dC^T A
                db = gemm(g2.T, a2).T
            else:
                db = gemm(a2.T, g2)
        return da, db


def _operand(t) -> Tuple[torch.Tensor, bool, int]:
    """``(t, rows_contiguous, ld)`` for a 2-D matrix the kernel reads in
    place: row-major (strides (ld, 1)) or column-major (strides (1, ld));
    any other strides are copied row-major."""
    r, c = t.shape
    s0, s1 = t.stride()
    if s1 == 1 and s0 >= max(c, 1):
        return t, True, s0
    if s0 == 1 and s1 >= max(r, 1):
        return t, False, s1
    t = t.contiguous()
    return t, True, max(c, 1)


def _vec(t, ld: int) -> int:
    """1 when 16-byte copies are safe: an aligned base and rows of a
    multiple of 4 floats."""
    return int(ld % 4 == 0 and t.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, sms: int = 132) -> Tuple[int, int, int]:
    """``(tile, split, k_per_split)`` for an (m, n, k) product on a card
    of ``sms`` SMs: the tile of :data:`TILES` and the split of K whose
    estimated time is least (tile 1 alone up to 64 rows).  A wave of
    blocks (as many as the SMs hold) takes its blocks' operations at their
    share of an SM's rate, plus a start; the bytes read bound from below;
    a split adds its partials' traffic and the adding kernel's launch.
    Ties go to fewer splits."""
    kt = -(-k // BK)
    floor = 4.0 * (m * k + k * n + m * n) / _BYTES_S
    best = None
    # up to 64 rows the 128-row tile would compute padding: tile 1 only
    for tile in (1,) if m <= 64 else tuple(TILES):
        bm, bn, per_sm, rate = TILES[tile]
        tiles = -(-m // bm) * -(-n // bn)
        seen = set()
        for want in range(1, min(kt, MAX_SPLIT) + 1):
            step = -(-kt // want)       # K tiles a split
            split = -(-kt // step)      # splits that are not empty
            if split in seen:
                continue
            seen.add(split)
            waves = -(-tiles * split // (sms * per_sm))
            t = waves * (2.0 * bm * bn * step * BK * per_sm / rate + _WAVE_S)
            t = max(t, floor)
            if split > 1:
                t += 8.0 * split * m * n / _BYTES_S + _LAUNCH_S
            key = (t, split, tile)
            if best is None or key < best[0]:
                best = (key, (tile, split, step * BK))
    return best[1]


def gemm(a, b):
    """``a @ b`` for 2-D float32 CUDA matrices ``a`` (M, K) and ``b``
    (K, N) of any strides by the kernel; returns a contiguous (M, N)."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    a, a_kc, lda = _operand(a)
    b, b_nc, ldb = _operand(b)
    tile, split, kps = plan(m, n, k, _sm_count(a.device.index))
    # with a split of K the kernel writes (split, M, N) partials
    c = out if split == 1 else torch.empty((split, m, n), dtype=torch.float32,
                                           device=a.device)
    if F32_GEMM._fn is None:
        F32_GEMM_REDUCE._entry()   # both entry points load outside a capture
    stream = torch.cuda.current_stream(a.device).cuda_stream
    F32_GEMM.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, lda,
                    ldb, n, m * n if split > 1 else 0, int(a_kc), int(b_nc),
                    tile, split, kps, _vec(a, lda), _vec(b, ldb),
                    int(n % 2 == 0), stream)
    if split > 1:
        F32_GEMM_REDUCE.launch(c.data_ptr(), out.data_ptr(), m * n, split,
                               stream)
    return out


def split_tf32(x):
    """``(hi, lo)``: float32 ``x`` as two TF32 values (10 stored mantissa
    bits each), each rounded to nearest with ties away from zero, as the
    kernel's ``split_tf32`` (finite ``x``)."""
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _rna_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32_reference(a, b):
    """The kernel's arithmetic in plain PyTorch: ``a`` and ``b`` split by
    :func:`split_tf32`, then ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` as
    three float32 products (exact products of TF32 values, float32
    sums).  Summed in another order than the kernel, so not its bits."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


__all__ = ["DECLINE_REASONS", "F32_GEMM", "F32_GEMM_REDUCE", "TILES",
           "decline", "decline_reason", "gemm", "matmul_f32",
           "matmul_3xtf32_reference", "plan", "reset_stats", "split_tf32",
           "stats", "weight_matmul"]
