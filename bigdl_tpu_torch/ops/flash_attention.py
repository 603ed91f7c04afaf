"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions (port of ``bigdl_tpu/ops/flash_attention.py``).

``csrc/flash_fwd.cu`` replaces the Pallas TPU kernel ``_fwd_kernel``
(``bigdl_tpu/ops/flash_attention.py:39``): tiled online-softmax
attention that returns ``o`` and ``lse = m + log l`` without ever
holding the (Tq, Tk) score matrix in device memory.  ``csrc/flash_bwd.cu``
replaces the backward pair ``_bwd_dkv_kernel`` (``:199``) and
``_bwd_dq_kernel`` (``:262``): dk/dv per key tile and dq per query tile,
recomputing p from the saved lse.  Semantics, shared by kernels and
plain versions:

- scale defaults to 1/sqrt(D); products and softmax in float32;
- masked scores are -1e30 (never -inf); causality is bottom-right
  aligned (key j is visible to query i iff j <= i + Tk - Tq); keys past
  Tk are masked by position; optional q-side and kv-side segment ids
  must be equal;
- bf16 inputs feed the value product with p rounded to bf16, as the
  TPU kernel's ``p.astype(vb.dtype)``; the backward rounds p before
  ``p^T do`` and ds before ``ds^T q`` and ``ds k`` the same way;
- ``o = acc / l`` with l == 0 replaced by 1, so a fully masked row has
  o = 0 and lse = -1e30, and its gradients are 0 (p is a select on the
  mask, never ``exp(.) * mask``);
- the backward's ``ds = p * (dp - (delta - dlse))`` with
  ``delta = rowsum(do * o)`` (plain torch in the wrapper, as the JAX
  package computes it outside its kernels) and ``dlse`` the cotangent
  of lse.

``flash_attention`` and ``flash_attention_with_lse`` are differentiable
through one ``torch.autograd.Function`` that mirrors the JAX package's
``_flash_lse`` custom VJP (``_flash`` is its first output, with a zero
lse cotangent).  Every wrapper takes the plain
version for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from bigdl_tpu_torch.ops._build import Kernel

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

FLASH_FWD = Kernel(
    "flash_fwd", "bigdl_flash_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p])
FLASH_BWD_DKV = Kernel(
    "flash_bwd", "bigdl_flash_bwd_dkv",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p])
FLASH_BWD_DQ = Kernel(
    "flash_bwd", "bigdl_flash_bwd_dq",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p])


def _visible(tq, tk, causal, seg_q, seg_k, device):
    """(1 or B, 1, Tq, Tk) boolean mask of the visible (query, key)
    pairs: bottom-right causality and segment equality."""
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(tk - tq)
    mask = mask[None, None]
    if seg_q is not None:
        mask = mask & (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    return mask


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None,
                              q_segment_ids=None, kv_segment_ids=None):
    """The plain PyTorch version: the whole (Tq, Tk) score matrix at
    once, with the kernel's masks and rounding.  Returns (o, lse)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(tq, tk, causal, q_segment_ids, kv_segment_ids, q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, o, lse, do, dlse=None, *,
                                       causal: bool = False,
                                       scale: Optional[float] = None,
                                       q_segment_ids=None,
                                       kv_segment_ids=None):
    """The plain PyTorch backward: (dq, dk, dv) from the forward's (o,
    lse), the output cotangent ``do`` and the lse cotangent ``dlse``
    (None for zeros), with the backward kernels' masks and rounding and
    the whole (Tq, Tk) matrices at once."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[-2], k.shape[-2]
    q32, k32, v32 = q.float(), k.float(), v.float()
    do32 = do.float()
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    mask = _visible(tq, tk, causal, q_segment_ids, kv_segment_ids, q.device)
    # a select, not exp(.) * mask: a fully masked row has lse = -1e30 and
    # exp(s - lse) is inf there
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    rest = (do32 * o.float()).sum(dim=-1)
    if dlse is not None:
        rest = rest - dlse.float()
    ds = (p * (dp - rest[..., None])).to(q.dtype).float()
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q, k, v):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q's "
                             f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")


def _segment_ptrs(seg_q, seg_k, b, tq, tk, device):
    """int32 device copies of the segment ids (kept alive by the caller
    while the kernel runs) and their pointers, or Nones."""
    if seg_q is None:
        return (None, None), (None, None)
    seg_q = seg_q.to(device=device, dtype=torch.int32).contiguous()
    seg_k = seg_k.to(device=device, dtype=torch.int32).contiguous()
    if seg_q.shape != (b, tq) or seg_k.shape != (b, tk):
        raise ValueError("segment ids must be (B, Tq) and (B, Tk)")
    return (seg_q, seg_k), (seg_q.data_ptr(), seg_k.data_ptr())


def _flash_fwd_cuda(q, k, v, seg_q, seg_k, causal: bool, scale: float):
    _check_inputs(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    segs, seg_ptrs = _segment_ptrs(seg_q, seg_k, b, tq, tk, q.device)
    if tq == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), *seg_ptrs,
                     o.data_ptr(), lse.data_ptr(), b, h, tq, tk, d,
                     _DTYPES[q.dtype], int(causal), float(scale), stream)
    return o, lse


class BackwardInputs:
    """The checked, contiguous CUDA inputs that both backward kernels
    read, with ``delta = rowsum(do * o)`` (plain torch, as the JAX
    package computes it outside its kernels).  Holds every tensor whose
    pointer a launch passes, so they outlive the launch."""

    def __init__(self, q, k, v, o, lse, do, dlse, seg_q, seg_k,
                 causal: bool, scale: float):
        _check_inputs(q, k, v)
        b, h, tq, d = q.shape
        tk = k.shape[2]
        for name, t, shape, dtype in (
                ("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                ("lse", lse, (b, h, tq), torch.float32),
                ("dlse", dlse, (b, h, tq), torch.float32)):
            if t.device != q.device or t.shape != shape or t.dtype != dtype:
                raise ValueError(
                    f"{name} must be {dtype} {tuple(shape)} on {q.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        # do arrives from the head merge's transpose: the kernels read rows
        self.q, self.k, self.v = q.contiguous(), k.contiguous(), v.contiguous()
        self.do = do.contiguous()
        self.lse, self.dlse = lse.contiguous(), dlse.contiguous()
        self.delta = (self.do.float() * o.float()).sum(dim=-1)
        self.segs, seg_ptrs = _segment_ptrs(seg_q, seg_k, b, tq, tk, q.device)
        self.ptrs = (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                     self.do.data_ptr(), self.lse.data_ptr(),
                     self.delta.data_ptr(), self.dlse.data_ptr(), *seg_ptrs)
        self.empty = tq == 0 or tk == 0
        self.tail = (b, h, tq, tk, d, _DTYPES[q.dtype], int(causal),
                     float(scale))


def flash_bwd_dkv(x: BackwardInputs):
    """(dk, dv) through ``csrc/flash_bwd.cu``'s dk/dv kernel."""
    dk, dv = torch.empty_like(x.k), torch.empty_like(x.v)
    if x.empty:
        return dk.zero_(), dv.zero_()
    FLASH_BWD_DKV.launch(*x.ptrs, dk.data_ptr(), dv.data_ptr(), *x.tail,
                         torch.cuda.current_stream(x.q.device).cuda_stream)
    return dk, dv


def flash_bwd_dq(x: BackwardInputs):
    """dq through ``csrc/flash_bwd.cu``'s dq kernel."""
    dq = torch.empty_like(x.q)
    if x.empty:
        return dq.zero_()
    FLASH_BWD_DQ.launch(*x.ptrs, dq.data_ptr(), *x.tail,
                        torch.cuda.current_stream(x.q.device).cuda_stream)
    return dq


def _flash_bwd_cuda(q, k, v, o, lse, do, dlse, seg_q, seg_k, causal: bool,
                    scale: float):
    x = BackwardInputs(q, k, v, o, lse, do, dlse, seg_q, seg_k, causal, scale)
    dk, dv = flash_bwd_dkv(x)
    return flash_bwd_dq(x), dk, dv


def _on_device(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return q.device.type == "cuda"


def _flash_fwd(q, k, v, seg_q, seg_k, causal, scale):
    if not _on_device(q, "flash_attention"):
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         q_segment_ids=seg_q,
                                         kv_segment_ids=seg_k)
    return _flash_fwd_cuda(q, k, v, seg_q, seg_k, causal, float(scale))


def _flash_bwd(q, k, v, o, lse, do, dlse, seg_q, seg_k, causal, scale):
    if not _on_device(q, "flash_attention backward"):
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
            q_segment_ids=seg_q, kv_segment_ids=seg_k)
    return _flash_bwd_cuda(q, k, v, o, lse, do, dlse, seg_q, seg_k, causal,
                           float(scale))


class _FlashLse(torch.autograd.Function):
    """(o, lse) = flash(q, k, v); the lse cotangent folds into the
    backward as ``ds += p * dlse`` (the JAX package's ``_flash_lse``).
    An unused output's cotangent arrives as zeros, so ``flash_attention``
    (the JAX package's ``_flash``) is this Function's first output."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, scale):
        o, lse = _flash_fwd(q, k, v, seg_q, seg_k, causal, scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, dlse, seg_q, seg_k,
                                ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, segment_ids=None):
    """Flash attention, differentiable.  q: (B, H, Tq, D); k, v: (B, H,
    Tk, D).  ``segment_ids`` (B, T): packed-document isolation,
    self-attention only (Tq == Tk)."""
    if segment_ids is not None and q.shape[-2] != k.shape[-2]:
        raise ValueError("segment_ids requires self-attention (Tq == Tk)")
    return _FlashLse.apply(q, k, v, segment_ids, segment_ids, causal,
                           _scale(q, scale))[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None,
                             q_segment_ids=None, kv_segment_ids=None):
    """Flash attention that also returns the float32 logsumexp (B, H, Tq)
    of the scaled scores, differentiable in both outputs; q-side and
    kv-side segment ids are independent (both or neither)."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids "
                         "or neither")
    return _FlashLse.apply(q, k, v, q_segment_ids, kv_segment_ids, causal,
                           _scale(q, scale))
