"""QTensor: symmetric weight-only int8 with per-channel float32 scales
(port of ``bigdl_tpu/quant/qtensor.py``).

A ``QTensor`` packs a weight as

    q     int8, the original shape          (the 4x-smaller payload)
    scale float32, broadcast-shaped (keepdims) against q

with ``w ~= q * scale``.  Symmetric, no zero point: round half to even
onto [-127, 127], scale = amax / 127 over the *reduced* axes, the axes
that contract in the consuming product, so each output channel (each
(layer, out-channel) pair of a layer-stacked transformer weight) keeps
its own scale.

The reference registers QTensor as a pytree node so ``lax.scan`` slices
a stacked ``(L, in, out)`` leaf per layer; here :meth:`QTensor.__getitem__`
takes one layer (``utils.params.layer_params`` calls it).  ``q`` keeps
the weight's shape but stores its last two axes column-major: cuBLASLt's
int8 and fp8 products on the card take the second operand that way (a
row-major one runs several times slower, or is refused), and a slice
``q[i]`` of a stacked leaf keeps the layout.

``native`` marks leaves whose owning layer dequantizes inside its own
product (``nn.Linear``, through ``kernels.qlinear``); every other leaf
is expanded at the entry seam (``transform.dequantize_entry``) unless
its ``compute`` mode is served by a QTensor-aware product
(``kernels.qmatmul``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: smallest representable scale: an all-zero channel must not divide by 0
_EPS = 1e-12
#: symmetric int8 range; -128 is excluded so the range is sign-balanced
QMAX = 127

COMPUTE_MODES = ("dequant", "int8", "auto", "fp8")


def torch_dtype(name) -> torch.dtype:
    """A dtype name as the reference writes it ("float32", "bfloat16")
    -> the torch dtype; a torch dtype passes through."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def true_div(x, c: float):
    """``x / c``, correctly rounded on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which can
    differ from the division in the last bit (and so move an int8
    rounding).  A device tensor divisor keeps the division."""
    return x / torch.full_like(x, c)


def _col_major(q):
    """``q`` with its last two axes stored column-major (a copy only when
    they are not already)."""
    if not isinstance(q, torch.Tensor) or q.ndim < 2:
        return q
    t = q.transpose(-1, -2)
    return q if t.is_contiguous() else t.contiguous().transpose(-1, -2)


class QTensor:
    """int8 values + broadcast-shaped float32 scales (symmetric).

    ``compute`` selects what the consuming product does with the leaf:
    ``"dequant"`` (expand to ``orig_dtype`` first, the default),
    ``"int8"`` (both operands int8, exact int32 accumulation:
    ``kernels.qmatmul_i8``), ``"fp8"`` (``kernels.qmatmul_f8``) or
    ``"auto"`` (``kernels.resolve_compute``).  ``act_scale`` pins a
    calibrated static activation scale (``activations``); ``None`` means
    dynamic per-token quantization.  ``q`` and ``scale`` are torch
    tensors (numpy arrays after ``utils.params.params_to_numpy``)."""

    __slots__ = ("q", "scale", "orig_dtype", "native", "compute",
                 "act_scale")

    def __init__(self, q, scale, orig_dtype: str = "float32",
                 native: bool = False, compute: str = "dequant",
                 act_scale: Optional[float] = None):
        if compute not in COMPUTE_MODES:
            raise ValueError(f"compute must be 'dequant', 'int8', "
                             f"'auto' or 'fp8', got {compute!r}")
        self.q = _col_major(q)
        self.scale = scale
        self.orig_dtype = dtype_name(orig_dtype)
        self.native = bool(native)
        self.compute = compute
        self.act_scale = None if act_scale is None else float(act_scale)

    # -- tensor-ish surface -------------------------------------------- #
    @property
    def shape(self) -> tuple:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        """Stored payload: int8 values plus the float32 scales."""
        return self.size + 4 * int(np.prod(tuple(self.scale.shape),
                                           dtype=np.int64))

    def dequantize(self, dtype=None):
        """``q * scale`` in float32, cast to ``dtype`` (default: the
        dtype the weight had before quantization)."""
        target = torch_dtype(dtype if dtype is not None else self.orig_dtype)
        # int8 x float32 in one pass: float32, the bits of q.float() * scale
        return (self.q * self.scale).to(target)

    def with_compute(self, compute: str,
                     act_scale: Optional[float] = None) -> "QTensor":
        """Same payload, another compute mode (tensors shared)."""
        return QTensor(self.q, self.scale, self.orig_dtype, self.native,
                       compute,
                       self.act_scale if act_scale is None else act_scale)

    def _like(self, q, scale) -> "QTensor":
        return QTensor(q, scale, self.orig_dtype, self.native, self.compute,
                       self.act_scale)

    def __getitem__(self, i: int) -> "QTensor":
        """One index of the leading axis (one layer of a stacked leaf),
        views of ``q`` and ``scale``.  A scale of leading extent 1 (the
        leading axis was reduced) broadcasts to every index."""
        scale = self.scale[0] if self.scale.shape[0] == 1 else self.scale[i]
        return self._like(self.q[i], scale)

    def to(self, device) -> "QTensor":
        return self._like(self.q.to(device), self.scale.to(device))

    def __repr__(self) -> str:
        return (f"QTensor(shape={self.shape}, "
                f"scale={tuple(self.scale.shape)}, orig={self.orig_dtype}, "
                f"native={self.native}, compute={self.compute})")


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)


def quantize_array(w, reduce_axes: Optional[Tuple[int, ...]] = None,
                   *, native: bool = False,
                   compute: str = "dequant") -> QTensor:
    """Quantize ``w`` (a tensor or numpy array) symmetrically to int8.

    ``reduce_axes`` are the axes the scale reduces over, the contraction
    axes of the consuming product (generic ``x @ w`` layouts: ``(-2,)``);
    ``None`` reduces over everything (one scale, per-tensor).  The
    arithmetic is the reference's, so ``q`` and ``scale`` are bitwise
    its own: a float32 division (not a product by the reciprocal) and
    round half to even."""
    w = torch.as_tensor(w)
    wf = w.float()
    axes = (tuple(reduce_axes) if reduce_axes is not None
            else tuple(range(w.ndim)))
    amax = wf.abs().amax(dim=axes, keepdim=True)
    scale = true_div(torch.clamp_min(amax, _EPS), QMAX)
    q = torch.clamp(torch.round(wf / scale), -QMAX, QMAX).to(torch.int8)
    return QTensor(q, scale, dtype_name(w.dtype), native, compute)


def dequantize_array(t, dtype=None):
    """Inverse of :func:`quantize_array`; passes plain tensors through
    (cast to ``dtype`` when given)."""
    if isinstance(t, QTensor):
        return t.dequantize(dtype)
    return t if dtype is None else t.to(torch_dtype(dtype))
