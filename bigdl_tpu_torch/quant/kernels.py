"""Products with quantized weights: dequant, int8 and fp8 (port of
``bigdl_tpu/quant/kernels.py``).

The reference computes these as plain ``lax.dot_general`` products with
int32 (int8) or float32 (fp8) accumulation, outside any Pallas kernel;
here they are library calls of the same arithmetic:

- **dequant**: ``q * scale`` expanded to the weight's original dtype,
  then ``torch.matmul`` at the activation's precision;
- **int8** (:func:`qmatmul_i8`): the activation quantized per token
  (``activations.quantize_per_token``), ``torch._int_mm`` for the exact
  int32 accumulators, then one float32 rescale ``acc * xs * ws``;
- **fp8** (:func:`qmatmul_f8`): both operands cast to e4m3 with per-row
  and per-column scales; ``torch._scaled_mm`` on the card, a float32
  product of the same e4m3 values on the CPU.

cuBLASLt's int8 product on the card refuses a first operand of 16 rows
or fewer and any ``k`` or ``n`` that is not a multiple of 8, and runs
fastest with the second operand column-major (the layout ``QTensor``
stores).  Rows are independent and zero columns add nothing, so
:func:`int_mm` pads with zeros and slices the result: the accumulators
stay exact, with no float fallback.

``qlinear`` (``nn.Linear``'s product with a native ``(out, in)`` weight
and per-output-channel scales ``(out, 1)``) keeps the reference's
operands: bfloat16 values of the activation and the expanded weight,
multiplied with float32 accumulation (``torch.matmul`` of their float32
copies, exact products), or :func:`qlinear_i8` in int8 compute.
``qconv`` (``SpatialConvolution``'s product with an OIHW weight and
per-output-plane scales ``(O, 1, 1, 1)``) does the same: in dequant
mode a convolution of the bfloat16 values with float32 accumulation
(``F.conv2d`` of their float32 copies, exact products); in int8 mode
(:func:`qconv_i8`) one activation scale per sample, the patches
gathered by ``F.unfold`` and multiplied by :func:`int_mm` for exact
int32 accumulators (``F.conv2d`` takes no int8 on the card), and one
float32 rescale.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import f32_gemm
from bigdl_tpu_torch.quant.activations import (E4M3_MAX, FP8_DTYPE,
                                               quantize_per_token,
                                               quantize_per_token_fp8)
from bigdl_tpu_torch.quant.qtensor import (QTensor, _col_major, is_qtensor,
                                           torch_dtype, true_div)

# cuBLASLt int8 product on the card: more than 16 rows, k and n multiples
# of 8 (checked on an H100 with torch 2.11); fp8: k and n multiples of 16
_INT8_MIN_ROWS = 32
_INT8_ALIGN = 8
_FP8_ALIGN = 16


def _pad_to(n: int, align: int) -> int:
    return -(-n // align) * align - n


def int_mm(a, b):
    """The exact int32 product of int8 ``a`` (m, k) and ``b`` (k, n).
    On the card, ``a`` is padded with zero rows to more than 16 and both
    operands with zeros to k and n multiples of 8; ``b`` goes to
    cuBLASLt column-major."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)      # the CPU takes every shape
    m, k = a.shape
    n = b.shape[1]
    pm = max(_INT8_MIN_ROWS - m, 0)
    pk, pn = _pad_to(k, _INT8_ALIGN), _pad_to(n, _INT8_ALIGN)
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    acc = torch._int_mm(a, _col_major(b))
    return acc[:m, :n] if (pm or pn) else acc


def _f8_mm(a, b):
    """float32 product of e4m3 ``a`` (m, k) and ``b`` (k, n): cuBLASLt's
    fp8 product (unit scales) on the card, the same e4m3 values as
    float32 on the CPU."""
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    k, n = b.shape
    pk, pn = _pad_to(k, _FP8_ALIGN), _pad_to(n, _FP8_ALIGN)
    if pk:
        a = F.pad(a.view(torch.uint8), (0, pk)).view(FP8_DTYPE)
    if pk or pn:
        b = F.pad(b.view(torch.uint8), (0, pn, 0, pk)).view(FP8_DTYPE)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    acc = torch._scaled_mm(a, _col_major(b), scale_a=one, scale_b=one,
                           out_dtype=torch.float32)
    return acc[:, :n] if pn else acc


def resolve_compute(qweight: QTensor, x_shape) -> str:
    """The effective compute mode for one (activation shape, weight)
    pair.  ``"auto"`` resolves through the autotuned int8-vs-dequant
    duel for the weight's device kind (``ops.autotune.lookup_qcompute``
    with m the product of ``x_shape[:-1]`` and (k, n) the weight's
    geometry; no verdict -> ``"dequant"``, so auto never loses to the
    storage-only recipe).  Memoized per (m, k, n) until
    ``autotune.clear_cache()``: under CUDA graphs it runs at capture
    only."""
    mode = qweight.compute
    if mode == "auto":
        from bigdl_tpu_torch.ops import autotune
        m = int(math.prod(x_shape[:-1])) if len(x_shape) > 1 else 1
        k = int(x_shape[-1])
        n = int(qweight.q.shape[0] if qweight.native
                else qweight.q.shape[-1])
        dev = getattr(qweight.q, "device", "cpu")
        mode = autotune.memoized(
            ("qcompute", m, k, n, autotune.device_key(dev)),
            lambda: autotune.lookup_qcompute(m, k, n, device=dev)
            or "dequant")
    return mode


def qlinear(x, qweight: QTensor, bias=None):
    """Quantized ``y = x @ W.T + b`` (``nn.Linear`` semantics, weight
    ``(out, in)`` with per-out-channel scales ``(out, 1)``); the compute
    mode dispatched per the weight's ``compute``."""
    if resolve_compute(qweight, x.shape) == "int8":
        return qlinear_i8(x, qweight, bias)
    w = qweight.dequantize(torch.bfloat16).float()
    if x.is_floating_point():
        x = x.to(torch.bfloat16).float()
    y = torch.matmul(x, w.T)
    if bias is not None:
        y = y + bias.float()
    return y.to(torch_dtype(qweight.orig_dtype))


def qlinear_i8(x, qweight: QTensor, bias=None):
    """``y = x @ W.T + b`` with int8 x int8 products: per-token
    activation quantization, exact int32 accumulation, one float32
    rescale by activation scale (..., 1) x weight scale (out,)."""
    xq, xs = quantize_per_token(x, scale=qweight.act_scale)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), qweight.q.T)
    acc = acc.reshape(xq.shape[:-1] + (acc.shape[-1],))
    y = acc.float() * xs * qweight.scale.reshape(-1)
    if bias is not None:
        y = y + bias.float()
    return y.to(torch_dtype(qweight.orig_dtype))


def qmatmul(x, w):
    """``x @ w`` for the ``(in, out)`` weights the transformer consumes
    directly (attention projections, MLP halves, the untied head):
    plain tensors go to ``ops.f32_gemm.weight_matmul`` (mixed float
    types promoted; float32 on the card takes the 3xTF32 kernel, the rest
    ``torch.matmul``); a QTensor's ``compute`` picks the recipe."""
    if not is_qtensor(w):
        if (x.is_floating_point() and w.is_floating_point()
                and x.dtype != w.dtype):
            # as jnp's ``@`` promotes (a bf16 clone's weights, float32
            # activations)
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        return f32_gemm.weight_matmul(x, w)
    f32_gemm.decline("qtensor")
    if w.q.ndim == 2:
        mode = resolve_compute(w, x.shape)
        if mode == "int8":
            return qmatmul_i8(x, w)
        if mode == "fp8":
            return qmatmul_f8(x, w)
    # the entry seam's numbers: expand to the original dtype, multiply
    # at the activation's precision
    wd = w.dequantize()
    if x.is_floating_point() and x.dtype != wd.dtype:
        x = x.to(wd.dtype)
    return torch.matmul(x, wd)


def qmatmul_i8(x, qweight: QTensor):
    """``x @ w`` (``(in, out)`` weight, scales ``(1, out)``) with int8 x
    int8 products: per-token activation quantization, exact int32
    accumulation, one float32 rescale by activation scale (..., 1) x
    weight scale (out,)."""
    xq, xs = quantize_per_token(x, scale=qweight.act_scale)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), qweight.q)
    acc = acc.reshape(xq.shape[:-1] + (acc.shape[-1],))
    y = acc.float() * xs * qweight.scale.reshape(-1)
    return y.to(torch_dtype(qweight.orig_dtype))


def qmatmul_f8(x, qweight: QTensor):
    """fp8 (e4m3) form of :func:`qmatmul_i8`: both operands cast to e4m3
    with per-token / per-column scales, float32 accumulation, one
    rescale.  Reached only through ``compute="fp8"``, which the policy
    gates on ``activations.fp8_supported()``."""
    xq, xs = quantize_per_token_fp8(x, force=True)
    wf = qweight.q.float()                  # re-express the int8 in e4m3
    wmax = torch.clamp_min(wf.abs().amax(dim=0, keepdim=True), 1e-12)
    wq = (wf / true_div(wmax, E4M3_MAX)).to(FP8_DTYPE)
    acc = _f8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    acc = acc.reshape(xq.shape[:-1] + (acc.shape[-1],))
    ws = qweight.scale.reshape(-1) * true_div(wmax.reshape(-1), E4M3_MAX)
    y = acc * xs * ws
    return y.to(torch_dtype(qweight.orig_dtype))


def qconv(x, qweight: QTensor, *, stride=(1, 1), padding=(0, 0),
          dilation=(1, 1), groups: int = 1):
    """Quantized convolution of an NCHW activation (a view of any
    strides) with an OIHW QTensor (scales ``(O, 1, 1, 1)``); the compute
    mode dispatched per the weight's ``compute``.  No bias: the layer
    adds its float bias after, as the reference's does."""
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    if resolve_compute(qweight, _conv_product_shape(x, qweight)) == "int8":
        return qconv_i8(x, qweight, **kw)
    w = qweight.dequantize(torch.bfloat16).float()
    if x.is_floating_point():
        x = x.to(torch.bfloat16).float()
    y = F.conv2d(x, w, None, **kw)
    return y.to(torch_dtype(qweight.orig_dtype))


def _conv_product_shape(x, qweight: QTensor):
    """The (rows, contraction) shape ``resolve_compute`` keys an
    ``auto`` weight by: one row per sample, the contraction I/g x kH x
    kW."""
    k = int(math.prod(qweight.q.shape[1:]))
    return (int(x.shape[0]), k)


def qconv_i8(x, qweight: QTensor, *, stride=(1, 1), padding=(0, 0),
             dilation=(1, 1), groups: int = 1):
    """int8 x int8 convolution: per-SAMPLE activation quantization (one
    scale over C, H and W: a convolution has no per-output-pixel
    pre-quantization), exact int32 accumulation of the unfolded patches
    against the int8 weight, one float32 rescale by sample scale x
    output-plane scale.  Bitwise the reference's ``qconv_i8``."""
    xf = x.float()
    n = xf.shape[0]
    if qweight.act_scale is not None:
        s = torch.full((n, 1, 1, 1), float(qweight.act_scale),
                       dtype=torch.float32, device=xf.device)
    else:
        amax = xf.abs().amax(dim=(1, 2, 3), keepdim=True)
        s = true_div(torch.clamp_min(amax, 1e-12), 127.0)
    xq = torch.clamp(torch.round(xf / s), -127, 127)
    q = qweight.q
    o, ig, kh, kw = q.shape
    h, w = xq.shape[2], xq.shape[3]
    oh = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    # the patches of the integer-valued activation (exact in float32),
    # then int8 for the product: (n, C*kH*kW, L) -> (n*L, C*kH*kW)
    cols = F.unfold(xq, (kh, kw), dilation=dilation, padding=padding,
                    stride=stride).to(torch.int8)
    cols = cols.view(n, groups, ig * kh * kw, oh * ow)
    og = o // groups
    acc = []
    for g in range(groups):
        a = cols[:, g].transpose(1, 2).reshape(n * oh * ow, ig * kh * kw)
        wg = q[g * og:(g + 1) * og].reshape(og, ig * kh * kw)
        acc.append(int_mm(a.contiguous(), wg.T))          # (n*L, og)
    acc = torch.cat(acc, dim=1) if groups > 1 else acc[0]
    acc = acc.view(n, oh, ow, o).permute(0, 3, 1, 2)      # NCHW view
    ws = qweight.scale.reshape(1, -1, 1, 1)
    y = acc.float() * s * ws
    return y.to(torch_dtype(qweight.orig_dtype))
