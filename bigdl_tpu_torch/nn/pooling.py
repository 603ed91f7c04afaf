"""Pooling layers (port of ``bigdl_tpu/nn/pooling.py``: SpatialMaxPooling,
SpatialAveragePooling, RoiPooling).

The reference sizes a pool by Torch's rule (floor, or ceil with the last
window starting inside the padded input) and pads ``(pad, needed)``:
``pad`` before, and after as much as the last window reaches past the
input.  ``F.max_pool2d`` and ``F.avg_pool2d`` size their output by the
same rule and clip the overhanging window, which for a max (padding is
-inf) is the same thing.  The average differs: the reference divides
every window by ``kernel_h * kernel_w`` when ``count_include_pad``,
overhanging ones too, where ``F.avg_pool2d(ceil_mode=True)`` divides an
overhanging window by fewer; ``divisor_override`` restores the
reference's divisor (and 1 for ``divide=False``).  PyTorch's pools
refuse a pad over half the kernel, which the reference allows: such a
pool pads explicitly (-inf or 0) and pools without padding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import check_format, spatial
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def pool_pads(size, kernel, stride, pad, ceil_mode):
    """The reference's output size and (before, after) padding of one
    spatial dim (``bigdl_tpu/nn/pooling.py`` ``_pool_pads``)."""
    if ceil_mode:
        out = -(-(size + 2 * pad - kernel) // stride) + 1
        if (out - 1) * stride >= size + pad:
            out -= 1
    else:
        out = (size + 2 * pad - kernel) // stride + 1
    needed = (out - 1) * stride + kernel - size - pad
    return out, (pad, max(needed, 0))


def _explicit_pad(x, layer, value):
    """``x`` (NCHW view) padded by the reference's (pad, needed) pairs."""
    _, (ph0, ph1) = pool_pads(x.shape[2], layer.kernel_h, layer.stride_h,
                              layer.pad_h, layer.ceil_mode)
    _, (pw0, pw1) = pool_pads(x.shape[3], layer.kernel_w, layer.stride_w,
                              layer.pad_w, layer.ceil_mode)
    return F.pad(x, (pw0, pw1, ph0, ph1), value=value)


def _torch_pads_ok(layer) -> bool:
    return (2 * layer.pad_h <= layer.kernel_h
            and 2 * layer.pad_w <= layer.kernel_w)


class _Pool(Module):
    def __init__(self, kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h,
                 ceil_mode, data_format):
        super().__init__()
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h
        self.stride_w = stride_w if stride_w is not None else kernel_w
        self.stride_h = stride_h if stride_h is not None else kernel_h
        self.pad_w = pad_w
        self.pad_h = pad_h
        self.ceil_mode = ceil_mode
        self.data_format = check_format(data_format)

    def _window(self):
        return ((self.kernel_h, self.kernel_w),
                (self.stride_h, self.stride_w))


class SpatialMaxPooling(_Pool):
    def __init__(self, kernel_w: int, kernel_h: int, stride_w: int = None,
                 stride_h: int = None, pad_w: int = 0, pad_h: int = 0,
                 data_format: str = "NCHW"):
        super().__init__(kernel_w, kernel_h, stride_w, stride_h, pad_w,
                         pad_h, False, data_format)

    def ceil(self) -> "SpatialMaxPooling":
        self.ceil_mode = True
        return self

    def floor(self) -> "SpatialMaxPooling":
        self.ceil_mode = False
        return self

    @spatial
    def f(self, params, x):
        k, s = self._window()
        if _torch_pads_ok(self):
            return F.max_pool2d(x, k, s, padding=(self.pad_h, self.pad_w),
                                ceil_mode=self.ceil_mode)
        return F.max_pool2d(_explicit_pad(x, self, float("-inf")), k, s)


class SpatialAveragePooling(_Pool):
    def __init__(self, kernel_w: int, kernel_h: int, stride_w: int = None,
                 stride_h: int = None, pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, data_format: str = "NCHW"):
        super().__init__(kernel_w, kernel_h, stride_w, stride_h, pad_w,
                         pad_h, ceil_mode, data_format)
        self.count_include_pad = count_include_pad
        self.divide = divide

    @spatial
    def f(self, params, x):
        k, s = self._window()
        # the reference's divisor: the whole window, or 1 for a plain sum;
        # None (count_include_pad False) counts the input's own elements
        divisor = (None if self.divide and not self.count_include_pad
                   else k[0] * k[1] if self.divide else 1)
        if _torch_pads_ok(self):
            return F.avg_pool2d(x, k, s, padding=(self.pad_h, self.pad_w),
                                ceil_mode=self.ceil_mode,
                                count_include_pad=self.count_include_pad,
                                divisor_override=divisor)
        y = F.avg_pool2d(_explicit_pad(x, self, 0.0), k, s,
                         divisor_override=divisor or 1)
        if divisor is None:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            y = y / F.avg_pool2d(_explicit_pad(ones, self, 0.0), k, s,
                                 divisor_override=1)
        return y


class RoiPooling(Module):
    """Region-of-interest max pooling (ref nn/RoiPooling.scala).

    Input: a table {features (N,C,H,W), rois (R,5) rows (batch_idx, x1,
    y1, x2, y2)}, 0-based batch_idx, coordinates in input-image scale.
    Output (R, C, pooled_h, pooled_w); an empty bin is 0.  Each bin is a
    masked max over the roi's feature map, all rois at once."""

    def __init__(self, pooled_w: int, pooled_h: int,
                 spatial_scale: float = 1.0):
        super().__init__()
        self.pooled_w = pooled_w
        self.pooled_h = pooled_h
        self.spatial_scale = spatial_scale

    def f(self, params, x, **kw):
        feats, rois = (x.to_seq() if isinstance(x, Table) else list(x))
        rois = torch.as_tensor(rois, device=feats.device, dtype=feats.dtype)
        _, _, h, w = feats.shape
        ph, pw = self.pooled_h, self.pooled_w
        dt = feats.dtype
        b = rois[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (torch.round(rois[:, i] * self.spatial_scale)
                          for i in range(1, 5))
        bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / ph
        bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / pw
        iy = torch.arange(ph, dtype=dt, device=feats.device)
        ix = torch.arange(pw, dtype=dt, device=feats.device)
        hstart = torch.clamp(torch.floor(iy * bin_h[:, None]) + y1[:, None],
                             0, h)
        hend = torch.clamp(torch.ceil((iy + 1) * bin_h[:, None])
                           + y1[:, None], 0, h)
        wstart = torch.clamp(torch.floor(ix * bin_w[:, None]) + x1[:, None],
                             0, w)
        wend = torch.clamp(torch.ceil((ix + 1) * bin_w[:, None])
                           + x1[:, None], 0, w)
        hh = torch.arange(h, dtype=dt, device=feats.device)
        ww = torch.arange(w, dtype=dt, device=feats.device)
        rmask = ((hh >= hstart[..., None]) & (hh < hend[..., None]))  # R,ph,H
        cmask = ((ww >= wstart[..., None]) & (ww < wend[..., None]))  # R,pw,W
        mask = rmask[:, :, None, :, None] & cmask[:, None, :, None, :]
        empty = ~mask.any(dim=(3, 4))  # (R, ph, pw)
        fmap = feats[b]  # (R, C, H, W)
        vals = torch.where(mask[:, None], fmap[:, :, None, None],
                           torch.tensor(float("-inf"), dtype=dt,
                                        device=feats.device))
        pooled = torch.amax(vals, dim=(4, 5))  # (R, C, ph, pw)
        return torch.where(empty[:, None], torch.zeros((), dtype=dt,
                                                       device=feats.device),
                           pooled)
