"""Convolution layers (port of ``bigdl_tpu/nn/conv.py``:
SpatialConvolution, SpatialShareConvolution, SpatialDilatedConvolution,
SpatialFullConvolution, SpatialConvolutionMap).

Weights are stored OIHW in both activation layouts (``(in, out/group,
kH, kW)`` for the full convolution, Torch's layout); the default
activation layout is NCHW.  ``data_format="NHWC"`` takes and returns
logical (N, H, W, C) activations: the layer hands ``F.conv2d`` the view
``x.permute(0, 3, 1, 2)``, whose strides are channels-last, so cuDNN
runs its NHWC kernels and writes a channels-last output, and permutes
that back, again a view.  No activation is copied into another layout.

The products are ``F.conv2d`` / ``F.conv_transpose2d`` (cuDNN on the
card, with TF32 off: ``device.resolve_device``).  ``init`` draws through
the key chain, so a built tree is the reference's bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn._util import match_compute_dtype
from bigdl_tpu_torch.nn.initialization import Default, InitializationMethod
from bigdl_tpu_torch.nn.module import Module, not_ported
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import keychain


def check_format(data_format: str) -> str:
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    return data_format


def to_nchw(x, data_format: str):
    """A logical NHWC activation as the NCHW view PyTorch's spatial ops
    take (channels-last strides, no copy); NCHW passes through."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def from_nchw(y, data_format: str):
    """The inverse view of :func:`to_nchw`."""
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def spatial(fn):
    """Wrap ``fn(self, params, x_nchw) -> y_nchw`` into an ``f`` that
    takes a 3-D (unbatched) input as the reference does and the layer's
    ``data_format``."""
    def f(self, params, x, **kw):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        df = getattr(self, "data_format", "NCHW")
        y = from_nchw(fn(self, params, to_nchw(x, df)), df)
        return y[0] if squeeze else y
    f.__doc__ = fn.__doc__
    return f


def _quantized(w):
    if is_qtensor(w):
        raise not_ported("a quantized convolution weight (qconv, qconv_i8)")


class SpatialConvolution(Module):
    """2-D convolution (ref nn/SpatialConvolution.scala).

    Arguments as the reference: (n_input_plane, n_output_plane,
    kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h, n_group),
    Torch's W-before-H order.
    """

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True,
                 init_method: type[InitializationMethod] = Default,
                 data_format: str = "NCHW"):
        super().__init__()
        assert n_input_plane % n_group == 0 and n_output_plane % n_group == 0
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h
        self.stride_w = stride_w
        self.stride_h = stride_h
        self.pad_w = pad_w
        self.pad_h = pad_h
        self.n_group = n_group
        self.with_bias = with_bias
        self.init_method = init_method
        self.data_format = check_format(data_format)

    def _fans(self):
        k = self.kernel_h * self.kernel_w
        return (self.n_input_plane // self.n_group * k,
                self.n_output_plane // self.n_group * k)

    def init(self, rng):
        wk, bk = keychain.split(rng)
        fan_in, fan_out = self._fans()
        shape = (self.n_output_plane, self.n_input_plane // self.n_group,
                 self.kernel_h, self.kernel_w)
        p = {"weight": self.init_method.weight(wk, shape, fan_in=fan_in,
                                               fan_out=fan_out)
             if self.init_method is not Default
             else Default.weight(wk, shape, fan_in=fan_in)}
        if self.with_bias:
            p["bias"] = Default.bias(bk, (self.n_output_plane,),
                                     fan_in=fan_in)
        return p

    def _dilation(self):
        return (1, 1)

    @spatial
    def f(self, params, x):
        w = params["weight"]
        _quantized(w)
        return F.conv2d(match_compute_dtype(x, w), w,
                        params["bias"] if self.with_bias else None,
                        stride=(self.stride_h, self.stride_w),
                        padding=(self.pad_h, self.pad_w),
                        dilation=self._dilation(), groups=self.n_group)


class SpatialShareConvolution(SpatialConvolution):
    """Memory-sharing variant of SpatialConvolution
    (ref nn/SpatialShareConvolution.scala): the reference shares im2col
    buffers between instances; cuDNN keeps no such buffer, so this is
    SpatialConvolution."""


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (ref nn/SpatialDilatedConvolution.scala)."""

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0,
                 dilation_w: int = 1, dilation_h: int = 1,
                 init_method: type[InitializationMethod] = Default,
                 data_format: str = "NCHW"):
        super().__init__(n_input_plane, n_output_plane, kernel_w, kernel_h,
                         stride_w, stride_h, pad_w, pad_h,
                         init_method=init_method, data_format=data_format)
        self.dilation_w = dilation_w
        self.dilation_h = dilation_h

    def _dilation(self):
        return (self.dilation_h, self.dilation_w)


class SpatialFullConvolution(Module):
    """Transposed convolution (ref nn/SpatialFullConvolution.scala):
    output size (in-1)*stride - 2*pad + kernel + adj, the weight in
    Torch's (nInput, nOutput/group, kH, kW) layout, which is
    ``F.conv_transpose2d``'s own.  ``adj`` must be below the stride."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0, n_group: int = 1,
                 no_bias: bool = False,
                 init_method: type[InitializationMethod] = Default,
                 data_format: str = "NCHW"):
        super().__init__()
        self.data_format = check_format(data_format)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h
        self.stride_w = stride_w
        self.stride_h = stride_h
        self.pad_w = pad_w
        self.pad_h = pad_h
        self.adj_w = adj_w
        self.adj_h = adj_h
        self.n_group = n_group
        self.with_bias = not no_bias
        self.init_method = init_method

    def init(self, rng):
        wk, bk = keychain.split(rng)
        fan_in = (self.n_output_plane // self.n_group * self.kernel_h
                  * self.kernel_w)
        shape = (self.n_input_plane, self.n_output_plane // self.n_group,
                 self.kernel_h, self.kernel_w)
        p = {"weight": self.init_method.weight(wk, shape, fan_in=fan_in)}
        if self.with_bias:
            p["bias"] = Default.bias(bk, (self.n_output_plane,),
                                     fan_in=fan_in)
        return p

    @spatial
    def f(self, params, x):
        w = params["weight"]
        return F.conv_transpose2d(
            match_compute_dtype(x, w), w,
            params["bias"] if self.with_bias else None,
            stride=(self.stride_h, self.stride_w),
            padding=(self.pad_h, self.pad_w),
            output_padding=(self.adj_h, self.adj_w), groups=self.n_group)


class SpatialConvolutionMap(Module):
    """Convolution over an explicit input->output connection table
    (ref nn/SpatialConvolutionMap.scala).  ``conn_table`` is a (K, 2)
    array of 1-based (input_plane, output_plane) pairs, as in Torch: a
    dense convolution whose weight is multiplied by a fixed 0/1 mask in
    the forward, so masked weights get zero gradient and stay zero."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1, pad_w: int = 0,
                 pad_h: int = 0):
        super().__init__()
        ct = np.asarray(conn_table, dtype=np.int32)
        self.conn_table = ct
        self.n_input_plane = int(ct[:, 0].max())
        self.n_output_plane = int(ct[:, 1].max())
        self.kernel_w = kernel_w
        self.kernel_h = kernel_h
        self.stride_w = stride_w
        self.stride_h = stride_h
        self.pad_w = pad_w
        self.pad_h = pad_h
        mask = np.zeros((self.n_output_plane, self.n_input_plane, 1, 1),
                        dtype=np.float32)
        for i, o in ct:
            mask[o - 1, i - 1, 0, 0] = 1.0
        self._mask = mask

    @staticmethod
    def full(nin: int, nout: int):
        return np.array([(i + 1, o + 1) for o in range(nout)
                         for i in range(nin)], dtype=np.int32)

    @staticmethod
    def one_to_one(n: int):
        return np.array([(i + 1, i + 1) for i in range(n)], dtype=np.int32)

    @staticmethod
    def random(nin: int, nout: int, nto: int, seed: int = 0):
        rng = np.random.RandomState(seed)
        pairs = []
        for o in range(nout):
            for i in rng.choice(nin, size=nto, replace=False):
                pairs.append((i + 1, o + 1))
        return np.array(pairs, dtype=np.int32)

    def init(self, rng):
        wk, bk = keychain.split(rng)
        nto = max(1, len(self.conn_table) // self.n_output_plane)
        stdv = 1.0 / math.sqrt(self.kernel_w * self.kernel_h * nto)
        w = keychain.uniform(wk, (self.n_output_plane, self.n_input_plane,
                                  self.kernel_h, self.kernel_w), -stdv, stdv)
        b = keychain.uniform(bk, (self.n_output_plane,), -stdv, stdv)
        return {"weight": w * self._mask, "bias": b}

    @spatial
    def f(self, params, x):
        mask = torch.as_tensor(self._mask, device=params["weight"].device)
        w = params["weight"] * mask.to(params["weight"].dtype)
        return F.conv2d(match_compute_dtype(x, w), w, params["bias"],
                        stride=(self.stride_h, self.stride_w),
                        padding=(self.pad_h, self.pad_w))
