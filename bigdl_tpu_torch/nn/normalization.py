"""Normalization layers (port of ``bigdl_tpu/nn/normalization.py``:
BatchNormalization, SpatialBatchNormalization, ``layer_norm`` and
LayerNorm, Normalize, SpatialCrossMapLRN, and the Spatial{Subtractive,
Divisive,Contrastive}Normalization).

``BatchNormalization`` keeps its running statistics in ``buffers`` and
returns new ones from ``apply``, as the reference does: the batch is
normalized with its biased variance and the unbiased one (``n/(n-1)``)
enters the running variance, Torch's momentum convention
(``running = (1-m)*running + m*batch``).  ``F.batch_norm`` (cuDNN on the
card) computes exactly that, but updates its running tensors in place;
it is handed fresh copies, so the buffers passed in are never written.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import check_format, spatial, to_nchw
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import keychain


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Layer norm over the trailing dim, normalized in float32 with the
    biased variance (as ``jnp.var``), cast back to ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


class BatchNormalization(Module):
    """Batch norm over (N, D) input (ref nn/BatchNormalization.scala); the
    channel axis is 1 for NCHW input of rank 3 or more and the last axis
    otherwise."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 data_format: str = "NCHW"):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.data_format = check_format(data_format)

    def init(self, rng):
        if not self.affine:
            return {}
        return {"weight": keychain.uniform(rng, (self.n_output,)),
                "bias": np.zeros((self.n_output,), np.float32)}

    def init_buffers(self):
        return {"running_mean": np.zeros((self.n_output,), np.float32),
                "running_var": np.ones((self.n_output,), np.float32)}

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        if not buffers:
            dev = x.device
            buffers = {k: torch.from_numpy(v).to(dev)
                       for k, v in self.init_buffers().items()}
        channels_last = x.ndim <= 2 or self.data_format == "NHWC"
        if x.ndim == 4:
            xc = to_nchw(x, self.data_format)  # a view
        elif channels_last and x.ndim > 2:
            xc = x.movedim(-1, 1)
        else:
            xc = x
        mean = buffers["running_mean"]
        var = buffers["running_var"]
        if training:
            mean, var = mean.clone(), var.clone()  # updated in place below
        w = params.get("weight") if self.affine else None
        b = params.get("bias") if self.affine else None
        y = F.batch_norm(xc, mean, var, w, b, training=training,
                         momentum=self.momentum, eps=self.eps)
        if x.ndim == 4:
            y = y.permute(0, 2, 3, 1) if self.data_format == "NHWC" else y
        elif channels_last and x.ndim > 2:
            y = y.movedim(1, -1)
        new_buffers = ({"running_mean": mean, "running_var": var}
                       if training else buffers)
        return y, new_buffers


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over (N, C, H, W) reducing N, H, W
    (ref nn/SpatialBatchNormalization.scala)."""


class LayerNorm(Module):
    """Layer normalization over the trailing feature dim: BN's affine
    gamma/beta convention, no running statistics."""

    def __init__(self, n_output: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.affine = affine

    def init(self, rng):
        if not self.affine:
            return {}
        return {"weight": np.ones((self.n_output,), np.float32),
                "bias": np.zeros((self.n_output,), np.float32)}

    def f(self, params, x, **kw):
        if self.affine:
            return layer_norm(x, params["weight"], params["bias"], self.eps)
        return layer_norm(x, eps=self.eps)


class Normalize(Module):
    """Lp-normalize each row (ref nn/Normalize.scala)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p = p
        self.eps = eps

    def f(self, params, x, **kw):
        if self.p == float("inf"):
            norm = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        else:
            norm = torch.pow(torch.sum(torch.pow(torch.abs(x), self.p),
                                       dim=-1, keepdim=True), 1.0 / self.p)
        return x / torch.clamp(norm, min=self.eps)


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels
    (ref nn/SpatialCrossMapLRN.scala):
    y = x * (k + alpha/size * sum_window x^2)^-beta, the window padded
    ``(half, size-1-half)`` with ``half = (size-1)//2``.
    ``F.local_response_norm`` pads ``(size//2, (size-1)//2)``, which
    agrees only for odd sizes, so the window sum is taken here: a
    3-D sum pool over the channel axis of the NCHW view."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, data_format: str = "NCHW"):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = check_format(data_format)

    @spatial
    def f(self, params, x):
        half = (self.size - 1) // 2
        sq = (x * x).unsqueeze(1)  # (N, 1, C, H, W)
        sq = F.pad(sq, (0, 0, 0, 0, half, self.size - 1 - half))
        window = F.avg_pool3d(sq, (self.size, 1, 1), stride=1,
                              divisor_override=1).squeeze(1)
        return x * torch.pow(self.k + self.alpha / self.size * window,
                             -self.beta)


def _smooth(x, kernel2d):
    """Depthwise 'same' smoothing with border renormalization: the
    (weighted local mean, coverage coefficient) of Torch's Spatial*
    normalizations."""
    kh, kw = kernel2d.shape
    k = (kernel2d / kernel2d.sum()).to(x.dtype)
    c = x.shape[1]
    w = torch.zeros((c, 1, kh, kw), dtype=x.dtype, device=x.device) + k
    pad = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
    mean = F.conv2d(F.pad(x, pad), w, groups=c) / c
    ones = torch.ones_like(x[:, :1])
    coef = F.conv2d(F.pad(ones, pad), w[:1])
    return mean, coef


def _gaussian_kernel(size: int) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - (size - 1) / 2.0)
                       / (size / 4.0)) ** 2)
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _kernel(layer, x):
    return torch.as_tensor(np.asarray(layer.kernel, np.float32),
                           device=x.device)


class SpatialSubtractiveNormalization(Module):
    """Subtract the kernel-weighted local mean (summed over channels),
    renormalized at the borders
    (ref nn/SpatialSubtractiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = kernel if kernel is not None else _gaussian_kernel(9)

    @spatial
    def f(self, params, x):
        mean, coef = _smooth(x, _kernel(self, x))
        mean_all = torch.sum(mean, dim=1, keepdim=True)  # across channels
        return x - mean_all / torch.clamp(coef, min=1e-12)


class SpatialDivisiveNormalization(Module):
    """Divide by the local standard deviation, floored at its per-sample
    mean (ref nn/SpatialDivisiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = kernel if kernel is not None else _gaussian_kernel(9)
        self.threshold = threshold
        self.thresval = thresval

    @spatial
    def f(self, params, x):
        mean_sq, coef = _smooth(x * x, _kernel(self, x))
        local_std = torch.sqrt(torch.clamp(
            torch.sum(mean_sq, dim=1, keepdim=True)
            / torch.clamp(coef, min=1e-12), min=0.0))
        per_sample_mean = torch.mean(local_std, dim=(1, 2, 3), keepdim=True)
        divisor = torch.maximum(local_std, per_sample_mean)
        divisor = torch.clamp(divisor, min=self.threshold)
        return x / divisor


class SpatialContrastiveNormalization(Module):
    """Subtractive then divisive normalization
    (ref nn/SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def f(self, params, x, **kw):
        return self.div.f({}, self.sub.f({}, x))
