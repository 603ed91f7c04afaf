"""Stochastic and gradient-shaping layers (port of
``bigdl_tpu/nn/dropout.py``: Dropout, L1Penalty, GradientReversal).

``Dropout`` keeps an element where ``uniform(key, shape) < 1 - p``,
``jax.random.bernoulli``'s rule, drawn on the host by the key chain
(``utils/keychain.py``, Threefry-2x32 as ``jax.random``) and copied to
the tensor's device as bytes.  So the mask from a key is the reference's
mask, bit for bit, on the CPU and on the card alike, and the same seed
gives the same run everywhere.  The draw costs host time in every
training forward (VGG-16's two dropouts at batch 32 are 2 x 131,072
elements a step); the copy does not wait for the device.

``L1Penalty`` and ``GradientReversal`` are identities in the forward
whose backward the reference writes as a ``jax.custom_vjp``; here each
is a ``torch.autograd.Function``.
"""
from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import keychain


def keep_mask(key, shape, keep: float, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, keep, shape)`` on ``device``: bool,
    True where kept."""
    return keep_masks([key], shape, keep, device)[0]


def keep_masks(keys, shape, keep: float, device) -> torch.Tensor:
    """:func:`keep_mask` of every key in ``keys``, stacked on a new
    leading axis and copied to ``device`` in one transfer."""
    masks = np.stack([keychain.uniform(k, shape) < np.float32(keep)
                      for k in keys])
    # from pageable memory an asynchronous copy is staged at once
    return torch.from_numpy(masks).to(device, non_blocking=True)


class Dropout(Module):
    """Zero each element with probability ``p`` in training mode, from
    the layer's key (ref nn/Dropout.scala); ``scale`` divides the kept
    ones by ``1 - p``, else eval mode multiplies by ``1 - p``."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.inplace = inplace  # API parity; the forward is out of place
        self.scale = scale

    def f(self, params, x, *, training=False, rng=None, **kw):
        if not training or self.p == 0.0:
            if not self.scale:
                return x * (1 - self.p)
            return x
        if rng is None:
            raise ValueError("Dropout in training mode needs an rng key")
        keep = keep_mask(rng, x.shape, 1.0 - self.p, x.device)
        y = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        if self.scale:
            y = y / (1.0 - self.p)
        return y

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self


class _L1PenaltyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x)
        ctx.weight = weight
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.weight * torch.sign(x), None


class L1Penalty(Module):
    """Identity forward that adds an L1 subgradient in the backward,
    ``grad + l1weight * sign(x)`` (ref nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average

    def f(self, params, x, **kw):
        w = (self.l1weight / x.numel() if self.size_average
             else self.l1weight)
        return _L1PenaltyFn.apply(x, w)


class _ReverseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """Identity forward, ``-lambda`` times the gradient backward
    (ref nn/GradientReversal.scala)."""

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def set_lambda(self, lam: float) -> "GradientReversal":
        self.the_lambda = lam
        return self

    def f(self, params, x, **kw):
        return _ReverseFn.apply(x, self.the_lambda)
