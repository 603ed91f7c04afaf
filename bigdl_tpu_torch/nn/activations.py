"""Activation layers (port of ``bigdl_tpu/nn/activations.py``; ref nn/:
ReLU, Tanh, Sigmoid, SoftMax, ... one Scala file each): thin functions
over torch ops, the same formulas as the reference's ``jax.nn`` ones.

All are stateless except PReLU (learnable) and RReLU (stochastic in
training, its slopes drawn from the key chain).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import keychain


class ReLU(Module):
    def __init__(self, ip: bool = False):
        super().__init__()
        self.ip = ip  # in-place flag kept for API parity

    def f(self, params, x, **kw):
        return torch.clamp_min(x, 0)


class ReLU6(Module):
    def f(self, params, x, **kw):
        return torch.clamp(x, 0, 6)


class GELU(Module):
    """Gaussian error linear unit; ``approximate=True`` is the tanh form
    (the reference's default)."""

    def __init__(self, approximate: bool = True):
        super().__init__()
        self.approximate = approximate

    def f(self, params, x, **kw):
        return F.gelu(x, approximate="tanh" if self.approximate else "none")


class Tanh(Module):
    def f(self, params, x, **kw):
        return torch.tanh(x)


class Sigmoid(Module):
    def f(self, params, x, **kw):
        return torch.sigmoid(x)


class SoftMax(Module):
    """Softmax over the last dim (ref nn/SoftMax.scala)."""

    def f(self, params, x, **kw):
        return torch.softmax(x, dim=-1)


class SoftMin(Module):
    def f(self, params, x, **kw):
        return torch.softmax(-x, dim=-1)


class LogSoftMax(Module):
    def f(self, params, x, **kw):
        return torch.log_softmax(x, dim=-1)


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), with no linear cut-over
    return torch.logaddexp(x, torch.zeros_like(x))


class LogSigmoid(Module):
    def f(self, params, x, **kw):
        return -_softplus(-x)


class SoftPlus(Module):
    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def f(self, params, x, **kw):
        return _softplus(self.beta * x) / self.beta


class SoftSign(Module):
    def f(self, params, x, **kw):
        return x / (1 + torch.abs(x))


class LeakyReLU(Module):
    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def f(self, params, x, **kw):
        return torch.where(x > 0, x, self.negval * x)


class ELU(Module):
    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def f(self, params, x, **kw):
        return torch.where(x > 0, x, self.alpha * (torch.exp(x) - 1))


class PReLU(Module):
    """Learnable leaky slope; n_output_plane=0 means one shared slope
    (ref nn/PReLU.scala)."""

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane

    def init(self, rng):
        n = max(self.n_output_plane, 1)
        return {"weight": np.full((n,), 0.25, dtype=np.float32)}

    def f(self, params, x, **kw):
        w = params["weight"]
        if self.n_output_plane > 0 and x.ndim > 1:
            # per-channel slope: channel dim is 1 for batched input
            # (N,C,...) or 0 for unbatched (C,...); prefer the axis
            # whose size matches
            n = self.n_output_plane
            if x.shape[1] == n:
                ch_axis = 1
            elif x.shape[0] == n:
                ch_axis = 0
            else:
                raise ValueError(
                    f"PReLU({n}): no input dim of size {n} in shape "
                    f"{tuple(x.shape)}")
            shape = [1] * x.ndim
            shape[ch_axis] = n
            w = w.reshape(shape)
        return torch.where(x > 0, x, w * x)


class RReLU(Module):
    """Randomized leaky ReLU: slope ~ U(lower, upper) in training (drawn
    from the key chain, the reference's draws), fixed mean slope in eval
    (ref nn/RReLU.scala)."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def f(self, params, x, *, training=False, rng=None, **kw):
        if training and rng is not None:
            a = torch.from_numpy(keychain.uniform(
                rng, tuple(x.shape), self.lower, self.upper)).to(x.device)
        else:
            a = (self.lower + self.upper) / 2
        return torch.where(x >= 0, x, a * x)


class HardTanh(Module):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False):
        super().__init__()
        self.min_value = min_value
        self.max_value = max_value

    def f(self, params, x, **kw):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(Module):
    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def f(self, params, x, **kw):
        return torch.where(torch.abs(x) > self.lam, x, torch.zeros_like(x))


class SoftShrink(Module):
    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def f(self, params, x, **kw):
        zero = torch.zeros_like(x)
        return torch.where(x > self.lam, x - self.lam,
                           torch.where(x < -self.lam, x + self.lam, zero))


class TanhShrink(Module):
    def f(self, params, x, **kw):
        return x - torch.tanh(x)


class Threshold(Module):
    """x if x > th else v (ref nn/Threshold.scala)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th = th
        self.v = v
        self.ip = ip  # in-place flag kept for API parity

    def f(self, params, x, **kw):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class Clamp(HardTanh):
    def __init__(self, min_value: float, max_value: float):
        super().__init__(min_value, max_value)


class Power(Module):
    """(shift + scale*x)^power (ref nn/Power.scala)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power = power
        self.scale = scale
        self.shift = shift

    def f(self, params, x, **kw):
        return torch.pow(self.shift + self.scale * x, self.power)


class Square(Module):
    def f(self, params, x, **kw):
        return torch.square(x)


class Sqrt(Module):
    def f(self, params, x, **kw):
        return torch.sqrt(x)


class Log(Module):
    def f(self, params, x, **kw):
        return torch.log(x)


class Exp(Module):
    def f(self, params, x, **kw):
        return torch.exp(x)


class Abs(Module):
    def f(self, params, x, **kw):
        return torch.abs(x)
