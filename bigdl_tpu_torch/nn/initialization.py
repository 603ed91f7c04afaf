"""Parameter initialization methods (port of
``bigdl_tpu/nn/initialization.py``; ref nn/InitializationMethod.scala:22:
Default, Xavier, BilinearFiller).

``Default`` reproduces Torch's per-layer fan-based uniform; ``Xavier`` the
Glorot uniform.  The draws go through the key chain
(:func:`bigdl_tpu_torch.utils.keychain.uniform`, bitwise
``jax.random.uniform``), so a tree built from a seed is the reference's
bit for bit.  Every method returns float32 numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np

from bigdl_tpu_torch.utils import keychain


class InitializationMethod:
    name = "default"


class Default(InitializationMethod):
    name = "default"

    @staticmethod
    def weight(rng, shape, fan_in):
        stdv = 1.0 / math.sqrt(fan_in)
        return keychain.uniform(rng, shape, -stdv, stdv)

    bias = weight


class Xavier(InitializationMethod):
    name = "xavier"

    @staticmethod
    def weight(rng, shape, fan_in, fan_out=None):
        if fan_out is None:
            fan_out = shape[0] if len(shape) > 1 else fan_in
        stdv = math.sqrt(6.0 / (fan_in + fan_out))
        return keychain.uniform(rng, shape, -stdv, stdv)

    @staticmethod
    def bias(rng, shape, fan_in):
        return np.zeros(shape, dtype=np.float32)


class BilinearFiller(InitializationMethod):
    """Bilinear-upsampling kernel init for SpatialFullConvolution
    (ref nn/InitializationMethod.scala BilinearFiller)."""
    name = "bilinearfiller"

    @staticmethod
    def weight(rng, shape, fan_in=None):
        # shape: (nInput, nOutput, kH, kW) or (nOutput, nInput, kH, kW)
        kh, kw = shape[-2], shape[-1]
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype=np.float32)
        flat = w.reshape(-1, kh * kw)
        for i in range(kh * kw):
            x = i % kw
            y = i // kw
            flat[:, i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return w
