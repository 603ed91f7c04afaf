"""The part of ``jax.random`` that the serving key chain draws from, in
numpy, bit for bit as jax computes it with its default PRNG
(``threefry2x32``, ``jax_threefry_partitionable`` on).

Keys are ``np.uint32`` arrays of shape (2,), or (n, 2) for ``split``'s
result; a key taken from ``np.asarray(jax.random.PRNGKey(s))`` goes
straight in.  ``prng_key``, ``split``, ``fold_in`` and ``uniform`` are
bitwise equal to jax's; ``gumbel`` takes two float32 logarithms, each
within an ulp of XLA's, so ``categorical`` (Gumbel argmax) can differ
from jax's only where the top two perturbed logits lie within about
1e-6 of each other.  ``sample`` is the one sampling rule built on
them that offline ``generate`` and the serving engine both draw by.

The cipher works on arrays only: numpy wraps uint32 array arithmetic
silently but warns on scalar overflow.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_F32_TINY = np.finfo(np.float32).tiny


def _threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 block cipher keyed by ``key`` (2,)
    over the counter pair (x0, x1), uint32 arrays of one shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.atleast_1d(x0).astype(np.uint32) + ks[0]
    x1 = np.atleast_1d(x1).astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(shape):
    """jax's ``iota_2x32_shape``: the row-major index of each element as
    (high, low) 32-bit halves."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def _key(key) -> np.ndarray:
    key = np.asarray(key)
    if key.shape != (2,):
        raise ValueError(f"a key is a uint32 array of shape (2,), got shape "
                         f"{key.shape}")
    return key.astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit ints off: the seed's low
    32 bits after a wrap to int32, behind a zero high word."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def as_key(rng=None) -> np.ndarray:
    """A sampling entry point's ``rng``: None (seed 0), an int seed, or
    a (2,) uint32 key."""
    if rng is None:
        return prng_key(0)
    if isinstance(rng, (int, np.integer)):
        return prng_key(int(rng))
    return _key(rng)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _counters((int(num),))
    b0, b1 = _threefry2x32(_key(key), hi, lo)
    return np.stack([b0, b1], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    b0, b1 = _threefry2x32(_key(key), np.zeros(1, np.uint32),
                           np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([b0, b1])


def random_bits(key, shape=()) -> np.ndarray:
    """32-bit ``random_bits``: the cipher over each element's counter,
    the two output words xored."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape)
    b0, b1 = _threefry2x32(_key(key), hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled and shifted, then at least
    ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _log_f32(x: np.ndarray) -> np.ndarray:
    # numpy's float32 log lands up to 3-4 ulp from XLA's; the float64 log
    # rounded once to float32 lands within 1 ulp of it
    return np.log(x.astype(np.float64)).astype(np.float32)


def gumbel(key, shape=()) -> np.ndarray:
    """``jax.random.gumbel`` in float32, mode "low":
    ``-log(-log(uniform(tiny, 1)))``, each log rounded to float32."""
    u = uniform(key, shape, _F32_TINY, 1.0)
    return -_log_f32(-_log_f32(u))


def categorical(key, logits, axis: int = -1) -> np.ndarray:
    """``jax.random.categorical``: the Gumbel-max draw along ``axis``
    (first index on ties, as ``jnp.argmax``)."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, axis=axis)


def sample(key, logits, temperature: float, clamp: bool) -> np.ndarray:
    """The sampling rule of ``generate`` and the serving engine over a
    (B, V) logits block: argmax at temperature 0 (or without a key),
    else one ``categorical`` over the whole block with ``key``, the
    logits divided in float32 by ``max(temperature, 1e-6)`` when
    ``clamp`` (every decode step), else by the temperature itself
    (``generate``'s first token).  Returns (B,) int64 indices."""
    if temperature <= 0.0 or key is None:
        return np.argmax(np.asarray(logits), axis=-1)
    denom = max(temperature, 1e-6) if clamp else temperature
    rows = np.asarray(logits, np.float32) / np.float32(denom)
    return categorical(key, rows, axis=-1)
