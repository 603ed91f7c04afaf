"""The part of ``jax.random`` that the serving key chain draws from, in
numpy, bit for bit as jax computes it with its default PRNG
(``threefry2x32``, ``jax_threefry_partitionable`` on).

Keys are ``np.uint32`` arrays of shape (2,), or (n, 2) for ``split``'s
result; a key taken from ``np.asarray(jax.random.PRNGKey(s))`` goes
straight in.  ``prng_key``, ``split``, ``fold_in`` and ``uniform`` are
bitwise equal to jax's.  ``normal`` runs XLA's float32 inverse error
function and lands within 4 ulp of jax's.  ``gumbel`` takes two float32
logarithms, each within an ulp of XLA's, so a ``categorical`` (Gumbel
argmax) draw can differ only where the top two perturbed logits lie
within about 1e-6 of each other.  ``sample`` is the one sampling rule built on
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
    over the counter pair (x0, x1), uint32 arrays of one shape; works in
    place on copies of them."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.atleast_1d(x0).astype(np.uint32) + ks[0]
    x1 = np.atleast_1d(x1).astype(np.uint32) + ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += np.uint32(i + 1)
    return x0, x1


#: counters per pass of the cipher: its temporaries stay in cache, which
#: makes a draw of many elements several times faster than one pass
_CHUNK = 1 << 16


def _counters(start: int, n: int):
    """jax's ``iota_2x32_shape`` over row-major indices start..start+n:
    each index as (high, low) 32-bit halves."""
    idx = np.arange(start, start + n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def _bits(key, start: int, n: int) -> np.ndarray:
    """The 32-bit words of counters start..start+n: the cipher's two
    output words xored."""
    b0, b1 = _threefry2x32(key, *_counters(start, n))
    b0 ^= b1
    return b0


def _chunks(n: int):
    for start in range(0, n, _CHUNK):
        yield start, min(_CHUNK, n - start)


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
    b0, b1 = _threefry2x32(_key(key), *_counters(0, int(num)))
    return np.stack([b0, b1], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    b0, b1 = _threefry2x32(_key(key), np.zeros(1, np.uint32),
                           np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([b0, b1])


def _size(shape) -> tuple:
    shape = tuple(int(s) for s in shape)
    return shape, int(np.prod(shape, dtype=np.int64))


def random_bits(key, shape=()) -> np.ndarray:
    """32-bit ``random_bits``: the cipher over each element's counter,
    the two output words xored."""
    shape, n = _size(shape)
    key = _key(key)
    out = np.empty(n, np.uint32)
    for start, m in _chunks(n):
        out[start:start + m] = _bits(key, start, m)
    return out.reshape(shape)


def uniform(key, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled and shifted in one fused
    multiply-add, then at least ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    shape, n = _size(shape)
    key = _key(key)
    out = np.empty(n, np.float32)
    for start, m in _chunks(n):
        bits = (_bits(key, start, m) >> np.uint32(9)) | np.uint32(0x3F800000)
        floats = bits.view(np.float32) - np.float32(1.0)
        if lo == 0.0 and hi == 1.0:  # the multiply-add is exact
            out[start:start + m] = floats
            continue
        # XLA contracts the scale and shift into one fused multiply-add
        out[start:start + m] = np.maximum(lo, _fma_f32(floats, hi - lo, lo))
    return out.reshape(shape)


#: XLA's float32 ``ErfInv`` (M. Giles' single-precision approximation):
#: polynomial coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma_f32(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32, as XLA's CPU code contracts
    it.  The float32 product is exact in float64, but the float64 sum
    may round, and the second rounding to float32 can then land on the
    wrong side of a tie.  That happens only where the float64 sum sits
    exactly halfway between two float32s (its low 29 bits a one and
    zeros; near zero, below float32's normal range, every sum is
    checked): there the exact error from TwoSum decides, moving an
    inexact sum one float64 ulp toward the exact value first."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    tie = ((s.view(np.int64) & 0x1FFFFFFF) == 0x10000000) \
        | (np.abs(s) < _F32_TINY)
    if tie.any():
        i = np.nonzero(tie)
        pi, ci, si = p[i], c[i], s[i]
        bb = si - pi
        err = (pi - (si - bb)) + (ci - bb)
        s[i] = np.where(err != 0, np.nextafter(
            si, np.where(err > 0, np.inf, -np.inf)), si)
    return s.astype(np.float32)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function over (-1, 1)."""
    w = _log1p_f32(-x * x)
    w = -w
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma_f32(p, w, np.where(lt, np.float32(lo), np.float32(hi)))
    return (p * x).astype(np.float32)


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with
    ``u = uniform(nextafter(-1, 0), 1)`` (bitwise jax's) and XLA's
    float32 ``erf_inv`` polynomial; within 4 ulp of jax's."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    shape, n = _size(shape)
    u = uniform(key, (n,), lo, 1.0)
    out = np.empty(n, np.float32)
    # a chunk at a time, so the polynomial's temporaries stay in cache
    for start, m in _chunks(n):
        out[start:start + m] = np.float32(np.sqrt(2.0)) * _erfinv_f32(
            u[start:start + m])
    return out.reshape(shape)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    return np.log1p(x.astype(np.float64)).astype(np.float32)


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
