"""Torch7-compatible Mersenne-Twister RNG on the host (port of
``bigdl_tpu/utils/rng.py``).

Standard MT19937 (state N=624, M=397) with Torch's seeding and its
53-bit doubles, so ``randperm`` gives the JAX package's permutation for
the same seed: the data pipeline's epoch shuffles match it record for
record.  ``normal`` is the polar (Marsaglia) method with the second value
cached, in Torch's order; ``exponential``, ``cauchy``, ``log_normal``,
``geometric`` and ``bernoulli`` transform one double each, and the
``*_array`` forms draw n values in one call.  :class:`RNG` is the
reference's thread-local facade (ref RandomGenerator.scala ``RNG``).

The draws run in the port's host library (``bigdl_tpu_torch/native``,
the generator's state and its cached normal live there); with
``BIGDL_TPU_NO_NATIVE=1`` they run in Python, bit for bit the same.
The JAX package's pure-Python fallback is not copied as it stands: its
vectorized block update reads words 227-395 before their update, so it
leaves the standard sequence at the 455th draw.
"""
from __future__ import annotations

import math
import threading

import numpy as np

from bigdl_tpu_torch import native

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class RandomGenerator:
    def __init__(self, seed: int = 5489):
        self._mt = np.zeros(_N, dtype=np.uint64)
        self._mti = _N + 1
        self._normal_cached = None
        self._native = None
        self._lib = native.get()
        if self._lib is not None:
            self._native = self._lib.mt_new(seed)
        self.set_seed(seed)

    def __del__(self):
        handle = getattr(self, "_native", None)
        if handle is not None:
            try:  # may run at interpreter exit, with ctypes half torn down
                self._lib.mt_free(handle)
            except Exception:
                pass

    def __getstate__(self) -> dict:
        """A copy or pickle carries the generator's state, never the
        native handle (two owners of one handle would free it twice)."""
        state = {k: v for k, v in self.__dict__.items()
                 if k not in ("_native", "_lib")}
        if self._native is not None:
            state["_native_state"] = self._lib.mt_get_state(self._native)
        return state

    def __setstate__(self, state: dict) -> None:
        native_state = state.pop("_native_state", None)
        self.__dict__.update(state)
        self._native = None
        self._lib = native.get() if native_state is not None else None
        if self._lib is not None:
            self._native = self._lib.mt_new(self._seed)
            self._lib.mt_set_state(self._native, *native_state)
        elif native_state is not None:  # the Python path resumes it
            mt, mti, cached, has_cached = native_state
            self._mt = np.asarray(mt, dtype=np.uint64)
            self._mti = mti
            self._normal_cached = cached if has_cached else None

    def set_seed(self, seed: int) -> "RandomGenerator":
        self._seed = seed
        if self._native is not None:
            self._lib.mt_set_seed(self._native, seed)
            return self
        mt = self._mt
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30)))
                     + i) & 0xFFFFFFFF
        self._mti = _N
        self._normal_cached = None
        return self

    def get_seed(self) -> int:
        return self._seed

    def _generate(self) -> None:
        mt = self._mt
        mag01 = np.array([0, _MATRIX_A], dtype=np.uint64)
        # the standard sequential update, vectorized in strips of N - M
        # words: word kk reads word (kk + M) mod N, which a strip this
        # short has either not updated yet or finished in the strip before
        for lo in range(0, _N - 1, _N - _M):
            hi = min(lo + _N - _M, _N - 1)
            y = (mt[lo:hi] & _UPPER_MASK) | (mt[lo + 1:hi + 1] & _LOWER_MASK)
            mt[lo:hi] = (mt[(np.arange(lo, hi) + _M) % _N]
                         ^ (y >> np.uint64(1))
                         ^ mag01[(y & np.uint64(1)).astype(np.int64)])
        y = ((mt[_N - 1] & np.uint64(_UPPER_MASK))
             | (mt[0] & np.uint64(_LOWER_MASK)))
        mt[_N - 1] = mt[_M - 1] ^ (y >> np.uint64(1)) ^ mag01[int(
            y & np.uint64(1))]
        self._mti = 0

    def random_int(self) -> int:
        if self._native is not None:
            return self._lib.mt_random_int(self._native)
        if self._mti >= _N:
            self._generate()
        y = int(self._mt[self._mti])
        self._mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y &= 0xFFFFFFFF
        y ^= (y << 15) & 0xEFC60000
        y &= 0xFFFFFFFF
        y ^= y >> 18
        return y

    def random(self) -> float:
        """53-bit double in [0, 1)."""
        if self._native is not None:
            return self._lib.mt_random(self._native)
        a = self.random_int() >> 5
        b = self.random_int() >> 6
        return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0)

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        return self.random() * (b - a) + a

    def normal(self, mean: float = 0.0, stdv: float = 1.0) -> float:
        if self._native is not None:
            return float(self._lib.mt_normal(self._native, 1, mean, stdv)[0])
        if self._normal_cached is not None:
            v = self._normal_cached
            self._normal_cached = None
            return mean + stdv * v
        while True:
            u = 2.0 * self.random() - 1.0
            v = 2.0 * self.random() - 1.0
            s = u * u + v * v
            if 0.0 < s < 1.0:
                break
        # the C library's log and sqrt, as the host library's: numpy's
        # vectorised log may round the last bit otherwise
        mult = math.sqrt(-2.0 * math.log(s) / s)
        self._normal_cached = v * mult
        return mean + stdv * (u * mult)

    def exponential(self, lam: float) -> float:
        return -1.0 / lam * np.log(1.0 - self.random())

    def cauchy(self, median: float, sigma: float) -> float:
        return median + sigma * np.tan(np.pi * (self.random() - 0.5))

    def log_normal(self, mean: float, stdv: float) -> float:
        zm = mean * mean
        zs = stdv * stdv
        return float(np.exp(self.normal(np.log(zm / np.sqrt(zs + zm)),
                                        np.sqrt(np.log(zs / zm + 1)))))

    def geometric(self, p: float) -> int:
        return int(np.log(1.0 - self.random()) / np.log(p)) + 1

    def bernoulli(self, p: float) -> bool:
        return self.random() <= p

    def uniform_array(self, n: int, a: float = 0.0,
                      b: float = 1.0) -> np.ndarray:
        if self._native is not None:
            return self._lib.mt_uniform(self._native, n, a, b)
        return np.array([self.uniform(a, b) for _ in range(n)])

    def normal_array(self, n: int, mean: float = 0.0,
                     stdv: float = 1.0) -> np.ndarray:
        if self._native is not None:
            return self._lib.mt_normal(self._native, n, mean, stdv)
        return np.array([self.normal(mean, stdv) for _ in range(n)])

    def bernoulli_array(self, n: int, p: float) -> np.ndarray:
        if self._native is not None:
            return self._lib.mt_bernoulli(self._native, n, p)
        return np.array([1.0 if self.bernoulli(p) else 0.0
                         for _ in range(n)])

    def randperm(self, n: int) -> np.ndarray:
        """1-based random permutation (Torch randperm semantics)."""
        if self._native is not None:
            return self._lib.mt_randperm(self._native, n)
        perm = np.arange(1, n + 1)
        for i in range(n - 1, 0, -1):
            j = int(self.random() * (i + 1))
            perm[i], perm[j] = perm[j], perm[i]
        return perm


class _ThreadLocalRNG(threading.local):
    gen: RandomGenerator = None  # made at first use, never at import


_tls = _ThreadLocalRNG()


def _gen() -> RandomGenerator:
    if _tls.gen is None:
        _tls.gen = RandomGenerator()
    return _tls.gen


class RNG:
    """The thread-local default generator (ref RandomGenerator.scala
    ``RNG``): each thread has its own, seeded 5489 until ``set_seed``."""

    @staticmethod
    def current() -> RandomGenerator:
        return _gen()

    @staticmethod
    def set_seed(seed: int) -> None:
        _gen().set_seed(seed)

    @staticmethod
    def uniform(a: float = 0.0, b: float = 1.0) -> float:
        return _gen().uniform(a, b)

    @staticmethod
    def normal(mean: float = 0.0, stdv: float = 1.0) -> float:
        return _gen().normal(mean, stdv)

    @staticmethod
    def bernoulli(p: float) -> bool:
        return _gen().bernoulli(p)
