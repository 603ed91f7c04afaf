"""Torch7-compatible Mersenne-Twister RNG on the host (port of
``bigdl_tpu/utils/rng.py``, its pure-Python MT19937 path).

Standard MT19937 (state N=624, M=397) with Torch's seeding and its
53-bit doubles, so ``randperm`` gives the JAX package's permutation for
the same seed (its native backend, ``csrc/bigdl_tpu_native.cpp``): the
data pipeline's epoch shuffles match it record for record.  The JAX
package's pure-Python fallback is not copied as it stands: its
vectorized block update reads words 227-395 before their update, so it
leaves the standard sequence at the 455th draw.
"""
from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class RandomGenerator:
    def __init__(self, seed: int = 5489):
        self._mt = np.zeros(_N, dtype=np.uint64)
        self._mti = _N + 1
        self.set_seed(seed)

    def set_seed(self, seed: int) -> "RandomGenerator":
        self._seed = seed
        mt = self._mt
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30)))
                     + i) & 0xFFFFFFFF
        self._mti = _N
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
        a = self.random_int() >> 5
        b = self.random_int() >> 6
        return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0)

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        return self.random() * (b - a) + a

    def randperm(self, n: int) -> np.ndarray:
        """1-based random permutation (Torch randperm semantics)."""
        perm = np.arange(1, n + 1)
        for i in range(n - 1, 0, -1):
            j = int(self.random() * (i + 1))
            perm[i], perm[j] = perm[j], perm[i]
        return perm
