"""Training rows: ``batch`` sequences of ``seq_len`` token ids a step,
drawn from the run's seed, every row of every step its own draw."""
from __future__ import annotations

import numpy as np

from h100_bench.bench.loadgen import rng


def batch(traffic: dict, seed: int, step: int, vocab: int):
    """Step ``step``'s (data, labels): (batch, seq_len) 1-based ids, the
    labels the data shifted by one."""
    n, t = int(traffic["batch"]), int(traffic["seq_len"])
    ids = rng(seed, 3, step).integers(1, vocab + 1, size=(n, t + 1),
                                      dtype=np.int64)
    return ids[:, :-1].copy(), ids[:, 1:].copy()
