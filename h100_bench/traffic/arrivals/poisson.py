"""Poisson arrivals: the gaps between starts are ``n`` stratified draws
of an exponential of mean ``1 / rate``, in an order drawn from the
run's seed.  Every seed spaces its starts by the same set of gaps, so
runs differ in when the bunches come, not in how much they bunch.  No
parameters."""
from __future__ import annotations

import numpy as np

from h100_bench.bench.loadgen import quantiles, rng


def starts(params: dict, n: int, rate: float, seed: int) -> np.ndarray:
    """``n`` start times from 0, in seconds."""
    if params:
        raise ValueError(f"poisson arrivals take no parameters: {params}")
    gaps = quantiles({"dist": "exponential", "mean": 1.0 / rate}, n,
                     rng(seed, 5), integer=False)
    return np.cumsum(gaps) - gaps[0]
