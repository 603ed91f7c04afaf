"""What the traffic generators share: stratified draws from a stated
distribution, the request a serving mix sends, and the seeded streams.

A mix file (``h100_bench/traffic/<name>.json``) names its generator by
``kind``: ``h100_bench/traffic/kinds/<kind>.py``.  A serving kind's
``schedule(traffic, seed, seconds, vocab, rate_rps=None, root=...)``
gives every request due in a window; a training kind's ``batch(traffic,
seed, step, vocab)`` gives a step's rows.  Lengths and gaps are drawn by
stratified quantiles: with N draws, the quantiles at (i + 0.5) / N of
the stated distribution, in a seeded order, so every seed draws the
same set of sizes in another order, and runs on different seeds differ
by order and token ids, not by how much work they carry.

A distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}``, ``{"dist": "uniform", "min", "max"}`` or ``{"dist":
"exponential", "mean"}`` (whole numbers for lengths, seconds for gaps).
"""
from __future__ import annotations

from statistics import NormalDist
from typing import List

import numpy as np

_NORMAL = NormalDist()


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (2 ** 64)]
                               + [int(s) for s in stream]))


def quantiles(dist: dict, n: int, rng: np.random.Generator,
              integer: bool = True) -> np.ndarray:
    """``n`` stratified draws of ``dist`` in a seeded order."""
    if n <= 0:
        return np.zeros((0,), np.int64 if integer else np.float64)
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    lo, hi = dist.get("min"), dist.get("max")
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(x)) for x in u])
        vals = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        vals = lo + u * ((hi - lo + 1) if integer else (hi - lo))
    elif kind == "exponential":
        vals = -np.log1p(-u) * dist["mean"]
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    if integer:
        vals = np.floor(vals).astype(np.int64)
    vals = np.clip(vals, lo, hi) if kind != "exponential" else vals
    return vals[rng.permutation(n)]


class Request:
    """One ask: due ``due_s`` after the window opens; ``temperature`` 0
    is greedy, else the engine draws each token from the key chain of
    ``rng``."""

    __slots__ = ("index", "due_s", "prompt", "max_new", "session", "ask",
                 "prefix_len", "temperature", "rng")

    def __init__(self, index, due_s, prompt, max_new, session, ask,
                 prefix_len, temperature=0.0, rng=None):
        self.index = index
        self.due_s = due_s
        self.prompt = prompt          # (t,) int32, 1-based ids
        self.max_new = max_new
        self.session = session
        self.ask = ask
        self.prefix_len = prefix_len  # the session's shared tokens
        self.temperature = temperature
        self.rng = rng

    @property
    def greedy(self) -> bool:
        return not self.temperature

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (f"Request({self.index}, due={self.due_s:.3f}s, "
                f"t={len(self.prompt)}, max_new={self.max_new})")


def describe(requests: List[Request]) -> dict:
    """Sizes of a schedule, for the log."""
    if not requests:
        return {"requests": 0}
    t = [len(r.prompt) for r in requests]
    o = [r.max_new for r in requests]
    return {"requests": len(requests), "prompt_tokens": int(sum(t)),
            "output_tokens": int(sum(o)), "prompt_max": max(t),
            "output_max": max(o),
            "last_due_s": round(requests[-1].due_s, 3)}


def check_lengths(requests: List[Request], cache_len: int) -> None:
    for r in requests:
        if len(r.prompt) + r.max_new > cache_len:
            raise ValueError(f"request {r.index}: {len(r.prompt)} + "
                             f"{r.max_new} tokens exceed {cache_len}")

