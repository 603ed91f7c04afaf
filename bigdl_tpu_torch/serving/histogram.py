"""The serving metrics' histogram, shared by ``LMMetrics`` and
``SpecMetrics``."""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


class Histogram:
    """Observed values (seconds for latencies): count and mean over all
    observations, percentiles over the most recent ``window``."""

    def __init__(self, window: int = 4096):
        self._recent: deque = deque(maxlen=window)
        self.count = 0
        self.sum = 0.0

    def observe(self, x: float) -> None:
        self._recent.append(float(x))
        self.count += 1
        self.sum += float(x)

    def percentile(self, q: float) -> Optional[float]:
        if not self._recent:
            return None
        return float(np.percentile(np.asarray(self._recent), q))

    def snapshot(self) -> dict:
        return {"count": self.count,
                "mean_s": (self.sum / self.count) if self.count else None,
                "p50_s": self.percentile(50),
                "p99_s": self.percentile(99)}
