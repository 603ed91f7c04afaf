"""Process-wide metric registry: counters, gauges, histograms and one
snapshot path (port of ``bigdl_tpu/obs/registry.py``).

Registration is get-or-create by name.  Live metric objects can also be
registered (``register(..., replace=True)``): that is how the serving
engine's ``LMMetrics`` and ``SpecMetrics`` and the host KV tier expose
their counters process-wide without copying.  The log-bucket
:class:`Histogram` is also the serving metrics' histogram, so their
percentiles are the reference's.

Every metric here is host state: reading one never touches a device.
:meth:`MetricRegistry.export_to_summary` writes a snapshot through the
tfevents writers of :mod:`bigdl_tpu_torch.visualization`.
"""
from __future__ import annotations

import bisect
import logging
import os
import threading
from typing import Callable, Dict, List, Optional

log = logging.getLogger("bigdl_tpu_torch.obs.registry")


def _log_edges() -> List[float]:
    # 10us .. ~100s, ~7% geometric steps
    edges = []
    v = 1e-5
    while v < 100.0:
        edges.append(v)
        v *= 1.07
    return edges


_EDGES = _log_edges()

#: what an overflow-bucket rank reports: the next geometric edge past
#: the instrumented range, finite but greater than every in-range answer
OVERFLOW_EDGE = _EDGES[-1] * 1.07


def percentile_from_counts(counts, p: float,
                           overflow: Optional[float] = None
                           ) -> Optional[float]:
    """Percentile over a bucket-count vector shaped like
    ``Histogram.counts()`` (upper bucket edge).  The difference of two
    ``counts()`` snapshots is the histogram of the interval between
    them.  An empty window is ``None``; negative entries (a torn delta)
    count as zero; a rank in the overflow bucket reports ``overflow``
    (default :data:`OVERFLOW_EDGE`)."""
    counts = [c if c > 0 else 0 for c in counts]
    total = sum(counts)
    if not total:
        return None
    if overflow is None:
        overflow = OVERFLOW_EDGE
    rank = max(1, int(round(total * p / 100.0)))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return _EDGES[i] if i < len(_EDGES) else overflow
    return overflow


class Counter:
    """Accumulator with a (value, parallel-count) pair and a unit tag."""

    __slots__ = ("value", "n", "unit", "_lock")

    def __init__(self, unit: str = ""):
        self.value = 0.0
        self.n = 1
        self.unit = unit
        self._lock = threading.Lock()

    def add(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += float(v)

    def set(self, v: float, n: int = 1) -> None:
        with self._lock:
            self.value = float(v)
            self.n = int(n)

    def get(self) -> tuple:
        with self._lock:
            return self.value, self.n

    def snapshot(self) -> dict:
        with self._lock:
            d = {"value": self.value, "n": self.n}
            if self.unit:
                d["unit"] = self.unit
            return d


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value", "unit", "_lock")

    def __init__(self, unit: str = ""):
        self.value: Optional[float] = None
        self.unit = unit
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> dict:
        with self._lock:
            d = {"value": self.value}
            if self.unit:
                d["unit"] = self.unit
            return d


class FnGauge:
    """Computed gauge: reads a callable at snapshot time (a failing
    callable reads as None)."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], Optional[float]]):
        self.fn = fn

    def snapshot(self) -> dict:
        try:
            v = self.fn()
        except Exception:
            v = None
        return {"value": v}


class Histogram:
    """Fixed log-bucket histogram over seconds, with percentile
    estimation (upper bucket edge: a conservative answer for a p99
    check)."""

    def __init__(self):
        self._counts = [0] * (len(_EDGES) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        self._counts[bisect.bisect_left(_EDGES, seconds)] += 1
        self.count += 1
        self.sum += seconds
        if seconds > self.max:
            self.max = seconds

    def counts(self) -> List[int]:
        """Copy of the raw bucket counts."""
        return list(self._counts)

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100]; None when empty."""
        if not self.count:
            return None
        rank = max(1, int(round(self.count * p / 100.0)))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return _EDGES[i] if i < len(_EDGES) else self.max
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_s": (self.sum / self.count) if self.count else None,
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
            "max_s": self.max if self.count else None,
        }


class MetricRegistry:
    """Name -> metric map with get-or-create accessors.

    Cardinality is bounded: past ``max_metrics`` (env
    ``BIGDL_TPU_REGISTRY_MAX``, floor 8) a new name gets a live but
    detached metric, and every ``snapshot`` carries the synthetic
    ``obs/registry_cardinality`` and ``obs/registry_overflow_total``
    gauges."""

    DEFAULT_MAX_METRICS = 4096

    def __init__(self, max_metrics: Optional[int] = None):
        if max_metrics is None:
            try:
                max_metrics = int(os.environ.get(
                    "BIGDL_TPU_REGISTRY_MAX", self.DEFAULT_MAX_METRICS))
            except ValueError:
                max_metrics = self.DEFAULT_MAX_METRICS
        self.max_metrics = max(int(max_metrics), 8)
        self._metrics: Dict[str, object] = {}
        self._overflow = 0
        self._warned_overflow = False
        self._lock = threading.Lock()

    def _overflowed(self, name: str) -> None:
        # caller holds self._lock
        self._overflow += 1
        if not self._warned_overflow:
            self._warned_overflow = True
            log.warning(
                "metric registry at cardinality cap (%d): %r and later "
                "new names get detached metrics; see "
                "obs/registry_overflow_total", self.max_metrics, name)

    def _get_or_create(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(**kw)
                if len(self._metrics) >= self.max_metrics:
                    self._overflowed(name)
                else:
                    self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get_or_create(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, unit=unit)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def register(self, name: str, metric, replace: bool = False):
        """Bind a live metric object; ``replace=True`` rebinds the name
        to the latest owner."""
        if not hasattr(metric, "snapshot"):
            raise TypeError(f"metric {name!r} has no snapshot() method")
        with self._lock:
            if not replace and name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            if name not in self._metrics \
                    and len(self._metrics) >= self.max_metrics:
                self._overflowed(name)
            else:
                self._metrics[name] = metric
        return metric

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._overflow = 0
            self._warned_overflow = False

    def cardinality(self) -> int:
        with self._lock:
            return len(self._metrics)

    def overflow_total(self) -> int:
        """Metric creations refused (detached) by the cardinality cap."""
        with self._lock:
            return self._overflow

    def snapshot(self) -> dict:
        """{name: metric.snapshot()} for every registered metric, plus
        the two synthetic self-reporting gauges."""
        with self._lock:
            items = list(self._metrics.items())
            card, over = len(self._metrics), self._overflow
        snap = {name: m.snapshot() for name, m in items}
        snap["obs/registry_cardinality"] = {"value": float(card)}
        snap["obs/registry_overflow_total"] = {"value": float(over)}
        return snap

    def export_to_summary(self, summary, step: int,
                          prefix: str = "Obs/") -> int:
        """Write every scalar-valued field of the snapshot through a
        ``visualization.Summary`` (tfevents) writer; histograms export
        their p50/p99/mean/count.  Returns the scalar count written."""
        wrote = 0
        for name, snap in self.snapshot().items():
            if "value" in snap:
                if snap["value"] is not None:
                    summary.add_scalar(prefix + name, float(snap["value"]),
                                       step)
                    wrote += 1
                continue
            for key in ("p50_s", "p99_s", "mean_s", "count"):
                v = snap.get(key)
                if v is not None:
                    summary.add_scalar(f"{prefix}{name}/{key}", float(v),
                                       step)
                    wrote += 1
        summary.flush()
        return wrote


#: process-wide registry
_GLOBAL = MetricRegistry()


def get_registry() -> MetricRegistry:
    return _GLOBAL
