"""Telemetry time-series: a background sampler over the MetricRegistry
(port of ``bigdl_tpu/obs/timeseries.py``).

``MetricRegistry.snapshot()`` is a point-in-time read — good for a
summary line, useless for "what happened in the 30 seconds before the
stall".  :class:`TimeSeriesSampler` closes that gap: a daemon thread
snapshots the registry at a fixed interval into a bounded ring, turning
the lifetime metrics every subsystem already publishes into an actual
time axis:

- gauges (and ``FnGauge``/``Counter`` values) record their value;
- counters additionally record the **delta** since the previous tick,
  so a rate is one subtraction away;
- histograms record *windowed* p50/p99 over just the interval — the
  same ``counts()``-delta idiom ``traffic.SLOController`` uses — plus
  the interval's observation count.

Consumers: the flight recorder embeds ``window()`` in every incident
bundle (the time axis around the incident), a load sweep records its
trajectory instead of one end-state snapshot, and post-mortems read
the ring directly.  A tick reads host-side registry objects only: an
``FnGauge`` that read a device tensor would synchronise the card from
this thread, so none of the port's gauges does.  The ring is bounded
(``capacity`` rows), so a week-long serving process pays a fixed
memory cost.

Threading mirrors ``SLOController``: a pure ``sample_now()`` core the
tests (and the flight recorder, on demand) call deterministically, and
``start()``/``stop()`` wrapping it in a daemon loop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from bigdl_tpu_torch.obs.registry import (MetricRegistry, get_registry,
                                    percentile_from_counts)

__all__ = ["TimeSeriesSampler", "get_sampler", "set_sampler"]


class TimeSeriesSampler:
    """Fixed-interval MetricRegistry sampler into a bounded ring.

    Each row::

        {"t_unix": ..., "t_perf": ..., "metrics": {
            "serving/requests":  {"value": 41.0, "delta": 3.0},
            "serving/lm/ttft":   {"count": 17, "count_delta": 2,
                                  "p50_s": ..., "p99_s": ...},
            "some/gauge":        {"value": 0.62},
        }}

    ``p50_s``/``p99_s`` in histogram entries are *windowed* (over the
    interval's observations only); ``None`` when the interval saw none.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 interval_s: float = 1.0, capacity: int = 300):
        self.registry = registry if registry is not None else get_registry()
        self.interval_s = max(float(interval_s), 0.01)
        self._rows: deque = deque(maxlen=max(int(capacity), 2))
        self._lock = threading.Lock()
        # previous tick's counter values / histogram bucket counts,
        # keyed by metric name — the windowed-delta state
        self._prev_values: dict = {}
        self._prev_counts: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.ticks = 0

    # -- core (pure, deterministic) ------------------------------------- #
    def sample_now(self) -> dict:
        """Take one sample row now and append it to the ring."""
        reg = self.registry
        row_metrics: dict = {}
        # metric objects first: counters/histograms need object access
        # for deltas; names() + get() is the registry's supported read
        for name in reg.names():
            m = reg.get(name)
            if m is None:
                continue
            try:
                entry = self._sample_metric(name, m)
            except Exception as e:  # a broken FnGauge must not kill the tick
                entry = {"error": f"{type(e).__name__}: {e}"}
            if entry is not None:
                row_metrics[name] = entry
        row_metrics["obs/registry_cardinality"] = {
            "value": float(reg.cardinality())}
        row = {"t_unix": time.time(), "t_perf": time.perf_counter(),
               "metrics": row_metrics}
        with self._lock:
            self._rows.append(row)
            self.ticks += 1
        return row

    def _sample_metric(self, name: str, m) -> Optional[dict]:
        counts_fn = getattr(m, "counts", None)
        if callable(counts_fn):  # histogram-shaped: windowed percentiles
            counts = counts_fn()
            prev = self._prev_counts.get(name)
            self._prev_counts[name] = counts
            if prev is not None and len(prev) == len(counts):
                delta = [max(0, c - p) for c, p in zip(counts, prev)]
            else:
                delta = counts
            n = sum(delta)
            return {"count": int(sum(counts)), "count_delta": int(n),
                    "p50_s": percentile_from_counts(delta, 50.0),
                    "p99_s": percentile_from_counts(delta, 99.0)}
        snap = m.snapshot()
        if not isinstance(snap, dict):
            return None
        if "value" in snap:
            v = snap["value"]
            entry = {"value": v}
            get_fn = getattr(m, "get", None)
            if callable(get_fn) and isinstance(v, (int, float)):
                # Counter: value + windowed delta
                prev = self._prev_values.get(name)
                self._prev_values[name] = v
                if prev is not None:
                    entry["delta"] = v - prev
            return entry
        # registered histogram-like object without counts(): keep its
        # lifetime snapshot fields as-is
        return {k: snap[k] for k in ("count", "p50_s", "p99_s")
                if k in snap}

    # -- reading -------------------------------------------------------- #
    def window(self, last_s: Optional[float] = None) -> list:
        """Ring rows (oldest first); ``last_s`` trims to the trailing
        wall-clock window — how the flight recorder asks for "the
        minute around the incident"."""
        with self._lock:
            rows = list(self._rows)
        if last_s is not None and rows:
            cutoff = rows[-1]["t_unix"] - float(last_s)
            rows = [r for r in rows if r["t_unix"] >= cutoff]
        return rows

    def series(self, name: str, field: str = "value") -> list:
        """One metric's ``(t_unix, field)`` pairs across the ring —
        the plot-me accessor for bench summaries and post-mortems."""
        out = []
        for r in self.window():
            entry = r["metrics"].get(name)
            if isinstance(entry, dict) and field in entry:
                out.append((r["t_unix"], entry[field]))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    # -- threading (SLOController pattern) ------------------------------ #
    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-timeseries")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:  # pragma: no cover - belt and braces
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "TimeSeriesSampler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


#: process-wide sampler slot — None until something (a load sweep, the
#: flight recorder CLI) installs one; the flight
#: recorder embeds its window when present and degrades to [] when not
_GLOBAL: Optional[TimeSeriesSampler] = None
_global_lock = threading.Lock()


def get_sampler() -> Optional[TimeSeriesSampler]:
    return _GLOBAL


def set_sampler(sampler: Optional[TimeSeriesSampler]
                ) -> Optional[TimeSeriesSampler]:
    """Install (or clear, with None) the process-wide sampler; returns
    the previous one so callers can restore it."""
    global _GLOBAL
    with _global_lock:
        prev = _GLOBAL
        _GLOBAL = sampler
    return prev
