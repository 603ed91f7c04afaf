"""Serving metrics: latency histograms, throughput, batch occupancy
(port of ``bigdl_tpu/serving/metrics.py``).

Per-request latency is split where a serving engineer needs it split —
queue wait (batching-policy cost) vs device time (model cost) — each a
log-spaced histogram with percentile estimation, plus counters for
throughput, batch occupancy (how full the padded bucket actually was)
and the compile-cache hit rate.  ``export_to_summary`` writes the
snapshot through the existing ``visualization`` tfevents writers, so
serving dashboards land next to the training ones.

The histogram class lives in :mod:`bigdl_tpu_torch.obs.registry` (it is the
registry's generic log-bucket ``Histogram``); ``LatencyHistogram``
stays importable from here for compatibility.  ``publish_to`` exposes
an engine's live histograms/counters in the process-wide registry.

``throughput_eps`` is computed over a sliding window (default 60s), so
an idle gap stops depressing the number the moment traffic resumes;
the lifetime average — the old semantics, examples since engine start —
is kept under ``throughput_eps_lifetime``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from bigdl_tpu_torch.obs.registry import (_EDGES, FnGauge,  # noqa: F401
                                    Histogram as LatencyHistogram,
                                    MetricRegistry)


class ServingMetrics:
    """One engine's counters; thread-safe (batcher worker + callers)."""

    def __init__(self, throughput_window_s: float = 60.0):
        self._lock = threading.Lock()
        self.queue_wait = LatencyHistogram()
        self.device_time = LatencyHistogram()
        self.total_latency = LatencyHistogram()
        self.requests = 0          # accepted submissions
        self.rejected = 0          # backpressure rejections
        self.examples = 0          # examples completed
        self.batches = 0           # device dispatches
        self.batch_examples = 0    # real examples across dispatches
        self.padded_examples = 0   # bucket slots across dispatches
        self.started_at = time.perf_counter()
        self._window_s = float(throughput_window_s)
        self._recent: deque = deque()  # (t_done, n_examples) per dispatch

    # -- registry wiring ------------------------------------------------ #
    def publish_to(self, registry: MetricRegistry,
                   prefix: str = "serving/") -> "ServingMetrics":
        """Register the live histograms and computed counters in the
        process-wide registry (latest engine wins the names)."""
        registry.register(prefix + "queue_wait", self.queue_wait,
                          replace=True)
        registry.register(prefix + "device_time", self.device_time,
                          replace=True)
        registry.register(prefix + "total_latency", self.total_latency,
                          replace=True)
        for key in ("requests", "rejected", "examples", "batches"):
            registry.register(prefix + key,
                              FnGauge(lambda k=key: getattr(self, k)),
                              replace=True)
        registry.register(prefix + "throughput_eps",
                          FnGauge(lambda: self.snapshot()["throughput_eps"]),
                          replace=True)
        return self

    # -- recording ------------------------------------------------------ #
    def record_submit(self) -> None:
        with self._lock:
            self.requests += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_batch(self, n_examples: int, bucket: int,
                     queue_waits_s, device_s: float) -> None:
        with self._lock:
            now = time.perf_counter()
            self.batches += 1
            self.examples += n_examples
            self.batch_examples += n_examples
            self.padded_examples += bucket
            self._recent.append((now, n_examples))
            self._evict(now)
            self.device_time.observe(device_s)
            for w in queue_waits_s:
                self.queue_wait.observe(w)

    def record_done(self, total_s: float) -> None:
        with self._lock:
            self.total_latency.observe(total_s)

    def _evict(self, now: float) -> None:
        horizon = now - self._window_s
        while self._recent and self._recent[0][0] < horizon:
            self._recent.popleft()

    # -- reading -------------------------------------------------------- #
    def snapshot(self, cache_stats: Optional[dict] = None) -> dict:
        with self._lock:
            now = time.perf_counter()
            elapsed = now - self.started_at
            self._evict(now)
            # sliding-window rate: examples completed in the last
            # window, over the window actually covered (a young engine
            # divides by its age, not the full window)
            span = min(elapsed, self._window_s)
            windowed = sum(n for _, n in self._recent)
            snap = {
                "requests": self.requests,
                "rejected": self.rejected,
                "examples": self.examples,
                "batches": self.batches,
                "throughput_eps": (windowed / span) if span > 0 else 0.0,
                "throughput_window_s": self._window_s,
                "throughput_eps_lifetime":
                    (self.examples / elapsed) if elapsed > 0 else 0.0,
                "batch_occupancy": (self.batch_examples / self.padded_examples)
                                   if self.padded_examples else None,
                "mean_batch_size": (self.batch_examples / self.batches)
                                   if self.batches else None,
                "queue_wait": self.queue_wait.snapshot(),
                "device_time": self.device_time.snapshot(),
                "total_latency": self.total_latency.snapshot(),
            }
        if cache_stats is not None:
            snap["compile_cache"] = dict(cache_stats)
        return snap

    def export_to_summary(self, summary, step: int,
                          cache_stats: Optional[dict] = None) -> None:
        """Write the scalar snapshot through a ``visualization.Summary``
        (tfevents) writer under ``Serving/*`` tags."""
        snap = self.snapshot(cache_stats)
        flat: Dict[str, Optional[float]] = {
            "Serving/Requests": snap["requests"],
            "Serving/Rejected": snap["rejected"],
            "Serving/ThroughputEPS": snap["throughput_eps"],
            "Serving/ThroughputEPSLifetime": snap["throughput_eps_lifetime"],
            "Serving/BatchOccupancy": snap["batch_occupancy"],
            "Serving/QueueWaitP50": snap["queue_wait"]["p50_s"],
            "Serving/QueueWaitP99": snap["queue_wait"]["p99_s"],
            "Serving/DeviceTimeP50": snap["device_time"]["p50_s"],
            "Serving/DeviceTimeP99": snap["device_time"]["p99_s"],
            "Serving/LatencyP50": snap["total_latency"]["p50_s"],
            "Serving/LatencyP99": snap["total_latency"]["p99_s"],
        }
        cache = snap.get("compile_cache") or {}
        if cache.get("hit_rate") is not None:
            flat["Serving/CacheHitRate"] = cache["hit_rate"]
        for tag, value in flat.items():
            if value is not None:
                summary.add_scalar(tag, float(value), step)
        summary.flush()
