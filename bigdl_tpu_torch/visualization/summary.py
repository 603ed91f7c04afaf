"""Training/validation TensorBoard summaries (port of
``bigdl_tpu/visualization/summary.py``).

Rebuild of ``utils/Summary.scala:33-287``: ``TrainSummary`` writes to
``<logdir>/<app>/train`` with per-tag triggers (LearningRate/Loss/
Throughput default every iteration; "Parameters" histograms opt-in because
pulling full parameters is expensive); ``ValidationSummary`` writes to
``<logdir>/<app>/validation``.  Histograms use the reference's exponential
buckets (1549 edges, geometric ratio 1.1 from ±1e-12, Summary.scala:270-282).
"""
from __future__ import annotations

import bisect
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .proto import HistogramProto, SummaryValue
from .reader import read_scalar as _read_scalar
from .writer import FileWriter


def _make_buckets() -> List[float]:
    pos = []
    v = 1e-12
    for _ in range(774):
        pos.append(v)
        v *= 1.1
    return [-x for x in reversed(pos)] + [0.0] + pos


_BUCKETS = _make_buckets()


def scalar(tag: str, value: float) -> SummaryValue:
    return SummaryValue(tag=tag, simple_value=float(value))


def histogram(tag: str, values) -> SummaryValue:
    arr = np.asarray(values, dtype=np.float64).ravel()
    h = HistogramProto()
    if arr.size:
        h.min = float(arr.min())
        h.max = float(arr.max())
        h.num = float(arr.size)
        h.sum = float(arr.sum())
        h.sum_squares = float((arr * arr).sum())
        idx = np.searchsorted(_BUCKETS, arr, side="left")
        counts = np.bincount(idx, minlength=len(_BUCKETS) + 1)
        # emit only buckets up to the last non-empty one (ref Summary.scala
        # emits sparse buckets; tensorboard accepts either)
        limits, buckets = [], []
        for i in range(len(_BUCKETS)):
            c = counts[i]
            if c > 0:
                limits.append(_BUCKETS[i])
                buckets.append(float(c))
        if counts[len(_BUCKETS)] > 0:
            limits.append(float("inf"))
            buckets.append(float(counts[len(_BUCKETS)]))
        if not limits:
            limits, buckets = [0.0], [0.0]
        h.bucket_limit = limits
        h.bucket = buckets
    return SummaryValue(tag=tag, histo=h)


class Summary:
    """Base logger bound to one tfevents folder."""

    def __init__(self, log_dir: str, app_name: str, sub_folder: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self.folder = os.path.join(log_dir, app_name, sub_folder)
        self.writer = FileWriter(self.folder)

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_summary(scalar(tag, value), step)
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.add_summary(histogram(tag, values), step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float, float]]:
        self.writer.flush()
        return _read_scalar(self.folder, tag)

    def flush(self) -> "Summary":
        self.writer.flush()
        return self

    def close(self) -> None:
        self.writer.close()


class TrainSummary(Summary):
    _SCALAR_TAGS = ("LearningRate", "Loss", "Throughput")
    _ALL_TAGS = _SCALAR_TAGS + ("Parameters",)

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        from bigdl_tpu_torch.optim.trigger import Trigger
        self._triggers: Dict[str, object] = {
            tag: Trigger.several_iteration(1) for tag in self._SCALAR_TAGS}

    def set_summary_trigger(self, tag: str, trigger) -> "TrainSummary":
        if tag not in self._ALL_TAGS:
            raise ValueError(
                "TrainSummary: only support LearningRate, Loss, Parameters "
                f"and Throughput, got {tag!r}")
        self._triggers[tag] = trigger
        return self

    def get_summary_trigger(self, tag: str):
        return self._triggers.get(tag)

    def should_record(self, tag: str, state) -> bool:
        trig = self._triggers.get(tag)
        return trig is not None and trig(state)


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


class ServingSummary(Summary):
    """Inference-side logger: serving dashboards land in
    ``<logdir>/<app>/serving`` next to the train/validation folders."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "serving")


class ObsSummary(Summary):
    """Whole-registry logger: ``obs.get_registry().export_to_summary``
    writes every registered counter/gauge/histogram here — the unified
    snapshot (training phase counters + serving latency percentiles in
    one folder, ``<logdir>/<app>/obs``)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "obs")
