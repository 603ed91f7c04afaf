"""Pipeline record types (port of ``bigdl_tpu/dataset/types.py``: the
ones the language-model pipeline uses)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Sample:
    """One training example: (feature, label) host arrays."""
    feature: np.ndarray
    label: np.ndarray

    @staticmethod
    def from_ndarray(feature, label) -> "Sample":
        return Sample(np.asarray(feature, dtype=np.float32),
                      np.asarray(label, dtype=np.float32))


@dataclass
class MiniBatch:
    """A batch of stacked features/labels, host numpy arrays; the
    optimizer moves them to the device."""
    data: np.ndarray
    labels: np.ndarray

    def size(self) -> int:
        return self.data.shape[0]


@dataclass
class LabeledSentence:
    """Token-id sequence + per-step or scalar label."""
    data: np.ndarray
    label: np.ndarray

    def data_length(self) -> int:
        return len(self.data)
