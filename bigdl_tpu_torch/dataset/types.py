"""Pipeline record types (port of ``bigdl_tpu/dataset/types.py``)."""
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
class ByteRecord:
    """Raw bytes and a label (ref dataset/Types.scala:80)."""
    data: bytes
    label: float


@dataclass
class LabeledImage:
    """A decoded image, (C, H, W) float32, and its 1-based label; grey
    images have one channel, BGR ones three."""
    data: np.ndarray
    label: float

    @property
    def width(self) -> int:
        return self.data.shape[2]

    @property
    def height(self) -> int:
        return self.data.shape[1]

    @property
    def channels(self) -> int:
        return self.data.shape[0]


@dataclass
class LabeledSentence:
    """Token-id sequence + per-step or scalar label."""
    data: np.ndarray
    label: np.ndarray

    def data_length(self) -> int:
        return len(self.data)
