"""CIFAR-10 reader (port of ``bigdl_tpu/dataset/cifar.py``): the python
pickle batches from a folder, or ``synthetic`` records when no files
are at hand."""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from bigdl_tpu_torch.dataset.types import LabeledImage

# per-channel BGR train statistics (pixel scale 0..255)
TRAIN_MEAN = (113.86538318359375, 122.950394140625, 125.306918046875)
TRAIN_STD = (66.70489964063091, 62.08870764001421, 62.993219278136884)


def _records_from_arrays(data: np.ndarray, labels,
                         count: Optional[int] = None) -> list:
    n = len(labels) if count is None else min(count, len(labels))
    out = []
    for i in range(n):
        chw_bgr = data[i].reshape(3, 32, 32).astype(np.float32)[::-1]
        out.append(LabeledImage(np.ascontiguousarray(chw_bgr),
                                float(labels[i]) + 1.0))
    return out


def load(folder: str, train: bool = True) -> list:
    """LabeledImages from the 'cifar-10-batches-py' layout under
    ``folder`` (or ``folder`` itself)."""
    d = folder
    if os.path.isdir(os.path.join(folder, "cifar-10-batches-py")):
        d = os.path.join(folder, "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    records = []
    for name in names:
        with open(os.path.join(d, name), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        records.extend(_records_from_arrays(batch[b"data"], batch[b"labels"]))
    return records


def synthetic(n: int = 1024, seed: int = 0) -> list:
    """Deterministic CIFAR-shaped images with a class-dependent bright
    band; the same seed gives the reference's records."""
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        label = i % 10
        img = rng.randint(0, 60, size=(3, 32, 32)).astype(np.float32)
        img[label % 3, (label // 3) * 8:(label // 3) * 8 + 8, :] += 150
        records.append(LabeledImage(img, float(label) + 1.0))
    return records
