"""MNIST reader (port of ``bigdl_tpu/dataset/mnist.py``): the standard
IDX files from a folder (``load`` never downloads), or ``synthetic``
records when no files are at hand."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from bigdl_tpu_torch.dataset.types import ByteRecord

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        return np.frombuffer(f.read(n * rows * cols),
                             dtype=np.uint8).reshape(n, rows, cols)


def read_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def load(folder: str, train: bool = True) -> list:
    """(bytes, 1-based label) records from the IDX files in ``folder``."""
    prefix = "train" if train else "t10k"
    img_path = lbl_path = None
    for c in (f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"):
        for suffix in ("", ".gz"):
            p = os.path.join(folder, c + suffix)
            if os.path.exists(p):
                img_path = p
                lbl_path = p.replace("images-idx3", "labels-idx1").replace(
                    "images.idx3", "labels.idx1")
    if img_path is None or not os.path.exists(lbl_path):
        raise FileNotFoundError(f"MNIST IDX files not found under {folder}")
    images = read_images(img_path)
    labels = read_labels(lbl_path)
    return [ByteRecord(images[i].tobytes(), float(labels[i]) + 1.0)
            for i in range(len(labels))]


def synthetic(n: int = 1024, seed: int = 0, jitter: int = 0) -> list:
    """Deterministic MNIST-shaped records with a class-dependent bright
    block, so a model can learn them; ``jitter`` shifts each block by a
    random offset in [-jitter, jitter].  The same seed gives the
    reference's records byte for byte."""
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        label = i % 10
        img = rng.randint(0, 50, size=(28, 28)).astype(np.uint8)
        r, c = divmod(label, 4)
        r0, c0 = r * 8, c * 7
        if jitter:
            r0 = int(np.clip(r0 + rng.randint(-jitter, jitter + 1), 0, 20))
            c0 = int(np.clip(c0 + rng.randint(-jitter, jitter + 1), 0, 21))
        img[r0:r0 + 8, c0:c0 + 7] += 180
        records.append(ByteRecord(img.tobytes(), float(label) + 1.0))
    return records
