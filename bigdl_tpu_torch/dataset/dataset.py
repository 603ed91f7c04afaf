"""DataSet sources (port of ``bigdl_tpu/dataset/dataset.py``, local
datasets only).

``LocalArrayDataSet`` holds in-memory records with an epoch reshuffle
drawn from the Torch-compatible MT19937 (``utils/rng.py``), so the same
seed gives the JAX package's record order.
"""
from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.rng import RandomGenerator


class AbstractDataSet:
    """data(train) / shuffle / size / transform (ref DataSet.scala:46-84)."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        pass

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "TransformedDataSet":
        return self.transform(transformer)


class TransformedDataSet(AbstractDataSet):
    def __init__(self, source: AbstractDataSet, transformer: Transformer):
        self.source = source
        self.transformer = transformer

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.source.data(train))

    def size(self) -> int:
        return self.source.size()

    def shuffle(self) -> None:
        self.source.shuffle()


class LocalDataSet(AbstractDataSet):
    """Marker base for single-host datasets (ref DataSet.scala:110)."""


class LocalArrayDataSet(LocalDataSet):
    """In-memory records; train iteration is infinite over a permuted index
    (one permutation per shuffle/epoch), eval iteration is one pass."""

    def __init__(self, records: Sequence, seed: int = 1):
        self.records = list(records)
        self._rng = RandomGenerator(seed)
        self._perm = np.arange(len(self.records))

    def size(self) -> int:
        return len(self.records)

    def shuffle(self) -> None:
        n = len(self.records)
        self._perm = self._rng.randperm(n) - 1  # randperm is 1-based

    def data(self, train: bool) -> Iterator:
        if train:
            def infinite():
                while True:
                    for i in self._perm:
                        yield self.records[int(i)]
            return infinite()
        return iter(self.records)


class DataSet:
    """Factories (ref DataSet.scala object)."""

    @staticmethod
    def array(records: Sequence, distributed: bool = False,
              seed: int = 1) -> AbstractDataSet:
        if distributed:
            raise NotImplementedError(
                "distributed datasets are not ported yet (ROADMAP Queue 1 "
                "item 12, 12-DIST: DistriOptimizer)")
        return LocalArrayDataSet(records, seed=seed)

    @staticmethod
    def image_folder(path: str, distributed: bool = False) -> AbstractDataSet:
        """Scan <path>/<label-dir>/<img files>; labels are 1-based by
        sorted dir name (ref DataSet.ImageFolder.paths :318-378).  Returns
        records of (filepath, label)."""
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        records = []
        for li, cls in enumerate(classes, start=1):
            d = os.path.join(path, cls)
            for fname in sorted(os.listdir(d)):
                records.append((os.path.join(d, fname), float(li)))
        return DataSet.array(records, distributed=distributed)
