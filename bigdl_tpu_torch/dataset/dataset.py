"""DataSet sources (port of ``bigdl_tpu/dataset/dataset.py``: arrays,
image folders and packed record files, local or distributed).

``LocalArrayDataSet`` holds in-memory records with an epoch reshuffle
drawn from the Torch-compatible MT19937 (``utils/rng.py``), so the same
seed gives the JAX package's record order.  ``DistributedDataSet`` is
one rank's shard of a global record list: rank r of a world of W holds
``records[r::W]``, shuffled from seed ``seed + r``.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

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


class DistributedDataSet(AbstractDataSet):
    """One rank's shard of a global dataset (ref DistributedDataSet
    :163 and CachedDistriDataSet :202-262): the global record list split
    round-robin across the ranks of ``torch.distributed`` (rank 0 of a
    world of one when no world runs), so every rank holds about 1/W of
    the data and only ever touches its own shard."""

    def __init__(self, records: Sequence, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, seed: int = 1):
        import torch.distributed as dist
        running = dist.is_available() and dist.is_initialized()
        pi = (dist.get_rank() if running else 0) \
            if process_index is None else process_index
        pc = (dist.get_world_size() if running else 1) \
            if process_count is None else process_count
        self.global_size = len(records)
        self.local = LocalArrayDataSet(list(records)[pi::pc], seed=seed + pi)
        self.process_index = pi
        self.process_count = pc

    def size(self) -> int:
        return self.global_size

    def local_size(self) -> int:
        return self.local.size()

    def shuffle(self) -> None:
        self.local.shuffle()

    def data(self, train: bool) -> Iterator:
        return self.local.data(train)


def is_distributed(dataset: AbstractDataSet) -> bool:
    """Whether ``dataset`` reads a ``DistributedDataSet`` (under any
    number of transformers)."""
    while isinstance(dataset, TransformedDataSet):
        dataset = dataset.source
    return isinstance(dataset, DistributedDataSet)


class DataSet:
    """Factories (ref DataSet.scala object)."""

    @staticmethod
    def array(records: Sequence, distributed: bool = False,
              seed: int = 1) -> AbstractDataSet:
        if distributed:
            return DistributedDataSet(records, seed=seed)
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

    @staticmethod
    def record_files(paths: Sequence[str],
                     distributed: bool = False) -> AbstractDataSet:
        """Dataset over packed record files: the repo's own shards and
        Hadoop SequenceFiles (``*.seq``, the reference's ImageNet layout
        with its compressed flavors), dispatched per file on the name,
        so the two mix in one dataset.  Records are the raw (bytes,
        label) pairs."""
        from bigdl_tpu_torch.dataset.hadoop_seqfile import file_records
        from bigdl_tpu_torch.dataset.seqfile import read_shard
        all_records = []
        for f in list(paths):
            if f.endswith(".seq"):
                all_records.extend(file_records(f))
            else:
                all_records.extend(read_shard(f))
        return DataSet.array(all_records, distributed=distributed)
