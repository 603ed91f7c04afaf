"""Transformer combinators (port of ``bigdl_tpu/dataset/transformer.py``:
``Transformer``, its ``>>`` chaining and ``SampleToBatch``).

A Transformer maps an iterator to an iterator and chains with ``>>``.
``SampleToBatch`` pads/stacks variable-length samples into MiniBatches.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.types import MiniBatch


class Transformer:
    """Iterator[A] -> Iterator[B]; subclasses implement __call__ or
    ``transform_one`` for per-record maps."""

    def __call__(self, it: Iterator) -> Iterator:
        return (self.transform_one(x) for x in it)

    def transform_one(self, x):
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first = first
        self.second = second

    def __call__(self, it: Iterator) -> Iterator:
        return self.second(self.first(it))


class SampleToBatch(Transformer):
    """Batch Samples into MiniBatches with optional feature/label padding to
    a fixed length (ref dataset/Transformer.scala:77-140 SampleToBatch)."""

    def __init__(self, batch_size: int, feature_padding: Optional[float] = None,
                 label_padding: Optional[float] = None,
                 fixed_length: Optional[int] = None, drop_last: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.fixed_length = fixed_length
        self.drop_last = drop_last

    def _pad_stack(self, arrays: Sequence[np.ndarray], pad_value: Optional[float]):
        if pad_value is None:
            return np.stack(arrays)
        length = self.fixed_length if self.fixed_length is not None else \
            max(a.shape[0] for a in arrays)
        out_shape = (len(arrays), length) + arrays[0].shape[1:]
        out = np.full(out_shape, pad_value, dtype=arrays[0].dtype)
        for i, a in enumerate(arrays):
            out[i, : a.shape[0]] = a[:length]
        return out

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        feats, labels = [], []
        for s in it:
            feats.append(np.asarray(s.feature))
            labels.append(np.asarray(s.label))
            if len(feats) == self.batch_size:
                yield MiniBatch(self._pad_stack(feats, self.feature_padding),
                                self._pad_stack(labels, self.label_padding))
                feats, labels = [], []
        if feats and not self.drop_last:
            yield MiniBatch(self._pad_stack(feats, self.feature_padding),
                            self._pad_stack(labels, self.label_padding))
