"""Transformer combinators (port of ``bigdl_tpu/dataset/transformer.py``:
``Transformer``, its ``>>`` chaining, ``FuncTransformer``,
``SampleToBatch`` and ``Prefetcher``).

A Transformer maps an iterator to an iterator and chains with ``>>``.
``SampleToBatch`` pads/stacks variable-length samples into MiniBatches.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

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


class FuncTransformer(Transformer):
    """A per-record map by a plain function."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def transform_one(self, x):
        return self.fn(x)


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


class Prefetcher(Transformer):
    """Run the upstream iterator on a background thread behind a bounded
    queue of ``depth`` items, so host decoding and augmentation overlap
    the device's steps.  An error upstream is raised where the consumer
    reads; a consumer that stops reading stops the worker."""

    def __init__(self, depth: int = 4):
        self.depth = depth

    def __call__(self, it: Iterator) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end, err = object(), object()

        def put(x) -> bool:
            while not stop.is_set():
                try:
                    q.put(x, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for x in it:
                    if not put(x):
                        return
            except BaseException as e:  # noqa: BLE001 - raised in consumer
                put((err, e))
                return
            put(end)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                x = q.get()
                if x is end:
                    break
                if isinstance(x, tuple) and len(x) == 2 and x[0] is err:
                    raise x[1]
                yield x
        finally:
            stop.set()
