"""Pipeline-style prediction API (port of ``bigdl_tpu/ml``; ref
org/apache/spark/ml/DLClassifier.scala and
models/utils/ModelBroadcast.scala).

The reference integrates with Spark ML as a transformer that broadcasts
a trained model to executors and maps batched forwards over DataFrame
rows (DLClassifier.scala:36-90).  Here a predictor runs one batched
eval-mode forward (``apply(..., training=False)`` under
``torch.no_grad``) on the model's device and streams any row source
through it — numpy arrays, iterables of Samples, or a DataFrame (duck
typed: anything with ``columns`` and a ``"features"`` column) — padding
the tail batch by repeating its last row, so every call has one shape.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["DLClassifier", "DLModel", "ModelBroadcast"]


class ModelBroadcast:
    """Structure/weights split for cheap model shipping
    (ref models/utils/ModelBroadcast.scala:32-90): the reference
    broadcasts the layer graph and the flattened weights separately so
    the big buffer ships once.  ``value()`` rebuilds a model shell around
    the same parameter and buffer tensors: the card's tensors are shared,
    never copied."""

    def __init__(self, model):
        import copy

        self._params = model.params
        self._buffers = model.buffers
        model_params, model_buffers = model.params, model.buffers
        model_grads = model.grad_params
        model.params, model.buffers, model.grad_params = None, {}, None
        try:
            self._structure = copy.deepcopy(model)  # paramless: cheap
        finally:
            model.params, model.buffers = model_params, model_buffers
            model.grad_params = model_grads

    def value(self):
        import copy

        model = copy.deepcopy(self._structure)
        model.params = self._params
        model.buffers = self._buffers
        return model


class DLModel:
    """Batched predictor over a trained module (the transform half of
    the reference's DLClassifier).  ``batch_shape`` mirrors the
    reference's ``batchShape`` param (DLClassifier.scala:50): (batch,
    *feature_dims)."""

    def __init__(self, model, batch_shape: Sequence[int]):
        self.model = model
        self.batch_shape = tuple(int(s) for s in batch_shape)
        model._built()

    @torch.no_grad()
    def _forward_batch(self, batch: np.ndarray) -> np.ndarray:
        model = self.model
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(model._device())
        out, _ = model.apply(model.params, x, buffers=model.buffers,
                             training=False)
        return out.float().cpu().numpy()

    def predict(self, features: Any) -> np.ndarray:
        """Raw model outputs, row-aligned with the input.

        ``features``: numpy array (n, *feature_dims), an iterable of
        feature rows, or a DataFrame holding flattenable rows."""
        rows = _as_rows(features, self.batch_shape[1:])
        bs = self.batch_shape[0]
        outs = []
        for start in range(0, len(rows), bs):
            chunk = rows[start:start + bs]
            n = len(chunk)
            if n < bs:  # pad the tail so every call has one shape
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bs - n, axis=0)], axis=0)
            outs.append(self._forward_batch(chunk)[:n])
        return np.concatenate(outs, axis=0) if outs else np.empty((0,))

    def predict_class(self, features: Any) -> np.ndarray:
        """1-based class predictions (the reference emits max-index+1 into
        the prediction column, DLClassifier.scala:79-86)."""
        out = self.predict(features)
        if out.size == 0:
            return np.empty((0,), dtype=np.int64)
        return np.argmax(out, axis=-1) + 1

    def transform(self, df):
        """DataFrame in, a copy with a 'prediction' column out (the
        Spark-ML transform contract); any object with ``columns``,
        ``copy()``, item access and item assignment will do."""
        pred = self.predict_class(
            np.stack([np.asarray(r) for r in df["features"]]))
        out = df.copy()
        out["prediction"] = pred.astype(np.float64)
        return out


class DLClassifier(DLModel):
    """Name parity with the reference's Spark-ML transformer
    (DLClassifier.scala:36).  Identical to DLModel but documents the
    classification contract: model outputs (log-)probabilities per
    class, ``transform``/``predict_class`` emit 1-based labels."""


def _as_rows(features: Any, feature_shape: tuple) -> np.ndarray:
    if hasattr(features, "columns"):  # a DataFrame
        features = [np.asarray(r) for r in features["features"]]
    if isinstance(features, np.ndarray):
        arr = features.astype(np.float32, copy=False)
    else:
        from bigdl_tpu_torch.dataset.types import Sample

        mat = []
        for row in features:
            if isinstance(row, Sample):
                row = row.feature
            mat.append(np.asarray(row, dtype=np.float32))
        arr = np.stack(mat) if mat else np.empty((0, *feature_shape),
                                                 np.float32)
    if feature_shape and arr.shape[1:] != feature_shape:
        arr = arr.reshape((arr.shape[0], *feature_shape))
    return arr
