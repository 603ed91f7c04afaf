"""Criterions (port of ``bigdl_tpu/nn/criterions.py``: the 24 losses of
the reference's ``nn/``).

Conventions preserved from Torch/BigDL: class targets are **1-based**;
``size_average=True`` (the default) means mean-reduction over the batch.
``loss(output, target)`` is a differentiable torch expression, so the
gradient is autograd's where the reference's is ``jax.grad``; every
class derives from :class:`~bigdl_tpu_torch.nn.module.Criterion`, whose
shell adds ``forward``/``backward``.  A target may be a tensor, a numpy
array (float64 read as float32, as JAX reads it) or, for the table
criterions, a Table, list or tuple of them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.utils.table import Table


def _seq(x):
    return x.to_seq() if isinstance(x, Table) else list(x)


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


def _like(target, output):
    """``target`` as a tensor on ``output``'s device; float64 becomes
    float32 (64-bit is off in the reference)."""
    t = torch.as_tensor(target, device=output.device)
    return t.float() if t.dtype == torch.float64 else t


def _weights(weights):
    return None if weights is None else torch.as_tensor(
        np.asarray(weights, np.float32))


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities, 1-based integer
    targets, optional per-class weights."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def loss(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        if output.dim() == 1:
            output = output[None]
            target = target.reshape(1)
        idx = target.to(torch.int64) - 1
        picked = output.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(output.device)[idx]
            total = -(w * picked).sum()
            return total / w.sum() if self.size_average else total
        return _reduce(-picked, self.size_average)

    def _flat_time_reduction(self) -> Optional[str]:
        if self.weights is not None:
            # weighted size_average normalizes by each call's own weight
            # sum: flattening changes the normalizer; the weighted SUM
            # has no normalizer and flattens exactly
            return None if self.size_average else "sum"
        return "mean" if self.size_average else "sum"


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused (ref nn/CrossEntropyCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self._nll = ClassNLLCriterion(weights, size_average)

    def loss(self, output, target):
        return self._nll.loss(F.log_softmax(output, dim=-1), target)

    def _flat_time_reduction(self):
        return self._nll._flat_time_reduction()  # softmax is per-row


class MSECriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce(torch.square(output - _like(target, output)),
                       self.size_average)

    def _flat_time_reduction(self):
        # mean/sum over all elements: equal per-timestep element counts
        # make the flattened call value-identical
        return "mean" if self.size_average else "sum"


class AbsCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce(torch.abs(output - _like(target, output)),
                       self.size_average)


class BCECriterion(Criterion):
    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def loss(self, output, target):
        eps = 1e-12
        target = _like(target, output)
        per = -(target * torch.log(output + eps)
                + (1 - target) * torch.log(1 - output + eps))
        if self.weights is not None:
            per = per * self.weights.to(output.device)
        return _reduce(per, self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || output) with output already log-probabilities
    (ref nn/DistKLDivCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        target = _like(target, output)
        per = torch.where(
            target > 0,
            target * (torch.log(torch.clamp_min(target, 1e-12)) - output),
            torch.zeros((), dtype=output.dtype, device=output.device))
        return _reduce(per, self.size_average)


class SmoothL1Criterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        d = torch.abs(output - _like(target, output))
        per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return _reduce(per, self.size_average)


class SmoothL1CriterionWithWeights(Criterion):
    """Detection-style smooth-L1 with sigma scaling and inside/outside
    weights (ref nn/SmoothL1CriterionWithWeights.scala).  Target is a
    table {bbox_target, inside_w, outside_w}; ``num`` normalizes the
    sum."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def loss(self, output, target):
        tgt, in_w, out_w = (_like(t, output) for t in _seq(target))
        d = in_w * (output - tgt)
        ad = torch.abs(d)
        per = torch.where(ad < 1.0 / self.sigma2,
                          0.5 * self.sigma2 * d * d,
                          ad - 0.5 / self.sigma2)
        total = (out_w * per).sum()
        return total / self.num if self.num > 0 else total


class MarginCriterion(Criterion):
    """Hinge: max(0, margin - y*x) (ref nn/MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce(torch.clamp_min(
            self.margin - output * _like(target, output), 0.0),
            self.size_average)


class MarginRankingCriterion(Criterion):
    """max(0, -y*(x1-x2) + margin) over table input {x1, x2}
    (ref nn/MarginRankingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        x1, x2 = _seq(output)
        y = _like(target[1] if isinstance(target, Table) else target, x1)
        return _reduce(torch.clamp_min(-y * (x1 - x2) + self.margin, 0.0),
                       self.size_average)


class MultiMarginCriterion(Criterion):
    """Multiclass hinge loss, p in {1,2}
    (ref nn/MultiMarginCriterion.scala)."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p = p
        self.weights = _weights(weights)
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        if output.dim() == 1:
            output = output[None]
            target = target.reshape(1)
        n, c = output.shape
        idx = target.to(torch.int64) - 1
        x_y = output.gather(1, idx[:, None])
        m = torch.clamp_min(self.margin - x_y + output, 0.0)
        if self.p == 2:
            m = m * m
        if self.weights is not None:
            m = m * self.weights.to(output.device)[idx][:, None]
        not_target = (torch.arange(c, device=output.device)[None, :]
                      != idx[:, None])
        per = torch.where(not_target, m, torch.zeros_like(m)).sum(1) / c
        return _reduce(per, self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """Torch multilabel hinge: per sample, targets are 1-based class
    indices padded with 0 (ref nn/MultiLabelMarginCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        if output.dim() == 1:
            output = output[None]
            target = target[None]
        n, c = output.shape
        tgt = target.to(torch.int64)
        # valid targets: nonzero entries before the first zero
        first_zero = torch.cumsum((tgt == 0).to(torch.int64), dim=1) > 0
        valid = (tgt > 0) & ~first_zero
        idx0 = torch.clamp(tgt - 1, 0, c - 1)
        # membership by comparison, not scatter: a padding slot clamped
        # onto a real target's index must not unmark it
        classes = torch.arange(c, device=output.device)
        is_target = (valid[:, :, None]
                     & (idx0[:, :, None] == classes)).any(dim=1)
        zero = torch.zeros((), dtype=output.dtype, device=output.device)
        x_t = torch.where(valid, output.gather(1, idx0), zero)  # (n, K)
        # for each valid target t and non-target j: max(0, 1 - (x_t - x_j))
        hinge = torch.clamp_min(1.0 - x_t[:, :, None] + output[:, None, :],
                                0.0)
        mask = valid[:, :, None] & ~is_target[:, None, :]
        per = torch.where(mask, hinge, zero).sum(dim=(1, 2)) / c
        return _reduce(per, self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid + BCE multilabel loss
    (ref nn/MultiLabelSoftMarginCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def loss(self, output, target):
        target = _like(target, output)
        per = F.softplus(-output) * target + F.softplus(output) * (1 - target)
        if self.weights is not None:
            per = per * self.weights.to(output.device)
        if output.dim() > 1:
            per = per.sum(-1) / output.shape[-1]
        return _reduce(per, self.size_average)


class SoftMarginCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce(F.softplus(-output * _like(target, output)),
                       self.size_average)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        per = torch.where(_like(target, output) == 1, output,
                          torch.clamp_min(self.margin - output, 0.0))
        return _reduce(per, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Hinge on the L1 distance of a pair {x1, x2}
    (ref nn/L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def loss(self, output, target):
        x1, x2 = _seq(output)
        d = torch.abs(x1 - x2).sum()
        y = _like(target, x1).reshape(())
        return torch.where(y == 1, d, torch.clamp_min(self.margin - d, 0.0))


class CosineEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def loss(self, output, target):
        x1, x2 = _seq(output)
        if x1.dim() == 1:
            x1, x2 = x1[None], x2[None]
        y = _like(target[1] if isinstance(target, Table) else target,
                  x1).reshape(-1)
        norms = (torch.linalg.vector_norm(x1, dim=-1)
                 * torch.linalg.vector_norm(x2, dim=-1))
        cos = (x1 * x2).sum(-1) / torch.clamp_min(norms, 1e-12)
        per = torch.where(y == 1, 1.0 - cos,
                          torch.clamp_min(cos - self.margin, 0.0))
        return _reduce(per, self.size_average)


def build_simplex(n: int) -> np.ndarray:
    """n unit vectors in R^n with pairwise dot -1/n (the reference's
    Cholesky-style recursive construction, float64, stored float32)."""
    mat = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        mat[k, k] = np.sqrt(max(1.0 - float(np.dot(mat[k, :k], mat[k, :k])),
                                0.0))
        if mat[k, k] > 0:
            for c in range(k + 1, n):
                mat[c, k] = (-1.0 / n - float(np.dot(mat[k, :k], mat[c, :k]))
                             ) / mat[k, k]
    return mat.astype(np.float32)


class ClassSimplexCriterion(Criterion):
    """MSE against a regular-simplex embedding of the target class
    (ref nn/ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.simplex = torch.from_numpy(build_simplex(n_classes))

    def loss(self, output, target):
        idx = torch.as_tensor(target, device=output.device).to(
            torch.int64) - 1
        tgt = self.simplex.to(output.device)[idx]
        return torch.square(output - tgt).mean()


class L1Cost(Criterion):
    """Sum of absolute values; target ignored (ref nn/L1Cost.scala)."""

    def loss(self, output, target=None):
        return torch.abs(output).sum()


class SoftmaxWithCriterion(Criterion):
    """Caffe SoftmaxWithLoss: softmax + NLL with ignore_label and
    normalization modes (ref nn/SoftmaxWithCriterion.scala).  Input is
    (N, C, ...) raw scores; the target holds 1-based classes and
    ``ignore_label`` is compared with it as given."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def loss(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        logp = F.log_softmax(output, dim=1)
        idx = target.to(torch.int64) - 1
        picked = logp.gather(1, idx[:, None]).squeeze(1)
        if self.ignore_label is not None:
            validm = target.to(torch.int32) != self.ignore_label
            picked = torch.where(validm, picked, torch.zeros_like(picked))
            count = validm.sum()
        else:
            count = picked.numel()
        total = -picked.sum()
        if self.normalize_mode == "VALID":
            return total / (torch.clamp_min(count, 1)
                            if isinstance(count, torch.Tensor)
                            else max(count, 1))
        if self.normalize_mode == "BATCH_SIZE":
            return total / output.shape[0]
        if self.normalize_mode == "FULL":
            return total / picked.numel()
        return total  # NONE


class ParallelCriterion(Criterion):
    """Weighted sum of member criterions applied to corresponding
    input/target table slots (ref nn/ParallelCriterion.scala)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.repeat_target = repeat_target
        self.criterions: list = []
        self.weights: list = []

    def add(self, criterion, weight: float = 1.0) -> "ParallelCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def loss(self, output, target):
        outs = _seq(output)
        tgts = [target] * len(outs) if self.repeat_target else _seq(target)
        total = 0.0
        for crit, w, o, t in zip(self.criterions, self.weights, outs, tgts):
            total = total + w * crit.loss(o, t)
        return total


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same input/target
    (ref nn/MultiCriterion.scala)."""

    def __init__(self):
        super().__init__()
        self.criterions: list = []
        self.weights: list = []

    def add(self, criterion, weight: float = 1.0) -> "MultiCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def loss(self, output, target):
        total = 0.0
        for crit, w in zip(self.criterions, self.weights):
            total = total + w * crit.loss(output, target)
        return total


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (batch, time, ...) output."""

    def __init__(self, criterion, size_average: bool = False):
        super().__init__()
        self.criterion = criterion
        self.size_average = size_average

    def loss(self, output, target):
        target = torch.as_tensor(target, device=output.device)
        t_steps = output.shape[1]
        if t_steps == 0:
            return torch.zeros((), dtype=torch.float32, device=output.device)
        red = getattr(self.criterion, "_flat_time_reduction", lambda: None)()
        if red is not None:
            # one flattened call; a "mean" inner loss recovers the
            # per-timestep SUM as flat_mean * T (equal counts per step)
            flat = self.criterion.loss(
                output.reshape((-1,) + tuple(output.shape[2:])),
                target.reshape((-1,) + tuple(target.shape[2:])))
            if red == "mean":
                return flat if self.size_average else flat * t_steps
            return flat / t_steps if self.size_average else flat
        # generic criterion: one call per timestep, summed in float32 and
        # returned in the inner loss's own dtype
        losses = [self.criterion.loss(output[:, t], target[:, t])
                  for t in range(t_steps)]
        total = torch.stack([x.float() for x in losses]).sum().to(
            losses[0].dtype)
        return total / t_steps if self.size_average else total


class CriterionTable(Criterion):
    """Wrap a criterion so (input, target) both come from one table
    (ref nn/CriterionTable.scala)."""

    def __init__(self, criterion):
        super().__init__()
        self.criterion = criterion

    def loss(self, output, target=None):
        xs = _seq(output)
        return self.criterion.loss(xs[0], xs[1] if len(xs) > 1 else target)
