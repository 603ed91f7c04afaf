"""Criterions (port of ``bigdl_tpu/nn/criterions.py``:
``ClassNLLCriterion`` and ``TimeDistributedCriterion``).

Conventions preserved from Torch/BigDL: class targets are **1-based**;
``size_average=True`` (the default) means mean-reduction over the batch.
``loss(output, target)`` is a differentiable torch expression; both
derive from :class:`~bigdl_tpu_torch.nn.module.Criterion`, whose shell
adds ``forward``/``backward``.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Criterion


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities, 1-based integer
    targets, optional per-class weights."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
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
