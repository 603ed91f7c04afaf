"""Validation methods and monoid results (port of
``bigdl_tpu/optim/validation.py``: ``ValidationResult``,
``AccuracyResult``, ``LossResult``, ``ValidationMethod``,
``Top1Accuracy``, ``Top5Accuracy``, ``Loss``, ``PerplexityResult`` and
``Perplexity``).  Results support ``+`` so per-batch results reduce
associatively.  The accuracies take 1-based targets, count on the
output's device and read one integer a batch."""
from __future__ import annotations

import math

import torch


class ValidationResult:
    def result(self) -> tuple[float, int]:
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int):
        self.correct = int(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other: "AccuracyResult") -> "AccuracyResult":
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        acc, n = self.result()
        return (f"Accuracy(correct: {self.correct}, count: {n}, "
                f"accuracy: {acc:.6f})")


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other: "LossResult") -> "LossResult":
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        avg, n = self.result()
        return f"Loss(sum: {self.loss:.4f}, count: {n}, mean: {avg:.6f})"


class ValidationMethod:
    name = "validation"

    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


def _targets(output, target, shape):
    t = torch.as_tensor(target, device=output.device)
    return t.to(torch.int64).reshape(shape)


class Top1Accuracy(ValidationMethod):
    """argmax(output) + 1 == the 1-based target (first index on ties)
    (ref ValidationMethod.scala:90)."""
    name = "Top1Accuracy"

    def __call__(self, output, target) -> AccuracyResult:
        pred = torch.argmax(output, dim=-1) + 1
        correct = (pred == _targets(output, target, pred.shape)).sum()
        return AccuracyResult(int(correct), pred.numel())


class Top5Accuracy(ValidationMethod):
    """The 1-based target among the five largest outputs, ranked by a
    stable sort of ``-output`` as the reference's ``argsort``."""
    name = "Top5Accuracy"

    def __call__(self, output, target) -> AccuracyResult:
        top5 = torch.argsort(-output, dim=-1, stable=True)[..., :5] + 1
        t = _targets(output, target, top5.shape[:-1] + (1,))
        correct = (top5 == t).any(dim=-1).sum()
        return AccuracyResult(int(correct), top5[..., 0].numel())


class Loss(ValidationMethod):
    """Criterion value over the batch (ref ValidationMethod.scala:207)."""
    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterions import ClassNLLCriterion
        self.criterion = criterion if criterion is not None else ClassNLLCriterion()

    def __call__(self, output, target) -> LossResult:
        return LossResult(float(self.criterion.loss(output, target)), 1)


class PerplexityResult(ValidationResult):
    """exp of the mean criterion value; the loss sum accumulates, so
    ``+`` stays exact, and ``exp`` is taken in ``result()``."""

    def __init__(self, loss: float, count: int):
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        return (math.exp(self.loss / max(self.count, 1)), self.count)

    def __add__(self, other: "PerplexityResult") -> "PerplexityResult":
        return PerplexityResult(self.loss + other.loss,
                                self.count + other.count)

    def __repr__(self):
        ppl, n = self.result()
        return f"Perplexity(count: {n}, perplexity: {ppl:.4f})"


class Perplexity(ValidationMethod):
    """Per-batch perplexity of a (time-distributed) NLL criterion; the
    default takes the LM's (B, T, V) log-probabilities."""
    name = "Perplexity"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterions import (ClassNLLCriterion,
                                                   TimeDistributedCriterion)
        self.criterion = (criterion if criterion is not None
                          else TimeDistributedCriterion(ClassNLLCriterion(),
                                                        True))

    def __call__(self, output, target) -> PerplexityResult:
        return PerplexityResult(float(self.criterion.loss(output, target)), 1)
