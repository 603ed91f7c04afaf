"""Validation methods and monoid results (port of
``bigdl_tpu/optim/validation.py``: ``ValidationResult``, ``LossResult``,
``ValidationMethod``, ``Loss``, ``PerplexityResult`` and
``Perplexity``).  Results support ``+`` so per-batch
results reduce associatively."""
from __future__ import annotations

import math


class ValidationResult:
    def result(self) -> tuple[float, int]:
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


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
