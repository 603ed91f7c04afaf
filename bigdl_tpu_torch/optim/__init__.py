"""Training loop, optimization methods, schedules, triggers and
validation (port of ``bigdl_tpu/optim``; ``Adagrad``, ``LBFGS`` and the
distributed optimizer are ROADMAP Queue 1 item 12)."""
from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, AdamW, Default,
                                                EpochDecay, EpochSchedule,
                                                EpochStep,
                                                LearningRateSchedule,
                                                OptimMethod, Poly, Regime,
                                                Step)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, LocalValidator,
                                             Optimizer,
                                             accumulated_loss_and_grads,
                                             loss_and_grads)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Perplexity,
                                              PerplexityResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adam", "AdamW", "Default", "EpochDecay",
           "EpochSchedule", "EpochStep", "LearningRateSchedule",
           "LocalOptimizer", "LocalValidator", "Loss", "LossResult",
           "OptimMethod", "Optimizer", "Perplexity", "PerplexityResult",
           "Poly", "Regime", "SGD", "Step", "Top1Accuracy", "Top5Accuracy",
           "Trigger", "ValidationMethod", "ValidationResult",
           "accumulated_loss_and_grads", "loss_and_grads"]
