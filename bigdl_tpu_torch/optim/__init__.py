"""Training loop, optimization methods (SGD, Adagrad, Adam, AdamW and
LBFGS with its line search), schedules, triggers and validation (port of
``bigdl_tpu/optim``; the distributed optimizer is ROADMAP Queue 1 item
12)."""
from bigdl_tpu_torch.optim.optim_method import (LBFGS, SGD, Adagrad, Adam,
                                                AdamW, Default, EpochDecay,
                                                EpochSchedule, EpochStep,
                                                LearningRateSchedule,
                                                OptimMethod, Poly, Regime,
                                                Step, ls_wolfe)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, LocalValidator,
                                             Optimizer, Validator,
                                             accumulated_loss_and_grads,
                                             loss_and_grads)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Perplexity,
                                              PerplexityResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adagrad", "Adam", "AdamW", "Default",
           "EpochDecay", "EpochSchedule", "EpochStep", "LBFGS",
           "LearningRateSchedule", "LocalOptimizer", "LocalValidator", "Loss",
           "LossResult", "Metrics", "OptimMethod", "Optimizer", "Perplexity",
           "PerplexityResult", "Poly", "Regime", "SGD", "Step", "Top1Accuracy",
           "Top5Accuracy", "Trigger", "ValidationMethod", "ValidationResult",
           "Validator",
           "accumulated_loss_and_grads", "loss_and_grads", "ls_wolfe"]
