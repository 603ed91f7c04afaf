"""Training loop, optimization methods, triggers and validation (port
of ``bigdl_tpu/optim``, the parts the language-model training path
uses)."""
from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, AdamW, Default,
                                                LearningRateSchedule,
                                                OptimMethod)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, LocalValidator,
                                             Optimizer, loss_and_grads)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (Loss, LossResult,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["Adam", "AdamW", "Default", "LearningRateSchedule",
           "LocalOptimizer", "LocalValidator", "Loss", "LossResult",
           "OptimMethod", "Optimizer", "SGD", "Trigger", "ValidationMethod",
           "ValidationResult", "loss_and_grads"]
