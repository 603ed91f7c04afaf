"""Triggers: predicates over the training state (port of
``bigdl_tpu/optim/trigger.py``, ref optim/Trigger.scala:22-70)."""
from __future__ import annotations

from typing import Callable


class Trigger:
    def __init__(self, fn: Callable[[dict], bool], name: str = "trigger"):
        self._fn = fn
        self.name = name

    def __call__(self, state: dict) -> bool:
        return self._fn(state)

    # -- factories (same four as the reference) -------------------------- #
    @staticmethod
    def every_epoch() -> "Trigger":
        """Fires when the epoch number just advanced (the optimizer sets
        'epoch_finished' at epoch rollover)."""
        return Trigger(lambda s: s.get("epoch_finished", False), "every_epoch")

    @staticmethod
    def several_iteration(interval: int) -> "Trigger":
        return Trigger(lambda s: s["neval"] % interval == 0, f"several_iteration({interval})")

    @staticmethod
    def max_epoch(maximum: int) -> "Trigger":
        return Trigger(lambda s: s["epoch"] > maximum, f"max_epoch({maximum})")

    @staticmethod
    def max_iteration(maximum: int) -> "Trigger":
        return Trigger(lambda s: s["neval"] > maximum, f"max_iteration({maximum})")

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in triggers), "and")

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers), "or")
