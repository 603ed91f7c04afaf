"""Optimization methods (port of ``bigdl_tpu/optim/optim_method.py``:
the ``Default`` learning-rate schedule, ``OptimMethod``, ``SGD``,
``Adam`` and ``AdamW``).

Each method works over the parameter dict tree: ``init_state(params)``
returns the state (``iteration`` as a host int, moments as trees of
tensors shaped like the parameters) and ``update(grads, state, params,
epoch)`` returns ``(params, state)``.  Unlike the JAX package's pure
updates, the port updates IN PLACE under ``torch.no_grad()``: the
returned ``params`` and ``state`` are the very dicts passed in, their
tensors overwritten, so a step allocates no second copy of the weights
or the moments.  The arithmetic is the JAX package's, element for
element; ``torch.optim`` is not used (its SGD dampening default
differs from BigDL's).
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.utils.params import tree_leaves, tree_map


class LearningRateSchedule:
    def rate(self, base_lr, iteration, epoch):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + iteration * decay) (Torch SGD default)."""

    def __init__(self, decay: float = 0.0):
        self.decay = decay

    def rate(self, base_lr, iteration, epoch):
        return base_lr / (1.0 + iteration * self.decay)


class OptimMethod:
    """An optimizer over parameter dict trees: ``init_state`` +
    ``update``."""

    def init_state(self, params):
        return {"iteration": 0}

    def update(self, grads, state, params, epoch=1):
        """-> (params, state), both updated in place."""
        raise NotImplementedError

    def clear_history(self) -> None:
        self._state = None

    def get_hyper_parameter(self) -> str:
        return ""


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


class SGD(OptimMethod):
    """SGD with momentum/nesterov/weight decay (ref optim/SGD.scala).
    Torch7 semantics: v = mu*v + (1-dampening)*g; the step is g + mu*v
    (nesterov) or v.  BigDL's default dampening equals the momentum."""

    def __init__(self, learning_rate: float = 1e-3, learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        # Torch-Lua/BigDL default: dampening = momentum (ref SGD.scala:39),
        # except under nesterov which requires dampening = 0
        self.dampening = dampening if dampening is not None else (
            0.0 if nesterov else momentum)
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0.0):
            raise ValueError("nesterov requires momentum > 0 and dampening = 0")
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def init_state(self, params):
        state = {"iteration": 0}
        if self.momentum > 0:
            state["velocity"] = _zeros_like(params)
        return state

    def current_rate(self, state, epoch=1):
        return self.schedule.rate(self.learning_rate, state["iteration"], epoch)

    @torch.no_grad()
    def update(self, grads, state, params, epoch=1):
        lr = self.current_rate(state, epoch)
        mu, damp, wd = self.momentum, self.dampening, self.weight_decay
        vs = (tree_leaves(state["velocity"]) if mu > 0
              else [None] * len(tree_leaves(params)))
        for w, g, v in zip(tree_leaves(params), tree_leaves(grads), vs):
            if wd > 0:
                g = g + wd * w
            if mu > 0:
                v.mul_(mu).add_((1 - damp) * g)
                g = g + mu * v if self.nesterov else v
            w.sub_(lr * g)
        state["iteration"] += 1
        return params, state

    def get_hyper_parameter(self) -> str:
        return f"Current learning rate is {self.learning_rate}. "


class Adam(OptimMethod):
    """Adam with bias correction (Kingma & Ba 2015); ``weight_decay`` is
    L2 folded into the gradient (see AdamW for the decoupled variant)."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.learning_rate_schedule = learning_rate_schedule or Default()

    def init_state(self, params):
        return {"iteration": 0, "m": _zeros_like(params),
                "v": _zeros_like(params)}

    def current_rate(self, state, epoch=1):
        return self.learning_rate_schedule.rate(
            self.learning_rate, state["iteration"], epoch)

    def _decayed(self, g, w):
        return g if self.weight_decay == 0.0 else g + self.weight_decay * w

    def _post_step(self, w_new, w_old, lr):
        return w_new

    @torch.no_grad()
    def update(self, grads, state, params, epoch=1):
        lr = self.current_rate(state, epoch)
        t = state["iteration"] + 1
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for w, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = self._decayed(g, w)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            w_new = w - lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            w.copy_(self._post_step(w_new, w, lr))
        state["iteration"] = t
        return params, state


class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter 2019): the
    decay applies to the weights, scaled by the current rate."""

    def _decayed(self, g, w):
        return g  # decay decoupled: applied in _post_step

    def _post_step(self, w_new, w_old, lr):
        if self.weight_decay == 0.0:
            return w_new
        return w_new - lr * self.weight_decay * w_old
