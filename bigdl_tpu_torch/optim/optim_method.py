"""Optimization methods (port of ``bigdl_tpu/optim/optim_method.py``:
the ``Default`` learning-rate schedule, ``OptimMethod``, ``SGD``,
``Adam`` and ``AdamW``).

Each method works over the parameter dict tree: ``init_state(params)``
returns the state (``iteration`` as a host int, moments as trees of
tensors shaped like the parameters) and ``update(grads, state, params,
epoch)`` returns ``(params, state)``: the very dicts passed in, their
tensors overwritten under ``torch.no_grad()``, where the JAX package's
updates are pure.  The arithmetic is the JAX package's, element for
element; ``torch.optim`` is not used (its SGD dampening default differs
from BigDL's).

The built-in methods stage, then commit: :meth:`OptimMethod.stage`
computes every new weight and moment out of place, and
:meth:`OptimMethod.commit` copies them over the live tensors in one
``torch._foreach_copy_`` and advances the iteration.  A failure while
staging (a CUDA out-of-memory in a temporary, a subclass's hook
raising) leaves the parameters and the state at the last completed
iteration, so the training loop can checkpoint it as the reference
does.  The price is one transient copy of the parameters and of each
moment tree at the commit.  A method that overrides ``update`` (a
user's in-place method) is not staged: :func:`stages_updates` tells
the loop which kind it holds, and the loop snapshots what such an
update may write before calling it (``optimizer.UpdateSnapshot``).
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map


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

    def stage(self, grads, state, params, epoch=1):
        """The step's new tensors, out of place: ``(targets, values,
        iteration)`` for :meth:`commit`.  Writes nothing."""
        raise NotImplementedError

    @torch.no_grad()
    def commit(self, staged, state) -> None:
        """Copy the staged values over their targets in one pass and
        advance the state's iteration."""
        targets, values, iteration = staged
        torch._foreach_copy_(targets, values)
        state["iteration"] = iteration

    def clear_history(self) -> None:
        self._state = None

    def get_hyper_parameter(self) -> str:
        return ""


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def _staged(update):
    update.staged = True
    return update


def stages_updates(method: OptimMethod) -> bool:
    """Whether ``method.update`` is a built-in staged update (its class
    did not override ``update``), so that ``stage`` raising leaves the
    parameters and the state untouched."""
    return getattr(type(method).update, "staged", False)


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

    @_staged
    def update(self, grads, state, params, epoch=1):
        self.commit(self.stage(grads, state, params, epoch), state)
        return params, state

    @torch.no_grad()
    def stage(self, grads, state, params, epoch=1):
        lr = self.current_rate(state, epoch)
        mu, damp, wd = self.momentum, self.dampening, self.weight_decay
        vs = (tree_leaves(state["velocity"]) if mu > 0
              else [None] * len(tree_leaves(params)))
        targets, values = [], []
        for w, g, v in zip(tree_leaves(params), tree_leaves(grads), vs):
            if wd > 0:
                g = g + wd * w
            if mu > 0:
                v_new = v * mu + (1 - damp) * g
                targets.append(v)
                values.append(v_new)
                g = g + mu * v_new if self.nesterov else v_new
            targets.append(w)
            values.append(w - lr * g)
        return targets, values, state["iteration"] + 1

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

    @_staged
    def update(self, grads, state, params, epoch=1):
        self.commit(self.stage(grads, state, params, epoch), state)
        return params, state

    @torch.no_grad()
    def stage(self, grads, state, params, epoch=1):
        lr = self.current_rate(state, epoch)
        t = state["iteration"] + 1
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        targets, values = [], []
        for w, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = self._decayed(g, w)
            m_new = m * b1 + (1 - b1) * g
            v_new = v * b2 + (1 - b2) * g * g
            w_new = w - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2)
                                              + self.eps)
            targets += [m, v, w]
            values += [m_new, v_new, self._post_step(w_new, w, lr)]
        return targets, values, t


class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter 2019): the
    decay applies to the weights, scaled by the current rate."""

    def _decayed(self, g, w):
        return g  # decay decoupled: applied in _post_step

    def _post_step(self, w_new, w_old, lr):
        if self.weight_decay == 0.0:
            return w_new
        return w_new - lr * self.weight_decay * w_old
