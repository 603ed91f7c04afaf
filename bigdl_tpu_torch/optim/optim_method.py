"""Optimization methods (port of ``bigdl_tpu/optim/optim_method.py``:
the learning-rate schedules ``Default``, ``Poly``, ``Step``,
``EpochStep``, ``EpochDecay`` and ``EpochSchedule`` with ``Regime``;
``OptimMethod``, ``SGD``, ``Adagrad``, ``Adam``, ``AdamW``, and
``LBFGS`` with its line search ``ls_wolfe``).

A schedule's rate is a host number: the iteration is a host int and the
epoch the training loop's.  Where the reference computes it in float32 array
arithmetic (``Poly``, ``Step``, ``EpochStep``) the port does the same
in numpy float32, so the rate is the reference's float32 value.

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

from typing import Callable, Optional

import numpy as np
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


class Poly(LearningRateSchedule):
    """lr * (1 - iter/max)^power; 0 beyond max (ref SGD.Poly)."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def rate(self, base_lr, iteration, epoch):
        frac = np.clip(np.float32(iteration) / np.float32(self.max_iteration),
                       np.float32(0.0), np.float32(1.0))
        return float(np.float32(base_lr)
                     * (np.float32(1.0) - frac) ** np.float32(self.power))


class Step(LearningRateSchedule):
    """lr * gamma^(floor(iter / step_size)) (ref SGD.Step)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, base_lr, iteration, epoch):
        k = np.floor(np.float32(iteration) / np.float32(self.step_size))
        return float(np.float32(base_lr) * np.float32(self.gamma) ** k)


class EpochStep(LearningRateSchedule):
    """lr * gamma^(floor((epoch-1) / step)) (ref SGD.EpochStep)."""

    def __init__(self, step: int, gamma: float):
        self.step = step
        self.gamma = gamma

    def rate(self, base_lr, iteration, epoch):
        k = np.floor(np.float32(epoch - 1) / np.float32(self.step))
        return float(np.float32(base_lr) * np.float32(self.gamma) ** k)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch) with a user decay function
    (ref SGD.EpochDecay); the function gets the epoch as a host int."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def rate(self, base_lr, iteration, epoch):
        return base_lr * 0.1 ** self.decay_fn(epoch)


class Regime:
    """An epoch range and its config (ref SGD.Regime): a dict with
    "learning_rate" (absolute) or "learning_rate_multiplier" (times the
    method's base rate); a bare number is the multiplier."""

    def __init__(self, start_epoch: int, end_epoch: int, config):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        if not isinstance(config, dict):
            config = {"learning_rate_multiplier": float(config)}
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """Piecewise-constant rate by epoch regime; the last regime that
    holds the epoch wins (ref SGD.EpochSchedule)."""

    def __init__(self, regimes: list):
        self.regimes = regimes

    def rate(self, base_lr, iteration, epoch):
        lr = base_lr
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                if "learning_rate_multiplier" in r.config:
                    lr = base_lr * r.config["learning_rate_multiplier"]
                else:
                    lr = r.config.get("learning_rate", base_lr)
        return lr


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

    def optimize(self, feval: Callable, x, epoch: int = 1):
        """One step from ``feval: x -> (loss, grad)`` (ref
        OptimMethod.optimize): ``(new x, [loss])``.  The caller's ``x``
        is not written (the step updates a copy), and the method's state
        lives on the instance between calls, as the reference's state
        Table does."""
        x = tree_map(lambda t: torch.as_tensor(t).clone(), x)
        if getattr(self, "_state", None) is None:
            self._state = self.init_state(x)
        loss, grad = feval(x)
        x, self._state = self.update(tree_map(torch.as_tensor, grad),
                                     self._state, x, epoch=epoch)
        return x, [loss]

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


class Adagrad(OptimMethod):
    """Adagrad (ref optim/Adagrad.scala): the squared gradients summed
    per element, each step scaled by their root."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, eps: float = 1e-10):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.eps = eps

    def init_state(self, params):
        return {"iteration": 0, "accum": _zeros_like(params)}

    def current_rate(self, state, epoch=1):
        return self.learning_rate / (
            1.0 + state["iteration"] * self.learning_rate_decay)

    @_staged
    def update(self, grads, state, params, epoch=1):
        self.commit(self.stage(grads, state, params, epoch), state)
        return params, state

    @torch.no_grad()
    def stage(self, grads, state, params, epoch=1):
        lr = self.current_rate(state, epoch)
        targets, values = [], []
        for w, g, a in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["accum"])):
            a_new = a + g * g
            targets += [a, w]
            values += [a_new, w - lr * g / (torch.sqrt(a_new) + self.eps)]
        return targets, values, state["iteration"] + 1


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


# --------------------------------------------------------------------- #
# LBFGS (ref optim/LBFGS.scala + LineSearch.scala lswolfe)              #
# --------------------------------------------------------------------- #
def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def ls_wolfe(feval, x, t, d, f, g, gtd, c1=1e-4, c2=0.9, tol_x=1e-9,
             max_iter=20):
    """Strong-Wolfe line search with bracketing and bisection (ref
    LineSearch.scala), on flat float32 vectors; ``feval`` returns (f,
    g) with ``f`` a host float.  Returns (f, g, t, evaluations)."""
    d_norm = float(d.abs().max())
    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    ls_func_evals = 0
    bracket = None
    for _ in range(max_iter):
        f_new, g_new = feval(x + t * d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        if f_new > (f + c1 * t * gtd) or (ls_func_evals > 1
                                          and f_new >= f_prev):
            bracket = (t_prev, t, f_prev, f_new, g_prev, g_new, gtd_prev,
                       gtd_new)
            break
        if abs(gtd_new) <= -c2 * gtd:
            return f_new, g_new, t, ls_func_evals
        if gtd_new >= 0:
            bracket = (t_prev, t, f_prev, f_new, g_prev, g_new, gtd_prev,
                       gtd_new)
            break
        t_prev, f_prev, g_prev, gtd_prev = t, f_new, g_new, gtd_new
        t = min(10.0, t * 2.0)
    if bracket is None:
        return f_new, g_new, t, ls_func_evals
    # zoom
    lo_t, hi_t, lo_f, hi_f, lo_g, hi_g, lo_gtd, hi_gtd = bracket
    for _ in range(max_iter):
        if abs(hi_t - lo_t) * d_norm < tol_x:
            break
        t = (lo_t + hi_t) / 2.0
        f_new, g_new = feval(x + t * d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        if f_new > (f + c1 * t * gtd) or f_new >= lo_f:
            hi_t, hi_f, hi_g, hi_gtd = t, f_new, g_new, gtd_new
        else:
            if abs(gtd_new) <= -c2 * gtd:
                return f_new, g_new, t, ls_func_evals
            if gtd_new * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_g, hi_gtd = lo_t, lo_f, lo_g, lo_gtd
            lo_t, lo_f, lo_g, lo_gtd = t, f_new, g_new, gtd_new
    return f_new, g_new, t, ls_func_evals


class LBFGS(OptimMethod):
    """Limited-memory BFGS with an optional strong-Wolfe line search
    (ref optim/LBFGS.scala).  A host-driven loop over one flat float32
    vector: each evaluation is one forward and backward on the device,
    each dot product one read back to the host.  Its state (the
    curvature pairs, the last direction and step) lives on the method
    between ``optimize`` calls, as the reference's does."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = False):
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 1.25
        self.tol_fun = tol_fun
        self.tol_x = tol_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search
        self._state: Optional[dict] = None

    def optimize(self, feval: Callable, x, epoch: int = 1):
        """Up to ``max_iter`` iterations from ``x`` (one reference
        ``optimize`` call, one outer loop).  Returns (x, loss
        history)."""
        x = torch.as_tensor(x)
        st = self._state if self._state is not None else {
            "old_dirs": [], "old_steps": [], "prev_g": None,
            "prev_loss": None, "d": None, "t": None, "hdiag": 1.0,
            "func_evals": 0}
        f, g = feval(x)
        f_hist = [float(f)]
        st["func_evals"] += 1
        abs_grad_sum = float(g.abs().sum())
        if abs_grad_sum <= self.tol_fun:
            self._state = st
            return x, f_hist

        for n_iter in range(self.max_iter):
            if st["prev_g"] is None:
                d = -g
                st["hdiag"] = 1.0
            else:
                y = g - st["prev_g"]
                s = st["d"] * st["t"]
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(st["old_dirs"]) == self.n_correction:
                        st["old_dirs"].pop(0)
                        st["old_steps"].pop(0)
                    st["old_dirs"].append(s)
                    st["old_steps"].append(y)
                    st["hdiag"] = ys / _dot(y, y)
                # two-loop recursion
                k = len(st["old_dirs"])
                ro = [1.0 / _dot(st["old_steps"][i], st["old_dirs"][i])
                      for i in range(k)]
                al = [0.0] * k
                q = -g
                for i in range(k - 1, -1, -1):
                    al[i] = _dot(st["old_dirs"][i], q) * ro[i]
                    q = q - al[i] * st["old_steps"][i]
                d = q * st["hdiag"]
                for i in range(k):
                    be = _dot(st["old_steps"][i], d) * ro[i]
                    d = d + st["old_dirs"][i] * (al[i] - be)
            st["prev_g"] = g
            gtd = _dot(g, d)
            if gtd > -self.tol_x:
                break
            if n_iter == 0 and st["prev_loss"] is None:
                t = min(1.0, 1.0 / max(abs_grad_sum, 1e-12)) \
                    * self.learning_rate
            else:
                t = self.learning_rate
            if self.line_search:
                f, g, t, evals = ls_wolfe(feval, x, t, d, float(f), g, gtd)
                x = x + t * d
                st["func_evals"] += evals
            else:
                x = x + t * d
                f, g = feval(x)
                st["func_evals"] += 1
            st["d"], st["t"] = d, t
            f_hist.append(float(f))
            abs_grad_sum = float(g.abs().sum())
            if abs_grad_sum <= self.tol_fun:
                break
            if float((d * t).abs().max()) <= self.tol_x:
                break
            if st["prev_loss"] is not None and \
                    abs(f_hist[-1] - f_hist[-2]) < self.tol_fun:
                break
            if st["func_evals"] >= self.max_eval:
                break
        st["prev_loss"] = f_hist[-1]
        self._state = st
        return x, f_hist
