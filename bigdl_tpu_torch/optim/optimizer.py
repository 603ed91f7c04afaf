"""Optimizer builder and the single-device training loop (port of
``bigdl_tpu/optim/optimizer.py``: ``Optimizer``, ``LocalOptimizer`` and
``LocalValidator``; ref optim/Optimizer.scala, LocalOptimizer.scala).

A step is eager PyTorch: the model's training forward, the criterion,
``torch.autograd.grad`` over every parameter leaf (through the flash
backward kernels on a CUDA device), optional gradient clipping, and the
optimizer method's in-place update.  The host fetches the loss once a
step, which is the step's only synchronisation.

Not ported yet, refused when asked for: checkpoints and preemption,
gradient accumulation, summaries, the stall watchdog, the observability
registry, LBFGS and distributed datasets (ROADMAP Queue 1).
"""
from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.optim.optim_method import OptimMethod, SGD
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils.params import tree_leaves, tree_map

log = logging.getLogger("bigdl_tpu_torch.optim")


def cast_float_leaves(tree, dtype):
    """The mixed-precision cast: float32 leaves to ``dtype``, every other
    leaf untouched.  Differentiable, so gradients arrive in float32."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, tree)


def loss_and_grads(model, criterion, params, data, labels, *, buffers=None,
                   generator: Optional[torch.Generator] = None,
                   compute_dtype: Optional[torch.dtype] = None):
    """One training forward and backward: ``(loss, grads, buffers)``
    with ``grads`` a tree shaped like ``params`` (float32 for float32
    leaves, whatever ``compute_dtype``) and ``loss`` a detached 0-d
    tensor on the device."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    run = live if compute_dtype is None else cast_float_leaves(
        live, compute_dtype)
    with torch.enable_grad():
        out, new_buffers = model.apply(run, data, buffers=buffers,
                                       training=True, generator=generator)
        loss = criterion.loss(out.float(), labels)
        flat = torch.autograd.grad(loss, leaves)
    it = iter(flat)
    return loss.detach(), tree_map(lambda _: next(it), params), new_buffers


class Optimizer:
    """Builder API (ref optim/Optimizer.scala:29-144)."""

    def __init__(self, model, dataset: AbstractDataSet, criterion):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_iteration(100)
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset: Optional[AbstractDataSet] = None
        self.validation_methods: Sequence[ValidationMethod] = ()
        self.validation_results: list = []  # the last validation's
        self.state: dict = {}
        self.compute_dtype: Optional[torch.dtype] = None  # None: float32
        self._clip_const = None
        self._clip_l2 = None

    # -- builder methods (reference names, pythonized) ------------------- #
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_compute_dtype(self, dtype) -> "Optimizer":
        """Mixed precision: forward and backward run with the float32
        parameters cast to ``dtype`` (bf16 sends the products and the
        flash kernels' bf16 variants to work), while the master weights
        and the optimizer state stay float32."""
        self.compute_dtype = dtype
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float) -> "Optimizer":
        """Clip every gradient element into [min, max]."""
        if not min_value < max_value:
            raise ValueError(f"min_value {min_value} must be below "
                             f"max_value {max_value}")
        self._clip_const = (float(min_value), float(max_value))
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float) -> "Optimizer":
        """Scale the WHOLE gradient tree so its global L2 norm is at most
        ``clip_norm`` (one norm across all leaves), after any constant
        clip and before the optimizer update."""
        self._clip_l2 = float(clip_norm)
        return self

    def _clip_gradients(self, grads):
        if self._clip_const is not None:
            lo, hi = self._clip_const
            grads = tree_map(lambda g: g.clamp(lo, hi), grads)
        if self._clip_l2 is not None:
            sq = sum((g.float() ** 2).sum() for g in tree_leaves(grads))
            norm = torch.sqrt(sq)
            scale = torch.clamp(self._clip_l2 / torch.clamp(norm, min=1e-12),
                                max=1.0)
            grads = tree_map(lambda g: (g * scale).to(g.dtype), grads)
        return grads

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_state(self, state: dict) -> "Optimizer":
        self.state = dict(state)
        return self

    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       methods: Sequence[ValidationMethod]) -> "Optimizer":
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = methods
        self._validator = None  # rebuilt around the new dataset
        return self

    def set_gradient_accumulation(self, n_micro: int) -> "Optimizer":
        if int(n_micro) != 1:
            raise NotImplementedError(
                "gradient accumulation is not ported yet (ROADMAP Queue 1)")
        return self

    def set_checkpoint(self, path: str, trigger: Trigger) -> "Optimizer":
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP Queue 1: checkpoint "
            "and resume)")

    def set_train_summary(self, summary) -> "Optimizer":
        raise NotImplementedError("summaries are not ported yet")

    set_validation_summary = set_train_summary

    @staticmethod
    def create(model, dataset: AbstractDataSet, criterion) -> "Optimizer":
        """The local loop; the port has no distributed dataset yet."""
        return LocalOptimizer(model, dataset, criterion)

    # -- shared loop plumbing ------------------------------------------- #
    def _init_driver_state(self):
        self.state.setdefault("epoch", 1)
        self.state.setdefault("neval", 1)
        self.state.setdefault("records_processed", 0)
        self.state["epoch_finished"] = False

    def _maybe_validate(self):
        if (self.validation_trigger is not None
                and self.validation_dataset is not None
                and self.validation_trigger(self.state)):
            results = self._validate()
            for method, result in results:
                log.info("%s is %s", method, result)
            self.validation_results = results
            return results
        return None

    def _validate(self):
        raise NotImplementedError

    def _fast_forward_data(self, data_iter, records_into_epoch: int) -> None:
        """Continue where an earlier ``optimize()`` stopped (a later call
        with a larger end trigger): replay the epoch rollovers' shuffles,
        then skip the records the epoch already trained on."""
        for _ in range(int(self.state.get("epoch", 1)) - 1):
            self.dataset.shuffle()
        skipped = 0
        while skipped < records_into_epoch:
            skipped += int(np.asarray(next(data_iter).data).shape[0])


class LocalOptimizer(Optimizer):
    """Single-process training loop (ref optim/LocalOptimizer.scala).

    The dataset yields MiniBatch (data, labels) host arrays; each step
    moves them to the model's device, differentiates, clips and updates
    the parameters in place.
    """

    def _step(self, params, buffers, opt_state, data, labels):
        loss, grads, new_buffers = loss_and_grads(
            self.model, self.criterion, params, data, labels,
            buffers=buffers, generator=self._generator,
            compute_dtype=self.compute_dtype)
        grads = self._clip_gradients(grads)
        self.optim_method.update(grads, opt_state, params,
                                 epoch=self.state["epoch"])
        return new_buffers, loss

    def optimize(self):
        self._init_driver_state()
        params = self.model.params
        buffers = getattr(self.model, "buffers", None) or {}
        # a state left by an earlier optimize() (or set by the caller)
        # continues: moments, momentum and the schedule's iteration
        restored = getattr(self.optim_method, "_state", None)
        opt_state = restored if restored else \
            self.optim_method.init_state(params)
        self._generator = torch.Generator().manual_seed(
            int(self.state.get("seed", 0)))
        device = tree_leaves(params)[0].device
        dataset_size = self.dataset.size()
        self.dataset.shuffle()
        data_iter = self.dataset.data(train=True)
        records_this_epoch = self.state.get("records_processed", 0)
        self._fast_forward_data(data_iter, records_this_epoch)
        wall0 = time.perf_counter()
        next_batch = None
        while not self.end_when(self.state):
            self.state["epoch_finished"] = False
            batch = next_batch if next_batch is not None else next(data_iter)
            next_batch = None
            t0 = time.perf_counter()
            buffers, loss = self._step(
                params, buffers, opt_state,
                torch.as_tensor(np.asarray(batch.data), device=device),
                torch.as_tensor(np.asarray(batch.labels), device=device))
            bs = batch.data.shape[0]
            if records_this_epoch + bs < dataset_size:
                # the next batch is read while the device runs this step;
                # not at an epoch boundary, where the rollover shuffle
                # below must come first
                next_batch = next(data_iter)
            loss_val = float(loss)  # the step's one synchronisation
            dt = time.perf_counter() - t0
            records_this_epoch += bs
            self.state["loss"] = loss_val
            self.state["throughput"] = bs / dt
            log.info("Epoch %d iteration %d: loss %.6f, throughput %.1f "
                     "records/s", self.state["epoch"], self.state["neval"],
                     loss_val, bs / dt)
            if records_this_epoch >= dataset_size:  # epoch rollover
                self.state["epoch"] += 1
                self.state["epoch_finished"] = True
                records_this_epoch = 0
                self.dataset.shuffle()
            self.state["records_processed"] = records_this_epoch
            self.model.params, self.model.buffers = params, buffers
            self.optim_method._state = opt_state
            self.state["neval"] += 1
            self._maybe_validate()
        log.info("training finished in %.1fs", time.perf_counter() - wall0)
        self.model.params, self.model.buffers = params, buffers
        return self.model

    def _validate(self):
        if getattr(self, "_validator", None) is None:
            self._validator = LocalValidator(self.model,
                                             self.validation_dataset)
        return self._validator.test(self.validation_methods)


class LocalValidator:
    """Eval-mode forward over the dataset, monoid-reducing the per-batch
    results (ref optim/LocalValidator.scala:29)."""

    def __init__(self, model, dataset: AbstractDataSet):
        self.model = model
        self.dataset = dataset

    @torch.no_grad()
    def test(self, methods: Sequence[ValidationMethod]):
        model = self.model
        device = tree_leaves(model.params)[0].device
        totals = [None] * len(methods)
        for batch in self.dataset.data(train=False):
            out, _ = model.apply(model.params,
                                 torch.as_tensor(np.asarray(batch.data),
                                                 device=device),
                                 buffers=getattr(model, "buffers", None),
                                 training=False)
            labels = torch.as_tensor(np.asarray(batch.labels), device=device)
            for i, m in enumerate(methods):
                r = m(out, labels)
                totals[i] = r if totals[i] is None else totals[i] + r
        return list(zip(methods, totals))
