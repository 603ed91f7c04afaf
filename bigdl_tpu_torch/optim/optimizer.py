"""Optimizer builder and the single-device training loop (port of
``bigdl_tpu/optim/optimizer.py``: ``Optimizer``, ``LocalOptimizer`` and
``LocalValidator``; ref optim/Optimizer.scala, LocalOptimizer.scala).

A step is eager PyTorch: the model's training forward, the criterion
plus a model's ``"aux_loss"`` buffer (the MoE balance term),
``torch.autograd.grad`` over every parameter leaf (through the flash
backward kernels on a CUDA device), optional gradient clipping, and the
optimizer method's update: a built-in method stages every new tensor
out of place and commits them in one pass, so a failure while staging
leaves the weights at the last completed iteration; a user's method
that updates in place (``stages_updates`` false) runs after a snapshot
of the weights and its state, restored if it raises.  With gradient
accumulation the step is a Python loop over micro-batches, each one's
graph freed before the next.  The host fetches the loss once a step,
which is the step's only synchronisation.

Checkpoints (``set_checkpoint``), ``resume_from``, the emergency
checkpoint on a failed loop and ``handle_preemption`` follow the
reference, writing its file format (``bigdl_tpu_torch.utils.file_io``).
So do TensorBoard summaries (``set_train_summary``: Loss, Throughput,
LearningRate and Parameters histograms on their triggers;
``set_validation_summary``), the phase counters (``metrics``, published
as ``train/*``) and the stall watchdog (``BIGDL_TPU_WATCHDOG``): a step
is bracketed up to the host's read of its loss, and a stall requests an
emergency checkpoint at the next completed iteration.

``LBFGS`` takes the reference's full-batch path instead
(:meth:`LocalOptimizer._optimize_lbfgs`): the parameters flattened into
one vector in the reference's ``ravel_pytree`` order, the dataset's
first batch evaluated by one forward and backward per line-search
point, validation, checkpoints and preemption after every outer
iteration.  Distributed datasets are not ported.
"""
from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.obs.registry import get_registry
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (LBFGS, OptimMethod, SGD,
                                                stages_updates)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils import file_io, fs, keychain
from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map
from bigdl_tpu_torch.utils.table import Table

log = logging.getLogger("bigdl_tpu_torch.optim")

_accum_fallback_warned: set = set()  # (batch_desc, rows, accum) warned


def cast_float_leaves(tree, dtype):
    """The mixed-precision cast: float32 leaves to ``dtype``, every other
    leaf untouched.  Differentiable, so gradients arrive in float32."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, tree)


def named_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict, keys sorted at every
    level and joined by ``/``: the reference's histogram tags (a JAX
    dict flattens in sorted key order)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key],
                                    f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, tree


def loss_and_grads(model, criterion, params, data, labels, *, buffers=None,
                   rng=None, generator: Optional[torch.Generator] = None,
                   compute_dtype: Optional[torch.dtype] = None):
    """One training forward and backward: ``(loss, grads, buffers)``
    with ``grads`` a tree shaped like ``params`` (float32 for float32
    leaves, whatever ``compute_dtype``) and ``loss`` a detached 0-d
    tensor on the device.  A model's ``"aux_loss"`` buffer (the MoE
    balance term, already weighted) joins the loss before it is
    differentiated.

    The model is called as every port ``Module`` is called:
    ``model.apply(params, data, buffers=, training=True, rng=rng)``,
    ``rng`` a key of the key chain (``utils/keychain.py``) or None.
    ``generator`` is passed on only when the caller gives one, and only
    ``TransformerLM.apply`` takes it (its dropout draws from a
    ``torch.Generator``; given none, it seeds one from ``rng``)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    run = live if compute_dtype is None else cast_float_leaves(
        live, compute_dtype)
    extra = {} if generator is None else {"generator": generator}
    with torch.enable_grad():
        out, new_buffers = model.apply(run, data, buffers=buffers,
                                       training=True, rng=rng, **extra)
        loss = criterion.loss(out.float(), labels)
        if "aux_loss" in new_buffers:
            loss = loss + new_buffers["aux_loss"]
        flat = torch.autograd.grad(loss, leaves)
    it = iter(flat)
    new_buffers = tree_map(lambda b: b.detach(), new_buffers)
    return loss.detach(), tree_map(lambda _: next(it), params), new_buffers


def accumulated_loss_and_grads(model, criterion, params, data, labels,
                               accum: int, *, buffers=None, rng=None,
                               generator: Optional[torch.Generator] = None,
                               compute_dtype: Optional[torch.dtype] = None,
                               batch_desc: str = "batch"):
    """:func:`loss_and_grads` over ``accum`` equal micro-batches (rows
    ``i*m .. (i+1)*m`` of ``data``): the mean of their losses and of
    their gradients, the buffers threaded through them in order, and
    micro-batch ``i`` keyed by row ``i`` of ``keychain.split(rng,
    accum)``, as the reference's scan is.  Each
    micro-batch's graph is freed before the next runs, so activation
    memory follows the micro-batch.  For a mean-reduced criterion this
    is the full-batch gradient.  A batch that ``accum`` does not divide
    (an epoch's ragged tail) runs as one unaccumulated step, with a
    warning once per shape (the reference's fallback)."""
    n = int(data.shape[0])
    if accum <= 1 or n % accum:
        if accum > 1 and (batch_desc, n, accum) not in _accum_fallback_warned:
            _accum_fallback_warned.add((batch_desc, n, accum))
            log.warning(
                "gradient accumulation: %s dim %d is not divisible by "
                "accum=%d, running this shape as ONE unaccumulated step "
                "(full-batch activation memory)", batch_desc, n, accum)
        return loss_and_grads(model, criterion, params, data, labels,
                              buffers=buffers, rng=rng, generator=generator,
                              compute_dtype=compute_dtype)
    m = n // accum
    rngs = [None] * accum if rng is None else keychain.split(rng, accum)
    g_sum = loss_sum = None
    for i in range(accum):
        loss, grads, buffers = loss_and_grads(
            model, criterion, params, data[i * m:(i + 1) * m],
            labels[i * m:(i + 1) * m], buffers=buffers, rng=rngs[i],
            generator=generator, compute_dtype=compute_dtype)
        if g_sum is None:
            g_sum, loss_sum = grads, loss.float()
        else:
            tree_map(lambda a, b: a.add_(b), g_sum, grads)
            loss_sum = loss_sum + loss.float()
        del grads
    inv = 1.0 / accum
    return loss_sum * inv, tree_map(lambda g: g * inv, g_sum), buffers


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
        self.train_summary = None
        self.validation_summary = None
        # host ms of each summary record, by kind ("scalars", "parameters")
        self.summary_ms: dict = {"scalars": [], "parameters": []}
        self.state: dict = {}
        # phase counters, published live into the process-wide registry
        self.metrics = Metrics().publish_to(get_registry())
        self.compute_dtype: Optional[torch.dtype] = None  # None: float32
        self.grad_accum = 1  # micro-batches a step
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.last_checkpoint: Optional[dict] = None  # iteration, bytes, s
        self._preempt_signals: tuple = ()
        self._preempted = False
        self._updating = False  # inside an update's writes
        self._update_snapshot = UpdateSnapshot()  # unstaged methods only
        self._stall_ckpt_requested = False
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
        """Split every batch into ``n_micro`` equal micro-batches and
        average their gradients before the one update
        (:func:`accumulated_loss_and_grads`).  ``n_micro`` must divide
        the first batch; a later ragged tail falls back to one
        unaccumulated step."""
        n_micro = int(n_micro)
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        self.grad_accum = n_micro
        return self

    def set_checkpoint(self, path: str, trigger: Trigger) -> "Optimizer":
        """Write ``model.<n>`` and ``state.<n>`` under ``path`` (a local
        directory, created; ``file://`` or ``memory://``) whenever
        ``trigger`` fires, ``n`` the iteration just finished."""
        filesystem, rest = fs.get_filesystem(path)
        if isinstance(filesystem, fs.LocalFileSystem):
            if os.path.exists(rest) and not os.path.isdir(rest):
                raise ValueError(f"checkpoint path {path} is not a directory")
            filesystem.makedirs(rest)
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        """Write Loss, Throughput and LearningRate scalars (and, on its
        trigger, a Parameters histogram per leaf) into ``summary``, a
        :class:`~bigdl_tpu_torch.visualization.TrainSummary`, each
        iteration its triggers fire."""
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary) -> "Optimizer":
        """Write each validation method's result into ``summary`` (a
        :class:`~bigdl_tpu_torch.visualization.ValidationSummary`)."""
        self.validation_summary = summary
        return self

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

    def _record_train_summary(self, loss_val: float, throughput: float,
                              epoch: int, iteration: int) -> None:
        """Trigger-gated scalars, and on its trigger the Parameters
        histograms (ref optimizer.py ``_record_train_summary``): step =
        ``neval``, the iteration just run; ``iteration`` is the method's
        counter that iteration's rate used.  A Parameters record copies
        every leaf to the host, so it runs only when its trigger fires;
        each record's host ms lands in ``summary_ms``."""
        ts = self.train_summary
        if ts is None:
            return
        t0 = time.perf_counter()
        step = self.state["neval"]
        gated = hasattr(ts, "should_record")
        if not gated or ts.should_record("Loss", self.state):
            ts.add_scalar("Loss", loss_val, step)
        if not gated or ts.should_record("Throughput", self.state):
            ts.add_scalar("Throughput", throughput, step)
        if gated and ts.should_record("LearningRate", self.state):
            m = self.optim_method
            if hasattr(m, "current_rate"):
                lr = float(m.current_rate({"iteration": iteration}, epoch))
            else:
                lr = float(getattr(m, "learning_rate", 0.0))
            ts.add_scalar("LearningRate", lr, step)
        t1 = time.perf_counter()
        self.summary_ms["scalars"].append((t1 - t0) * 1e3)
        if gated and ts.should_record("Parameters", self.state):
            for name, leaf in named_leaves(self.model.params):
                ts.add_histogram(name, leaf.detach().float().cpu().numpy(),
                                 step)
            self.summary_ms["parameters"].append(
                (time.perf_counter() - t1) * 1e3)

    def _maybe_validate(self):
        if (self.validation_trigger is not None
                and self.validation_dataset is not None
                and self.validation_trigger(self.state)):
            results = self._validate()
            for method, result in results:
                log.info("%s is %s", method, result)
                if self.validation_summary is not None:
                    self.validation_summary.add_scalar(
                        str(method), result.result()[0],
                        self.state["neval"] - 1)
            self.validation_results = results
            return results
        return None

    def _validate(self):
        raise NotImplementedError

    # -- checkpoints, resume and preemption ----------------------------- #
    def _maybe_checkpoint(self) -> bool:
        if (self.checkpoint_trigger is not None
                and self.checkpoint_path is not None
                and self.checkpoint_trigger(self.state)):
            self._checkpoint()
            return True
        return False

    def handle_preemption(self, signals=None) -> "Optimizer":
        """On SIGTERM (or ``signals``) during ``optimize()``: finish the
        iteration in flight, write a checkpoint when a path is set, and
        return.  The handler is installed when ``optimize()`` starts on
        the main thread and the previous one restored when it returns."""
        self._preempt_signals = (tuple(signals) if signals is not None
                                 else (signal.SIGTERM,))
        return self

    def _install_preemption(self) -> dict:
        """Install the preemption handler; returns the handlers it
        replaced."""
        self._preempted = False
        if not self._preempt_signals:
            return {}
        if threading.current_thread() is not threading.main_thread():
            log.warning("handle_preemption: optimize() runs off the main "
                        "thread, where no signal handler can be installed")
            return {}

        def handler(signum, frame):
            self._preempted = True
            log.warning("received signal %s: will checkpoint and stop "
                        "after the current iteration", signum)

        previous = {}
        for s in self._preempt_signals:
            previous[s] = signal.getsignal(s)
            signal.signal(s, handler)
        return previous

    @staticmethod
    def _restore_signals(previous: dict) -> None:
        for s, h in previous.items():
            signal.signal(s, signal.SIG_DFL if h is None else h)

    def _check_preemption(self) -> bool:
        return self._preempted

    def _checkpoint(self) -> None:
        """Write ``model.<n>`` and ``state.<n>``, ``n`` the iteration
        just finished; the state holds the driver state, the optimizer
        method's state as numpy and the method's class name."""
        t0 = time.perf_counter()
        n = self.state["neval"] - 1
        nbytes = file_io.save_module(
            self.model, fs.join(self.checkpoint_path, f"model.{n}"),
            overwrite=True)
        opt_state = getattr(self.optim_method, "_state", None)
        nbytes += file_io.save(
            {"driver_state": dict(self.state),
             "optim_state": (file_io.state_to_numpy(opt_state)
                             if opt_state is not None else None),
             "optim_method": type(self.optim_method).__name__},
            fs.join(self.checkpoint_path, f"state.{n}"), overwrite=True)
        dt = time.perf_counter() - t0
        self.last_checkpoint = dict(iteration=n, bytes=nbytes, seconds=dt)
        log.info("checkpoint written at iteration %d: %d bytes in %.3f s",
                 n, nbytes, dt)

    def resume_from(self, path: str) -> "Optimizer":
        """Load the newest ``model.<n>``/``state.<n>`` pair under
        ``path`` (either package's) into this optimizer's model, driver
        state and optimizer method, so the next ``optimize()`` continues
        the run: counters, moments, the schedule's position and the
        records already read this epoch.  No pair there is a cold
        start."""
        from bigdl_tpu_torch.models.utils import restore_optim_state
        found = file_io.latest_checkpoint(path)
        if not found:
            log.info("resume_from(%s): no checkpoint pair found, cold "
                     "start", path)
            return self
        model_path, state_path, n = found
        file_io.load_module(model_path, template=self.model)
        restore_optim_state(self, self.optim_method, state_path)
        get_registry().counter("resilience/resumes").add(1)
        log.warning("resumed from %s (iteration %d, epoch %s, %s records "
                    "into the epoch)", path, n, self.state.get("epoch"),
                    self.state.get("records_processed", 0))
        return self

    def _publish_for_checkpoint(self) -> None:
        """Make ``model.params`` and the method's state current before an
        emergency checkpoint: the local loop publishes every iteration."""

    def _emergency_checkpoint(self, reason: str = "") -> bool:
        """Checkpoint the last completed iteration on the failure path;
        never raises, so the original error is what surfaces.  Skipped
        when the failure struck while a staged method's commit was
        writing the weights: they are between two steps there (an
        in-place user method's failed ``update`` has been rolled back to
        its snapshot by then)."""
        if self.checkpoint_path is None:
            log.warning("cannot write emergency checkpoint (%s): no "
                        "checkpoint path configured, call set_checkpoint "
                        "first", reason)
            return False
        if self._updating:
            log.error("no emergency checkpoint (%s): the failure struck "
                      "while the update was writing the weights", reason)
            return False
        try:
            self._publish_for_checkpoint()
            self._checkpoint()
        except Exception:
            log.exception("emergency checkpoint failed (%s)", reason)
            return False
        get_registry().counter("resilience/emergency_checkpoints").add(1)
        log.warning("emergency checkpoint written at iteration %d (%s)",
                    self.state["neval"] - 1, reason)
        return True

    def _arm_stall_checkpoint(self, watchdog) -> None:
        """The escalation: when the stall watchdog fires, request an
        emergency checkpoint, taken by the loop at the next completed
        iteration (the stalled step may still be running; a checkpoint
        from the watchdog's thread would race it)."""
        self._stall_ckpt_requested = False
        if watchdog is None:
            return

        def _on_stall(event):
            self._stall_ckpt_requested = True

        watchdog.on_stall = _on_stall

    def _maybe_stall_checkpoint(self) -> None:
        if self._stall_ckpt_requested:
            self._stall_ckpt_requested = False
            self._emergency_checkpoint(
                "stall watchdog escalation: checkpointing at the next "
                "completed iteration")

    def _fast_forward_data(self, data_iter, records_into_epoch: int) -> None:
        """Continue where an earlier ``optimize()`` or a checkpoint
        stopped: replay the epoch rollovers' shuffles, then skip the
        records the epoch already trained on."""
        for _ in range(int(self.state.get("epoch", 1)) - 1):
            self.dataset.shuffle()
        skipped = 0
        while skipped < records_into_epoch:
            skipped += int(np.asarray(next(data_iter).data).shape[0])


class UpdateSnapshot:
    """The weights and optimizer state an unstaged (in-place) update may
    write, taken before it runs.  Every container of the trees is
    walked: a dict's or ``Table``'s entries and a list's items (which
    object sits where, and host values such as ``iteration``) are
    recorded, a tuple is descended into, a numpy array is copied on the
    host, and every tensor's values are copied by one
    ``torch._foreach_copy_`` into buffers allocated on first use and
    reused while the shapes hold.  ``restore`` puts all of it back.  A
    leaf of another kind could be written in place where no snapshot
    reaches, so ``take`` refuses it.  It costs one more copy of the
    weights and the state on the device."""

    _IMMUTABLE = (type(None), bool, int, float, complex, str, bytes,
                  np.generic, torch.dtype, torch.device)

    def __init__(self):
        self._bufs: list = []
        self._nodes: list = []
        self._arrays: list = []
        self._tensors: list = []

    def take(self, *trees) -> None:
        self._nodes, self._arrays, self._tensors = [], [], []
        seen = set()

        def walk(x):
            if isinstance(x, self._IMMUTABLE) or id(x) in seen:
                return
            seen.add(id(x))
            if isinstance(x, torch.Tensor):
                self._tensors.append(x)
            elif isinstance(x, np.ndarray):
                self._arrays.append((x, x.copy()))
            elif isinstance(x, (dict, Table)):
                self._nodes.append((x, list(x.items())))
                for v in list(x.values()):
                    walk(v)
            elif isinstance(x, list):
                self._nodes.append((x, list(x)))
                for v in x:
                    walk(v)
            elif isinstance(x, tuple):
                for v in x:
                    walk(v)
            else:
                raise TypeError(
                    f"an in-place update's params or state hold a "
                    f"{type(x).__name__}, which its snapshot cannot "
                    f"restore; keep tensors, numpy arrays and scalars "
                    f"in dicts, Tables, lists or tuples")

        for tree in trees:
            walk(tree)
        if [(b.shape, b.dtype, b.device) for b in self._bufs] != [
                (t.shape, t.dtype, t.device) for t in self._tensors]:
            self._bufs = [torch.empty_like(t) for t in self._tensors]
        if self._tensors:
            with torch.no_grad():
                torch._foreach_copy_(self._bufs, self._tensors)

    def restore(self) -> None:
        for node, saved in self._nodes:
            if isinstance(node, list):
                node[:] = saved
            elif isinstance(node, dict):
                node.clear()
                node.update(saved)
            else:  # a Table
                for k in list(node.keys()):
                    del node[k]
                for k, v in saved:
                    node[k] = v
        for a, saved in self._arrays:
            np.copyto(a, saved)
        if self._tensors:
            with torch.no_grad():
                torch._foreach_copy_(self._tensors, self._bufs)


class LocalOptimizer(Optimizer):
    """Single-process training loop (ref optim/LocalOptimizer.scala).

    The dataset yields MiniBatch (data, labels) host arrays; each step
    moves them to the model's device, differentiates (accumulating over
    micro-batches when asked), clips and updates the parameters.

    Keys follow the reference's chain: ``keychain.prng_key(
    state["seed"])`` (seed 0 by default), split once a step, the step's
    key split again per micro-batch under accumulation, and each key
    handed to ``model.apply(..., rng=key)``.  That is the one contract
    by which the loop calls a model: any port ``Module`` takes ``rng``
    (a container folds it per child, ``Dropout`` draws its mask from
    it), and ``TransformerLM`` seeds its dropout generator from it.
    """

    def _step(self, params, buffers, opt_state, data, labels, rng):
        loss, grads, new_buffers = accumulated_loss_and_grads(
            self.model, self.criterion, params, data, labels,
            self.grad_accum, buffers=buffers, rng=rng,
            compute_dtype=self.compute_dtype)
        grads = self._clip_gradients(grads)
        method, epoch = self.optim_method, self.state["epoch"]
        if stages_updates(method):
            # everything that can fail runs before the first write
            staged = method.stage(grads, opt_state, params, epoch=epoch)
            del grads
            self._updating = True
            method.commit(staged, opt_state)
        else:
            # a user's in-place update: snapshot what it may write, and
            # put it back if the update raises midway
            self._update_snapshot.take(params, opt_state)
            self._updating = True
            try:
                method.update(grads, opt_state, params, epoch=epoch)
            except BaseException:
                self._update_snapshot.restore()
                self._updating = False
                raise
        self._updating = False
        return new_buffers, loss

    def optimize(self):
        self._init_driver_state()
        previous = self._install_preemption()
        try:
            return self._optimize()
        finally:
            self._restore_signals(previous)

    def _optimize(self):
        self._updating = False
        if isinstance(self.optim_method, LBFGS):
            return self._optimize_lbfgs()
        params = self.model.params
        buffers = getattr(self.model, "buffers", None) or {}
        # a state left by an earlier optimize(), set by the caller or
        # restored from a checkpoint continues: moments, momentum and
        # the schedule's iteration
        restored = getattr(self.optim_method, "_state", None)
        opt_state = restored if restored else \
            self.optim_method.init_state(params)
        # the reference's key chain: one key for the run, split once a
        # step; the step's key reaches every layer as ``rng``
        rng = keychain.prng_key(int(self.state.get("seed", 0)))
        device = tree_leaves(params)[0].device
        self.dataset.shuffle()
        data_iter = self.dataset.data(train=True)
        records_this_epoch = self.state.get("records_processed", 0)
        self._fast_forward_data(data_iter, records_this_epoch)
        # step-cadence stall detection; a stall escalates to a
        # checkpoint at the next completed iteration
        from bigdl_tpu_torch.obs.watchdog import (env_watchdog_enabled,
                                                  env_watchdog_kwargs,
                                                  shared_watchdog)
        watchdog = None
        if env_watchdog_enabled():
            watchdog = shared_watchdog("train_step")
            # every knob from this run's environment: an unset one takes
            # its default, not the value an earlier run left behind
            watchdog.reset(**{"k": 10.0, "deadline_s": None,
                              **env_watchdog_kwargs()})
        self._arm_stall_checkpoint(watchdog)
        try:
            self._loop(params, buffers, opt_state, rng, device, data_iter,
                       records_this_epoch, watchdog)
        except Exception as e:
            # the last completed iteration is on the model: persist it
            # before the failure surfaces, so resume_from loses at most
            # the iteration in flight
            self._emergency_checkpoint(f"training loop failed: {e!r}")
            raise
        finally:
            if watchdog is not None:
                # a step the failure left open must not fire later
                watchdog.on_stall = None
                watchdog.reset()
        return self.model

    def _loop(self, params, buffers, opt_state, rng, device, data_iter,
              records_this_epoch, watchdog=None):
        dataset_size = self.dataset.size()
        wall0 = time.perf_counter()
        next_batch = fetch_error = None
        accum_checked = False
        while not self.end_when(self.state):
            if fetch_error is not None:
                # the read ahead failed during the previous iteration:
                # surface it where a plain read would have
                raise fetch_error
            self.state["epoch_finished"] = False
            batch = next_batch if next_batch is not None else next(data_iter)
            next_batch = None
            bs = batch.data.shape[0]
            if not accum_checked:
                # the first batch is the steady size; a later ragged
                # tail falls back to one unaccumulated step by design
                accum_checked = True
                if self.grad_accum > 1 and bs % self.grad_accum:
                    raise ValueError(
                        f"set_gradient_accumulation({self.grad_accum}) "
                        f"needs the batch size ({bs}) divisible by n_micro")
            rng, sub = keychain.split(rng)
            t0 = time.perf_counter()
            if watchdog is not None:
                watchdog.step_started()
            buffers, loss = self._step(
                params, buffers, opt_state,
                torch.as_tensor(np.asarray(batch.data), device=device),
                torch.as_tensor(np.asarray(batch.labels), device=device), sub)
            if records_this_epoch + bs < dataset_size:
                # the next batch is read while the device runs this step;
                # not at an epoch boundary, where the rollover shuffle
                # below must come first.  A failed read is held until
                # this iteration is recorded: the weights already hold
                # its update
                try:
                    next_batch = next(data_iter)
                except Exception as e:
                    fetch_error = e
            loss_val = float(loss)  # the step's one synchronisation
            if watchdog is not None:
                # after the sync: the bracket spans the device's work,
                # not only the launches
                watchdog.step_finished()
            dt = time.perf_counter() - t0
            self.metrics.add("computing time", dt)
            records_this_epoch += bs
            self.state["loss"] = loss_val
            self.state["throughput"] = bs / dt
            log.info("Epoch %d iteration %d: loss %.6f, throughput %.1f "
                     "records/s", self.state["epoch"], self.state["neval"],
                     loss_val, bs / dt)
            epoch_of_step = self.state["epoch"]
            if records_this_epoch >= dataset_size:  # epoch rollover
                self.state["epoch"] += 1
                self.state["epoch_finished"] = True
                records_this_epoch = 0
                self.dataset.shuffle()
            # current every iteration, so any checkpoint records how far
            # into the epoch training got
            self.state["records_processed"] = records_this_epoch
            self.model.params, self.model.buffers = params, buffers
            self.optim_method._state = opt_state
            # the update advanced the counter: the rate it used is one back
            self._record_train_summary(
                loss_val, bs / dt, epoch_of_step,
                int(opt_state.get("iteration", 1)) - 1)
            self.state["neval"] += 1
            self._maybe_validate()
            wrote = self._maybe_checkpoint()
            if not wrote:
                self._maybe_stall_checkpoint()
            if self._check_preemption():
                if self.checkpoint_path is not None and not wrote:
                    self._checkpoint()
                log.warning("stopping on preemption at iteration %d",
                            self.state["neval"] - 1)
                break
        log.info("training finished in %.1fs", time.perf_counter() - wall0)
        log.info("phase breakdown: %s", self.metrics.summary())
        self.model.params, self.model.buffers = params, buffers

    def _optimize_lbfgs(self):
        """The full-batch path for LBFGS (ref optimizer.py
        ``_optimize_lbfgs``; the reference drives LBFGS through the same
        feval machinery, optim/LocalOptimizer + LBFGS.scala): one
        ``optimize`` call of the method an iteration, on the dataset's
        first batch."""
        if self._clip_const is not None or self._clip_l2 is not None:
            # a clipped gradient is inconsistent with the loss the Wolfe
            # line search evaluates and corrupts the curvature pairs
            raise ValueError(
                "gradient clipping is incompatible with LBFGS (the line "
                "search and curvature pairs need the true gradient) — "
                "remove the clipping or use SGD/Adam")
        if self.grad_accum > 1:
            raise ValueError(
                "set_gradient_accumulation is not supported with LBFGS "
                "(the strong-Wolfe line search evaluates the full batch) "
                "— use SGD/Adam, or drop the accumulation")
        model, criterion = self.model, self.criterion
        # ravel_pytree's order: the leaves in sorted-key order, each
        # raveled row-major
        flat, _, unravel = model.get_parameters()
        flat = flat.detach()
        buffers = getattr(model, "buffers", None) or {}
        batch = next(self.dataset.data(train=True))
        data = torch.as_tensor(np.asarray(batch.data), device=flat.device)
        labels = torch.as_tensor(np.asarray(batch.labels), device=flat.device)

        def feval(v):
            v = v.detach().requires_grad_(True)
            with torch.enable_grad():
                params = unravel(v)
                if self.compute_dtype is not None:
                    params = cast_float_leaves(params, self.compute_dtype)
                out, _ = model.apply(params, data, buffers=buffers,
                                     training=True)
                loss = criterion.loss(out.float(), labels)
                (g,) = torch.autograd.grad(loss, v)
            return float(loss.detach()), g

        dataset_size = self.dataset.size()
        records_this_epoch = 0
        batch_records = int(np.asarray(batch.data).shape[0])
        while not self.end_when(self.state):
            self.state["epoch_finished"] = False
            flat, hist = self.optim_method.optimize(feval, flat)
            self.state["loss"] = hist[-1]
            log.info("LBFGS iteration %d: loss %.6f", self.state["neval"],
                     hist[-1])
            self.state["neval"] += 1
            records_this_epoch += batch_records
            if records_this_epoch >= dataset_size:
                self.state["epoch"] += 1
                self.state["epoch_finished"] = True
                records_this_epoch = 0
            model.params = unravel(flat)
            self._maybe_validate()
            wrote = self._maybe_checkpoint()
            if self._check_preemption():
                if self.checkpoint_path is not None and not wrote:
                    self._checkpoint()
                log.warning("stopping on preemption at iteration %d",
                            self.state["neval"] - 1)
                break
        return model

    def _validate(self):
        if getattr(self, "_validator", None) is None:
            self._validator = LocalValidator(self.model,
                                             self.validation_dataset)
        return self._validator.test(self.validation_methods)


class Validator:
    """Standalone evaluation (ref optim/Validator.scala:23-31): a model
    and the dataset it is tested on."""

    def __init__(self, model, dataset: AbstractDataSet):
        self.model = model
        self.dataset = dataset


class LocalValidator(Validator):
    """Eval-mode forward over the dataset, monoid-reducing the per-batch
    results (ref optim/LocalValidator.scala:29)."""

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
