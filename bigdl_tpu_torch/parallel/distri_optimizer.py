"""Distributed synchronous-SGD engine (port of
``bigdl_tpu/parallel/distri_optimizer.py``; ref optim/DistriOptimizer.scala,
SURVEY.md §3.2).

One rank per device, ZeRO-1.  Each rank of the mesh's data axis keeps
the float32 master slice of the flat parameter vector it owns and that
slice's optimizer state.  An iteration is the reference's cycle, over
``torch.distributed`` collectives instead of one shard_map program:

    reference                               here
    ---------------------------------       ---------------------------------
    bf16 all_gather of the master shard     bf16 all_gather_into_tensor,
                                              widened to float32
    forward/backward on the local shard     the same, on this rank's batch
      of the batch (accumulated)              (accumulated_loss_and_grads)
    bf16 psum_scatter of the gradients      bf16 reduce_scatter_tensor,
                                              then the mean
    clip on the slice, psum'd norm          the same, all_reduce'd norm
    method.update on the slice              the same (staged and committed)
    pmean of the buffers and the loss       all_reduce, then / world

Each rank draws its noise from ``fold_in(step key, rank)`` of the key
chain (``utils/keychain.py``), as each mesh slot does in the reference.
A rank reads its own batch: a :class:`DistributedDataSet` gives rank r
the records ``r, r + world, ...``; the global batch is the ranks'
batches in rank order.

Deliberate divergences, as in the reference: no straggler dropping (the
collectives are lockstep), and bf16 transport rounds where the
reference's fp16 codec truncates.  The optimizer's state and the
weights are published (gathered in float32 onto every rank) only when
a trigger needs them and at the end, as the reference's ``getModel``.
"""
from __future__ import annotations

import logging
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, is_distributed
from bigdl_tpu_torch.obs import get_tracer
from bigdl_tpu_torch.optim.optim_method import stages_updates
from bigdl_tpu_torch.optim.optimizer import (Optimizer, Validator,
                                             accumulated_loss_and_grads)
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, data_parallel_mesh,
                                           in_mesh, init_world)
from bigdl_tpu_torch.parallel.parameters import (AllReduceParameter,
                                                 CollectiveRecord,
                                                 all_gather_flat)
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map

log = logging.getLogger("bigdl_tpu_torch.optim")


def _mean_all_reduce(t: torch.Tensor, group, n: int, record) -> torch.Tensor:
    """The float32 mean of ``t`` over the group (``lax.pmean``)."""
    out = t.detach().float().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    record.add("all-reduce", out)
    return (out / torch.full_like(out, float(n))).to(t.dtype)


def _gather_full(shard: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's slice of a flat vector, in rank order (float32, no
    compression: the publish path)."""
    out = torch.empty(shard.numel() * n, dtype=shard.dtype,
                      device=shard.device)
    all_gather_flat(out, shard.contiguous(), group)
    return out


class DistriOptimizer(Optimizer):
    """Data-parallel trainer over the ranks of a mesh (ref
    DistriOptimizer).  ``dataset`` yields this rank's MiniBatches;
    ``optimize`` returns the model with the gathered float32 weights.
    With no ``mesh``, the world is started if it is not running
    (:func:`~bigdl_tpu_torch.parallel.mesh.init_world` on the model's
    device type) and every rank joins the data axis."""

    def __init__(self, model, dataset: AbstractDataSet, criterion,
                 mesh=None):
        super().__init__(model, dataset, criterion)
        self.mesh = mesh
        self._record = CollectiveRecord()
        self._footprint = None
        self._live_publish = None
        self.n_slots = None

    # ------------------------------------------------------------------ #
    def _device(self) -> torch.device:
        return tree_leaves(self.model.params)[0].device

    def _resolve_mesh(self):
        if self.mesh is None:
            dev = self._device()
            init_world(dev.type)
            self.mesh = data_parallel_mesh(device_type=dev.type)
        self.n_slots = int(self.mesh.size())
        return self.mesh

    def _group(self):
        return self.mesh.get_group(DATA_AXIS)

    def _slot(self) -> int:
        return int(self.mesh.get_local_rank(DATA_AXIS))

    @staticmethod
    def _repad_flat_leaf(leaf, arp: AllReduceParameter):
        """Re-pad a checkpointed flat optimizer-state vector for the
        current slot count.  Only 1-D leaves spanning the whole parameter
        vector re-pad (moment buffers); scalars and anything else pass
        through.  A leaf that cannot belong to this model's parameter
        size fails loudly instead of training on garbage."""
        if not isinstance(leaf, (torch.Tensor, np.ndarray)):
            return leaf
        a = torch.as_tensor(leaf)
        if a.ndim != 1 or a.numel() == arp.padded_size:
            return leaf
        if a.numel() < arp.size:
            raise ValueError(
                f"restored optimizer state has a flat vector of size "
                f"{a.numel()}, smaller than the model's parameter size "
                f"{arp.size} — the checkpoint belongs to a different model")
        # a genuine re-pad only trims the zero padding tail of the old
        # slot count; nonzero values there mean a larger model's state
        tail = a[arp.size:]
        if tail.numel() and bool((tail != 0).any()):
            raise ValueError(
                f"restored optimizer state has "
                f"{int(torch.count_nonzero(tail))} nonzero values beyond "
                f"the model's parameter size {arp.size} — the checkpoint "
                f"belongs to a larger model, refusing to truncate it")
        out = a.new_zeros(arp.padded_size)
        out[: arp.size] = a[: arp.size]
        return out

    def _check_preemption(self) -> bool:
        """Preemption consensus: a signal lands on ONE rank; every rank
        must leave the loop at the same iteration, or the others wait in
        the next step's collectives.  Only with ``handle_preemption``
        active (the startup check makes that symmetric)."""
        preempted = super()._check_preemption()
        if self._preempt_signals and self.n_slots > 1:
            flag = torch.tensor([int(preempted)], device=self._device())
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group())
            preempted = bool(flag.item())
        return preempted

    def _check_symmetric_triggers(self) -> None:
        """Publishing gathers across ranks, and the triggers that fire
        it are evaluated per rank: asymmetric configuration would leave
        some ranks in a collective the others never enter.  Verified
        once, loudly."""
        if self.n_slots <= 1:
            return
        cfg = torch.tensor(
            [self.train_summary is not None,
             self.validation_trigger is not None
             and self.validation_dataset is not None,
             self.checkpoint_trigger is not None
             and self.checkpoint_path is not None,
             bool(self._preempt_signals)], dtype=torch.int32,
            device=self._device())
        every = [torch.empty_like(cfg) for _ in range(self.n_slots)]
        dist.all_gather(every, cfg, group=self._group())
        if any(not torch.equal(cfg, other) for other in every):
            raise ValueError(
                "summary/validation/checkpoint/preemption configuration "
                f"differs across ranks (this rank: {cfg.tolist()}, rank 0: "
                f"{every[0].tolist()}); asymmetric triggers deadlock the "
                "publish collective — configure every rank identically")

    def _checkpoint(self) -> None:
        """Every rank holds the published state; the mesh's first rank
        writes it."""
        if self._slot() == 0:
            super()._checkpoint()

    def _publish_for_checkpoint(self) -> None:
        """Emergency checkpoint: gather the live slices so the
        checkpoint records the last completed step."""
        if self._live_publish is not None:
            self._live_publish()

    # ------------------------------------------------------------------ #
    def optimize(self):
        self._init_driver_state()
        mesh = self._resolve_mesh()
        if not in_mesh(mesh):
            return self.model  # a rank outside a sub-mesh trains nothing
        previous = self._install_preemption()
        try:
            return self._optimize_impl()
        except Exception as e:
            # persist the last completed step before the failure surfaces
            self._emergency_checkpoint(f"training loop failed: {e!r}")
            raise
        finally:
            self._live_publish = None
            self._restore_signals(previous)

    def _init_state(self, arp, slot, dev):
        method = self.optim_method
        restored = getattr(method, "_state", None)
        if restored:
            full = tree_map(lambda l: self._repad_flat_leaf(l, arp), restored)

            def mine(leaf):
                if isinstance(leaf, (torch.Tensor, np.ndarray)):
                    t = torch.as_tensor(leaf)
                    if t.ndim == 1 and t.numel() == arp.padded_size:
                        lo = slot * arp.slice_size
                        return t[lo:lo + arp.slice_size].to(
                            dev, torch.float32).clone()
                return leaf
            return tree_map(mine, full)
        return method.init_state(torch.zeros(arp.slice_size,
                                             dtype=torch.float32,
                                             device=dev))

    def _step(self, arp, w_shard, opt_state, buffers, data, labels, rng,
              group, slot):
        """One ZeRO-1 iteration on this rank: (new buffers, mean loss);
        ``w_shard`` and ``opt_state`` are updated in place."""
        n = self.n_slots
        loss, grads, new_buffers, g_shard = self._gradients(
            arp, w_shard, buffers, data, labels, rng, group, slot)
        del grads

        def psum_sq(sq):
            sq = sq.reshape(1).clone()
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
            self._record.add("all-reduce", sq)
            return sq[0]
        g_shard = self._clip_gradients(g_shard, psum=psum_sq)
        method, epoch = self.optim_method, self.state["epoch"]
        if stages_updates(method):
            staged = method.stage(g_shard, opt_state, w_shard, epoch=epoch)
            self._updating = True
            method.commit(staged, opt_state)
        else:
            self._update_snapshot.take(w_shard, opt_state)
            self._updating = True
            try:
                method.update(g_shard, opt_state, w_shard, epoch=epoch)
            except BaseException:
                self._update_snapshot.restore()
                self._updating = False
                raise
        self._updating = False
        new_buffers = tree_map(
            lambda b: _mean_all_reduce(b, group, n, self._record)
            if b.ndim > 0 else b, new_buffers)
        if "aux_loss" in new_buffers:
            new_buffers = dict(new_buffers)
            new_buffers["aux_loss"] = _mean_all_reduce(
                new_buffers["aux_loss"], group, n, self._record)
        loss = _mean_all_reduce(loss.float(), group, n, self._record)
        return new_buffers, loss

    def _gradients(self, arp, w_shard, buffers, data, labels, rng, group,
                   slot):
        """An iteration's first half on this rank: the bf16 gather of
        the weights, the loss and gradients of this rank's batch under
        ``fold_in(rng, slot)``, and the bf16 reduce-scatter of those
        gradients.  Returns (loss, the local gradient tree, the new
        buffers, this rank's averaged float32 gradient slice)."""
        rng = keychain.fold_in(rng, slot)
        params = arp.unravel(arp.gather_weights(w_shard, group))
        loss, grads, new_buffers = accumulated_loss_and_grads(
            self.model, self.criterion, params, data, labels,
            self.grad_accum, buffers=buffers, rng=rng,
            compute_dtype=self.compute_dtype,
            batch_desc="per-device batch (global batch / devices)")
        del params
        return loss, grads, new_buffers, \
            arp.scatter_gradients(grads, group, mean=True)

    def _begin(self):
        """The state ``optimize()`` starts from on this rank: the flat
        layout, the float32 master slice, its optimizer state, the
        buffers and the key chain's root."""
        self.model._built()
        dev, slot = self._device(), self._slot()
        arp = AllReduceParameter(self.model.params, self.n_slots,
                                 record=self._record)
        w_shard = arp.init_shards(self.model.params)[slot].to(dev).clone()
        opt_state = self._init_state(arp, slot, dev)
        buffers = getattr(self.model, "buffers", None) or {}
        rng = keychain.prng_key(int(self.state.get("seed", 0)))
        return arp, w_shard, opt_state, buffers, rng

    def step_gradients(self, data, labels):
        """The first iteration's :meth:`_gradients` (the code every
        training step runs) on ``data``, without the update, for checks:
        ``(loss, local_grads, reduced_slice)``.  Weights and state are
        not touched, and the collectives are not recorded."""
        self._resolve_mesh()
        self._record.enabled = False
        arp, w_shard, _, buffers, rng = self._begin()
        _, sub = keychain.split(rng)
        loss, grads, _, g_shard = self._gradients(
            arp, w_shard, buffers, data, labels, sub, self._group(),
            self._slot())
        return loss, grads, g_shard

    def _optimize_impl(self):
        self._updating = False
        self._check_symmetric_triggers()
        group, slot, n = self._group(), self._slot(), self.n_slots
        self._record.clear()
        self._record.enabled = True
        arp, w_shard, opt_state, buffers, rng = self._begin()
        dev = self._device()
        tracer = get_tracer()

        global_dataset_size = self.dataset.size()
        self.dataset.shuffle()
        data_iter = self.dataset.data(train=True)
        records_this_epoch = self.state.get("records_processed", 0)
        self._fast_forward_data(data_iter, records_this_epoch // n)

        def fetch_and_place():
            with tracer.span("train/fetch", cat="train"):
                batch = next(data_iter)
            t_shard = time.perf_counter()
            with tracer.span("train/h2d", cat="train",
                             rows=int(np.asarray(batch.data).shape[0])):
                data = torch.as_tensor(np.asarray(batch.data), device=dev)
                labels = torch.as_tensor(np.asarray(batch.labels),
                                         device=dev)
            # the data-side phase metric (ref DistriOptimizer.scala:115)
            self.metrics.add("shard data time", time.perf_counter() - t_shard)
            return batch, data, labels

        from bigdl_tpu_torch.obs.watchdog import (env_watchdog_enabled,
                                                  env_watchdog_kwargs,
                                                  shared_watchdog)
        watchdog = None
        if env_watchdog_enabled():
            watchdog = shared_watchdog("train_step")
            watchdog.reset(**{"k": 10.0, "deadline_s": None,
                              **env_watchdog_kwargs()})
        self._arm_stall_checkpoint(watchdog)

        def publish_state():
            full = _gather_full(w_shard, group, n)
            self.model.params = arp.to_pytree(full)
            self.model.buffers = buffers

            def gather_leaf(leaf):
                if isinstance(leaf, torch.Tensor) and leaf.ndim == 1 \
                        and leaf.numel() == arp.slice_size:
                    return _gather_full(leaf, group, n)
                return leaf
            self.optim_method._state = tree_map(gather_leaf, opt_state)
        self._live_publish = publish_state

        wall0 = time.perf_counter()
        next_ready = None
        accum_checked = False
        try:
            while not self.end_when(self.state):
                self.state["epoch_finished"] = False
                if next_ready is not None:
                    batch, data, labels = next_ready
                    next_ready = None
                else:
                    batch, data, labels = fetch_and_place()
                local_bs = int(data.shape[0])
                if not accum_checked:
                    accum_checked = True
                    if self.grad_accum > 1 and local_bs % self.grad_accum:
                        raise ValueError(
                            f"set_gradient_accumulation({self.grad_accum}) "
                            f"needs the per-device batch (global batch / "
                            f"devices = {local_bs}) divisible by n_micro")
                rng, sub = keychain.split(rng)
                t0 = time.perf_counter()
                if watchdog is not None:
                    watchdog.step_started()
                buffers, loss = self._step(arp, w_shard, opt_state, buffers,
                                           data, labels, sub, group, slot)
                self._record.enabled = False  # the footprint: step one's
                global_bs = local_bs * n
                if records_this_epoch + global_bs < global_dataset_size:
                    # read ahead while the device works; never across the
                    # epoch boundary, where the rollover shuffle comes first
                    next_ready = fetch_and_place()
                loss_val = float(loss)
                if watchdog is not None:
                    watchdog.step_finished()
                dt = time.perf_counter() - t0
                tracer.add_complete("train/step", t0, dt, cat="train",
                                    args={"iteration": self.state["neval"],
                                          "epoch": self.state["epoch"],
                                          "loss": loss_val})
                records_this_epoch += global_bs
                self.metrics.add("computing time", dt)
                self.state["loss"] = loss_val
                self.state["throughput"] = global_bs / dt
                log.info("Epoch %d iteration %d: loss %.6f, throughput %.1f "
                         "records/s", self.state["epoch"], self.state["neval"],
                         loss_val, global_bs / dt)
                epoch_of_step = self.state["epoch"]
                if records_this_epoch >= global_dataset_size:
                    self.state["epoch"] += 1
                    self.state["epoch_finished"] = True
                    records_this_epoch = 0
                    self.dataset.shuffle()
                self.state["records_processed"] = records_this_epoch
                published = False

                def publish():
                    # the full gather runs only when a trigger needs it,
                    # at most once an iteration (ref getModel)
                    nonlocal published
                    if published:
                        return
                    published = True
                    t_pub = time.perf_counter()
                    with tracer.span("train/publish", cat="train",
                                     iteration=self.state["neval"]):
                        publish_state()
                    self.metrics.add("publish time",
                                     time.perf_counter() - t_pub)

                ts = self.train_summary
                if ts is not None and hasattr(ts, "should_record") \
                        and ts.should_record("Parameters", self.state):
                    publish()  # the histograms read the gathered weights
                self._record_train_summary(
                    loss_val, global_bs / dt, epoch_of_step,
                    int(opt_state.get("iteration", 1)) - 1)
                self.state["neval"] += 1
                do_val = (self.validation_trigger is not None
                          and self.validation_dataset is not None
                          and self.validation_trigger(self.state))
                do_ckpt = (self.checkpoint_trigger is not None
                           and self.checkpoint_path is not None
                           and self.checkpoint_trigger(self.state))
                preempted = self._check_preemption()
                preempt_ckpt = preempted and self.checkpoint_path is not None
                if do_val or do_ckpt or preempt_ckpt:
                    publish()
                    if do_val:
                        with tracer.span("train/validate", cat="train",
                                         iteration=self.state["neval"]):
                            self._run_validation()
                    if do_ckpt or preempt_ckpt:
                        with tracer.span("train/checkpoint", cat="train",
                                         iteration=self.state["neval"]):
                            self._checkpoint()
                if not (do_ckpt or preempt_ckpt):
                    self._maybe_stall_checkpoint()
                if preempted:
                    log.warning("stopping on preemption at iteration %d",
                                self.state["neval"] - 1)
                    break
        finally:
            if watchdog is not None:
                watchdog.on_stall = None
                watchdog.reset()
        self.state["records_processed"] = records_this_epoch
        log.info("training finished in %.1fs", time.perf_counter() - wall0)
        # the fleet-mean phase breakdown: a collective, safe here since
        # every rank leaves the loop at the same iteration
        log.info("phase breakdown: %s",
                 self.metrics.aggregate(group).summary())
        with tracer.span("train/publish", cat="train", final=True,
                         iteration=self.state["neval"] - 1):
            publish_state()
        self._footprint = None
        return self.model

    def _run_validation(self):
        results = self._validate()
        for method, result in results:
            log.info("%s is %s", method, result)
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(
                    str(method), result.result()[0], self.state["neval"] - 1)
        self.validation_results = results

    def collective_footprint(self) -> dict:
        """Bytes each collective family produced in one training step
        (the first of the last ``optimize()``): the all-gather row is the
        reference's "get weights average" traffic, the reduce-scatter
        and all-reduce rows its "aggregate gradient time" (ref
        optim/DistriOptimizer.scala:115-213)."""
        if self._footprint is not None:
            return self._footprint
        if not self._record.ops:
            raise RuntimeError("run optimize() first — the footprint is "
                               "read from the collectives a step issued")
        from bigdl_tpu_torch.utils import profiling
        self._footprint = profiling.collective_footprint(self._record.ops)
        return self._footprint

    def _validate(self):
        if getattr(self, "_validator", None) is None:
            self._validator = DistriValidator(
                self.model, self.validation_dataset, self.mesh)
        return self._validator.test(self.validation_methods)


class DistriValidator(Validator):
    """Sharded evaluation (ref optim/DistriValidator.scala:29): each rank
    runs the eval forward over its dataset.  A ``DistributedDataSet``
    holds one shard a rank, so the per-rank results reduce to one (the
    monoid's sum, through an all_gather of each rank's result); a local
    dataset is whole on every rank, and its result is the rank's own."""

    def __init__(self, model, dataset: AbstractDataSet, mesh=None):
        super().__init__(model, dataset)
        self.mesh = mesh

    @torch.no_grad()
    def test(self, methods: Sequence[ValidationMethod]):
        model = self.model
        device = tree_leaves(model.params)[0].device
        if self.mesh is None:
            init_world(device.type)
            self.mesh = data_parallel_mesh(device_type=device.type)
        group = self.mesh.get_group(DATA_AXIS)
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
        world = dist.get_world_size(group)
        if world > 1 and is_distributed(self.dataset):
            gathered = [None] * world
            dist.all_gather_object(gathered, totals, group=group)
            totals = [None] * len(methods)
            for per_rank in gathered:
                for i, r in enumerate(per_rank):
                    if r is not None:
                        totals[i] = r if totals[i] is None else totals[i] + r
        return list(zip(methods, totals))
