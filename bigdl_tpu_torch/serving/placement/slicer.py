"""MeshSlicer: carve a device set into replica slots (port of
``bigdl_tpu/serving/placement/slicer.py``).

A *slot* is the serving unit of placement: a contiguous group of ``tp``
devices carrying one engine replica, tensor-parallel within the slot.
Data parallelism across slots is not a mesh axis: it is the replica
set's least-loaded dispatch, so a dead slot is a replica-death event the
resilience layer already handles, not a collective hang.

The reference's slot is a JAX ``Mesh`` over devices of one process.
The port's tensor parallelism is DTensor over the ranks of a process
world, one rank per device (``parallel.mesh``), so a slot takes one of
two forms:

- ``tp == 1``: one device, its card (the reference's replica slots:
  each replica of a set, each disaggregated phase, on its own card).
  ``replicated()`` and ``input_sharding()`` name that device;
- ``tp > 1``: a ``DeviceMesh`` over the slot's ranks with the one axis
  ``model``; its shardings are ``parallel.mesh.NamedSharding`` s.  Every
  rank of the slot builds the same engine over DTensor parameters, is
  handed the same requests, and returns the same streams: its
  schedulers decide each round together over the slot's host-side
  ``control`` group (:mod:`~bigdl_tpu_torch.serving.placement.lockstep`).
  Creating a mesh or a group is collective, so every rank of the world
  carves, and carving ``tp > 1`` with no world running raises
  :class:`PlacementError`.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.mesh import MODEL_AXIS, replicated
from bigdl_tpu_torch.serving.placement.topology import (DeviceTopology,
                                                        world_rank)


_CARVES = itertools.count()


class PlacementError(RuntimeError):
    """A carve, acquire or build that the device set cannot satisfy."""


class MeshSlice:
    """One replica slot: ``tp`` devices, under a 1-D ``model``-axis
    ``DeviceMesh`` when ``tp > 1``.

    The slice is the engine's placement parameter: it names the device
    the engine builds on and derives every sharding the engine needs.

    Args:
        slot_id: the slot's index in its carve.
        devices: the slot's ``tp`` devices.
        tp: tensor-parallel degree.
        ids: the devices' ids (positions in their topology; default
            ``0 .. tp-1``).
        per_rank: device ``ids[i]`` belongs to world rank ``ids[i]``
            (always so for ``tp > 1``).
    """

    __slots__ = ("slot_id", "devices", "tp", "mesh", "control", "ranks",
                 "device_ids")

    def __init__(self, slot_id: int, devices: Sequence, tp: int,
                 ids: Optional[Sequence[int]] = None, *,
                 per_rank: bool = False):
        if len(devices) != tp:
            raise PlacementError(
                f"slot {slot_id}: {len(devices)} devices != tp={tp}")
        self.slot_id = int(slot_id)
        self.devices = tuple(torch.device(d) for d in devices)
        self.tp = int(tp)
        self.device_ids = tuple(int(i) for i in (ids if ids is not None
                                                 else range(tp)))
        #: the world ranks that hold the slot; None: this process does
        self.ranks = self.device_ids if (per_rank or tp > 1) else None
        self.mesh = None
        #: the slot's ranks' host-side (gloo) group, for the schedulers'
        #: lockstep; None for ``tp == 1``
        self.control = None
        if tp > 1:
            if world_rank() is None:
                raise PlacementError(
                    f"tensor parallelism (tp={tp}) needs one rank per "
                    "device: start a process world first "
                    "(bigdl_tpu_torch.parallel.init_world in every rank, "
                    "or launch with torchrun), then carve on every rank")
            world = dist.get_world_size()
            if max(self.device_ids) >= world:
                raise PlacementError(
                    f"slot {slot_id} wants ranks {list(self.device_ids)}; the "
                    f"process world has {world}")
            from torch.distributed.device_mesh import DeviceMesh
            # collective: every rank of the world builds every slot's mesh
            self.mesh = DeviceMesh(self.devices[0].type,
                                   list(self.device_ids),
                                   mesh_dim_names=(MODEL_AXIS,))
            # DTensor caches sharding decisions per thread, keyed by the
            # mesh, and a mesh compares equal to any earlier one over the
            # same ranks: a thread that served an earlier carve would
            # reach that carve's groups while a fresh thread on another
            # rank reaches this one's, and their collectives never pair.
            # A token drawn in carve order (the same on every rank) makes
            # this mesh its own.
            self.mesh._thread_id = ("carve", next(_CARVES))
            self.mesh._hash = None
            self.control = dist.new_group(list(self.device_ids),
                                          backend="gloo")

    @property
    def tag(self) -> str:
        """Stable string for graph-cache keys and stats: the same bucket
        made for another slot (other devices) must not share an entry."""
        return (f"slot{self.slot_id}:tp{self.tp}:"
                f"d{','.join(str(i) for i in self.device_ids)}")

    @property
    def lead(self) -> Optional[int]:
        """The slot's lead rank (its first): the one that answers for
        the slot when a driver forwards work to it; None for a slot of
        this process's own cards."""
        return self.ranks[0] if self.ranks is not None else None

    def holds_this_rank(self) -> bool:
        """Whether the calling process drives a device of this slot:
        always, for a slot of this process's own cards; else when its
        world rank is one of the slot's."""
        return self.ranks is None or world_rank() in self.ranks

    @property
    def device(self) -> torch.device:
        """The calling process's device of the slot: the slot's card,
        or, for a slot over ranks, this rank's.  Raises
        :class:`PlacementError` when the slot does not hold the rank."""
        if self.ranks is None:
            return self.devices[0]
        rank = world_rank()
        if rank not in self.ranks:
            raise PlacementError(
                f"{self!r} is held by ranks {list(self.ranks)}, not by "
                f"this process (rank {rank}): build its engine on those "
                "ranks")
        return self.devices[self.ranks.index(rank)]

    def replicated(self):
        """Where a value held whole by the slot lives: the slot's device
        (``tp == 1``), or a ``NamedSharding`` replicating it over the
        slot's mesh."""
        return self.device if self.mesh is None else replicated(self.mesh)

    def input_sharding(self):
        """Where staged request payloads land: replicated on the slot
        (tensor parallelism shards weights, not the batch: every rank
        sees the whole batch)."""
        return self.replicated()

    def lockstep(self):
        """A scheduler's :class:`~bigdl_tpu_torch.serving.placement.\
lockstep.Lockstep` on this slot; None for ``tp == 1``, whose scheduler
        decides alone."""
        if self.control is None:
            return None
        from bigdl_tpu_torch.serving.placement.lockstep import Lockstep
        return Lockstep(self)

    def describe(self) -> dict:
        return {"slot_id": self.slot_id, "tp": self.tp,
                "device_ids": list(self.device_ids)}

    def __repr__(self) -> str:
        return f"MeshSlice({self.tag})"


class MeshSlicer:
    """Carve a :class:`DeviceTopology` into equal-width replica slots."""

    def __init__(self, topology: Optional[DeviceTopology] = None):
        self.topology = topology or DeviceTopology.detect()

    def max_slots(self, tp: int = 1) -> int:
        """How many tp-wide slots the device set can hold."""
        if tp < 1:
            raise PlacementError(f"tp must be >= 1, got {tp}")
        return self.topology.n_devices // tp

    def carve(self, slots: int, tp: int = 1) -> List[MeshSlice]:
        """``slots`` slices of ``tp`` contiguous devices each.

        Contiguity matters on real hardware: adjacent ranks of one host
        share its fastest links (NVLink), the same reason the reference
        pinned one executor's task slots to one physical node.
        """
        if slots < 1:
            raise PlacementError(f"slots must be >= 1, got {slots}")
        need = slots * tp
        have = self.topology.n_devices
        if need > have:
            raise PlacementError(
                f"cannot carve {slots} slot(s) x TP{tp} = {need} devices "
                f"from a {have}-device topology"
                f"{' (degraded detection)' if self.topology.degraded else ''}")
        devs = self.topology.devices
        return [MeshSlice(i, devs[i * tp:(i + 1) * tp], tp,
                          range(i * tp, (i + 1) * tp),
                          per_rank=self.topology.per_rank)
                for i in range(slots)]
