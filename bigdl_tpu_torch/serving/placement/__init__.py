"""bigdl_tpu_torch.serving.placement: device topology, slot carving and
replica placement for serving across devices (port of
``bigdl_tpu/serving/placement``).

The reference framework's core trick was mapping each physical compute
unit to a Spark task slot so one engine drove the whole cluster
(Engine.init, arXiv 1804.05839).  The reference package carves its JAX
devices into named submeshes, N data-parallel replica *slots* x M-way
tensor parallelism within a slot, and lets GSPMD insert the collectives.
The port's tensor parallelism is DTensor over a process world, one rank
per device (``parallel.mesh``), so a slot is either one card of this
process (``tp == 1``) or a ``model``-axis ``DeviceMesh`` over ``tp``
ranks, every one of which builds the same engine (see
:mod:`~bigdl_tpu_torch.serving.placement.slicer`).

Three layers, smallest first:

- :class:`DeviceTopology`: the cards of this process, or one device per
  rank of a running world; an empty degraded set when the query fails;
- :class:`MeshSlicer`: carve the device set into :class:`MeshSlice`
  slots (contiguous, disjoint);
- :class:`PlacementPolicy`: pack replicas onto slots (acquire/release
  with headroom accounting), publish ``serving/placement/*`` gauges.

A replica set or a disaggregated pair whose slots sit on other ranks of
a world runs *forwarded*: world rank 0 drives, and a :class:`Channel`
per slot carries its requests to the slot's ranks
(:mod:`~bigdl_tpu_torch.serving.placement.forward`).

:func:`serving_tp_rules` and :func:`shard_params_chunked` stage a served
module's parameters onto a slot: copied onto its card, or each rank's
shard wrapped as a DTensor.
"""
from bigdl_tpu_torch.serving.placement.forward import Channel
from bigdl_tpu_torch.serving.placement.policy import PlacementPolicy
from bigdl_tpu_torch.serving.placement.rules import (serving_tp_rules,
                                                     shard_params_chunked)
from bigdl_tpu_torch.serving.placement.slicer import (MeshSlice, MeshSlicer,
                                                      PlacementError)
from bigdl_tpu_torch.serving.placement.topology import DeviceTopology

__all__ = [
    "Channel", "DeviceTopology", "MeshSlice", "MeshSlicer", "PlacementError",
    "PlacementPolicy", "serving_tp_rules", "shard_params_chunked",
]
