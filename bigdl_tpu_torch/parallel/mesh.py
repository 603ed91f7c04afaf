"""The process world and its device meshes (port of
``bigdl_tpu/parallel/mesh.py``; ref utils/Engine.scala topology
discovery).

The reference puts N chips of one process on the axes of a JAX
``Mesh``.  Here one process drives one device (one rank per card, as
NCCL wants), so a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the initialised world.  Axis names are the
reference's, so layers and optimizers agree on them:

  data     - batch sharding (the reference's only strategy)
  model    - tensor parallelism (width sharding)
  sequence - sequence/context parallelism (ring attention)
  pipeline - pipeline stages
  expert   - mixture-of-experts

:func:`init_world` starts the world: from ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` when ``torchrun`` sets them, else a world of one over a
``file://`` store in a temporary directory (no TCP port).  On a card the
world's CUDA tensors go through NCCL on ``cuda:LOCAL_RANK`` (the group is
``cpu:gloo,cuda:nccl``, so host tensors have gloo and a card's never
do); a world the caller starts on the CPU is gloo alone.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"
PIPELINE_AXIS = "pipeline"
EXPERT_AXIS = "expert"


def init_world(device=None, *, init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Start ``torch.distributed`` unless it runs already; returns this
    rank's device.  ``device`` is ``"cuda"`` (the default: NCCL, the
    rank's card ``cuda:LOCAL_RANK``) or ``"cpu"`` (gloo).  ``rank``,
    ``world_size`` and ``init_method`` override the environment.  A
    running world is kept, and must carry the device asked for: NCCL
    for the card, gloo for the CPU; else this raises."""
    from bigdl_tpu_torch.device import resolve_device
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if dist.is_initialized():
        _check_backend("cuda" if cuda else "cpu")
        return rank_device() if cuda else torch.device("cpu")
    env = os.environ
    if rank is None and "RANK" in env and "WORLD_SIZE" in env:
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    else:
        rank = 0 if rank is None else int(rank)
        world_size = 1 if world_size is None else int(world_size)
        local = rank
        if init_method is None:
            if world_size != 1:
                raise ValueError("a world of more than one rank needs an "
                                 "init_method (or torchrun's environment)")
            store = tempfile.mkdtemp(prefix="bigdl_tpu_torch_world_")
            init_method = f"file://{os.path.join(store, 'store')}"
    if cuda:
        dev = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(dev)
        dist.init_process_group("cpu:gloo,cuda:nccl", init_method=init_method,
                                rank=rank, world_size=world_size)
        return dev
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size)
    return torch.device("cpu")


def shutdown_world() -> None:
    """Destroy the default process group (and every mesh's groups)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device() -> torch.device:
    """This rank's device: its card when the world has NCCL, else the
    CPU."""
    if "nccl" in str(dist.get_backend()):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check_backend(device_type: str) -> None:
    """Raise unless the running world's backend serves ``device_type``:
    a card's tensors need NCCL, a host's gloo."""
    backend = str(dist.get_backend())
    need = "nccl" if device_type == "cuda" else "gloo"
    if need not in backend:
        raise RuntimeError(
            f"{device_type!r} was asked for, but the running process "
            f"world's backend is {backend!r}, which has no {need}: start "
            f"the world on that device (init_world({device_type!r})) or "
            f"name the device it runs on")


def _device_type(device_type: Optional[str]) -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process world: call init_world() first")
    device_type = device_type or rank_device().type
    _check_backend(device_type)
    return device_type


def create_mesh(axes: Optional[dict] = None,
                device_type: Optional[str] = None):
    """A DeviceMesh from {axis_name: size} over every rank of the world.
    With no axes: all ranks on the data axis.  The sizes must multiply
    to the world size (one axis may be -1 to absorb the remainder).
    ``device_type`` defaults to the rank's device's; ``"cpu"`` makes a
    host mesh in a world that has gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _device_type(device_type)
    n = dist.get_world_size()
    if not axes:
        axes = {DATA_AXIS: n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {n} ranks")
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def data_parallel_mesh(n_devices: Optional[int] = None,
                       device_type: Optional[str] = None):
    """A 1-D mesh on the data axis over ranks ``0 .. n_devices - 1``
    (default: the whole world).  Every rank of the world calls it; a
    rank outside the mesh gets one whose ``get_coordinate()`` is None."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 0
    n = world if n_devices is None else int(n_devices)
    if n > world or n < 1:
        raise ValueError(f"a data-parallel mesh of {n} ranks needs {n} "
                         f"ranks; this world has {world} (CUDA devices "
                         f"visible: {torch.cuda.device_count()})")
    if n == world:
        return create_mesh({DATA_AXIS: n}, device_type)
    return DeviceMesh(_device_type(device_type), list(range(n)),
                      mesh_dim_names=(DATA_AXIS,))


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


# --------------------------------------------------------------------- #
# shardings, axes and the collectives of the model-parallel strategies  #
# --------------------------------------------------------------------- #
class NamedSharding:
    """A mesh and a spec naming, for each dimension of a tensor, the mesh
    axis it is split over (None: not split); the reference's
    ``NamedSharding(mesh, PartitionSpec(*spec))``.  ``placements`` is
    the same as DTensor placements, one per mesh dimension."""

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                out[names.index(axis)] = Shard(dim)
        return tuple(out)


def batch_sharding(mesh, ndim: int, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard dim 0 (batch) over ``axis``, replicate the rest."""
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


class MeshAxis:
    """One named axis of ``mesh`` as this rank sees it: its ``size``,
    this rank's ``index`` along it, its process ``group`` (the ranks that
    differ from this one only along the axis) and their global ``ranks``
    in index order.  The per-rank bodies of the strategies take one where
    the reference's take an axis name bound by ``shard_map``."""

    def __init__(self, mesh, name: str):
        if name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"the mesh has no axis {name!r}; its axes are "
                             f"{mesh.mesh_dim_names}")
        self.mesh, self.name = mesh, name
        self.group = mesh.get_group(name)
        self.size = dist.get_world_size(self.group)
        self.index = int(mesh.get_local_rank(name))
        self.ranks = [dist.get_global_rank(self.group, i)
                      for i in range(self.size)]


def _axes(mesh, axes) -> list:
    """MeshAxis objects for a name, a MeshAxis or a sequence of either;
    None entries are dropped."""
    if axes is None or isinstance(axes, (str, MeshAxis)):
        axes = [axes]
    return [a if isinstance(a, MeshAxis) else MeshAxis(mesh, a)
            for a in axes if a is not None]


def _send_recv(tensors, axis: MeshAxis, shift: int) -> list:
    """Send each tensor ``shift`` places up the axis and receive the
    same shapes from ``shift`` places down, all in one
    ``batch_isend_irecv`` (no rank waits on a send before its receive)."""
    n = axis.size
    dst = axis.ranks[(axis.index + shift) % n]
    src = axis.ranks[(axis.index - shift) % n]
    ops, outs = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, axis.group))
        ops.append(dist.P2POp(dist.irecv, out, src, axis.group))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _RingPermute(torch.autograd.Function):
    """``lax.ppermute`` by ``shift`` along one axis: rank i's tensors go
    to rank i + shift; the backward sends the cotangents back."""

    @staticmethod
    def forward(ctx, axis, shift, *tensors):
        ctx.axis, ctx.shift = axis, shift
        outs = _send_recv(tensors, axis, shift)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        floats = [i for i, g in enumerate(grads) if g.is_floating_point()]
        back = _send_recv([grads[i] for i in floats], ctx.axis, -ctx.shift)
        out = [None] * len(grads)
        for i, g in zip(floats, back):
            out[i] = g
        return (None, None, *out)


def ring_permute(tensors, axis: MeshAxis, shift: int = 1):
    """Rotate ``tensors`` (one tensor or a sequence) ``shift`` ranks up
    ``axis``: this rank gets the tensors of rank index - shift.
    Differentiable; integer tensors ride along without gradients.  On
    an axis of one rank it returns its input and launches nothing."""
    single = isinstance(tensors, torch.Tensor)
    seq = [tensors] if single else list(tensors)
    if axis.size == 1:
        return tensors if single else tuple(seq)
    outs = _RingPermute.apply(axis, shift, *seq)
    return outs[0] if single else tuple(outs)


def _all_gather_cat(x, axis: MeshAxis, dim: int):
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def _chunk(x, axis: MeshAxis, dim: int):
    if x.shape[dim] % axis.size:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"divide over the {axis.name!r} axis of "
                         f"{axis.size}")
    return x.chunk(axis.size, dim=dim)[axis.index]


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _chunk(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, ctx.axis, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.axis, ctx.dim).contiguous(), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axes, *tensors):
        ctx.axes = axes
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        for axis in ctx.axes:
            works = [dist.all_reduce(g, group=axis.group, async_op=True)
                     for g in grads]
            for w in works:
                w.wait()
        return (None, *grads)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        x = x.clone()
        dist.all_reduce(x, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def scatter_to_axis(x, mesh, axes, dim: int):
    """This rank's chunk of the global ``x`` along ``dim``, split over
    ``axes`` (a name, a MeshAxis or several, outermost first); the
    backward gathers the chunks' gradients, so a replicated ``x`` gets
    its whole gradient on every rank."""
    for axis in _axes(mesh, axes):
        if axis.size > 1:
            x = _Scatter.apply(x, axis, dim)
    return x


def gather_from_axis(x, mesh, axes, dim: int):
    """The global tensor from every rank's chunk along ``dim`` (the
    inverse of :func:`scatter_to_axis`); the backward keeps this rank's
    chunk of the gradient."""
    for axis in reversed(_axes(mesh, axes)):
        if axis.size > 1:
            x = _Gather.apply(x, axis, dim)
    return x


def copy_to_axis(tensors, mesh, axes):
    """``tensors`` (a sequence) as they are; the backward sums their
    gradients over ``axes``: for a replicated input that each rank uses
    on its own part of the work (its shard of the tokens, its stage)."""
    axes = [a for a in _axes(mesh, axes) if a.size > 1]
    tensors = list(tensors)
    if not axes or not tensors:
        return tensors
    return list(_Copy.apply(axes, *tensors))


def reduce_from_axis(x, mesh, axes):
    """The sum of ``x`` over ``axes``, the same on every rank (``psum``
    into a replicated value); the backward is the identity."""
    for axis in _axes(mesh, axes):
        if axis.size > 1:
            x = _Reduce.apply(x, axis)
    return x
