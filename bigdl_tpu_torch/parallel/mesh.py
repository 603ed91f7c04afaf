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
from typing import Optional

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
