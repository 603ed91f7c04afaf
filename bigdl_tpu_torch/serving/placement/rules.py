"""Sharding rules for SERVED nn modules, and a chunked loader onto a slot
(port of ``bigdl_tpu/serving/placement/rules.py``).

``parallel.tensor_parallel`` writes its specs for (in, out) training
weights; ``nn.Linear`` keeps the Torch layout, weight (output_size,
input_size) with y = x @ W.T, so the Megatron dims flip: column-parallel
(shard the OUTPUT dim, no forward communication) is ("model", None)
here and row-parallel (shard the INPUT dim, one all-reduce) is (None,
"model").

:func:`serving_tp_rules` derives the alternating col/row pairing from
the module tree itself (forward-order Linears inside containers), which
also makes it layout-uniform over int8 ``QTensor`` leaves.  A QTensor
crosses as its two children, as the reference's pytree node does: ``q``
at path ``(..., 0)`` shaped like the weight and ``scale`` at ``(...,
1)``, (out, 1) keepdims, so one divisibility-guarded shape rule shards
q and scale together under col and replicates the (out, 1) scale under
row.  A dim the TP degree does not divide stays replicated.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from bigdl_tpu_torch.parallel.mesh import MODEL_AXIS, NamedSharding
from bigdl_tpu_torch.parallel.tensor_parallel import keystr
from bigdl_tpu_torch.quant.qtensor import QTensor, is_qtensor

#: ``rules(path, leaf) -> NamedSharding | None``
Rules = Callable[[tuple, Any], Optional[NamedSharding]]


def _linear_prefixes(module, prefix: str = "") -> list:
    """Param-path prefixes of every Linear, in forward order."""
    from bigdl_tpu_torch.nn.linear import Linear
    if isinstance(module, Linear):
        return [prefix]
    out = []
    mods = getattr(module, "modules", None)
    if isinstance(mods, (list, tuple)):
        for i, m in enumerate(mods):
            out.extend(_linear_prefixes(m, f"{prefix}['{i}']"))
    return out


def serving_tp_rules(module, mesh, axis: str = MODEL_AXIS) -> Rules:
    """Megatron col/row alternation over a served module's Linears.

    Returns a ``rules(path, leaf)`` callable for
    :func:`shard_params_chunked` / ``tensor_parallel.shard_params``
    (``mesh`` a ``DeviceMesh`` with the ``axis`` dimension).  Leaves
    outside any Linear, and dims ``tp`` does not divide, return None
    (the caller replicates).  TransformerLM serving does not go through
    this: it has its own layer-stacked ``transformer_lm_tp_rules``.
    """
    tp = int(mesh.size(list(mesh.mesh_dim_names).index(axis)))
    prefixes = _linear_prefixes(module)

    def _col(shp) -> Optional[NamedSharding]:
        # shard dim 0: weight (out, in), bias (out,), qscale (out, 1)
        if len(shp) >= 1 and shp[0] >= tp and shp[0] % tp == 0:
            return NamedSharding(mesh, (axis,) + (None,) * (len(shp) - 1))
        return None

    def _row(shp) -> Optional[NamedSharding]:
        # shard dim 1: weight (out, in); bias and the (out, 1) qscale
        # stay replicated: the all-reduced output is whole on every rank
        if len(shp) >= 2 and shp[1] >= tp and shp[1] % tp == 0:
            return NamedSharding(mesh, (None, axis) + (None,) * (len(shp) - 2))
        return None

    def rules(path, leaf):
        if tp <= 1:
            return None
        name = keystr(path)
        shp = tuple(getattr(leaf, "shape", ()))
        for j, pfx in enumerate(prefixes):
            if name.startswith(pfx + "["):
                return _col(shp) if j % 2 == 0 else _row(shp)
        return None

    return rules


def _host(t) -> torch.Tensor:
    """A leaf as a host tensor (a copy off a device)."""
    if isinstance(t, np.ndarray):
        return torch.from_numpy(t)
    return t.detach().cpu()


def _put(host: torch.Tensor, device, chunk_bytes: int) -> torch.Tensor:
    """``host`` onto ``device`` through the chunked staging path."""
    from bigdl_tpu_torch.utils.transfer import chunked_device_put
    a = host.contiguous()
    arr = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return chunked_device_put(arr, a.dtype, device=device,
                              chunk_bytes=chunk_bytes)


def _local_shard(host: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of ``host`` under ``placements`` (DTensor's
    ``torch.chunk`` split along each sharded dim)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            host = host.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return host


def shard_params_chunked(params: Any, rules: Rules, placement, *,
                         chunk_bytes: Optional[int] = None) -> Any:
    """Put every leaf of ``params`` on ``placement`` (a
    :class:`~bigdl_tpu_torch.serving.placement.MeshSlice`), each through
    the chunked staging copy (``utils.transfer.chunked_device_put``,
    32 MB slices by default), in one pass:

    - ``tp == 1``: onto the slot's device; a leaf already there is kept
      as it is (no copy);
    - ``tp > 1``: each rank stages only its own shard of each leaf (per
      ``rules(path, leaf)``, replicated where they return None) and wraps
      it with ``DTensor.from_local``: the dense tree is never staged on
      one device first.  A QTensor crosses in the dequant compute mode:
      ``torch._int_mm``, its int8 product, has no DTensor rule, so its
      shards expand inside the product, as the reference's entry seam
      expands a non-native QTensor.
    """
    from bigdl_tpu_torch.utils.transfer import DEFAULT_CHUNK_BYTES
    if chunk_bytes is None:
        chunk_bytes = DEFAULT_CHUNK_BYTES
    mesh = placement.mesh
    device = placement.device

    def place(path, leaf):
        if mesh is None:
            if isinstance(leaf, torch.Tensor) and leaf.device == device:
                return leaf
            return _put(_host(leaf), device, chunk_bytes)
        from torch.distributed.tensor import DTensor
        spec = rules(path, leaf) or NamedSharding(mesh, ())
        host = _host(leaf)
        local = _put(_local_shard(host, mesh, spec.placements), device,
                     chunk_bytes)
        return DTensor.from_local(local, mesh, spec.placements,
                                  run_check=False, shape=host.shape,
                                  stride=host.contiguous().stride())

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        if is_qtensor(node):
            compute = node.compute if mesh is None else "dequant"
            return QTensor(place(path + (0,), node.q),
                           place(path + (1,), node.scale), node.orig_dtype,
                           node.native, compute, node.act_scale)
        if node is None:
            return None
        return place(path, node)

    return walk(params, ())
