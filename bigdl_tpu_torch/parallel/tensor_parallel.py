"""Tensor (model) parallelism: width-sharded layers over the ``model``
mesh axis (port of ``bigdl_tpu/parallel/tensor_parallel.py``).

The reference puts ``NamedSharding``s on the parameters and lets GSPMD
insert the collectives.  Here a parameter becomes a DTensor
(``torch.distributed.tensor``) with the same placements, and the
model's unchanged forward runs on the sharded tree: DTensor's sharding
propagation inserts the collectives.  The Megatron pairing, column
parallel (output dim split, no forward communication) into row
parallel (input dim split, one all-reduce), means one collective per
attention block and one per MLP.

The hand-written kernels never see a DTensor: a tensor-parallel model
runs its plain attention core (:func:`pin_xla_attention`).  Serving's
cached steps (``models/transformer/generate.py``) gather q/k/v whole
before attention instead, so a served slot keeps the kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                           NamedSharding, batch_sharding,
                                           replicated)


def keystr(path: tuple) -> str:
    """A key path as ``jax.tree_util.keystr`` prints it: ``"['blocks']
    ['attn']['wq']"`` (no spaces), so the reference's rules match."""
    return "".join(f"[{k!r}]" for k in path)


def column_parallel_spec(mesh, axis: str = MODEL_AXIS) -> NamedSharding:
    """(in, out) weight with the OUTPUT dim sharded: y = x @ W yields
    activations sharded on their last dim; no forward communication."""
    return NamedSharding(mesh, (None, axis))


def row_parallel_spec(mesh, axis: str = MODEL_AXIS) -> NamedSharding:
    """(in, out) weight with the INPUT dim sharded: consumes
    column-parallel activations; one all-reduce on the output."""
    return NamedSharding(mesh, (axis, None))


def replicated_spec(mesh) -> NamedSharding:
    return replicated(mesh)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params: Any,
                 rules: Callable[[tuple, Any], Optional[NamedSharding]],
                 mesh) -> Any:
    """A tree of DTensors: each leaf placed by ``rules(path, leaf)``,
    replicated where a rule returns None.  ``path`` is the tuple of keys
    down to the leaf (match by name with :func:`keystr`).  Every rank
    passes the same tree; a leaf that requires grad keeps requiring
    it."""
    from torch.distributed.tensor import distribute_tensor
    rep = replicated_spec(mesh)

    def place(path, leaf):
        sharding = rules(path, leaf) or rep
        with torch.no_grad():
            out = distribute_tensor(leaf.detach(), mesh, sharding.placements)
        return out.requires_grad_(leaf.requires_grad)

    return _map_with_path(place, params)


def mha_tp_rules(mesh, axis: str = MODEL_AXIS):
    """Sharding rules for ``MultiHeadAttention`` params: q/k/v projections
    column-parallel (heads shard over ``axis``), output projection
    row-parallel: the Megatron attention pattern (one all-reduce)."""
    col, row, rep = (column_parallel_spec(mesh, axis),
                     row_parallel_spec(mesh, axis), replicated_spec(mesh))

    def rules(path, leaf):
        name = keystr(path)
        if any(w in name for w in ("wq", "wk", "wv")):
            return col
        if "wo" in name:
            return row
        if any(b in name for b in ("bq", "bk", "bv")):
            return NamedSharding(mesh, (axis,))  # the bias follows its shard
        return rep

    return rules


def mlp_tp_rules(mesh, first_weight: str, second_weight: str,
                 axis: str = MODEL_AXIS):
    """Column-parallel first linear, row-parallel second: matches any
    two-layer MLP given the key-path substrings of its weights."""
    col, row, rep = (column_parallel_spec(mesh, axis),
                     row_parallel_spec(mesh, axis), replicated_spec(mesh))

    def rules(path, leaf):
        name = keystr(path)
        if first_weight in name:
            return col if leaf.ndim == 2 else NamedSharding(mesh, (axis,))
        if second_weight in name:
            return row if leaf.ndim == 2 else rep
        return rep

    return rules


def constrain_batch(x, mesh, axis: str = DATA_AXIS):
    """``x`` (the global batch, the same on every rank) as a DTensor
    with its batch dim split over ``axis``; a DTensor is redistributed.
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate
    placements = batch_sharding(mesh, x.ndim, axis).placements
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements)


def replicate_on(x, mesh):
    """``x``, a plain tensor every rank holds whole (a served batch), as
    a replicated DTensor on ``mesh``; a DTensor stays as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_step(fn):
    """``fn`` (a serving step over a tensor-parallel tree) with its
    outputs made whole leaf by leaf (``nn._util.whole``) for the host
    pull."""
    from bigdl_tpu_torch.nn._util import whole
    from bigdl_tpu_torch.utils.pytree import tree_map

    def run(*args):
        return tree_map(whole, fn(*args))

    return run


def pin_xla_attention(model) -> None:
    """Put a model's attention on its plain core (``"xla"``), the one a
    sharded tree runs: the flash kernels take plain CUDA tensors, never
    DTensors.  "auto" would pick the kernels on a card.  An explicit
    ``"flash"`` raises rather than degrade."""
    mha = getattr(model, "_mha", None) or getattr(model, "mha", None)
    if mha is None:
        return
    if mha.attention_impl == "flash":
        raise ValueError(
            "attention_impl='flash' cannot be used under tensor-parallel "
            "sharding (the flash kernels take plain tensors, not "
            "DTensors); build the model with attention_impl='xla'")
    mha.attention_impl = "xla"


def transformer_lm_tp_rules(mesh, axis: str = MODEL_AXIS):
    """Megatron sharding of ``TransformerLM``'s layer-STACKED tree (every
    ``blocks`` leaf has a leading ``n_layers`` axis, so the Megatron dims
    shift right by one): attention q/k/v column-parallel over heads, wo
    row-parallel, MLP w1 column / w2 row, embeddings, norms and head
    replicated, MoE stacks replicated (experts shard over the expert
    axis, ``parallel.expert``).  The model's own forward then runs the
    plain attention core (:func:`pin_xla_attention`); a served slot's
    cached steps gather q/k/v whole before attention and keep the
    kernels."""

    def rules(path, leaf):
        name = keystr(path)
        stacked = 1 if "blocks" in name else 0

        def spec(*dims):
            return NamedSharding(mesh, (None,) * stacked + dims)

        if "'moe'" in name:
            return replicated_spec(mesh)
        if any(w in name for w in ("wq", "wk", "wv")):
            return spec(None, axis)          # (h, inner) col-parallel
        if any(b in name for b in ("bq", "bk", "bv")):
            return spec(axis)
        if "wo" in name:
            return spec(axis, None)          # (inner, h) row-parallel
        if "'w1'" in name:
            return spec(None, axis)          # (h, ffn) col-parallel
        if "'b1'" in name:
            return spec(axis)
        if "'w2'" in name:
            return spec(axis, None)          # (ffn, h) row-parallel
        return replicated_spec(mesh)

    return rules
