"""Sequence-parallel TransformerLM (port of
``bigdl_tpu/models/transformer/sp.py``): the forward with the sequence
dimension split over a mesh axis, one shard a rank, and every
attention block running ring attention (or Ulysses) from
``bigdl_tpu_torch.parallel.sequence``.  Activations never hold the full
sequence on one rank until the log-probabilities are gathered at the
end, so context length scales with the ranks.

Everything but attention is token-local (LayerNorm, MLP, embedding,
head), so the only communication inside the layers is the ring itself;
the parameters' gradients are summed over the ranks once, after the
backward (``parallel.sequence.copy_params``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.parallel.mesh import (SEQUENCE_AXIS, MeshAxis,
                                           _all_gather_cat)
from bigdl_tpu_torch.parallel.sequence import (_shard, _unshard, copy_params,
                                               gather_segments,
                                               ring_attention_local,
                                               ulysses_attention_local)
from bigdl_tpu_torch.quant.transform import dequantize_entry
from bigdl_tpu_torch.utils.params import layer_params


def ring_lm_apply(model, params, ids, mesh, *, seq_axis: str = SEQUENCE_AXIS,
                  data_axis: Optional[str] = None, impl: Optional[str] = None,
                  block_size: Optional[int] = None):
    """Sequence-parallel forward of a built ``TransformerLM``: every rank
    passes the same (B, T) 1-based ids, T divisible by the ``seq_axis``
    size (and B by the ``data_axis`` size on a 2-D mesh), and gets the
    (B, T, vocab) float32 log-probabilities.

    The model's configuration is authoritative: ``impl`` defaults to
    "flash" where the model's attention resolves to the flash kernels
    (``attention_impl="flash"``, or "auto" on a CUDA device) and to
    "blocks" else; ``block_size`` to the model's (a pinned flash tile;
    None, the kernel's default tile); ``model.remat`` recomputes each
    block in the backward as the single-device forward does.  Dropout
    is refused (build the model with dropout=0)."""
    mha = model._mha
    if impl is None:
        impl = "flash" if mha.resolve_use_flash(model.device) else "blocks"
    if block_size is None:
        block_size = mha.block_size

    def attn(q, k, v, axis, seg=None):
        return ring_attention_local(q, k, v, axis, causal=True, impl=impl,
                                    block_size=block_size, segment_ids=seg)

    return _sequence_parallel_apply(model, params, ids, mesh,
                                    seq_axis=seq_axis, data_axis=data_axis,
                                    attn_fn=attn)


def ulysses_lm_apply(model, params, ids, mesh, *,
                     seq_axis: str = SEQUENCE_AXIS,
                     data_axis: Optional[str] = None):
    """Ulysses variant of :func:`ring_lm_apply`: each attention block
    exchanges sequence shards for head shards (one all-to-all in, one
    out) and attends over the full sequence on ``n_head / N`` heads.
    The head count must divide by the axis size."""
    n = MeshAxis(mesh, seq_axis).size
    if model.n_head % n != 0:
        raise ValueError(
            f"Ulysses needs n_head ({model.n_head}) divisible by the "
            f"'{seq_axis}' axis size ({n}); use ring_lm_apply otherwise")

    def attn(q, k, v, axis, seg=None):
        return ulysses_attention_local(q, k, v, axis, causal=True,
                                       segment_ids_full=seg)

    # the (B, T) ids are the same in every layer: gather them once
    return _sequence_parallel_apply(model, params, ids, mesh,
                                    seq_axis=seq_axis, data_axis=data_axis,
                                    attn_fn=attn,
                                    seg_prepare=gather_segments)


def _sequence_parallel_apply(model, params, ids, mesh, *, seq_axis,
                             data_axis, attn_fn, seg_prepare=None):
    """The shared body: this rank's shard of the ids, its embedding at
    its global positions, the blocks with ``attn_fn`` as the
    (sequence-split) attention core, the token-local head, and the
    gathered log-probabilities.  ``seg_prepare(seg, axis)`` transforms
    the shard's segment ids once a step, before the layers."""
    if model.dropout > 0.0:
        raise ValueError("sequence-parallel apply does not support "
                         "dropout — build the TransformerLM with dropout=0")
    if model.moe_experts:
        raise ValueError("sequence-parallel apply does not support MoE "
                         "blocks yet — use the single-device forward or "
                         "parallel.expert.moe_apply")
    ids = torch.as_tensor(ids, device=model.device)
    if ids.shape[-1] > model.max_len:
        # a position slice past the table would come back short; fail
        # loudly as the single-device path does
        raise ValueError(
            f"sequence length {ids.shape[-1]} exceeds the model's "
            f"max_len {model.max_len}")
    if ids.is_floating_point():
        ids = ids.to(torch.int32)
    seq = MeshAxis(mesh, seq_axis)
    ids = _shard(ids.long() - 1, mesh, data_axis, seq, 1)
    params = copy_params(dequantize_entry(params), mesh,
                         (seq_axis, data_axis))
    mha = model._mha
    t_local = ids.shape[-1]
    offset = seq.index * t_local
    h = params["embed"][ids]
    # GLOBAL positions of this shard: rope and the learned table key on
    # them (a key rotated at its own position stays right as it travels)
    positions = offset + torch.arange(t_local, device=ids.device)
    if model.pos_encoding == "learned":
        h = h + params["pos"][offset:offset + t_local]

    seg = None
    if model.doc_start_id is not None:
        # GLOBAL segment ids: this shard's cumsum plus the marker totals
        # of every shard before it (one (N, B) all_gather)
        local = torch.cumsum((ids == model.doc_start_id - 1)
                             .to(torch.int32), dim=-1)
        prev = torch.zeros_like(local[..., -1])
        if seq.size > 1:
            totals = _all_gather_cat(local[..., -1:], seq, 1)  # (B, N)
            prev = totals[:, :seq.index].sum(dim=1)
        seg = local + prev[:, None]
        if seg_prepare is not None:
            seg = seg_prepare(seg, seq)

    def block(bp, h):
        a = model._layer_norm(bp["ln1"], h)
        q, k, v = mha.project_qkv(bp["attn"], a, a, a)
        q, k = model._rope(q, k, positions)
        h = h + mha.project_out(bp["attn"], attn_fn(q, k, v, seq, seg))
        m, _ = model._mlp(bp, model._layer_norm(bp["ln2"], h))
        return h + m

    for layer in range(model.n_layers):
        bp = layer_params(params["blocks"], layer)
        if model.remat and torch.is_grad_enabled():
            h = checkpoint(block, bp, h, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = block(bp, h)
    h = model._layer_norm(params["ln_f"], h)
    logp = torch.log_softmax(model.head_logits(params, h).float(), dim=-1)
    return _unshard(logp, mesh, data_axis, seq, 1)
