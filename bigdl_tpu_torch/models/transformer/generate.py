"""Autoregressive decoding for ``TransformerLM`` (port of
``bigdl_tpu/models/transformer/generate.py``).

The reference scans jitted, donated programs over the layer-stacked
parameters; here each function loops over the layers in Python and
updates KV caches and paged arenas IN PLACE (``index_put_``), where the
reference donates them and returns fresh arrays.  The functions still
return the caches they were given, so the two packages share one
contract.  Ids are 0-based inside, 1-based at :func:`generate`'s edge.

The serving steps are capturable as CUDA graphs: every per-call index
(``last_index``, ``prefix_len``, a tree rung's ``depths``/``anc``) may
be a device tensor, and no step reads a value back to the host or
copies one to the device, so one captured graph serves every value of
its inputs.

Quantized params (``TransformerLM.quantize``) serve as they are stored:
each step expands the top-level dequant-mode leaves at its entry and
the stacked blocks' one layer at a time (``_layers``), where the
reference expands the whole tree inside its traced step.  The expansion
is elementwise, so the numbers are the same, and a captured step holds
one layer's float copy instead of the model's.  ``k_scale``/``v_scale``
(L, N, H, B) float32 mark int8 KV arenas (``BlockPool(kv_quant=
"int8")``): rows are quantized per (position, head) on write
(:func:`_kv_quantize_rows`) and dequantized inside the dense gather;
the paged kernel reads float arenas only, as the reference's does.

MoE models decode with dense routing on every path (``_finish_block``),
as the reference's do, so a stream does not depend on its batch.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.attention import dot_product_attention
from bigdl_tpu_torch.ops import flash_attention, paged_decode_attention
from bigdl_tpu_torch.parallel.expert import switch_mlp
from bigdl_tpu_torch.quant.qtensor import true_div
from bigdl_tpu_torch.quant.transform import dequantize_entry
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import layer_params


def _entry(params):
    """The entry seam for the top-level leaves (embeddings, final norm,
    an untied head); the blocks expand per layer in :func:`_layers`."""
    top = dequantize_entry({k: v for k, v in params.items()
                            if k != "blocks"})
    return dict(top, blocks=params["blocks"])


def _layers(model, params):
    """Each layer's params in turn, its dequant-mode leaves expanded as
    it is reached (one layer's float copy alive at a time)."""
    for i in range(model.n_layers):
        yield dequantize_entry(layer_params(params["blocks"], i))


def _kv_quantize_rows(x):
    """Symmetric int8 rows for the quantized KV arenas: ``x`` (..., D)
    float -> (q int8 (..., D), scale float32 (...,)), one absmax scale
    per (position, head) row, bitwise the reference's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = true_div(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _layer_scales(k_scale, v_scale, layer):
    """One layer's (k, v) scale arenas; (None, None) for float arenas."""
    if k_scale is None:
        return None, None
    return k_scale[layer], v_scale[layer]


def _write_rows(kc, vc, ks, vs, blk, off, k, v):
    """Write one layer's new k/v rows (..., H, D) at (``blk``, ``off``)
    in place: as they are into float arenas, quantized with their
    scales into int8 ones (``ks``/``vs`` not None)."""
    if ks is None:
        kc[blk, :, off, :] = k.to(kc.dtype)
        vc[blk, :, off, :] = v.to(vc.dtype)
        return
    kq, ksr = _kv_quantize_rows(k)
    vq, vsr = _kv_quantize_rows(v)
    kc[blk, :, off, :] = kq
    vc[blk, :, off, :] = vq
    ks[blk, :, off] = ksr
    vs[blk, :, off] = vsr


def _gather_rows(arena, scale, index):
    """``arena[index]`` of one layer; int8 rows come back dequantized,
    times their gathered scales in one float32 pass."""
    x = arena[index]
    return x if scale is None else x * scale[index][..., None]


def _block_qkv(model, bp, h):
    """One block's q/k/v for a (B, T, hidden) slice, pre-attention."""
    a = model._layer_norm(bp["ln1"], h)
    return model._mha.project_qkv(bp["attn"], a, a, a)


def _head_logits(model, params, h):
    """LM-head product shared by every decode and prefill path."""
    return model.head_logits(params, h)


def _row_at(h, index):
    """``h[:, index]`` kept as a length-1 axis: a Python int slices, a
    device int tensor (any shape holding one value) gathers on the
    device."""
    if isinstance(index, torch.Tensor):
        return h.index_select(1, index.reshape(1).long())
    return h[:, index:index + 1]


def _finish_block(model, bp, h, o):
    """The block after attention.  An MoE block routes DENSE here, on
    every cached path: the capacity window is a batch-level training
    construct, under which a sequence's tokens would drop depending on
    which other rows share the dispatch; dense per-token routing is
    batch-independent and has static shapes (the balance loss, a
    training term, is dropped)."""
    h = h + model._mha.project_out(bp["attn"], o)
    m = model._layer_norm(bp["ln2"], h)
    if model.moe_experts:
        return h + switch_mlp(bp["moe"], m, capacity_factor=None)[0]
    return h + model._dense_mlp(bp, m)


def _prefill_parts(model, params, ids0, last_index, *,
                   attention_impl: Optional[str] = None,
                   blocks: Optional[tuple] = None):
    """Run a (possibly bucket-padded) prompt once; return (float32
    logits (B, V) at ``last_index``, k, v) with k/v (L, B, H, T, D).
    Padded tail rows stay causally invisible to the row at
    ``last_index`` (an int, or a device int tensor).  ``attention_impl``
    overrides the model's attention core ("flash" runs the CUDA flash
    kernel).  The core resolves for this prefill's length, as the
    reference resolves per trace: explicit "flash" pins the kernel's
    default tile, "auto" takes the tuned plan for the length.
    ``blocks`` (block_q, block_k) pins the kernel's tile (the LM
    engine's per-bucket resolution)."""
    params = _entry(params)
    b, t = ids0.shape
    h = params["embed"][ids0]
    if model.pos_encoding == "learned":
        h = h + params["pos"][:t]
    positions = torch.arange(t, device=ids0.device)
    mha = model._mha
    use_flash = mha.resolve_use_flash(ids0.device, attention_impl,
                                      seq_len=t, dtype=h.dtype)
    bq, bk = (blocks or mha.pinned_tile(h.dtype, attention_impl)
              or (None, None))
    ks, vs = [], []
    for bp in _layers(model, params):
        q, k, v = _block_qkv(model, bp, h)
        q, k = model._rope(q, k, positions)
        if use_flash:
            o = flash_attention(q, k, v, causal=True, block_q=bq,
                                block_k=bk)
        else:
            o = dot_product_attention(q, k, v, causal=True)
        h = _finish_block(model, bp, h, o)
        ks.append(k)
        vs.append(v)
    h = _row_at(h, last_index)
    h = model._layer_norm(params["ln_f"], h)
    logits = _head_logits(model, params, h)[:, 0]
    return logits.float(), torch.stack(ks), torch.stack(vs)


def _prefill(model, params, ids0, cache_len: int):
    """Offline prefill: prompt logits + k/v zero-padded to (L, B, H,
    cache_len, D), ready for the decode loop."""
    t = ids0.shape[1]
    logits, k, v = _prefill_parts(model, params, ids0, t - 1)
    pad = (0, 0, 0, cache_len - t)
    return (logits, torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad))


def _decode_step_slots(model, params, token, pos, k_cache, v_cache):
    """One cached decode step over S independent slots: token (S,)
    0-based, pos (S,) the position each slot writes.  Caches (L, S, H,
    cache_len, D) are written in place.  Returns (float32 logits (S, V),
    k_cache, v_cache)."""
    params = _entry(params)
    s = token.shape[0]
    hd = model._mha.head_dim
    pos = pos.long()
    h = params["embed"][token.long()][:, None, :]
    if model.pos_encoding == "learned":
        # clamped: a drafter's scratch row sits one past max_len when
        # cache_len == max_len (the reference's gather clamps the same)
        h = h + params["pos"][pos.clamp(max=params["pos"].shape[0] - 1)][
            :, None, :]
    positions = pos[:, None, None]
    cache_len = k_cache.shape[3]
    mask = (torch.arange(cache_len, device=pos.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    rows = torch.arange(s, device=pos.device)
    for i, bp in enumerate(_layers(model, params)):
        q, k, v = _block_qkv(model, bp, h)          # (S, H, 1, D)
        q, k = model._rope(q, k, positions)
        kc, vc = k_cache[i], v_cache[i]
        kc[rows, :, pos, :] = k[:, :, 0, :].to(kc.dtype)
        vc[rows, :, pos, :] = v[:, :, 0, :].to(vc.dtype)
        scores = torch.matmul(q.float(), kc.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        o = torch.matmul(torch.softmax(scores, dim=-1), vc.float())
        h = _finish_block(model, bp, h, o.to(h.dtype))
    h = model._layer_norm(params["ln_f"], h)
    logits = _head_logits(model, params, h)[:, 0]
    return logits.float(), k_cache, v_cache


def _prefill_suffix_parts(model, params, ids0, last_index, prefix_len,
                          blocks, k_arena, v_arena, k_scale=None,
                          v_scale=None):
    """Prefill a prompt SUFFIX against a cached prefix held in paged
    blocks: ``ids0`` (1, Ts) is the bucket-padded suffix at absolute
    positions ``prefix_len + i``; ``blocks`` (Pb,) the scratch-padded
    chain holding the prefix in the arenas (L, N, H, B, D).  Returns
    (logits at suffix index ``last_index``, k, v) with k/v (L, 1, H,
    Ts, D), as :func:`_prefill_parts` for the suffix rows.
    ``last_index`` and ``prefix_len`` are ints or device int tensors.

    Attention is plain (as in the reference): the suffix queries attend
    the cached prefix keys (stored post-RoPE, so never rotated again)
    below ``prefix_len`` plus the causal suffix keys.  With
    ``k_scale``/``v_scale`` the prefix gather dequantizes int8 rows; the
    returned suffix k/v stay float (``_insert_blocks`` quantizes
    them)."""
    params = _entry(params)
    b, ts = ids0.shape
    dev = ids0.device
    blen = k_arena.shape[3]
    pb = blocks.shape[0]
    h = params["embed"][ids0]
    positions = prefix_len + torch.arange(ts, device=dev)
    if model.pos_encoding == "learned":
        # clamped for padded tail rows, which stay causally invisible
        h = h + params["pos"][positions.clamp(max=params["pos"].shape[0] - 1)]
    jq = torch.arange(ts, device=dev)[:, None]
    jk = torch.arange(pb * blen + ts, device=dev)[None, :]
    mask = ((jk < prefix_len)
            | ((jk >= pb * blen) & (jk - pb * blen <= jq)))[None, None]
    ks, vs = [], []
    for i, bp in enumerate(_layers(model, params)):
        kc, vc = k_arena[i], v_arena[i]              # (N, H, B, D)
        q, k, v = _block_qkv(model, bp, h)
        q, k = model._rope(q, k, positions)
        n_h, d = kc.shape[1], kc.shape[3]
        ksl, vsl = _layer_scales(k_scale, v_scale, i)
        kp = _gather_rows(kc, ksl, blocks)
        vp = _gather_rows(vc, vsl, blocks)
        kp = kp.permute(1, 0, 2, 3).reshape(1, n_h, pb * blen, d)
        vp = vp.permute(1, 0, 2, 3).reshape(1, n_h, pb * blen, d)
        o = dot_product_attention(q, torch.cat([kp.to(k.dtype), k], dim=2),
                                  torch.cat([vp.to(v.dtype), v], dim=2),
                                  mask=mask)
        h = _finish_block(model, bp, h, o)
        ks.append(k)
        vs.append(v)
    h = _row_at(h, last_index)
    h = model._layer_norm(params["ln_f"], h)
    logits = _head_logits(model, params, h)[:, 0]
    return logits.float(), torch.stack(ks), torch.stack(vs)


def _insert_blocks(k_arena, v_arena, k_new, v_new, block_ids,
                   k_scale=None, v_scale=None):
    """Scatter a prefilled chunk's k/v (L, 1, H, Tb, D) into arena
    blocks (L, N, H, B, D) in place: row i lands in block
    ``block_ids[i // B]`` at offset ``i % B`` (chunks start
    block-aligned).  ``block_ids`` is padded with the scratch block 0,
    which absorbs the bucket-padding rows.  With ``k_scale``/``v_scale``
    (L, N, H, B) the rows are quantized per (position, head) on the way
    in and their scales scattered alongside; returns the four arenas
    then."""
    L, N, H, B, D = k_arena.shape
    nb = block_ids.shape[0]
    tb = k_new.shape[3]
    pad = nb * B - tb
    if pad:
        k_new = torch.nn.functional.pad(k_new, (0, 0, 0, pad))
        v_new = torch.nn.functional.pad(v_new, (0, 0, 0, pad))
    if k_scale is not None:
        kq, ksr = _kv_quantize_rows(k_new[:, 0])     # (L, H, nb*B, D/-)
        vq, vsr = _kv_quantize_rows(v_new[:, 0])
        k_arena[:, block_ids] = kq.reshape(L, H, nb, B, D).permute(
            0, 2, 1, 3, 4)
        v_arena[:, block_ids] = vq.reshape(L, H, nb, B, D).permute(
            0, 2, 1, 3, 4)
        k_scale[:, block_ids] = ksr.reshape(L, H, nb, B).permute(0, 2, 1, 3)
        v_scale[:, block_ids] = vsr.reshape(L, H, nb, B).permute(0, 2, 1, 3)
        return k_arena, v_arena, k_scale, v_scale
    kb = k_new[:, 0].reshape(L, H, nb, B, D).permute(0, 2, 1, 3, 4)
    vb = v_new[:, 0].reshape(L, H, nb, B, D).permute(0, 2, 1, 3, 4)
    k_arena[:, block_ids] = kb.to(k_arena.dtype)
    v_arena[:, block_ids] = vb.to(v_arena.dtype)
    return k_arena, v_arena


def _decode_step_paged(model, params, token, pos, tables, k_arena,
                       v_arena, k_scale=None, v_scale=None, *,
                       attn_impl: str = "gather"):
    """One cached decode step over S slots against PAGED arenas (L, N,
    H, B, D): each slot's KV lives in the blocks named by its row of
    ``tables`` (S, M).  The new k/v row of each slot is written in place
    at (block, offset) from ``pos``; idle slots carry an all-scratch
    table, so their writes land in block 0, which is never attended.
    Attention reads each slot's chain under the position mask, either
    by gathering it into a dense (S, H, M*B, D) view (``"gather"``) or
    in place through the CUDA paged kernel (``"paged_kernel"``; its
    plain version on CPU tensors).  Returns (float32 logits (S, V),
    k_arena, v_arena), and the scale arenas after them for int8 arenas
    (``k_scale``/``v_scale``), which need the gather: the paged kernel
    reads raw float blocks."""
    if attn_impl not in ("gather", "paged_kernel"):
        raise ValueError(f"attn_impl must be 'gather' or 'paged_kernel', "
                         f"got {attn_impl!r}")
    if k_scale is not None and attn_impl == "paged_kernel":
        raise ValueError("kv_quant='int8' requires decode_attn='gather' "
                         "(the paged kernel reads raw float blocks)")
    params = _entry(params)
    mha = model._mha
    s, m = tables.shape
    B = k_arena.shape[3]
    ctx = m * B
    pos_l, tables_l = pos.long(), tables.long()
    h = params["embed"][token.long()][:, None, :]
    if model.pos_encoding == "learned":
        h = h + params["pos"][pos_l][:, None, :]
    positions = pos_l[:, None, None]
    rows = torch.arange(s, device=pos.device)
    blk = tables_l[rows, pos_l // B]
    off = pos_l % B
    if attn_impl == "gather":
        mask = (torch.arange(ctx, device=pos.device)[None, :]
                <= pos_l[:, None])[:, None, None, :]
    for i, bp in enumerate(_layers(model, params)):
        kc, vc = k_arena[i], v_arena[i]              # (N, H, B, D)
        q, k, v = _block_qkv(model, bp, h)           # (S, H, 1, D)
        q, k = model._rope(q, k, positions)
        ksl, vsl = _layer_scales(k_scale, v_scale, i)
        _write_rows(kc, vc, ksl, vsl, blk, off, k[:, :, 0, :], v[:, :, 0, :])
        if attn_impl == "paged_kernel":
            o = paged_decode_attention(q, kc, vc, tables, pos)
        else:
            kg = _gather_rows(kc, ksl, tables_l)
            vg = _gather_rows(vc, vsl, tables_l)
            kg = kg.permute(0, 2, 1, 3, 4).reshape(
                s, mha.n_head, ctx, mha.head_dim)
            vg = vg.permute(0, 2, 1, 3, 4).reshape(
                s, mha.n_head, ctx, mha.head_dim)
            scores = torch.matmul(q.float(), kg.float().transpose(-1, -2))
            scores = scores / math.sqrt(mha.head_dim)
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
            o = torch.matmul(torch.softmax(scores, dim=-1), vg.float())
        h = _finish_block(model, bp, h, o.to(h.dtype))
    h = model._layer_norm(params["ln_f"], h)
    logits = _head_logits(model, params, h)[:, 0]
    if k_scale is not None:
        return logits.float(), k_arena, v_arena, k_scale, v_scale
    return logits.float(), k_arena, v_arena


def _score_candidates(model, params, tokens, rope_pos, store, n_cand, mask,
                      tables, k_arena, v_arena, k_scale=None, v_scale=None):
    """The verify steps' shared body: W candidate rows per slot, row j of
    slot s rotated (and, for learned positions, embedded) at
    ``rope_pos[s, j]``, its k/v written in place at arena position
    ``store[s, j]`` (rows >= ``n_cand[s]`` go to the scratch block 0,
    which is never attended), attending the slot's gathered chain under
    ``mask`` (S, 1, W, ctx) with float32 scores.  Returns (float32 logits
    (S, W, V), k_arena, v_arena), and the scale arenas after them for
    int8 arenas."""
    params = _entry(params)
    mha = model._mha
    s, w = tokens.shape
    m = tables.shape[1]
    B = k_arena.shape[3]
    ctx = m * B
    dev = tokens.device
    tables_l = tables.long()
    h = params["embed"][tokens.long()]               # (S, W, hidden)
    if model.pos_encoding == "learned":
        # clamped: padded rows of a near-full slot may index past the table
        h = h + params["pos"][rope_pos.clamp(max=params["pos"].shape[0] - 1)]
    positions = rope_pos[:, None, :]                 # (S, 1, W)
    # the column index clamps to the table width (a padded row of a
    # chain-filling slot would otherwise index past it), and rows >=
    # n_cand go to the scratch block outright
    blkcol = (store // B).clamp(max=m - 1)
    blk = torch.where(torch.arange(w, device=dev)[None, :]
                      < n_cand.long()[:, None],
                      tables_l[torch.arange(s, device=dev)[:, None], blkcol],
                      0)                             # (S, W)
    off = store % B
    for i, bp in enumerate(_layers(model, params)):
        kc, vc = k_arena[i], v_arena[i]              # (N, H, B, D)
        q, k, v = _block_qkv(model, bp, h)           # (S, H, W, D)
        q, k = model._rope(q, k, positions)
        ksl, vsl = _layer_scales(k_scale, v_scale, i)
        _write_rows(kc, vc, ksl, vsl, blk, off, k.transpose(1, 2),
                    v.transpose(1, 2))
        kg = _gather_rows(kc, ksl, tables_l)
        vg = _gather_rows(vc, vsl, tables_l)
        kg = kg.permute(0, 2, 1, 3, 4).reshape(
            s, mha.n_head, ctx, mha.head_dim)
        vg = vg.permute(0, 2, 1, 3, 4).reshape(
            s, mha.n_head, ctx, mha.head_dim)
        scores = torch.matmul(q.float(), kg.float().transpose(-1, -2))
        scores = scores / math.sqrt(mha.head_dim)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        o = torch.matmul(torch.softmax(scores, dim=-1), vg.float())
        h = _finish_block(model, bp, h, o.to(h.dtype))
    h = model._layer_norm(params["ln_f"], h)
    logits = _head_logits(model, params, h).float()
    if k_scale is not None:
        return logits, k_arena, v_arena, k_scale, v_scale
    return logits, k_arena, v_arena


def _verify_step_paged(model, params, tokens, pos, n_cand, tables, k_arena,
                       v_arena, k_scale=None, v_scale=None):
    """Speculative VERIFY over paged arenas: score all W = k+1 candidate
    rows per slot in one step.  ``tokens`` (S, W) 0-based, laid out
    ``[last_emitted, draft_1 .. draft_k]``; ``pos`` (S,) each slot's next
    write position, so candidate j sits at ``pos + j``; ``n_cand`` (S,)
    the valid rows per slot (1 for a plain-decode slot, 0 for an idle
    one).  Returns (float32 logits (S, W, V), k_arena, v_arena), the
    arenas written in place: logits row j is the distribution for the
    token after candidate j.

    Rollback is pointer-only: a rejected row's k/v stays in the arena
    above the slot's rewound position, where the position mask hides it
    until a later write lands there.  Attention is the dense gather with
    float32 scores, the reference's own (its paged kernel is
    single-query)."""
    s, w = tokens.shape
    ctx = tables.shape[1] * k_arena.shape[3]
    dev = tokens.device
    abspos = pos.long()[:, None] + torch.arange(w, device=dev)[None, :]
    # row j attends positions <= pos + j: (S, 1, W, ctx)
    mask = (torch.arange(ctx, device=dev)[None, None, :]
            <= abspos[:, :, None])[:, None]
    return _score_candidates(model, params, tokens, abspos, abspos, n_cand,
                             mask, tables, k_arena, v_arena, k_scale,
                             v_scale)


def _tree_verify_step_paged(model, params, tokens, pos, n_cand, tables,
                            k_arena, v_arena, k_scale=None, v_scale=None,
                            *, depths, anc):
    """Tree-speculative VERIFY over paged arenas: score all W nodes of a
    fixed-shape candidate tree per slot in one step.  ``tokens`` (S, W)
    holds one token per node (node 0 the last emitted root), ``depths``
    (W,) and ``anc`` (W, W) are the shape's per-node depths and
    ancestor-or-self matrix (numpy, or device tensors built once per
    shape, as a captured step takes them).

    Node j stores its k/v at arena offset ``pos + j`` (siblings share a
    position but never an offset) and rotates at its true position
    ``pos + depths[j]``; its mask admits the committed prefix (``col <
    pos``) plus exactly its ancestors' offsets.  A path node at depth d
    therefore sees what linear-verify row d sees, and a chain shape is
    the linear verify.  ``_tree_commit_paged`` later copies accepted
    off-spine rows down to their position offsets; rows >= ``n_cand`` go
    to the scratch block."""
    s, w = tokens.shape
    ctx = tables.shape[1] * k_arena.shape[3]
    dev = tokens.device
    pos_l = pos.long()
    if not isinstance(depths, torch.Tensor):
        depths = torch.as_tensor(np.asarray(depths), device=dev)
    if not isinstance(anc, torch.Tensor):
        anc = torch.as_tensor(np.asarray(anc, bool), device=dev)
    depths, ancm = depths.long(), anc.bool()          # (W,), (W, W)
    store = pos_l[:, None] + torch.arange(w, device=dev)[None, :]
    rope = pos_l[:, None] + depths[None, :]
    rel = torch.arange(ctx, device=dev)[None, :] - pos_l[:, None]  # (S, ctx)
    in_tree = (rel >= 0) & (rel < w)
    anc_cols = ancm[:, rel.clamp(0, w - 1)]          # (W, S, ctx)
    mask = ((rel < 0)[:, None, :]
            | (in_tree[:, None, :] & anc_cols.permute(1, 0, 2)))[:, None]
    return _score_candidates(model, params, tokens, rope, store, n_cand,
                             mask, tables, k_arena, v_arena, k_scale,
                             v_scale)


def _tree_commit_paged(src, pos, tables, k_arena, v_arena, k_scale=None,
                       v_scale=None):
    """After the host walk accepts a tree path, copy each accepted node's
    k/v row from its STORE offset ``pos + src[s, d-1]`` down to its
    POSITION offset ``pos + d``, in place, so the committed chain reads
    contiguously.  ``src`` (S, Dmax) is the accepted node at depth d =
    column + 1; identity entries rewrite a row onto itself.  Each layer
    gathers every source row (with its scales, for int8 arenas) before it
    writes any.  Returns the arenas it was given."""
    s, dmax = src.shape
    m = tables.shape[1]
    B = k_arena.shape[3]
    dev = src.device
    rows = torch.arange(s, device=dev)[:, None]
    tables_l = tables.long()
    src_abs = pos.long()[:, None] + src.long()
    dst_abs = (pos.long()[:, None] + 1
               + torch.arange(dmax, device=dev)[None, :])
    # identity rows of a near-full slot clamp src and dst to the same
    # final block column, so the clamped write is still a no-op
    sblk = tables_l[rows, (src_abs // B).clamp(max=m - 1)]
    soff = src_abs % B
    dblk = tables_l[rows, (dst_abs // B).clamp(max=m - 1)]
    doff = dst_abs % B
    for i, (kc, vc) in enumerate(zip(k_arena, v_arena)):
        ksl, vsl = _layer_scales(k_scale, v_scale, i)
        kr = kc[sblk, :, soff, :]                    # (S, Dmax, H, D) copies
        vr = vc[sblk, :, soff, :]
        if ksl is not None:
            ksr = ksl[sblk, :, soff]                 # (S, Dmax, H) copies
            vsr = vsl[sblk, :, soff]
        kc[dblk, :, doff, :] = kr
        vc[dblk, :, doff, :] = vr
        if ksl is not None:
            ksl[dblk, :, doff] = ksr
            vsl[dblk, :, doff] = vsr
    if k_scale is not None:
        return k_arena, v_arena, k_scale, v_scale
    return k_arena, v_arena


def _choose(logits, temperature: float, key, clamp: bool):
    """Each row's next token by ``keychain.sample`` over the whole (B, V)
    block with one key, on the host; greedy stays on the device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    toks = keychain.sample(key, logits.cpu().numpy(), temperature, clamp)
    return torch.from_numpy(toks).to(logits.device)


@torch.no_grad()
def generate(model: TransformerLM, params, prompt_ids, max_new_tokens: int,
             *, temperature: float = 0.0, rng=None,
             cache_len: Optional[int] = None, device=None):
    """Continue ``prompt_ids`` (B, T) 1-based ids; returns (B, T +
    max_new_tokens) 1-based int64 ids on the host.  temperature 0 is
    greedy; above it each token is drawn from the reference's key chain:
    ``rng`` (an int seed or a (2,) uint32 key, default seed 0) splits
    once for the first token, and the rest split ``max_new_tokens - 1``
    step keys, one categorical over the (B, V) logits each.

    ``device`` (default ``"cuda"``) must be the model's device.
    ``cache_len`` defaults to prompt + new and must be <= max_len."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"generate on {dev}, but the model lives on "
                         f"{model.device}")
    ids = torch.as_tensor(prompt_ids)
    if ids.is_floating_point():
        ids = ids.to(torch.int32)
    ids = ids.long().cpu()
    b, t = ids.shape
    if t == 0:
        raise ValueError("empty prompt: generation needs at least one "
                         "prompt token")
    if max_new_tokens <= 0:
        return ids
    total = t + int(max_new_tokens)
    cache_len = int(cache_len) if cache_len is not None else total
    if cache_len > model.max_len or total > model.max_len:
        raise ValueError(
            f"prompt + new tokens ({total}) exceeds the model's max_len "
            f"({model.max_len})")
    if cache_len < total:
        raise ValueError(
            f"cache_len ({cache_len}) smaller than prompt + new tokens "
            f"({total})")
    key = keychain.as_key(rng)
    first_key = step_keys = None
    if temperature > 0.0:
        key, first_key = keychain.split(key)
        if max_new_tokens > 1:
            step_keys = keychain.split(key, int(max_new_tokens) - 1)
    params = dequantize_entry(params)  # int8 clones generate too
    ids0 = (ids - 1).to(dev)
    logits, k_cache, v_cache = _prefill(model, params, ids0, cache_len)
    tok = _choose(logits, temperature, first_key, clamp=False)
    out = [tok]
    pos = torch.full((b,), t, dtype=torch.long, device=dev)
    for i in range(int(max_new_tokens) - 1):
        logits, k_cache, v_cache = _decode_step_slots(
            model, params, tok, pos, k_cache, v_cache)
        tok = _choose(logits, temperature,
                      None if step_keys is None else step_keys[i], clamp=True)
        out.append(tok)
        pos = pos + 1
    gen = torch.stack(out, dim=1).cpu() + 1
    return torch.cat([ids, gen], dim=1)
