"""Sequence (context) parallelism: ring attention and Ulysses all-to-all
(port of ``bigdl_tpu/parallel/sequence.py``).

The sequence dimension is split over a mesh axis, one shard a rank.
Ring attention keeps each rank's queries and passes the k/v shards
round the ring with :func:`~bigdl_tpu_torch.parallel.mesh.ring_permute`
(``lax.ppermute``'s counterpart, point to point), merging each hop's
partial attention by the online softmax, so no rank holds the (T, T)
scores.  Ulysses trades two ``all_to_all_single`` exchanges (sequence
to heads and back) for full-sequence attention on H/N heads.

One hop, :func:`ring_hop`, is a function of its own: the partial
attention of the local queries against one k/v block and its merge
into the running state.  ``impl="flash"`` computes it with the flash
kernels (``ops.flash_attention_with_lse``, differentiable in both its
output and its logsumexp) and merges by logsumexp weighting in float32;
``impl="blocks"`` with the plain online-softmax core of
``nn.attention``.  Causality by shard position: a past block is
unmasked, the diagonal block takes the kernel's causal mask (Tq == Tk),
and a future block is skipped by a Python ``if`` on the rank's own index
(the reference's ``lax.cond``), so nothing is launched for it.

The per-rank bodies (``*_local``) take a :class:`MeshAxis` where the
reference's take an axis name bound by ``shard_map``; the global views
take the mesh and the axis names, as the reference's do, with every
rank passing the same global tensors and getting the global result
(``parallel.mesh``'s region functions carry the gradients).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.nn.attention import (NEG_INF, _block_scores, _finalize,
                                          online_softmax_update,
                                          segment_mask)
from bigdl_tpu_torch.parallel.mesh import (SEQUENCE_AXIS, MeshAxis,
                                           _all_gather_cat, copy_to_axis,
                                           gather_from_axis, ring_permute,
                                           scatter_to_axis)
from bigdl_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

IMPLS = ("blocks", "flash")


class _Skip(torch.autograd.Function):
    """A skipped hop: the state passes unchanged, and the block it did
    not read stays in the graph, so every rank's backward runs the same
    ring permutes (the block's gradient here is zero)."""

    @staticmethod
    def forward(ctx, o, *block):
        ctx.n = len(block)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def ring_init(q, impl: str):
    """The merge's identity for queries ``q``: flash (o = 0, lse = -inf)
    in float32; blocks (o = 0, l = 0, m = -inf) in q's dtype."""
    if impl == "flash":
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                           device=q.device))
    return (torch.zeros_like(q), torch.zeros(q.shape[:-1], dtype=q.dtype,
                                             device=q.device),
            torch.full(q.shape[:-1], NEG_INF, dtype=q.dtype, device=q.device))


def ring_finish(state, q, impl: str):
    """The attention output from a merged state, in q's dtype."""
    if impl == "flash":
        return state[0].to(q.dtype)
    o, l, _ = state
    return _finalize(o, l)


def ring_hop(state, q, k, v, *, rank: int, src: int, causal: bool = False,
             scale: Optional[float] = None, impl: str = "flash",
             block_size: Optional[int] = None, segment_ids=None,
             kv_segment_ids=None):
    """Merge the partial attention of shard ``rank``'s queries ``q``
    against the k/v block that began on shard ``src`` into ``state``
    (:func:`ring_init`'s layout).  q, k, v: (B, H, T_local, D), every
    shard the same length.  Causal: ``src > rank`` is skipped,
    ``src == rank`` takes the causal mask, ``src < rank`` none.
    ``segment_ids`` (B, T_local) are the queries' and ``kv_segment_ids``
    the block's (both or neither).  Flash: ``block_size`` pins the
    forward kernel's tile ``(block_size, block_size)`` (a tile the kernel
    was not built for raises); None takes its default tile."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'blocks' or 'flash', got {impl!r}")
    if causal and src > rank:
        block = [t for t in (k, v) if t.requires_grad]
        if torch.is_grad_enabled() and block:
            return (_Skip.apply(state[0], *block),) + tuple(state[1:])
        return state
    diagonal = causal and src == rank
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if impl == "flash":
        from bigdl_tpu_torch.ops.flash_attention import \
            flash_attention_with_lse
        o, lse = state
        ob, lb = flash_attention_with_lse(
            q, k, v, causal=diagonal, scale=scale,
            q_segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            block_q=block_size, block_k=block_size)
        # exact merge of normalized partials over disjoint key sets; the
        # kernel's lse is finite (-1e30 for a row with no visible key),
        # so logaddexp(-inf, lse_blk) = lse_blk and its gradients are 0
        # and 1
        lse_new = torch.logaddexp(lse, lb)
        o = (o * torch.exp(lse - lse_new)[..., None]
             + ob.float() * torch.exp(lb - lse_new)[..., None])
        return o, lse_new
    mask = None
    if diagonal:
        t = q.shape[-2]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        smask = segment_mask(segment_ids, kv_segment_ids)
        mask = smask if mask is None else mask & smask
    return online_softmax_update(state, _block_scores(q, k, v, mask, scale))


def _ring_schedule(axis: MeshAxis, kv, state, hop):
    """Rounds 0..N-1 of ``state = hop(r, state, kv_r)``, passing the k/v
    tuple (k, v and, with segment ids, the key side's shard) to the next
    rank after every round but the last (that rotation's block would be
    discarded)."""
    for r in range(axis.size - 1):
        state = hop(r, state, kv)
        kv = ring_permute(kv, axis)
    return hop(axis.size - 1, state, kv)


def ring_attention_local(q, k, v, axis: MeshAxis, *, causal: bool = False,
                         scale: Optional[float] = None, impl: str = "blocks",
                         block_size: Optional[int] = None, segment_ids=None):
    """Per-rank body of ring attention over ``axis``: q, k, v are this
    rank's (B, H, T_local, D) shard; returns its (B, H, T_local, D)
    output.  Round r attends to the block that began on rank (index - r)
    mod N, then passes its block on.  ``segment_ids`` (B, T_local): this
    shard's packed-document ids; the key side's copy rides the ring with
    k/v, so isolation holds across shard boundaries."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'blocks' or 'flash', got {impl!r}")
    me, n = axis.index, axis.size

    def hop(r, state, kv):
        return ring_hop(state, q, kv[0], kv[1], rank=me, src=(me - r) % n,
                        causal=causal, scale=scale, impl=impl,
                        block_size=block_size, segment_ids=segment_ids,
                        kv_segment_ids=kv[2] if len(kv) > 2 else None)

    kv = (k, v) if segment_ids is None else (k, v, segment_ids)
    return ring_finish(_ring_schedule(axis, kv, ring_init(q, impl), hop),
                       q, impl)


def _shard(x, mesh, batch_axis, axis, dim: int):
    x = scatter_to_axis(x, mesh, batch_axis, 0)
    return scatter_to_axis(x, mesh, axis, dim)


def _unshard(x, mesh, batch_axis, axis, dim: int):
    x = gather_from_axis(x, mesh, axis, dim)
    return gather_from_axis(x, mesh, batch_axis, 0)


def ring_attention(q, k, v, mesh, *, axis: str = SEQUENCE_AXIS,
                   batch_axis: Optional[str] = None, causal: bool = False,
                   impl: str = "blocks", block_size: Optional[int] = None,
                   segment_ids=None):
    """Global-view ring attention: every rank passes the same (B, H, T,
    D) q, k, v; T is split over ``axis`` (and B over ``batch_axis`` on a
    2-D mesh) and the (B, H, T, D) output comes back on every rank.
    ``segment_ids`` (B, T): packed-document isolation."""
    seq = MeshAxis(mesh, axis)
    ql, kl, vl = (_shard(t, mesh, batch_axis, seq, 2) for t in (q, k, v))
    seg = (None if segment_ids is None
           else _shard(segment_ids, mesh, batch_axis, seq, 1))
    o = ring_attention_local(ql, kl, vl, seq, causal=causal, impl=impl,
                             block_size=block_size, segment_ids=seg)
    return _unshard(o, mesh, batch_axis, seq, 2)


def gather_segments(segment_ids, axis: MeshAxis):
    """The (B, T) segment ids from every rank's (B, T_local) shard."""
    if axis.size == 1:
        return segment_ids
    return _all_gather_cat(segment_ids, axis, 1)


def _exchange(x, axis: MeshAxis):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


class _AllToAll(torch.autograd.Function):
    """``x`` (N, ...): chunk j goes to rank j, chunk i of the result came
    from rank i.  The exchange is its own transpose."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


def _all_to_all(x, axis: MeshAxis):
    return _AllToAll.apply(x, axis)


def _seq2head(x, axis: MeshAxis):
    """(B, H, T_local, D) -> (B, H/N, T, D)."""
    n = axis.size
    b, h, t, d = x.shape
    x = x.reshape(b, n, h // n, t, d).transpose(0, 1)
    return _all_to_all(x, axis).permute(1, 2, 0, 3, 4).reshape(
        b, h // n, n * t, d)


def _head2seq(x, axis: MeshAxis):
    """(B, H/N, T, D) -> (B, H, T_local, D)."""
    n = axis.size
    b, hn, t, d = x.shape
    x = x.reshape(b, hn, n, t // n, d).permute(2, 0, 1, 3, 4)
    return _all_to_all(x, axis).transpose(0, 1).reshape(b, n * hn, t // n, d)


def ulysses_attention_local(q, k, v, axis: MeshAxis, *, causal: bool = False,
                            scale: Optional[float] = None, segment_ids=None,
                            segment_ids_full=None):
    """Per-rank body of Ulysses over ``axis``: q, k, v (B, H, T_local,
    D) with H divisible by the axis size.  Exchange sequence shards for
    head shards, attend over the full sequence on H/N heads, exchange
    back.  ``segment_ids`` (B, T_local) are gathered to (B, T) here; a
    caller that runs many layers gathers once and passes the (B, T)
    ids as ``segment_ids_full``."""
    n = axis.size
    if q.shape[1] % n:
        raise ValueError(f"Ulysses needs n_head ({q.shape[1]}) divisible "
                         f"by axis size ({n})")
    if n > 1:
        q, k, v = (_seq2head(t, axis) for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    mask = None
    if causal:
        t = q.shape[-2]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    if segment_ids_full is None and segment_ids is not None:
        segment_ids_full = gather_segments(segment_ids, axis)
    if segment_ids_full is not None:
        smask = segment_mask(segment_ids_full, segment_ids_full)
        mask = smask if mask is None else mask & smask
    _, l, o = _block_scores(q, k, v, mask, scale)
    o = _finalize(o, l)
    return _head2seq(o, axis) if n > 1 else o


def ulysses_attention(q, k, v, mesh, *, axis: str = SEQUENCE_AXIS,
                      batch_axis: Optional[str] = None, causal: bool = False,
                      segment_ids=None):
    """Global-view Ulysses attention (the layout of
    :func:`ring_attention`)."""
    seq = MeshAxis(mesh, axis)
    ql, kl, vl = (_shard(t, mesh, batch_axis, seq, 2) for t in (q, k, v))
    seg = (None if segment_ids is None
           else _shard(segment_ids, mesh, batch_axis, seq, 1))
    o = ulysses_attention_local(ql, kl, vl, seq, causal=causal,
                                segment_ids=seg)
    return _unshard(o, mesh, batch_axis, seq, 2)


def copy_params(params, mesh, axes):
    """``params`` with every floating tensor leaf passed through
    :func:`copy_to_axis` (one node): each rank's gradient is summed over
    ``axes``, the ranks that each used the tree on their own shard."""
    leaves, treedef = tree_flatten(params)
    idx = [i for i, t in enumerate(leaves)
           if isinstance(t, torch.Tensor) and t.is_floating_point()]
    copied = copy_to_axis([leaves[i] for i in idx], mesh, axes)
    for i, t in zip(idx, copied):
        leaves[i] = t
    return tree_unflatten(treedef, leaves)


def sequence_parallel_self_attention(mha, params, x, mesh, *,
                                     axis: str = SEQUENCE_AXIS,
                                     batch_axis: Optional[str] = None,
                                     kind: str = "ring"):
    """Run a ``MultiHeadAttention`` with the sequence dimension of ``x``
    (B, T, F) split over ``axis``: the projections run on this rank's
    shard, the core as ring (blocks) or Ulysses; every rank returns the
    (B, T, hidden) output."""
    if kind not in ("ring", "ulysses"):
        raise ValueError(f"kind must be 'ring' or 'ulysses', got {kind!r}")
    seq = MeshAxis(mesh, axis)
    params = copy_params(params, mesh, (axis, batch_axis))
    xs = _shard(x, mesh, batch_axis, seq, 1)
    q, k, v = mha.project_qkv(params, xs, xs, xs)
    if kind == "ring":
        o = ring_attention_local(q, k, v, seq, causal=mha.causal)
    else:
        o = ulysses_attention_local(q, k, v, seq, causal=mha.causal)
    return _unshard(mha.project_out(params, o), mesh, batch_axis, seq, 1)
