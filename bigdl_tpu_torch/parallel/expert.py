"""Top-1 (switch) mixture of experts (port of
``bigdl_tpu/parallel/expert.py``): ``switch_mlp`` on one device, and
``moe_apply`` with the experts split over the ``expert`` mesh axis.

The routing, the capacity rule and the balance loss are the
reference's.  The dispatch is not: the reference builds a (T, E, C)
one-hot and contracts it twice, which at 8 x 1024 tokens and 8 experts
is a 335 MB tensor and 129 GFLOP of products with zeros a layer.  Here
capacity dispatch moves the same rows by index:

- each kept token's slot is ``expert * C + position``; a token over
  capacity points at one spare row past the ``E * C`` slots;
- the experts' input ``(E, C, D)`` is one gather of the tokens (an
  empty slot reads a zero row), each expert weight one batched product
  (``torch.bmm``), and the output one gather back, times the gate value;
- every slot holds at most one token, so the gathers' backward adds
  (``index_add``) never meet at a kept address: the dispatch is
  deterministic on the card too.

Dense dispatch (``capacity_factor=None``, every cached decode path)
runs each expert's MLP over every token, as the reference's masked
dispatch does, and picks each token's routed row: static shapes, no
host synchronisation, so it runs inside captured CUDA graphs.  Its cost
is ``E`` times a dense MLP's products.

Over a mesh (``moe_apply``), a rank of the expert axis holds E/N
experts and runs the same dispatch over them alone: the routing is
every rank's (the gate is replicated), a token routed elsewhere takes
the spare row, and one all-reduce over the expert axis assembles the
outputs.  The capacity counts per token shard, and with a data axis the
balance loss averages f_e and P_e over it before their product.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.parallel.mesh import (EXPERT_AXIS, MeshAxis,
                                           copy_to_axis, gather_from_axis,
                                           reduce_from_axis, scatter_to_axis)
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import keychain


def init_moe_params(rng, n_experts: int, d_model: int,
                    d_hidden: int) -> dict:
    """Gate (D, E) and the experts' two products, stacked on a leading
    expert axis: ``w1`` (E, D, F), ``w2`` (E, F, D); all uniform in
    +-1/sqrt(D), from ``split(rng, 3)`` of a key-chain key, as the
    reference draws them (float32 numpy)."""
    kg, k1, k2 = keychain.split(rng, 3)
    # the reference's scale is float32 (1 / jnp.sqrt(d)): a float64 one
    # can round to another float32 bound and move every draw
    scale = np.float32(1.0) / np.sqrt(np.float32(d_model))

    def draw(key, *shape):
        return keychain.uniform(key, shape, -scale, scale)

    return {"gate": draw(kg, d_model, n_experts),
            "w1": draw(k1, n_experts, d_model, d_hidden),
            "w2": draw(k2, n_experts, d_hidden, d_model)}


def _top1_route(gate, x2):
    """-> (float32 probs (T, E), top expert (T,), gate value (T,) in
    ``x2``'s dtype).  ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    probs = torch.softmax(torch.matmul(x2, gate).float(), dim=-1)
    top = torch.argmax(probs, dim=-1)
    gate_val = probs.to(x2.dtype).gather(-1, top[:, None])[:, 0]
    return probs, top, gate_val


def _balance_loss(top, probs, n_experts: int,
                  data_axis: Optional[MeshAxis] = None):
    """Switch load-balancing loss E * sum_e f_e * P_e: f_e the share of
    tokens routed to e (no gradient), P_e the mean router probability.
    With ``data_axis`` (tokens split over it), f_e and P_e average over
    the token shards FIRST (averaging the per-shard products would add a
    cross-shard covariance term)."""
    frac = F.one_hot(top, n_experts).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    if data_axis is not None and data_axis.size > 1:
        frac = reduce_from_axis(frac, data_axis.mesh, data_axis) \
            / data_axis.size
        mean_p = reduce_from_axis(mean_p, data_axis.mesh, data_axis) \
            / data_axis.size
    return n_experts * torch.sum(frac * mean_p)


def _capacity_slots(top, n_experts: int, cap: int):
    """Each token's slot ``expert * cap + position`` in its expert's
    queue, ``n_experts * cap`` (the spare row) when over capacity.  The
    position counts with an int64 cumsum over the tokens in row-major
    order, so a token's slot counts the routed tokens of every batch row
    before it (the reference's rule)."""
    oh = F.one_hot(top, n_experts)                    # (T, E) int64
    pos = (torch.cumsum(oh, dim=0) * oh).sum(dim=-1) - 1
    keep = pos < cap
    slot = torch.where(keep, top * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return slot, keep


def _expert_ffn(w1, w2, x):
    """(E, N, D) or a broadcast (N, D) -> (E, N, D): tanh-GELU MLP per
    expert, no biases (the reference's ``_expert_ffn``)."""
    h = F.gelu(torch.matmul(x, w1), approximate="tanh")
    return torch.matmul(h, w2)


def _dispatch(w1, w2, x, top, gate_val, n_experts: int,
              capacity_factor: Optional[float], *, lo: int = 0,
              reduce=None, drops: Optional[list] = None):
    """Each token's routed expert output times its gate value, for the
    tokens ``x`` (T, D).  ``w1``/``w2`` hold experts ``lo`` .. ``lo +
    E_l`` of ``n_experts`` (all of them on one device); a token routed to
    another rank's expert gets a zero row, and ``reduce`` (the expert
    axis's sum) assembles every token's row before the gate value
    multiplies it, so the gate's gradient is whole on every rank."""
    e_local, t = w1.shape[0], x.shape[0]
    local = (None if e_local == n_experts
             else (top >= lo) & (top < lo + e_local))
    if capacity_factor is None:
        out = _expert_ffn(w1, w2, x)                 # (E_l, T, D)
        rows = torch.arange(t, device=x.device)
        if local is None:
            y = out[top, rows]
        else:
            y = out[(top - lo).clamp(0, e_local - 1), rows]
            y = torch.where(local[:, None], y, torch.zeros_like(y))
    else:
        cap = max(1, int(math.ceil(capacity_factor * t / n_experts)))
        slot, keep = _capacity_slots(top, n_experts, cap)
        spare = e_local * cap
        if local is not None:
            slot = torch.where(local & keep, slot - lo * cap,
                               torch.full_like(slot, spare))
        # slot -> token (an empty slot reads the zero row at index t);
        # only the spare row sees duplicate writes, and it is dropped
        src = torch.full((spare + 1,), t, dtype=torch.long, device=x.device)
        src.scatter_(0, slot, torch.arange(t, device=x.device))
        x_pad = torch.cat([x, x.new_zeros(1, x.shape[1])])
        expert_in = x_pad[src[:-1]].view(e_local, cap, -1)
        out = _expert_ffn(w1, w2, expert_in).reshape(spare, -1)
        out_pad = torch.cat([out, out.new_zeros(1, out.shape[1])])
        y = out_pad[slot]
        if drops is not None:
            drops.append((t - keep.sum()).detach())
    if reduce is not None:
        y = reduce(y)
    return y * gate_val[:, None]


def switch_mlp(params, x, capacity_factor: Optional[float] = None,
               drops: Optional[list] = None,
               balance_axis: Optional[MeshAxis] = None):
    """Single-device switch MoE over tokens ``x`` (..., D); returns
    ``(y, aux)`` with ``y`` shaped like ``x`` and ``aux`` the float32
    balance loss.  ``capacity_factor=None`` is dense dispatch; otherwise
    each expert takes at most C = max(1, ceil(c * T / E)) of the T
    flattened tokens, and a token over capacity gets a zero output.
    ``drops`` (a list) receives the step's count of tokens over capacity
    as a 0-d device tensor (no synchronisation).  ``balance_axis``: the
    axis this rank's tokens are a shard of (data parallelism); the
    balance loss then takes the globally averaged f_e and P_e, the
    unbiased Switch objective."""
    for name in ("w1", "w2"):
        if is_qtensor(params[name]):
            raise TypeError(
                f"the MoE expert weight {name!r} is an int8-compute "
                "QTensor, which no MoE product consumes (the reference's "
                "quantization policy has no rule for MoE leaves either); "
                "quantize MoE models with compute='dequant'")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    n_experts = params["gate"].shape[1]
    probs, top, gate_val = _top1_route(params["gate"], x2)
    y = _dispatch(params["w1"], params["w2"], x2, top, gate_val, n_experts,
                  capacity_factor, drops=drops)
    aux = _balance_loss(top, probs, n_experts, balance_axis)
    return y.reshape(shape), aux


def moe_apply_local(params, x, *, axis: MeshAxis,
                    data_axis: Optional[MeshAxis] = None,
                    capacity_factor: Optional[float] = None):
    """Per-rank body over the expert ``axis``: ``params['w1'/'w2']`` hold
    this rank's slice of E/N experts, ``params['gate']`` (D, E) all of
    them; ``x`` (T, D) the same on every rank of the axis.  Returns
    ``(y (T, D), aux)``."""
    gate, n_total = params["gate"], params["gate"].shape[1]
    probs, top, gate_val = _top1_route(gate, x)
    # the experts read their copy of x: its gradient from them is summed
    # over the axis, the routing's is every rank's own
    x_ffn = copy_to_axis([x], axis.mesh, axis)[0]
    y = _dispatch(params["w1"], params["w2"], x_ffn, top, gate_val, n_total,
                  capacity_factor, lo=axis.index * params["w1"].shape[0],
                  reduce=lambda y: reduce_from_axis(y, axis.mesh, axis))
    return y, _balance_loss(top, probs, n_total, data_axis)


def moe_apply(params, x, mesh, *, axis: str = EXPERT_AXIS,
              data_axis: Optional[str] = None,
              capacity_factor: Optional[float] = None):
    """Global-view MoE over tokens ``x`` (T, D) or (B, T, D): every rank
    passes the same params and tokens and gets ``(y, aux)``.  The
    experts split over ``axis``; ``data_axis`` splits the tokens over
    it on a 2-D mesh.  ``capacity_factor`` switches to capacity-bounded
    dispatch, the capacity taken per token shard."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    eax = MeshAxis(mesh, axis)
    dax = MeshAxis(mesh, data_axis) if data_axis else None
    x2 = scatter_to_axis(x2, mesh, dax, 0)
    # each token shard's gradient of the shared weights is summed over
    # the data axis; the expert stacks then split over the expert axis
    gate, w1, w2 = copy_to_axis([params["gate"], params["w1"],
                                 params["w2"]], mesh, dax)
    local = {"gate": gate, "w1": scatter_to_axis(w1, mesh, eax, 0),
             "w2": scatter_to_axis(w2, mesh, eax, 0)}
    y, aux = moe_apply_local(local, x2, axis=eax, data_axis=dax,
                             capacity_factor=capacity_factor)
    return gather_from_axis(y, mesh, dax, 0).reshape(shape), aux
