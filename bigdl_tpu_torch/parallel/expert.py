"""Top-1 (switch) mixture of experts on one device (port of
``bigdl_tpu/parallel/expert.py``: ``init_moe_params`` and
``switch_mlp``; ``moe_apply`` over a mesh is not ported).

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
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def _balance_loss(top, probs, n_experts: int):
    """Switch load-balancing loss E * sum_e f_e * P_e: f_e the share of
    tokens routed to e (no gradient), P_e the mean router probability."""
    frac = F.one_hot(top, n_experts).float().mean(dim=0)
    return n_experts * torch.sum(frac * probs.mean(dim=0))


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


def switch_mlp(params, x, capacity_factor: Optional[float] = None,
               drops: Optional[list] = None):
    """Single-device switch MoE over tokens ``x`` (..., D); returns
    ``(y, aux)`` with ``y`` shaped like ``x`` and ``aux`` the float32
    balance loss.  ``capacity_factor=None`` is dense dispatch; otherwise
    each expert takes at most C = max(1, ceil(c * T / E)) of the T
    flattened tokens, and a token over capacity gets a zero output.
    ``drops`` (a list) receives the step's count of tokens over capacity
    as a 0-d device tensor (no synchronisation)."""
    for name in ("w1", "w2"):
        if is_qtensor(params[name]):
            raise TypeError(
                f"the MoE expert weight {name!r} is an int8-compute "
                "QTensor, which no MoE product consumes (the reference's "
                "quantization policy has no rule for MoE leaves either); "
                "quantize MoE models with compute='dequant'")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    gate, w1, w2 = params["gate"], params["w1"], params["w2"]
    n_experts = gate.shape[1]
    probs, top, gate_val = _top1_route(gate, x2)
    if capacity_factor is None:
        out = _expert_ffn(w1, w2, x2)                # (E, T, D)
        rows = torch.arange(x2.shape[0], device=x2.device)
        y = out[top, rows] * gate_val[:, None]
    else:
        t = x2.shape[0]
        cap = max(1, int(math.ceil(capacity_factor * t / n_experts)))
        slot, keep = _capacity_slots(top, n_experts, cap)
        # slot -> token (an empty slot reads the zero row at index t);
        # only the spare row sees duplicate writes, and it is dropped
        src = torch.full((n_experts * cap + 1,), t, dtype=torch.long,
                         device=x2.device)
        src.scatter_(0, slot, torch.arange(t, device=x2.device))
        x_pad = torch.cat([x2, x2.new_zeros(1, x2.shape[1])])
        expert_in = x_pad[src[:-1]].view(n_experts, cap, -1)
        out = _expert_ffn(w1, w2, expert_in).reshape(n_experts * cap, -1)
        out_pad = torch.cat([out, out.new_zeros(1, out.shape[1])])
        y = out_pad[slot] * gate_val[:, None]
        if drops is not None:
            drops.append((t - keep.sum()).detach())
    aux = _balance_loss(top, probs, n_experts)
    return y.reshape(shape), aux
