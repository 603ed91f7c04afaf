"""A configuration's model sizes, and its weights drawn on the device
from the run's seed.

The tree has the layout ``bigdl_tpu_torch``'s ``TransformerLM`` and the
plain reference (``h100_bench/reference/gpt2.py``) both read: ``embed``
(V, h), ``pos`` (P, h), ``blocks`` stacked on a leading layer axis
(``ln1``, ``attn`` with ``wq``/``wk``/``wv``/``wo`` and their biases,
``ln2``, ``w1``/``b1``/``w2``/``b2``) and ``ln_f``; the head is tied to
the embedding.  The draws are GPT-2's published initialiser (the
configuration's ``initializer_range``, 0.02; Radford et al. 2019): every
table and product normal with that standard deviation, the two
projections back into the residual stream (``wo``, ``w2``) scaled down
by 1/sqrt(2 n_layer), zero biases and unit LayerNorm gains.  (With the
port's own initialiser, 1/sqrt(h) tables and uniform products, the
positions of a deep random model collapse onto one hidden direction:
greedy tokens then repeat with wide margins, and no rounding of the
products can change one, so a check on served tokens could not tell
float32 from TF32.)  One ``torch.Generator`` on the device draws each
leaf in one call, in a fixed order, so one seed gives the same tree on
every run; calling :func:`make_params` again after the program's state
is freed gives the reference the same weights without keeping a copy.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def sizes(config: dict) -> Dict[str, int]:
    """The configuration file's published keys as the sizes the harness
    uses: ``vocab``, ``hidden``, ``heads``, ``head_dim``, ``layers``,
    ``ffn``, ``positions``, and ``eps``."""
    h = int(config["n_embd"])
    heads = int(config["n_head"])
    return {"vocab": int(config["vocab_size"]), "hidden": h,
            "heads": heads, "head_dim": h // heads,
            "layers": int(config["n_layer"]),
            "ffn": int(config.get("n_inner") or 4 * h),
            "positions": int(config["n_positions"]),
            "eps": float(config["layer_norm_epsilon"])}


def make_params(config: dict, seed: int, device, dtype=torch.float32):
    """The weight tree for ``config`` drawn from ``seed`` on ``device``."""
    s = sizes(config)
    h, f, L, V, P = (s["hidden"], s["ffn"], s["layers"], s["vocab"],
                     s["positions"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))

    def normal(shape, std):
        t = torch.empty(shape, device=dev, dtype=dtype)
        return t.normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    std = float(config["initializer_range"])
    std_out = std / math.sqrt(2 * L)
    embed = normal((V, h), std)
    pos = normal((P, h), std)
    attn = {name: normal((L, h, h), std) for name in ("wq", "wk", "wv")}
    attn["wo"] = normal((L, h, h), std_out)
    attn.update({name: zeros(L, h) for name in ("bq", "bk", "bv", "bo")})
    blocks = {"ln1": {"weight": ones(L, h), "bias": zeros(L, h)},
              "attn": attn,
              "ln2": {"weight": ones(L, h), "bias": zeros(L, h)},
              "w1": normal((L, h, f), std), "b1": zeros(L, f),
              "w2": normal((L, f, h), std_out), "b2": zeros(L, h)}
    return {"embed": embed, "pos": pos, "blocks": blocks,
            "ln_f": {"weight": ones(h), "bias": zeros(h)}}


def leaves(tree, prefix: str = ""):
    """``(path, tensor)`` pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], f"{prefix}/{key}" if prefix
                              else key)
    else:
        yield prefix, tree
