"""GPT-2 state dicts into and out of ``TransformerLM`` (port of
``bigdl_tpu/models/transformer/io.py``).

Hugging Face GPT-2 keeps its ``Conv1D`` weights as ``(in, out)``, the
layout of the model's products, so the copy splits and stacks only:

    HF key                              TransformerLM params
    ------------------------------      -------------------------------
    wte.weight (V, H)                   embed
    wpe.weight (T, H)                   pos           (learned only)
    h.<i>.ln_1.{weight,bias}            blocks.ln1    (stacked over i)
    h.<i>.attn.c_attn.{weight,bias}     blocks.attn.{wq,wk,wv,bq,bk,bv}
                                        (fused (H, 3H) split q|k|v)
    h.<i>.attn.c_proj.{weight,bias}     blocks.attn.{wo,bo}
    h.<i>.mlp.c_fc.{weight,bias}        blocks.{w1,b1}
    h.<i>.mlp.c_proj.{weight,bias}      blocks.{w2,b2}
    h.<i>.ln_2.{weight,bias}            blocks.ln2
    ln_f.{weight,bias}                  ln_f
    lm_head.weight (V, H)               head = weight.T  (untied only)

A ``transformer.`` prefix (``GPT2LMHeadModel``) is stripped.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    """A tensor (bf16 widened to float32) or array-like as numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        v = v.numpy()
    return np.asarray(v)


def load_gpt2_state_dict(model, state_dict):
    """Copy a GPT-2 checkpoint (a ``GPT2Model``/``GPT2LMHeadModel`` state
    dict of tensors or arrays) into ``model``'s params on its device and
    return the model.  The model must match the checkpoint (vocab,
    hidden, layers, heads, learned positions, a dense MLP); a mismatch
    raises with both shapes, and a diverged ``lm_head`` into a tied
    model raises rather than being dropped."""
    sd: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        sd[k] = _to_numpy(v)

    if model.moe_experts:
        raise ValueError("GPT-2 checkpoints carry dense MLP blocks: a "
                         "moe_experts>0 TransformerLM cannot load them")
    dev = model.device
    h, L, f = model.hidden_size, model.n_layers, model.ffn_size

    def take(key, expect_shape):
        if key not in sd:
            raise ValueError(f"checkpoint has no '{key}' "
                             f"(keys: {sorted(sd)[:8]}...)")
        a = sd[key]
        if tuple(a.shape) != tuple(expect_shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(a.shape)} vs "
                             f"model {tuple(expect_shape)}")
        return a.astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    params = {"embed": put(take("wte.weight", (model.vocab_size, h)))}
    if model.pos_encoding != "learned":
        raise ValueError("GPT-2 checkpoints carry learned positions: build "
                         "the TransformerLM with pos_encoding='learned'")
    if "wpe.weight" not in sd:
        raise ValueError(f"checkpoint has no 'wpe.weight' "
                         f"(keys: {sorted(sd)[:8]}...)")
    wpe = take("wpe.weight", (sd["wpe.weight"].shape[0], h))
    if wpe.shape[0] < model.max_len:
        raise ValueError(f"checkpoint wpe covers {wpe.shape[0]} positions "
                         f"< model max_len {model.max_len}")
    params["pos"] = put(wpe[:model.max_len])

    blocks: Dict[tuple, list] = {}

    def add(path, value):
        blocks.setdefault(path, []).append(value)

    for i in range(L):
        p = f"h.{i}."
        add(("ln1", "weight"), take(p + "ln_1.weight", (h,)))
        add(("ln1", "bias"), take(p + "ln_1.bias", (h,)))
        cw = take(p + "attn.c_attn.weight", (h, 3 * h))
        cb = take(p + "attn.c_attn.bias", (3 * h,))
        for j, (wn, bn) in enumerate((("wq", "bq"), ("wk", "bk"),
                                      ("wv", "bv"))):
            add(("attn", wn), cw[:, j * h:(j + 1) * h])
            add(("attn", bn), cb[j * h:(j + 1) * h])
        add(("attn", "wo"), take(p + "attn.c_proj.weight", (h, h)))
        add(("attn", "bo"), take(p + "attn.c_proj.bias", (h,)))
        add(("ln2", "weight"), take(p + "ln_2.weight", (h,)))
        add(("ln2", "bias"), take(p + "ln_2.bias", (h,)))
        add(("w1",), take(p + "mlp.c_fc.weight", (h, f)))
        add(("b1",), take(p + "mlp.c_fc.bias", (f,)))
        add(("w2",), take(p + "mlp.c_proj.weight", (f, h)))
        add(("b2",), take(p + "mlp.c_proj.bias", (h,)))

    stacked: Dict = {}
    for path, per_layer in blocks.items():
        d = stacked
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = put(np.stack(per_layer))
    params["blocks"] = stacked
    params["ln_f"] = {"weight": put(take("ln_f.weight", (h,))),
                      "bias": put(take("ln_f.bias", (h,)))}
    if not model.tie_embeddings:
        head = take("lm_head.weight", (model.vocab_size, h))
        params["head"] = put(head.T)
    elif "lm_head.weight" in sd:
        # a fine-tune may have untied its head; putting wte in its place
        # would change the output distribution without a word
        head = take("lm_head.weight", (model.vocab_size, h))
        if not np.allclose(head, sd["wte.weight"], rtol=1e-5, atol=1e-6):
            raise ValueError(
                "checkpoint's lm_head.weight differs from wte.weight "
                "(untied fine-tune) but the model was built with "
                "tie_embeddings=True: rebuild with tie_embeddings=False to "
                "import it faithfully")
    model.params = params
    return model


def export_gpt2_state_dict(model) -> Dict[str, np.ndarray]:
    """The model's params as a GPT-2 state dict of float32 numpy arrays
    (``GPT2Model`` keys; prepend ``transformer.`` and mirror
    ``lm_head.weight`` from ``wte.weight`` for a ``GPT2LMHeadModel``):
    layers unstacked, q/k/v fused back into ``c_attn``."""
    if model.params is None:
        raise ValueError("model has no params to export: call "
                         "model.build(seed) (or train it) first")
    if model.moe_experts:
        raise ValueError("MoE blocks have no GPT-2 layout")
    if model.pos_encoding != "learned":
        raise ValueError("GPT-2's layout carries learned positions: rope "
                         "models cannot export to it")
    p = model.params

    def as32(x):
        return _to_numpy(x).astype(np.float32)

    out: Dict[str, np.ndarray] = {"wte.weight": as32(p["embed"]),
                                  "wpe.weight": as32(p["pos"])}
    blocks = p["blocks"]
    a = blocks["attn"]
    for i in range(model.n_layers):
        pre = f"h.{i}."
        out[pre + "ln_1.weight"] = as32(blocks["ln1"]["weight"][i])
        out[pre + "ln_1.bias"] = as32(blocks["ln1"]["bias"][i])
        out[pre + "attn.c_attn.weight"] = np.concatenate(
            [as32(a["wq"][i]), as32(a["wk"][i]), as32(a["wv"][i])], axis=1)
        out[pre + "attn.c_attn.bias"] = np.concatenate(
            [as32(a["bq"][i]), as32(a["bk"][i]), as32(a["bv"][i])])
        out[pre + "attn.c_proj.weight"] = as32(a["wo"][i])
        out[pre + "attn.c_proj.bias"] = as32(a["bo"][i])
        out[pre + "ln_2.weight"] = as32(blocks["ln2"]["weight"][i])
        out[pre + "ln_2.bias"] = as32(blocks["ln2"]["bias"][i])
        out[pre + "mlp.c_fc.weight"] = as32(blocks["w1"][i])
        out[pre + "mlp.c_fc.bias"] = as32(blocks["b1"][i])
        out[pre + "mlp.c_proj.weight"] = as32(blocks["w2"][i])
        out[pre + "mlp.c_proj.bias"] = as32(blocks["b2"][i])
    out["ln_f.weight"] = as32(p["ln_f"]["weight"])
    out["ln_f.bias"] = as32(p["ln_f"]["bias"])
    if not model.tie_embeddings:
        out["lm_head.weight"] = np.ascontiguousarray(as32(p["head"]).T)
    return out
