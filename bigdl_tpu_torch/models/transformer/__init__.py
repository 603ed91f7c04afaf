"""Decoder-only transformer language model (port of
``bigdl_tpu/models/transformer/__init__.py``).

1-based token ids in, (B, T, vocab) float32 log-probabilities out.  The
parameter tree is the reference's: ``embed`` (V, hidden), ``pos``
(max_len, hidden) for learned positions, ``blocks`` stacked on a
leading layer axis (``ln1``, ``attn``, ``ln2``, and ``w1``/``b1``,
``w2``/``b2`` or, with ``moe_experts > 0``, ``moe`` with ``gate``,
``w1`` and ``w2``), ``ln_f``, and ``head`` (hidden, V) when the head is
not tied.  Pre-LayerNorm blocks, tanh-approximate GELU, LayerNorm eps
1e-5.

``init(rng)`` draws the reference's tree from the key chain
(:mod:`bigdl_tpu_torch.utils.keychain`, ``jax.random`` bit for bit), so
``build(seed)`` is the reference's ``build(seed)``.  ``f`` is the
forward: the serving forward (no autograd) in eval mode, differentiable
with ``training=True``; ``apply`` is the training forward:
differentiable through the stacked leaves (each layer reads views of
them), with dropout drawn from the reference's keys (``rng=``) or from
an explicit ``torch.Generator`` (``generator=``), and optional
activation recomputation (``remat``).
An MoE model's blocks are top-1 switch MoEs
(``bigdl_tpu_torch.parallel.switch_mlp``) at ``moe_capacity_factor``;
``apply`` reports ``moe_aux_weight`` times the summed balance loss as
the ``"aux_loss"`` buffer, which the optimizers add to the loss.
``quantize`` returns an int8 (or bf16) clone for serving: both forwards
expand its dequant-mode leaves at the entry (``quant.dequantize_entry``)
and send int8-compute leaves to ``quant.qmatmul``.  ``save`` and
``load`` read and write the JAX package's checkpoint format (format 1,
``bigdl_tpu_torch.utils.file_io``).
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn._util import replicate_like
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.dropout import keep_masks
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import layer_norm
from bigdl_tpu_torch.parallel.expert import init_moe_params, switch_mlp
from bigdl_tpu_torch.quant.kernels import qmatmul
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.quant.transform import (QuantPolicy, dequantize_entry,
                                             publish_quant_report,
                                             quantize_params)
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import layer_params, params_from_numpy


def apply_rope(x, positions, base: float = 10000.0):
    """Rotary position embedding, rotate-half convention: x (..., T, D)
    with D even, positions broadcastable to (..., T) absolute indices."""
    d = x.shape[-1]
    half = d // 2
    # a Python base: no host-to-device copy, so a captured step holds it
    freqs = torch.pow(float(base), -torch.arange(
        0, half, dtype=torch.float32, device=x.device) * 2.0 / d)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., :, None] \
        * freqs
    cos, sin = replicate_like(torch.cos(ang), x), replicate_like(
        torch.sin(ang), x)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                      (x2 * cos + x1 * sin).to(x.dtype)], -1)


class TransformerLM(Module):
    """Causal transformer LM over 1-based token ids, a
    :class:`~bigdl_tpu_torch.nn.module.Module` (the Torch-style shell,
    ``serve`` and the padded-batch ``ServingEngine`` take it).

    ``init(rng)`` returns the reference's float32 parameter tree (numpy)
    from a key-chain key; ``build(seed)`` stores it on ``device`` as
    ``self.params``.
    """

    def __init__(self, vocab_size: int, hidden_size: int = 128,
                 n_head: int = 4, n_layers: int = 2,
                 ffn_size: Optional[int] = None, max_len: int = 512,
                 dropout: float = 0.0, tie_embeddings: bool = True,
                 remat: bool = False, attention_impl: str = "auto",
                 block_size: Optional[int] = None,
                 pos_encoding: str = "learned", rope_base: float = 10000.0,
                 moe_experts: int = 0,
                 moe_capacity_factor: Optional[float] = 1.25,
                 moe_aux_weight: float = 0.01,
                 doc_start_id: Optional[int] = None, device=None):
        super().__init__()
        if hidden_size % n_head != 0:
            raise ValueError("hidden_size must divide by n_head")
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding must be 'learned' or 'rope', "
                             f"got {pos_encoding!r}")
        if pos_encoding == "rope" and (hidden_size // n_head) % 2 != 0:
            raise ValueError("rope needs an even head_dim")
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.n_layers = n_layers
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_len = max_len
        self.dropout = dropout
        self.tie_embeddings = tie_embeddings
        self.remat = remat
        self.pos_encoding = pos_encoding
        self.rope_base = rope_base
        self.moe_experts = int(moe_experts)
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight
        # a list here collects each MoE layer's count of tokens over
        # capacity (0-d device tensors) as the forwards run
        self.moe_drops: Optional[list] = None
        self.doc_start_id = doc_start_id
        # a block size pins the flash kernels' tile (MultiHeadAttention
        # .pinned_tile); the LM never takes the blockwise core
        self._mha = MultiHeadAttention(hidden_size, n_head, causal=True,
                                       with_bias=True,
                                       attention_impl=attention_impl,
                                       block_size=block_size)
        self.params: Optional[dict] = None
        self.buffers: dict = params_from_numpy(self.init_buffers(),
                                               self.device)

    # -------------------------------------------------------------- #
    def _init_block(self, rng) -> dict:
        """One block's tree from its key: ``split(rng, 3)``, the
        attention from the first, ``w1`` (or the MoE) from the second,
        ``w2`` from the third."""
        ks = keychain.split(rng, 3)
        h, f = self.hidden_size, self.ffn_size
        std_h, std_f = 1.0 / math.sqrt(h), 1.0 / math.sqrt(f)
        p = {
            "ln1": {"weight": np.ones((h,), np.float32),
                    "bias": np.zeros((h,), np.float32)},
            "attn": self._mha.init(ks[0]),
            "ln2": {"weight": np.ones((h,), np.float32),
                    "bias": np.zeros((h,), np.float32)},
        }
        if self.moe_experts:
            p["moe"] = init_moe_params(ks[1], self.moe_experts, h, f)
            return p
        p.update(w1=keychain.uniform(ks[1], (h, f), -std_h, std_h),
                 b1=np.zeros((f,), np.float32),
                 w2=keychain.uniform(ks[2], (f, h), -std_f, std_f),
                 b2=np.zeros((h,), np.float32))
        return p

    def init(self, rng) -> dict:
        """The reference's float32 parameter tree (numpy) from a
        key-chain key: ``split(rng, 4)`` into the embedding's, the
        positions', the head's and the blocks' keys; the blocks' key
        split once per layer (the reference ``vmap``s one block init over
        those keys; a loop over the same keys draws the same values) and
        the layers stacked on a leading axis."""
        k_emb, k_pos, k_head, k_blocks = keychain.split(rng, 4)
        h, v = self.hidden_size, self.vocab_size
        std = np.float32(1.0 / math.sqrt(h))
        layers = [self._init_block(k)
                  for k in keychain.split(k_blocks, self.n_layers)]

        def stack(trees):
            if isinstance(trees[0], dict):
                return {k: stack([t[k] for t in trees]) for k in trees[0]}
            return np.stack(trees)

        p = {
            "embed": keychain.normal(k_emb, (v, h)) * std,
            "blocks": stack(layers),
            "ln_f": {"weight": np.ones((h,), np.float32),
                     "bias": np.zeros((h,), np.float32)},
        }
        if self.pos_encoding == "learned":
            p["pos"] = keychain.normal(k_pos, (self.max_len, h)) * std
        if not self.tie_embeddings:
            p["head"] = keychain.uniform(k_head, (h, v), -float(std),
                                         float(std))
        return p

    def param_shapes(self) -> dict:
        """The shapes of :meth:`init`'s tree, drawing nothing."""
        h, v, f, n = (self.hidden_size, self.vocab_size, self.ffn_size,
                      self.n_layers)
        norm = {"weight": (n, h), "bias": (n, h)}
        block = {"ln1": norm,
                 "attn": {name: (n,) + shape
                          for name, shape in self._mha.param_shapes().items()},
                 "ln2": dict(norm)}
        if self.moe_experts:
            e = self.moe_experts
            block["moe"] = {"gate": (n, h, e), "w1": (n, e, h, f),
                            "w2": (n, e, f, h)}
        else:
            block.update(w1=(n, h, f), b1=(n, f), w2=(n, f, h), b2=(n, h))
        p = {"embed": (v, h), "blocks": block,
             "ln_f": {"weight": (h,), "bias": (h,)}}
        if self.pos_encoding == "learned":
            p["pos"] = (self.max_len, h)
        if not self.tie_embeddings:
            p["head"] = (h, v)
        return p

    def init_buffers(self) -> dict:
        """``{"aux_loss": 0}`` for an MoE model; a dense one keeps none."""
        if self.moe_experts:
            return {"aux_loss": np.zeros((), np.float32)}
        return {}

    def build(self, seed=0, device=None) -> "TransformerLM":
        """:meth:`Module.build` (the reference's key chain) on ``device``,
        by default the model's own."""
        return super().build(seed, self.device if device is None
                             else device)

    def zero_grad_parameters(self) -> None:
        """The OO shell's gradients start empty (a backward fills them),
        so a built model holds no second copy of its weights."""
        self.grad_params = None

    def save(self, path: str, overwrite: bool = False) -> "TransformerLM":
        """Write the model to ``path`` (a local path, ``file://`` or
        ``memory://``) in the JAX package's format 1: its spec, and its
        params and buffers as numpy."""
        from bigdl_tpu_torch.utils import file_io
        file_io.save_module(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path: str, template: Optional["TransformerLM"] = None,
             device=None) -> "TransformerLM":
        """Read a model saved by either package.  With ``template`` the
        arrays go into it (its tree and shapes must match) and the
        stored spec is not read; without one a ``TransformerLM`` is built
        on ``device`` (default ``"cuda"``) from the spec's
        hyperparameters."""
        from bigdl_tpu_torch.utils import file_io
        return file_io.load_module(path, template=template, device=device)

    def quantize(self, dtype: str = "int8", *, policy=None,
                 compute: Optional[str] = None) -> "TransformerLM":
        """A weight-quantized clone for serving (``self`` keeps its
        params; the two can serve side by side, their graphs keyed
        apart).  ``dtype="int8"``: eligible weights become QTensors
        (``quant.QuantPolicy``'s defaults skip biases, 1-D leaves and the
        embedding tables); ``compute`` picks the products' regime
        (``"dequant"``, ``"int8"``, ``"auto"``, ``"fp8"``), and an
        explicit ``policy`` wins over it.  ``dtype="bf16"``: a plain
        cast.  The clone's ``quant_report`` holds the byte counts, the
        per-leaf max abs dequantization error and, for int8 compute, the
        int32-accumulator overflow risk; they are also published as the
        ``quant/*`` gauges of the metric registry.  Inference only:
        train the float model and quantize again."""
        if self.params is None:
            raise ValueError("quantize() needs params: call build(seed) "
                             "or set params first")
        if policy is None and compute is not None:
            policy = QuantPolicy(dtype, compute=compute)
        report: dict = {}
        new = copy.copy(self)
        new.params = quantize_params(self.params, dtype, policy=policy,
                                     report=report)
        new.quant_report = report
        publish_quant_report(report)
        return new

    # -------------------------------------------------------------- #
    @staticmethod
    def _layer_norm(p, x):
        return layer_norm(x, p["weight"], p["bias"])

    def _rope(self, q, k, positions):
        if self.pos_encoding != "rope":
            return q, k
        return (apply_rope(q, positions, self.rope_base),
                apply_rope(k, positions, self.rope_base))

    @staticmethod
    def _dense_mlp(bp, m):
        m = F.gelu(qmatmul(m, bp["w1"]) + bp["b1"], approximate="tanh")
        return qmatmul(m, bp["w2"]) + bp["b2"]

    def _mlp(self, bp, m):
        """The block's feed-forward half: ``(out, aux)``, the switch MoE
        at the model's capacity factor with its balance loss, or the
        dense GELU MLP with no auxiliary term (``aux`` None)."""
        if self.moe_experts:
            return switch_mlp(bp["moe"], m,
                              capacity_factor=self.moe_capacity_factor,
                              drops=self.moe_drops)
        return self._dense_mlp(bp, m), None

    def _keep_masks(self, x, drop):
        """The block's two dropout keep masks over ``x``'s shape, or
        None: from the block's ``torch.Generator`` seed (an int), or from
        its key as the reference draws them, a split before each site."""
        if drop is None:
            return None
        keep = 1.0 - self.dropout
        if isinstance(drop, int):
            g = torch.Generator(device=x.device).manual_seed(drop)
            return [torch.empty_like(x).bernoulli_(keep, generator=g)
                    for _ in range(2)]
        subs = []
        for _ in range(2):
            drop, sub = keychain.split(drop)
            subs.append(sub)
        return keep_masks(subs, x.shape, keep, x.device)

    def _dropout(self, x, mask):
        if mask is None:
            return x
        return x * mask.to(x.dtype) / (1.0 - self.dropout)

    def _block(self, bp, x, positions, segment_ids=None, drop=None):
        """One pre-LN block.  ``drop`` (training with dropout only) is
        the block's ``torch.Generator`` seed or its key-chain key: both
        redraw the same masks, so a recomputed block (``remat``) replays
        its first run."""
        mha = self._mha
        masks = self._keep_masks(x, drop)
        a = self._layer_norm(bp["ln1"], x)
        q, k, v = mha.project_qkv(bp["attn"], a, a, a)
        q, k = self._rope(q, k, positions)
        # the LM keeps a block size as flash tiles, never the blockwise core
        o = mha.attend(q, k, v, segment_ids=segment_ids,
                       allow_blockwise=False)
        o = mha.project_out(bp["attn"], o)
        x = x + self._dropout(o, None if masks is None else masks[0])
        m, aux = self._mlp(bp, self._layer_norm(bp["ln2"], x))
        return x + self._dropout(m, None if masks is None else masks[1]), aux

    def head_logits(self, params, h):
        """The LM head: ``h @ embed.T`` when tied, ``h @ head`` else (a
        quantized untied head through ``qmatmul``; the policy never
        quantizes the embedding)."""
        if self.tie_embeddings:
            return torch.matmul(h, params["embed"].T.to(h.dtype))
        head = params["head"]
        if is_qtensor(head):
            return qmatmul(h, head)
        return torch.matmul(h, head.to(h.dtype))

    def _forward(self, params, x, training: bool, generator=None,
                 rng=None):
        params = dequantize_entry(params)  # int8 clones run the forward too
        ids = torch.as_tensor(x, device=self.device)
        if ids.is_floating_point():
            ids = ids.to(torch.int32)
        ids = ids.long() - 1  # 1-based API edge -> 0-based gather
        t = ids.shape[-1]
        h = params["embed"][ids]
        if self.pos_encoding == "learned":
            h = h + params["pos"][:t]
        positions = torch.arange(t, device=self.device)
        segment_ids = None
        if self.doc_start_id is not None:
            # ids are 0-based here; the marker id came in 1-based
            segment_ids = torch.cumsum(
                (ids == self.doc_start_id - 1).to(torch.int32), dim=-1)
        drops = [None] * self.n_layers
        if training and self.dropout > 0.0:
            if generator is not None:
                # one seed per layer, drawn before the loop
                drops = torch.randint(0, 2 ** 62, (self.n_layers,),
                                      generator=generator).tolist()
            elif rng is not None:
                # the reference's chain: one key per layer, split again
                # before each of the block's two dropout sites
                drops = list(keychain.split(keychain.as_key(rng),
                                            self.n_layers))
            else:
                raise ValueError(
                    "TransformerLM with dropout>0 needs an rng (or a "
                    "generator) in training mode: a fixed key would apply "
                    "the same dropout mask every step")
        aux = None
        for layer in range(self.n_layers):
            bp = layer_params(params["blocks"], layer)
            if self.remat and torch.is_grad_enabled():
                h, a = checkpoint(self._block, bp, h, positions, segment_ids,
                                  drops[layer], use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, a = self._block(bp, h, positions, segment_ids,
                                   drops[layer])
            if a is not None:
                aux = a if aux is None else aux + a
        h = self._layer_norm(params["ln_f"], h)
        logp = torch.log_softmax(self.head_logits(params, h).float(), dim=-1)
        return logp, aux

    def f(self, params, x, *, training: bool = False, rng=None):
        """(B, T) 1-based ids (float or int) -> (B, T, V) float32
        log-probabilities (the reference's ``f``).  Eval mode runs with
        no autograd (the serving forward); ``training=True`` is
        differentiable, as :meth:`apply` is, its dropout drawn from
        ``rng``."""
        if training:
            return self._forward(params, x, True, rng=rng)[0]
        with torch.no_grad():
            return self._forward(params, x, False)[0]

    def apply(self, params, x, *, buffers=None, training: bool = False,
              generator: Optional[torch.Generator] = None, rng=None):
        """The training forward: ``(logp, buffers)``, differentiable in
        every leaf of ``params``.  ``training`` turns dropout on, its
        masks drawn from ``rng``, a key of the key chain, as the
        reference draws them, or from ``generator`` (a CPU
        ``torch.Generator``), which wins when both are given; one of them
        is required when ``dropout > 0``.  An MoE model returns
        ``moe_aux_weight`` times the layers' summed balance loss as
        ``buffers["aux_loss"]``; a dense one adds no key."""
        logp, aux = self._forward(params, x, training, generator, rng)
        new_buffers = dict(buffers) if buffers else {}
        if self.moe_experts:
            new_buffers["aux_loss"] = self.moe_aux_weight * aux
        return logp, new_buffers
