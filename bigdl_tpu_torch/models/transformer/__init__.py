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

``f`` is the serving forward (no autograd); ``apply`` is the training
forward: differentiable through the stacked leaves (each layer reads
views of them), with dropout drawn from an explicit
``torch.Generator`` and optional activation recomputation (``remat``).
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
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import layer_norm
from bigdl_tpu_torch.parallel.expert import init_moe_params, switch_mlp
from bigdl_tpu_torch.quant.kernels import qmatmul
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.quant.transform import (QuantPolicy, dequantize_entry,
                                             publish_quant_report,
                                             quantize_params)
from bigdl_tpu_torch.utils.params import layer_params


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
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                      (x2 * cos + x1 * sin).to(x.dtype)], -1)


class TransformerLM(Module):
    """Causal transformer LM over 1-based token ids, a
    :class:`~bigdl_tpu_torch.nn.module.Module` (the Torch-style shell,
    ``serve`` and the padded-batch ``ServingEngine`` take it).

    ``init(generator)`` returns a fresh parameter tree on ``device``
    from a ``torch.Generator``; ``build(seed)`` stores one as
    ``self.params``.
    """

    def __init__(self, vocab_size: int, hidden_size: int = 128,
                 n_head: int = 4, n_layers: int = 2,
                 ffn_size: Optional[int] = None, max_len: int = 512,
                 dropout: float = 0.0, tie_embeddings: bool = True,
                 remat: bool = False, attention_impl: str = "auto",
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
        self._mha = MultiHeadAttention(hidden_size, n_head, causal=True,
                                       with_bias=True,
                                       attention_impl=attention_impl)
        self.params: Optional[dict] = None
        self.buffers: dict = self.init_buffers()

    # -------------------------------------------------------------- #
    def _init_block(self, g: torch.Generator) -> dict:
        h, f = self.hidden_size, self.ffn_size
        std_h, std_f = 1.0 / math.sqrt(h), 1.0 / math.sqrt(f)
        dev = self.device
        p = {
            "ln1": {"weight": torch.ones((h,), device=dev),
                    "bias": torch.zeros((h,), device=dev)},
            "attn": self._mha.init_generator(g, dev),
            "ln2": {"weight": torch.ones((h,), device=dev),
                    "bias": torch.zeros((h,), device=dev)},
        }
        if self.moe_experts:
            p["moe"] = init_moe_params(g, self.moe_experts, h, f, dev)
            return p
        p.update(
            w1=torch.empty((h, f)).uniform_(-std_h, std_h,
                                            generator=g).to(dev),
            b1=torch.zeros((f,), device=dev),
            w2=torch.empty((f, h)).uniform_(-std_f, std_f,
                                            generator=g).to(dev),
            b2=torch.zeros((h,), device=dev))
        return p

    def init(self, generator: torch.Generator) -> dict:
        """A fresh float32 parameter tree on ``self.device``, drawn from
        ``generator`` (a CPU generator: the same seed gives the same
        weights on every device)."""
        h, v = self.hidden_size, self.vocab_size
        std = 1.0 / math.sqrt(h)
        g = generator
        layers = [self._init_block(g) for _ in range(self.n_layers)]

        def stack(trees):
            if isinstance(trees[0], dict):
                return {k: stack([t[k] for t in trees]) for k in trees[0]}
            return torch.stack(trees)

        p = {
            "embed": (torch.randn((v, h), generator=g) * std).to(self.device),
            "blocks": stack(layers),
            "ln_f": {"weight": torch.ones((h,), device=self.device),
                     "bias": torch.zeros((h,), device=self.device)},
        }
        if self.pos_encoding == "learned":
            p["pos"] = (torch.randn((self.max_len, h), generator=g)
                        * std).to(self.device)
        if not self.tie_embeddings:
            p["head"] = torch.empty((h, v)).uniform_(
                -std, std, generator=g).to(self.device)
        return p

    def init_buffers(self) -> dict:
        """``{"aux_loss": 0}`` for an MoE model; a dense one keeps none."""
        if self.moe_experts:
            return {"aux_loss": torch.zeros((), device=self.device)}
        return {}

    def build(self, seed: int = 0) -> "TransformerLM":
        self.params = self.init(torch.Generator().manual_seed(int(seed)))
        self.buffers = self.init_buffers()
        return self

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

    def _dropout(self, x, generator: torch.Generator):
        keep = 1.0 - self.dropout
        return x * torch.empty_like(x).bernoulli_(keep, generator=generator) \
            / keep

    def _block(self, bp, x, positions, segment_ids=None, seed=None):
        """One pre-LN block.  ``seed`` (training with dropout only) seeds
        the block's own generator, so a recomputed block (``remat``)
        draws the same masks as its first run."""
        mha = self._mha
        a = self._layer_norm(bp["ln1"], x)
        q, k, v = mha.project_qkv(bp["attn"], a, a, a)
        q, k = self._rope(q, k, positions)
        o = mha.attend(q, k, v, segment_ids=segment_ids)
        o = mha.project_out(bp["attn"], o)
        g = None
        if seed is not None:
            g = torch.Generator(device=x.device).manual_seed(int(seed))
            o = self._dropout(o, g)
        x = x + o
        m, aux = self._mlp(bp, self._layer_norm(bp["ln2"], x))
        if g is not None:
            m = self._dropout(m, g)
        return x + m, aux

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

    def _forward(self, params, x, training: bool, generator):
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
        seeds = [None] * self.n_layers
        if training and self.dropout > 0.0:
            if generator is None:
                raise ValueError(
                    "TransformerLM with dropout>0 needs a generator in "
                    "training mode: a fixed seed would apply the same "
                    "dropout mask every step")
            # one seed per layer, drawn before the loop (the reference
            # splits one key per layer)
            seeds = torch.randint(0, 2 ** 62, (self.n_layers,),
                                  generator=generator).tolist()
        aux = None
        for layer in range(self.n_layers):
            bp = layer_params(params["blocks"], layer)
            if self.remat and torch.is_grad_enabled():
                h, a = checkpoint(self._block, bp, h, positions, segment_ids,
                                  seeds[layer], use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, a = self._block(bp, h, positions, segment_ids,
                                   seeds[layer])
            if a is not None:
                aux = a if aux is None else aux + a
        h = self._layer_norm(params["ln_f"], h)
        logp = torch.log_softmax(self.head_logits(params, h).float(), dim=-1)
        return logp, aux

    @torch.no_grad()
    def f(self, params, x):
        """(B, T) 1-based ids (float or int) -> (B, T, V) float32
        log-probabilities, eval mode, no autograd (the serving
        forward)."""
        return self._forward(params, x, False, None)[0]

    def apply(self, params, x, *, buffers=None, training: bool = False,
              generator: Optional[torch.Generator] = None, rng=None):
        """The training forward: ``(logp, buffers)``, differentiable in
        every leaf of ``params``.  ``training`` turns dropout on, drawn
        from ``generator`` (a CPU ``torch.Generator``; required when
        ``dropout > 0``), or else from a generator seeded by ``rng``, the
        reference's key-chain key (the masks are not the reference's).
        An MoE model returns ``moe_aux_weight`` times the layers' summed
        balance loss as ``buffers["aux_loss"]``; a dense one adds no
        key."""
        if generator is None and rng is not None and training \
                and self.dropout > 0.0:
            key = np.asarray(rng, np.uint32)
            generator = torch.Generator().manual_seed(
                (int(key[0]) << 32) | int(key[1]))
        logp, aux = self._forward(params, x, training, generator)
        new_buffers = dict(buffers) if buffers else {}
        if self.moe_experts:
            new_buffers["aux_loss"] = self.moe_aux_weight * aux
        return logp, new_buffers
