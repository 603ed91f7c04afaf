"""Attention layers (port of ``bigdl_tpu/nn/attention.py``).

Parameters keep the JAX layout: ``wq``/``wk``/``wv`` are ``(hidden,
H*D)``, ``wo`` is ``(H*D, hidden)``, applied as ``x @ w``.  Heads are
split to ``(B, H, T, D)`` as in the reference.  ``MultiHeadAttention``
is a :class:`~bigdl_tpu_torch.nn.module.Module`: ``build(seed)`` draws
the reference's tree bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.quant.kernels import qmatmul
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.table import Table


def segment_mask(seg_q, seg_k):
    """(B, 1, Tq, Tk) boolean packed-document isolation mask from
    (B, Tq)/(B, Tk) segment ids; broadcasts over the head dim."""
    return seg_q[:, None, :, None] == seg_k[:, None, None, :]


def _finalize(o, l):
    return o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          scale: Optional[float] = None):
    """Plain attention over (..., T, D).  Masked scores are ``-inf`` and
    a row whose every key is masked weighs nothing, so it returns 0 (the
    reference's ``_safe_exp`` / ``_finalize``); its gradients are 0, not
    NaN, because the exponent of such a row is taken at a finite
    stand-in for its -inf maximum."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if causal:
        tq, tk = q.shape[-2], k.shape[-2]
        cmask = torch.ones((tq, tk), dtype=torch.bool,
                           device=q.device).tril(tk - tq)
        mask = cmask if mask is None else torch.logical_and(mask, cmask)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    empty = torch.isneginf(m)
    p = torch.where(empty, torch.zeros_like(s),
                    torch.exp(s - torch.where(empty, torch.zeros_like(m), m)))
    l = p.sum(dim=-1)
    return _finalize(torch.matmul(p, v), l)


def _match_compute_dtype(x, w):
    """Cast a float input to a float weight's dtype (the reference's
    ``match_compute_dtype``), so the product runs in the weight's type; a
    QTensor weight leaves the input as it is (``qmatmul`` decides)."""
    if is_qtensor(w):
        return x
    if x.is_floating_point() and w.is_floating_point() and x.dtype != w.dtype:
        return x.to(w.dtype)
    return x


#: the attention cores a MultiHeadAttention dispatches between
ATTENTION_IMPLS = ("auto", "flash", "xla")


class MultiHeadAttention(Module):
    """Multi-head attention over (B, T, F): projections, head split and
    the attention-core dispatch shared by ``TransformerLM``.  Input: a
    tensor (self-attention) or a Table/tuple (query, key, value)."""

    def __init__(self, hidden_size: int, n_head: int,
                 head_dim: Optional[int] = None, causal: bool = False,
                 with_bias: bool = True, attention_impl: str = "auto"):
        super().__init__()
        if head_dim is None and hidden_size % n_head != 0:
            raise ValueError("hidden_size must divide by n_head")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be 'auto', 'flash' or "
                             f"'xla', got {attention_impl!r}")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.head_dim = head_dim or hidden_size // n_head
        self.causal = causal
        self.with_bias = with_bias
        # "flash": always the CUDA flash kernels (plain versions on CPU
        # tensors); "xla": always plain attention; "auto": the kernels on
        # a CUDA device (which raise for a head width they do not take),
        # plain attention on the host
        self.attention_impl = attention_impl

    def _shapes(self):
        inner = self.n_head * self.head_dim
        return (("wq", (self.hidden_size, inner)),
                ("wk", (self.hidden_size, inner)),
                ("wv", (self.hidden_size, inner)),
                ("wo", (inner, self.hidden_size)))

    def _bias_size(self, name: str) -> int:
        return self.hidden_size if name == "bo" else \
            self.n_head * self.head_dim

    def init(self, rng) -> dict:
        """The reference's tree from a key-chain key: ``split(rng, 4)``
        and a uniform draw per projection, zero biases (numpy)."""
        std = 1.0 / math.sqrt(self.hidden_size)
        p = {name: keychain.uniform(k, shape, -std, std)
             for (name, shape), k in zip(self._shapes(),
                                         keychain.split(rng, 4))}
        if self.with_bias:
            for name in ("bq", "bk", "bv", "bo"):
                p[name] = np.zeros((self._bias_size(name),), np.float32)
        return p

    def init_generator(self, generator: torch.Generator,
                       device="cpu") -> dict:
        """A tree drawn from a ``torch.Generator`` (``TransformerLM``'s
        own initializer), on ``device``."""
        std = 1.0 / math.sqrt(self.hidden_size)
        p = {name: torch.empty(shape).uniform_(
                -std, std, generator=generator).to(device)
             for name, shape in self._shapes()}
        if self.with_bias:
            for name in ("bq", "bk", "bv", "bo"):
                p[name] = torch.zeros((self._bias_size(name),), device=device)
        return p

    def resolve_use_flash(self, device: torch.device,
                          attention_impl: Optional[str] = None) -> bool:
        """ONE dispatch rule for every call path (module forward,
        ``TransformerLM`` block, generation prefill); ``attention_impl``
        overrides the module's own setting for one call."""
        impl = self.attention_impl if attention_impl is None else attention_impl
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be 'auto', 'flash' or "
                             f"'xla', got {impl!r}")
        if impl == "flash":
            return True
        if impl == "auto":
            return torch.device(device).type == "cuda"
        return False

    def _split_heads(self, x):  # (B, T, H*D) -> (B, H, T, D)
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):  # (B, H, T, D) -> (B, T, H*D)
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def project_qkv(self, params, q_in, k_in, v_in):
        # qmatmul is the QTensor-aware seam: plain tensors go straight to
        # torch.matmul, an int8-compute weight to the int8 product
        q = qmatmul(_match_compute_dtype(q_in, params["wq"]), params["wq"])
        k = qmatmul(_match_compute_dtype(k_in, params["wk"]), params["wk"])
        v = qmatmul(_match_compute_dtype(v_in, params["wv"]), params["wv"])
        if self.with_bias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        return (self._split_heads(q), self._split_heads(k),
                self._split_heads(v))

    def project_out(self, params, o):
        y = qmatmul(self._merge_heads(o), params["wo"])
        if self.with_bias:
            y = y + params["bo"]
        return y

    def attend(self, q, k, v, *, segment_ids=None):
        """Flash kernels (per :meth:`resolve_use_flash`) or plain
        attention, both differentiable.  ``segment_ids`` (B, T):
        packed-document isolation, self-attention only."""
        if segment_ids is not None and q.shape[-2] != k.shape[-2]:
            raise ValueError("segment_ids requires self-attention "
                             "(Tq == Tk)")
        if self.resolve_use_flash(q.device):
            from bigdl_tpu_torch.ops import flash_attention
            return flash_attention(q, k, v, causal=self.causal,
                                   segment_ids=segment_ids)
        mask = (None if segment_ids is None
                else segment_mask(segment_ids, segment_ids))
        return dot_product_attention(q, k, v, causal=self.causal, mask=mask)

    def f(self, params, x, *, segment_ids=None, **kw):
        """Self-attention (a tensor) or (query, key, value) (a Table or a
        tuple)."""
        if isinstance(x, Table):
            q_in, k_in, v_in = x.to_seq()[:3]
        elif isinstance(x, (tuple, list)):
            q_in, k_in, v_in = x[0], x[1], x[2]
        else:
            q_in = k_in = v_in = x
        q, k, v = self.project_qkv(params, q_in, k_in, v_in)
        o = self.attend(q, k, v, segment_ids=segment_ids)
        return self.project_out(params, o)
