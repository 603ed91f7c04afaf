"""Attention layers (port of ``bigdl_tpu/nn/attention.py``).

Parameters keep the JAX layout: ``wq``/``wk``/``wv`` are ``(hidden,
H*D)``, ``wo`` is ``(H*D, hidden)``, applied as ``x @ w``.  Heads are
split to ``(B, H, T, D)`` as in the reference.  ``MultiHeadAttention``
is a :class:`~bigdl_tpu_torch.nn.module.Module`: ``build(seed)`` draws
the reference's tree bit for bit.

Three attention cores, as in the reference: the flash kernels
(``ops.flash_attention``), the blockwise online-softmax core
(:func:`blockwise_attention`, pinned by ``block_size``) and plain
attention (:func:`dot_product_attention`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn._util import replicate_like
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.quant.kernels import qmatmul
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.table import Table


NEG_INF = float("-inf")


def _safe_exp(x, m):
    """exp(x - m) with -inf maxima treated as empty (0 weight)."""
    empty = torch.isneginf(m)
    return torch.where(empty, torch.zeros_like(x),
                       torch.exp(x - torch.where(empty, torch.zeros_like(m),
                                                 m)))


def online_softmax_update(carry, block):
    """One step of the streaming-softmax accumulation of blockwise (and
    ring) attention: merge a new (m_blk, l_blk, o_blk) partial into the
    running (o, l, m).  Shapes: m, l (..., Tq); o (..., Tq, D)."""
    o, l, m = carry
    m_blk, l_blk, o_blk = block
    m_new = torch.maximum(m, m_blk)
    alpha = _safe_exp(m, m_new)
    beta = _safe_exp(m_blk, m_new)
    o = o * alpha[..., None] + o_blk * beta[..., None]
    l = l * alpha + l_blk * beta
    return o, l, m_new


def segment_mask(seg_q, seg_k):
    """(B, 1, Tq, Tk) boolean packed-document isolation mask from
    (B, Tq)/(B, Tk) segment ids; broadcasts over the head dim."""
    return seg_q[:, None, :, None] == seg_k[:, None, None, :]


def _block_scores(q, k, v, mask, scale):
    """Partial attention of q against one k/v block.  q: (..., Tq, D);
    k, v: (..., Tk, D); mask broadcastable to (..., Tq, Tk) or None.
    Returns (m_blk (..., Tq), l_blk (..., Tq), o_blk (..., Tq, D))."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_blk = s.amax(dim=-1)
    p = _safe_exp(s, m_blk[..., None])
    return m_blk, p.sum(dim=-1), torch.matmul(p, v)


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
        cmask = replicate_like(torch.ones((tq, tk), dtype=torch.bool,
                                          device=q.device).tril(tk - tq), q)
        mask = cmask if mask is None else torch.logical_and(mask, cmask)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~replicate_like(mask, s), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    empty = torch.isneginf(m)
    p = torch.where(empty, torch.zeros_like(s),
                    torch.exp(s - torch.where(empty, torch.zeros_like(m), m)))
    l = p.sum(dim=-1)
    return _finalize(torch.matmul(p, v), l)


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False,
                        scale: Optional[float] = None):
    """Streaming attention: k/v are consumed in blocks of ``block_size``
    keys with an online softmax, so no (Tq, Tk) score matrix is held at
    once.  A Python loop over the key blocks in plain PyTorch,
    differentiable by autograd.  The tail block is padded and its pad
    keys masked by position; when Tq != Tk the query positions align to
    the ends (``q_pos = arange(Tq) + Tk - Tq``).  q, k, v: (B, H, T, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    tk = k.shape[-2]
    block_size = min(block_size, tk)
    rem = tk % block_size
    padded = rem != 0
    if padded:  # pad the tail block; pad keys are masked out by position
        pad = block_size - rem
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    tq = q.shape[-2]
    q_pos = torch.arange(tq, device=q.device) + (tk - tq)
    o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=q.dtype, device=q.device)
    for i in range(k.shape[-2] // block_size):
        lo = i * block_size
        kb, vb = k[..., lo:lo + block_size, :], v[..., lo:lo + block_size, :]
        mask = None
        if causal or padded:
            k_pos = lo + torch.arange(block_size, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :] if causal
                    else torch.ones((tq, block_size), dtype=torch.bool,
                                    device=q.device))
            if padded:
                mask = mask & (k_pos < tk)[None, :]
        o, l, m = online_softmax_update(
            (o, l, m), _block_scores(q, kb, vb, mask, scale))
    return _finalize(o, l)


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

    #: a spec saved before the blockwise core existed rebuilds unpinned
    block_size: Optional[int] = None

    def __init__(self, hidden_size: int, n_head: int,
                 head_dim: Optional[int] = None, causal: bool = False,
                 with_bias: bool = True, block_size: Optional[int] = None,
                 attention_impl: str = "auto"):
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
        self.block_size = block_size  # None: no pinned blockwise core
        # "flash": always the CUDA flash kernels (plain versions on CPU
        # tensors); "xla": always plain attention; "auto": the kernels on
        # a CUDA device, which raise for a head width they do not take,
        # and on the host a tuned verdict for the CPU, else plain
        # attention (ops.use_flash_auto)
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

    def param_shapes(self) -> dict:
        """The shapes of :meth:`init`'s tree, in its order."""
        shapes = dict(self._shapes())
        if self.with_bias:
            for name in ("bq", "bk", "bv", "bo"):
                shapes[name] = (self._bias_size(name),)
        return shapes

    def resolve_use_flash(self, device: torch.device,
                          attention_impl: Optional[str] = None,
                          seq_len: Optional[int] = None,
                          dtype=None) -> bool:
        """ONE dispatch rule for every call path (module forward,
        ``TransformerLM`` block, generation prefill, each prefill bucket
        of the LM engine); ``attention_impl`` overrides the module's own
        setting for one call.  Explicit "flash" always; "xla" never;
        "auto" by ``ops.use_flash_auto`` for (seq_len, head_dim, dtype,
        causal) on ``device`` (always the kernels on a CUDA device; on
        the CPU a tuned verdict, else plain), unless a block_size is set,
        which pins the blockwise core.  Without ``seq_len`` "auto" takes
        the static rule, a CUDA device."""
        impl = self.attention_impl if attention_impl is None else attention_impl
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be 'auto', 'flash' or "
                             f"'xla', got {impl!r}")
        if impl == "flash":
            return True
        if impl == "auto" and not self.block_size:
            if seq_len is None:
                return torch.device(device).type == "cuda"
            from bigdl_tpu_torch.ops import use_flash_auto
            return use_flash_auto(seq_len, self.head_dim, dtype, self.causal,
                                  device=device)
        return False

    def pinned_tile(self, dtype, attention_impl: Optional[str] = None):
        """The flash tile a call pins, or None: ``(block_size,
        block_size)`` for a pinned block size (the kernel raises for a
        tile it was not built for), the kernel's default tile for an
        explicit "flash" (the cache never moves it), None for "auto" (the
        tuned plan picks the tile, and on the CPU may route to the plain
        core)."""
        if self.block_size:
            return (self.block_size, self.block_size)
        if (attention_impl or self.attention_impl) == "flash":
            from bigdl_tpu_torch.ops import flash_tiles
            return flash_tiles(dtype, self.head_dim)[0]
        return None

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

    def attend(self, q, k, v, *, segment_ids=None, allow_blockwise=True):
        """The ONE attention-core dispatch of the module forward and the
        ``TransformerLM`` blocks, all differentiable: flash (per
        :meth:`resolve_use_flash`), then blockwise (a pinned block_size,
        module path only), then plain.  ``segment_ids`` (B, T):
        packed-document isolation, self-attention only (masked inside the
        flash tiles or by an explicit mask on the plain core)."""
        if segment_ids is not None and q.shape[-2] != k.shape[-2]:
            raise ValueError("segment_ids requires self-attention "
                             "(Tq == Tk)")
        if self.resolve_use_flash(q.device, seq_len=q.shape[-2],
                                  dtype=q.dtype):
            from bigdl_tpu_torch.ops import flash_attention
            bq, bk = self.pinned_tile(q.dtype) or (None, None)
            return flash_attention(q, k, v, causal=self.causal,
                                   segment_ids=segment_ids, block_q=bq,
                                   block_k=bk)
        if self.block_size and allow_blockwise:
            if segment_ids is not None:
                raise ValueError(
                    "segment_ids is not supported with a pinned "
                    "block_size (blockwise core); use "
                    "attention_impl='flash', or unset block_size for "
                    "the plain core")
            return blockwise_attention(q, k, v, block_size=self.block_size,
                                       causal=self.causal)
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
