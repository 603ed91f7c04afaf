"""GPT-2 in plain PyTorch, float32: the reference of every cell.

A pre-LayerNorm decoder (Radford et al. 2019; the layout of the
published ``config.json`` files): learned positions, causal softmax
attention scaled by 1/sqrt(head_dim), tanh-approximate GELU, LayerNorm
with the configuration's epsilon, and the head tied to the token
embedding.  No kernel, cache, batching or anything of the program: it
reads the weight tree ``bench/weights.py`` draws and token ids.  Ids
here are 0-based; the program's are 1-based at its edge.

Every matrix product goes through one function, so the same code gives
the control: ``precision="tf32"`` rounds both operands of every product
to TF32 (10 explicit mantissa bits, round to nearest even) and
accumulates in float32, which is what the tensor cores do when TF32 is
allowed.  ``"float32"`` keeps the products in float32; callers turn
TF32 off in PyTorch (:func:`strict_float32`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


def strict_float32() -> None:
    """Float32 products stay float32 on the card (PyTorch's TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the leading axes that broadcasting added."""
    while t.dim() > len(shape):
        t = t.sum(0)
    return t


class _TF32MatMul(torch.autograd.Function):
    """A product with both operands rounded to TF32, forward and in the
    two backward products, as the tensor cores compute all three."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = torch.matmul(rg, rb.transpose(-1, -2))
        gb = _sum_to(torch.matmul(ra.transpose(-1, -2), rg), rb.shape)
        return ga, gb


def products(precision: str):
    """The matrix product of ``precision``."""
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"precision must be one of {PRECISIONS}, "
                     f"got {precision!r}")


def _layer(p: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked block leaves."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(p["blocks"])


def _attention(bp: dict, x: torch.Tensor, heads: int, mm) -> torch.Tensor:
    b, t, h = x.shape
    d = h // heads
    a = bp["attn"]

    def split(y):
        return y.reshape(b, t, heads, d).transpose(1, 2)

    q = split(mm(x, a["wq"]) + a["bq"])
    k = split(mm(x, a["wk"]) + a["bk"])
    v = split(mm(x, a["wv"]) + a["bv"])
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    scores = scores.masked_fill(causal, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v)
    o = o.transpose(1, 2).reshape(b, t, h)
    return mm(o, a["wo"]) + a["bo"]


def hidden(params: dict, ids0: torch.Tensor, heads: int, eps: float,
           precision: str = "float32") -> torch.Tensor:
    """(B, T) 0-based ids -> (B, T, h) final LayerNorm'd hidden states."""
    mm = products(precision)
    t = ids0.shape[-1]
    x = params["embed"][ids0] + params["pos"][:t]
    h = x.shape[-1]
    n_layers = params["blocks"]["w1"].shape[0]
    for i in range(n_layers):
        bp = _layer(params, i)
        a = F.layer_norm(x, (h,), bp["ln1"]["weight"], bp["ln1"]["bias"],
                         eps)
        x = x + _attention(bp, a, heads, mm)
        m = F.layer_norm(x, (h,), bp["ln2"]["weight"], bp["ln2"]["bias"],
                         eps)
        m = F.gelu(mm(m, bp["w1"]) + bp["b1"], approximate="tanh")
        x = x + mm(m, bp["w2"]) + bp["b2"]
    return F.layer_norm(x, (h,), params["ln_f"]["weight"],
                        params["ln_f"]["bias"], eps)


def logits(params: dict, h: torch.Tensor, precision: str = "float32"):
    """The tied head: ``h @ embed.T``."""
    return products(precision)(h, params["embed"].T)


# -- serving ------------------------------------------------------------ #
@torch.no_grad()
def sequence_logits(params: dict, seq0: Sequence[int], heads: int,
                    eps: float, precision: str = "float32") -> torch.Tensor:
    """The logits at every position of one 0-based sequence: row ``i``
    predicts the token after position ``i``.  (T, V) float32."""
    dev = params["embed"].device
    ids = torch.tensor([list(seq0)], dtype=torch.long, device=dev)
    return logits(params, hidden(params, ids, heads, eps, precision)[0],
                  precision)


def gaps(ref_logits: torch.Tensor, chosen0) -> torch.Tensor:
    """How far each chosen token's logit lies below the reference's best
    at its position (0 where it is the best)."""
    chosen = torch.as_tensor(chosen0, device=ref_logits.device,
                             dtype=torch.long)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, chosen[:, None])[:, 0]


# -- training ----------------------------------------------------------- #
def nll_sum(params: dict, ids0: torch.Tensor, labels0: torch.Tensor,
            heads: int, eps: float, precision: str) -> torch.Tensor:
    """Summed negative log-likelihood of ``labels0`` (B, T)."""
    h = hidden(params, ids0, heads, eps, precision)
    logp = torch.log_softmax(logits(params, h, precision), dim=-1)
    return -logp.gather(-1, labels0[..., None]).sum()


def adam_steps(params: dict, batches: List[Tuple[torch.Tensor,
                                                   torch.Tensor]],
               heads: int, eps: float, *, lr: float, beta1: float,
               beta2: float, adam_eps: float, row_block: int,
               precision: str = "float32") -> Dict[str, object]:
    """Train ``params`` (updated in place) on ``batches`` of 0-based
    (ids, labels), one Adam step each, the loss the mean token NLL.
    Each step's gradient is summed over blocks of ``row_block`` rows,
    so the peak follows the block.  Returns each step's loss, each
    leaf's gradient as Adam received it at the first step (by name) and
    the starting values, for the change."""
    from h100_bench.bench.weights import leaves
    named = list(leaves(params))
    start = {name: t.detach().clone() for name, t in named}
    m = {name: torch.zeros_like(t) for name, t in named}
    v = {name: torch.zeros_like(t) for name, t in named}
    losses, first_grads = [], None
    for step, (ids0, labels0) in enumerate(batches, start=1):
        for _, t in named:
            t.requires_grad_(True)
            t.grad = None
        n_tokens = ids0.numel()
        total = 0.0
        for r in range(0, ids0.shape[0], row_block):
            part = nll_sum(params, ids0[r:r + row_block],
                           labels0[r:r + row_block], heads, eps, precision)
            (part / n_tokens).backward()
            total += float(part.detach())
        losses.append(total / n_tokens)
        bc1, bc2 = 1 - beta1 ** step, 1 - beta2 ** step
        with torch.no_grad():
            grads = {name: t.grad for name, t in named}
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in grads.items()}
            for name, t in named:
                g = grads[name]
                m[name].mul_(beta1).add_(g, alpha=1 - beta1)
                v[name].mul_(beta2).add_(g * g, alpha=1 - beta2)
                t.sub_(lr * (m[name] / bc1)
                       / (torch.sqrt(v[name] / bc2) + adam_eps))
        for _, t in named:
            t.grad = None
            t.requires_grad_(False)
    return {"losses": losses, "first_grads": first_grads, "start": start}
