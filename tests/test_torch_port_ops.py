"""bigdl_tpu_torch, kernel modules and nn pieces: the port's plain
PyTorch versions against the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU (as
tests/test_ops.py and tests/test_paged_attention.py do), with pinned
blocks so the autotune cache never steers it.  The CUDA kernels
themselves run only on the card: tests/test_torch_port_kernels.py
compares each kernel with its plain version there.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.attention import MultiHeadAttention as JaxMHA
from bigdl_tpu.nn.normalization import layer_norm as jax_layer_norm
from bigdl_tpu.ops import flash_attention as jax_flash
from bigdl_tpu.ops import flash_attention_with_lse as jax_flash_lse
from bigdl_tpu.ops import paged_decode_attention as jax_paged

from bigdl_tpu_torch import resolve_device
from bigdl_tpu_torch.nn import (MultiHeadAttention, dot_product_attention,
                                layer_norm)
from bigdl_tpu_torch.ops import (FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
                                 PAGED_DECODE, flash_attention,
                                 flash_attention_backward_reference,
                                 flash_attention_reference,
                                 flash_attention_with_lse,
                                 paged_decode_attention,
                                 paged_decode_attention_reference)
from bigdl_tpu_torch.utils.params import params_from_numpy, params_to_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# flash forward: plain version vs the JAX Pallas kernel (interpret mode)      #
# --------------------------------------------------------------------------- #

FLASH_CASES = {
    # name: (tq, tk, causal, segmented)
    "causal_aligned": (32, 32, True, False),
    "causal_unaligned": (13, 13, True, False),
    "cross_tk_gt_tq": (8, 24, True, False),
    "cross_tq_gt_tk_fully_masked_rows": (12, 8, True, False),
    "noncausal_unaligned": (5, 11, False, False),
    "segmented": (20, 20, True, True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(case):
    """o and lse within 1e-5: both sides compute float32 products and
    softmax; only the summation order differs."""
    tq, tk, causal, segmented = FLASH_CASES[case]
    rng = np.random.RandomState(len(case))
    q, k, v = (_randn(rng, 2, 2, tq, 16), _randn(rng, 2, 2, tk, 16),
               _randn(rng, 2, 2, tk, 16))
    seg_q = seg_k = None
    if segmented:
        seg_q = np.sort(rng.randint(0, 3, size=(2, tq)), axis=1).astype(
            np.int32)
        seg_k = seg_q
    o_ref, lse_ref = jax_flash_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        q_segment_ids=None if seg_q is None else jnp.asarray(seg_q),
        kv_segment_ids=None if seg_k is None else jnp.asarray(seg_k),
        block_q=8, block_k=8)
    o, lse = flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        q_segment_ids=None if seg_q is None else torch.from_numpy(seg_q),
        kv_segment_ids=None if seg_k is None else torch.from_numpy(seg_k))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               atol=1e-5, rtol=1e-5)
    if case == "cross_tq_gt_tk_fully_masked_rows":
        # rows 0..3 see no key: o = 0 and lse = -1e30, never NaN
        assert np.all(o.numpy()[:, :, :4] == 0.0)
        assert np.all(lse.numpy()[:, :, :4] <= -1e29)


def test_flash_plain_matches_jax_bf16():
    """bf16 inputs: p is rounded to bf16 before the value product on both
    sides; o is bf16, so it agrees to bf16 rounding (2e-2), lse (float32
    from exact bf16 products) to 1e-5."""
    rng = np.random.RandomState(7)
    q, k, v = (_randn(rng, 1, 2, 24, 16) for _ in range(3))
    o_ref, lse_ref = jax_flash_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
        block_q=8, block_k=8)
    o, lse = flash_attention_with_lse(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# flash backward: the autograd Functions and the plain backward vs the JAX    #
# Pallas backward kernels (interpret mode)                                    #
# --------------------------------------------------------------------------- #

BWD_CASES = {
    # name: (tq, tk, causal, segmented); mirrors tests/test_ops.py's
    # TestFlashBackward, TestFlashBackwardCross and the segmented grads
    "full": (32, 32, False, False),
    "causal": (32, 32, True, False),
    "causal_tq_gt_tk_fully_masked_rows": (48, 20, True, False),
    "segmented_unaligned": (45, 45, True, True),
}


def _bwd_inputs(case):
    tq, tk, causal, segmented = BWD_CASES[case]
    rng = np.random.RandomState(100 + len(case))
    q, k, v = (_randn(rng, 2, 2, tq, 16), _randn(rng, 2, 2, tk, 16),
               _randn(rng, 2, 2, tk, 16))
    seg = None
    if segmented:
        seg = np.sort(rng.randint(0, 3, size=(2, tq)), axis=1).astype(
            np.int32)
    return q, k, v, causal, seg


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_function_grads_match_jax(case):
    """torch.autograd.grad through the port's Function (plain forward and
    backward on CPU tensors) against jax.grad through the JAX flash
    custom VJP (Pallas backward kernels, interpret mode), with a
    cotangent that is non-zero on every row, fully masked ones included:
    1e-4, float32 on both sides."""
    q, k, v, causal, seg = _bwd_inputs(case)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal,
                      segment_ids=None if seg is None else jnp.asarray(seg),
                      block_q=16, block_k=16)
        return jnp.sum((o - 1.0) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = flash_attention(tq_, tk_, tv_, causal=causal,
                        segment_ids=None if seg is None
                        else torch.from_numpy(seg))
    got = torch.autograd.grad(((o - 1.0) ** 2).sum(), (tq_, tk_, tv_))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_flash_lse_function_takes_the_lse_cotangent():
    """A loss of both o and lse (the ring-attention merge shape): the
    port's _FlashLse backward against jax.grad of the JAX
    flash_attention_with_lse, 1e-4."""
    rng = np.random.RandomState(24)
    q, k, v = (_randn(rng, 2, 2, 32, 16) for _ in range(3))
    seg = np.sort(rng.randint(0, 2, size=(2, 32)), axis=1).astype(np.int32)

    def jloss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, causal=True,
                               q_segment_ids=jnp.asarray(seg),
                               kv_segment_ids=jnp.asarray(seg),
                               block_q=16, block_k=16)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(lse))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_with_lse(
        *ts, causal=True, q_segment_ids=torch.from_numpy(seg),
        kv_segment_ids=torch.from_numpy(seg))
    got = torch.autograd.grad((o ** 2).sum() + torch.sin(lse).sum(), ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_plain_backward_matches_jax_bwd_kernels(case):
    """The plain backward against the JAX ``_flash_bwd`` (both Pallas
    backward kernels, interpret mode) on the same (o, lse, do, dlse),
    with a random lse cotangent and scale 0.25: 1e-4."""
    from bigdl_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
    q, k, v, causal, seg = _bwd_inputs(case)
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse = _flash_fwd(jq, jk, jv, jseg, jseg, causal, 0.25, 16, 16, True)
    rng = np.random.RandomState(21)
    do = rng.randn(*o.shape).astype(np.float32)
    dlse = rng.randn(*lse.shape).astype(np.float32)
    want = _flash_bwd(jq, jk, jv, o, lse, jnp.asarray(do), jnp.asarray(dlse),
                      jseg, jseg, causal, 0.25, 16, 16, True)
    tseg = None if seg is None else torch.from_numpy(seg)
    got = flash_attention_backward_reference(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do,
                                                   dlse)),
        causal=causal, scale=0.25, q_segment_ids=tseg, kv_segment_ids=tseg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_flash_plain_backward_matches_jax_bwd_kernels_bf16():
    """bf16 inputs: both sides round p before p^T do and ds before ds^T q
    and ds k, then return bf16 gradients: 2e-2 relative to each
    gradient's max |value| (bf16 rounding of p, ds and the outputs)."""
    from bigdl_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
    rng = np.random.RandomState(25)
    q, k, v, do = (_randn(rng, 1, 2, 24, 16) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = _flash_fwd(jq, jk, jv, None, None, True, 0.25, 8, 8, True)
    dlse = jnp.zeros(lse.shape, jnp.float32)
    want = _flash_bwd(jq, jk, jv, o, lse, jdo, dlse, None, None, True, 0.25,
                      8, 8, True)
    got = flash_attention_backward_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.from_numpy(np.array(o.astype(jnp.float32))).to(
            torch.bfloat16),
        torch.from_numpy(np.array(lse)),
        torch.from_numpy(do).to(torch.bfloat16), causal=True, scale=0.25)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), b,
                                   atol=2e-2 * np.abs(b).max(), rtol=0)


def _tf32(x):
    """float32 rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, on the float32 word, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b, passes):
    """a @ b with float32 sums over TF32 operands: one product of the
    rounded operands (``passes=1``), or the backward kernels' 3xTF32
    split, lo*hi + hi*lo + hi*hi with x = hi + lo (``passes=3``)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("passes", [1, 3])
def test_flash_backward_products_need_three_tf32_passes(passes):
    """The float32 backward kernels run every product on the tensor cores
    as three TF32 products.  Emulated here on the CPU at (1,4,256,64)
    causal, the five products so split keep every gradient within the
    kernels' float32 tolerance, 1e-4 of its max |value|, of the plain
    backward; one TF32 product each does not (at most 2.3e-6 against
    4e-4 to 1.4e-3 on this input)."""
    rng = np.random.RandomState(30)
    q, k, v, do = (torch.from_numpy(_randn(rng, 1, 4, 256, 64))
                   for _ in range(4))
    dlse = torch.from_numpy(_randn(rng, 1, 4, 256))
    scale = 0.125
    o, lse = flash_attention_reference(q, k, v, causal=True, scale=scale)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, dlse,
                                              causal=True, scale=scale)
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    mask = torch.ones(256, 256, dtype=torch.bool).tril()
    s = _tf32_mm(q, kt, passes) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = _tf32_mm(p.transpose(-1, -2), do, passes)
    dp = _tf32_mm(do, vt, passes)
    rest = (do * o).sum(-1) - dlse
    ds = p * (dp - rest[..., None])
    dq = _tf32_mm(ds, k, passes) * scale
    dk = _tf32_mm(ds.transpose(-1, -2), q, passes) * scale
    ratios = [(a - b).abs().max().item() / b.abs().max().item()
              for a, b in zip((dq, dk, dv), want)]
    if passes == 3:
        assert max(ratios) <= 1e-4, ratios
    else:
        assert min(ratios) > 1e-4, ratios


_LOG2E = 1.4426950408889634


def _flash_fwd_emulation(q, k, v, causal, scale, passes, bq=64, bk=64):
    """The tensor-core forward's arithmetic in torch, float32: 64-row
    query tiles walk 64-key tiles up to the last one a causal row
    reaches; S = Q K^T and O += P V as TF32 products (``_tf32_mm``); the
    online softmax in exp2 form with m kept in the units of s * scale,
    masked scores -inf; o = acc / l (l == 0 taken as 1), lse = m + log l."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    shift = tk - tq
    o = torch.zeros_like(q)
    lse = torch.empty((b, h, tq))
    scale_l2 = scale * _LOG2E
    for q0 in range(0, tq, bq):
        rows = torch.arange(q0, min(q0 + bq, tq))
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), d))
        n_k = -(-tk // bk)
        if causal:
            last = int(rows[-1]) + shift
            n_k = 0 if last < 0 else min(n_k, last // bk + 1)
        for j in range(n_k):
            keys = torch.arange(j * bk, min((j + 1) * bk, tk))
            s = _tf32_mm(q[:, :, rows], k[:, :, keys].transpose(-1, -2),
                         passes)
            if causal:
                vis = keys[None, :] <= rows[:, None] + shift
                s = torch.where(vis, s, torch.full_like(s, -float("inf")))
            m_new = torch.maximum(m, s.amax(-1) * scale)
            alpha = torch.exp2((m - m_new) * _LOG2E)
            p = torch.exp2(s * scale_l2 - (m_new * _LOG2E)[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _tf32_mm(p, v[:, :, keys], passes)
            m = m_new
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, rows] = acc / l_safe[..., None]
        lse[:, :, rows] = m + torch.log(l_safe)
    return o, lse


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("tk", [200, 136])
def test_flash_forward_emulation_matches_jax(tk, passes):
    """The float32 forward kernel runs both products on the tensor cores
    as three TF32 products.  Emulated on the CPU at (1,4,200,64) x
    (1,4,tk,64) causal, o and lse stay within 1e-4 of the JAX
    ``flash_attention_with_lse`` (Pallas kernel, interpret mode); with
    tk = 136 the first 64 rows see no key and must give o = 0 and lse =
    -1e30 exactly.  One TF32 product each does not stay within 1e-4."""
    rng = np.random.RandomState(40 + tk)
    q = _randn(rng, 1, 4, 200, 64)
    k, v = _randn(rng, 1, 4, tk, 64), _randn(rng, 1, 4, tk, 64)
    o_ref, lse_ref = jax_flash_lse(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=True, block_q=64, block_k=64)
    o, lse = _flash_fwd_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=True, scale=0.125, passes=passes)
    err = max(np.abs(o.numpy() - np.asarray(o_ref)).max(),
              np.abs(lse.numpy() - np.asarray(lse_ref)).max())
    if passes == 1:
        assert err > 1e-4, err
        return
    assert err <= 1e-4, err
    blind = 200 - tk
    assert np.all(o.numpy()[:, :, :blind] == 0.0)
    assert np.all(lse.numpy()[:, :, :blind] == np.float32(-1e30))


def _paged_split_emulation(q, ka, va, tables, pos, chunk_keys):
    """The split paged kernel's arithmetic in torch, float32: each (slot,
    head)'s live keys in chunks of whole table entries; per chunk the
    scores q . k / sqrt(D), m = max, p = exp(s - m), l = sum p and
    acc = p . V; the combine over the live chunks in chunk order,
    o = sum acc_c exp(m_c - M) / sum l_c exp(m_c - M)."""
    from bigdl_tpu_torch.ops.paged_attention import split_count
    s, h, d = q.shape
    width = tables.shape[1]
    blen = ka.shape[2]
    n_split = split_count(width, blen, chunk_keys)
    chunk = -(-width // n_split) * blen
    out = torch.empty((s, h, d))
    for si in range(s):
        n = min(int(pos[si]) + 1, width * blen)
        kp = torch.arange(n)
        blocks = tables[si].long()[kp // blen]
        krows = ka[blocks, :, kp % blen].float()       # (n, H, D)
        vrows = va[blocks, :, kp % blen].float()
        for hi in range(h):
            parts = []
            for k0 in range(0, n, chunk):
                kk, vv = krows[k0:k0 + chunk, hi], vrows[k0:k0 + chunk, hi]
                sc = (kk @ q[si, hi]) / torch.sqrt(torch.tensor(
                    d, dtype=torch.float32))
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m, p.sum(), p @ vv))
            mx = torch.stack([m for m, _, _ in parts]).max()
            f = [torch.exp(m - mx) for m, _, _ in parts]
            lt = sum(l * fc for (_, l, _), fc in zip(parts, f))
            out[si, hi] = sum(a * fc for (_, _, a), fc in zip(parts, f)) / lt
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_emulation_matches_jax(dtype):
    """The paged kernel's chunked partials and their combine, emulated on
    the CPU with the wrapper's chunk size (64 keys, 4 blocks of 16), at
    pos 0, 15, 16, 63, 64 and M * block_len - 1 (one to two chunks, at
    and across block and chunk edges): within 1e-5 of the JAX
    ``paged_decode_attention`` (Pallas kernel, interpret mode); the bf16
    arena is read in float32 on both sides."""
    from bigdl_tpu_torch.ops.paged_attention import CHUNK_KEYS
    q, ka, va, tables = _paged_inputs(seed=8, slots=6, heads=2, head_dim=64,
                                      width=8, block_len=16)
    pos = np.asarray([0, 15, 16, 63, 64, 8 * 16 - 1], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_paged(jnp.asarray(q), jnp.asarray(ka, jdt), jnp.asarray(va, jdt),
                    jnp.asarray(tables), jnp.asarray(pos))
    tdt = getattr(torch, dtype)
    out = _paged_split_emulation(
        torch.from_numpy(q), torch.from_numpy(ka).to(tdt),
        torch.from_numpy(va).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(pos), CHUNK_KEYS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_plain_attention_grads_are_finite_on_fully_masked_rows():
    """dot_product_attention (the "xla" path): a row with no visible key
    returns 0 and gives zero, finite gradients, as the flash path does."""
    rng = np.random.RandomState(26)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 2, n, 16)).requires_grad_()
               for n in (12, 8, 8))
    o = dot_product_attention(q, k, v, causal=True)
    got = torch.autograd.grad(((o - 1.0) ** 2).sum(), (q, k, v))
    ref = flash_attention(q, k, v, causal=True)
    want = torch.autograd.grad(((ref - 1.0) ** 2).sum(), (q, k, v))
    assert torch.all(o[:, :, :4] == 0)
    assert torch.all(got[0][:, :, :4] == 0)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_flash_wrapper_takes_plain_version_on_cpu():
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 2, 9, 16)).requires_grad_()
               for _ in range(3))
    counters = (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ)
    before = [c.launches for c in counters]
    o = flash_attention(q, k, v, causal=True)
    ref, _ = flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ref)
    torch.autograd.grad(o.sum(), (q, k, v))
    # a CPU call never launches, forward or backward
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :5], v[:, :, :5],
                        segment_ids=torch.zeros((1, 9), dtype=torch.int32))


# --------------------------------------------------------------------------- #
# paged decode: plain version vs the JAX Pallas kernel (interpret mode)       #
# --------------------------------------------------------------------------- #

def _paged_inputs(seed, slots=3, heads=2, head_dim=8, width=6, block_len=4):
    rng = np.random.RandomState(seed)
    num_blocks = slots * width + 1            # block 0 is scratch
    q = _randn(rng, slots, heads, head_dim)
    ka = _randn(rng, num_blocks, heads, block_len, head_dim)
    va = _randn(rng, num_blocks, heads, block_len, head_dim)
    ids = np.arange(1, slots * width + 1)
    rng.shuffle(ids)                           # non-contiguous chains
    tables = ids.reshape(slots, width).astype(np.int32)
    return q, ka, va, tables


@pytest.mark.parametrize("dtype,layout", [("float32", "SHD"),
                                          ("float32", "SH1D"),
                                          ("bfloat16", "SHD")])
def test_paged_plain_matches_jax(dtype, layout):
    """pos 0 (one key), mid-block and the last position; the bf16 arena
    is read in float32 on both sides, so 1e-5 holds for it too."""
    q, ka, va, tables = _paged_inputs(seed=3)
    pos = np.asarray([0, 9, 23], np.int32)
    if layout == "SH1D":
        q = q[:, :, None, :]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_paged(jnp.asarray(q), jnp.asarray(ka, jdt), jnp.asarray(va, jdt),
                    jnp.asarray(tables), jnp.asarray(pos))
    out = paged_decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(ka).to(tdt),
        torch.from_numpy(va).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(pos))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_paged_wrapper_takes_plain_version_on_cpu():
    q, ka, va, tables = (torch.from_numpy(x) for x in _paged_inputs(seed=4))
    pos = torch.tensor([2, 13, 6], dtype=torch.int32)
    before = PAGED_DECODE.launches
    out = paged_decode_attention(q, ka, va, tables, pos)
    assert torch.equal(out, paged_decode_attention_reference(
        q, ka, va, tables, pos))
    assert PAGED_DECODE.launches == before


# --------------------------------------------------------------------------- #
# nn pieces                                                                   #
# --------------------------------------------------------------------------- #

def test_layer_norm_matches_jax():
    """Biased variance, eps 1e-5, float32 normalization: 1e-5."""
    rng = np.random.RandomState(0)
    x = _randn(rng, 3, 5, 32) * 3.0 + 1.0
    w, b = _randn(rng, 32), _randn(rng, 32)
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mha_matches_jax(impl):
    """Projections, head split/merge and the attention core on the same
    weights (the JAX init, carried over with params_from_numpy): 1e-5."""
    jm = JaxMHA(32, 4, causal=True, attention_impl="xla")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp["bq"] = np.linspace(-1, 1, 32).astype(np.float32)
    m = MultiHeadAttention(32, 4, causal=True, attention_impl=impl)
    p = params_from_numpy(jp, "cpu")
    rng = np.random.RandomState(2)
    x = _randn(rng, 2, 7, 32)
    seg = np.asarray([[0, 0, 0, 1, 1, 1, 1], [0, 1, 1, 1, 2, 2, 2]],
                     np.int32)
    ref_q, ref_k, ref_v = jm.project_qkv(jp, x, x, x)
    q, k, v = m.project_qkv(p, *(torch.from_numpy(x),) * 3)
    for a, r in ((q, ref_q), (k, ref_k), (v, ref_v)):
        assert tuple(a.shape) == (2, 4, 7, 8)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)
    ref = jm.f(jp, jnp.asarray(x), segment_ids=jnp.asarray(seg))
    out = m.f(p, torch.from_numpy(x), segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("hidden,heads", [(64, 4), (768, 12)])
def test_auto_attention_means_the_kernels_on_cuda_at_any_head_width(
        hidden, heads):
    """"auto" sends a CUDA device to the flash kernels whatever the head
    width (the kernels raise for a width they do not take, never fall
    back) and the CPU to plain attention; "xla" is plain everywhere."""
    m = MultiHeadAttention(hidden, heads, causal=True)
    assert m.resolve_use_flash(torch.device("cuda"))
    assert not m.resolve_use_flash(torch.device("cpu"))
    assert not m.resolve_use_flash(torch.device("cuda"), "xla")


def test_build_runs_one_nvcc_per_source_and_reuses_the_library(
        tmp_path, monkeypatch):
    """ops._build with a stand-in compiler: both sources compile at once
    into hash-named libraries, a second call reuses them, and a failing
    compile raises with the compiler's output."""
    from bigdl_tpu_torch.ops import _build
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\nout=''\nwhile [ $# -gt 0 ]; do "
        "[ \"$1\" = -o ] && out=$2; shift; done\n"
        "echo 'ptxas info    : Used 8 registers'\necho lib > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build(["flash_fwd", "paged_decode"])
    for name, r in first.items():
        assert r["path"] == _build.library_path(name) and r["path"].exists()
        assert r["ptxas"] == ["ptxas info    : Used 8 registers"]
    again = _build.build(["flash_fwd"])["flash_fwd"]
    assert again["seconds"] == 0.0 and again["ptxas"] == []
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic'\nexit 2\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(["paged_decode"])


def test_build_hashes_the_shared_headers_into_every_library(tmp_path,
                                                           monkeypatch):
    """Every source may include csrc/*.cuh: editing a header in a copy of
    csrc changes every library's path (so none is reused stale), and an
    unchanged tree gives the same paths."""
    import shutil
    from bigdl_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = ("flash_fwd", "paged_decode", "flash_bwd")
    before = [_build.library_path(n) for n in names]
    assert [_build.library_path(n) for n in names] == before
    header = csrc / "sm90_mma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = [_build.library_path(n) for n in names]
    assert all(a != b for a, b in zip(after, before))


def test_params_roundtrip_keeps_keys_and_layout():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.asarray(jnp.ones((2,), jnp.bfloat16)),
                  "d": np.arange(3, dtype=np.int32)}}
    t = params_from_numpy(tree, "cpu")
    assert t["a"].shape == (2, 3) and t["b"]["c"].dtype == torch.bfloat16
    assert t["b"]["d"].dtype == torch.int32
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], np.ones(2, np.float32))
    assert params_from_numpy(tree, "cpu", torch.float64)["a"].dtype \
        == torch.float64


# --------------------------------------------------------------------------- #
# the port stands alone; the device is explicit                               #
# --------------------------------------------------------------------------- #

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    assert REPO / "bigdl_tpu_torch/serving/compile_cache.py" in files
    # the registry, tracer, fault injector, transfer and host KV tier are
    # copies of JAX-free reference modules: the port keeps its own
    for mod in ("obs/__init__.py", "obs/registry.py", "obs/tracer.py",
                "resilience/__init__.py", "resilience/errors.py",
                "resilience/faults.py", "utils/transfer.py",
                "serving/kvtier/__init__.py", "serving/kvtier/store.py"):
        assert REPO / "bigdl_tpu_torch" / mod in files, mod
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "bigdl_tpu"), (f, mod)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.generate import generate
    from bigdl_tpu_torch.serving import LMServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(vocab_size=11, hidden_size=8, n_head=2, n_layers=1)
    model = TransformerLM(vocab_size=11, hidden_size=8, n_head=2,
                          n_layers=1, max_len=16, device="cpu").build(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, model.params, np.asarray([[1, 2]]), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMServingEngine(model)
    from bigdl_tpu_torch.models.transformer import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--synthetic", "-e", "1"])     # --device defaults to cuda
    assert resolve_device("cpu") == torch.device("cpu")
