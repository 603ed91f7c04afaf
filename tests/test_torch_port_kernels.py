"""bigdl_tpu_torch's CUDA kernels on the card, each against its plain
PyTorch version.  Every test here needs an NVIDIA GPU and ``nvcc`` and
skips without them; the file imports neither JAX nor the JAX package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_kernels.py
"""
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import resolve_device
from bigdl_tpu_torch.ops import (FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
                                 FLASH_TILES, PAGED_DECODE, flash_attention,
                                 flash_attention_backward_reference,
                                 flash_attention_reference,
                                 flash_attention_with_lse,
                                 paged_decode_attention,
                                 paged_decode_attention_reference)

pytestmark = pytest.mark.cuda

TOL = {"float32": (1e-4, 1e-4),     # (o, lse): summation order only
       "bfloat16": (2e-2, 1e-2)}    # bf16 rounding of p and o
# backward, relative to each gradient's max |value|: float32 differs by
# summation order only; bf16 by the rounding of p and ds to bf16
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def card():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return resolve_device("cuda")


def _rand(g, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,causal,d", [(100, 100, True, 64),
                                            (64, 200, True, 64),
                                            (70, 30, True, 128),
                                            (33, 17, False, 64)])
def test_flash_kernel_matches_plain(card, dtype, tq, tk, causal, d):
    g = torch.Generator().manual_seed(tq + tk)
    tdt = getattr(torch, dtype)
    q = _rand(g, (2, 3, tq, d), card, tdt)
    k = _rand(g, (2, 3, tk, d), card, tdt)
    v = _rand(g, (2, 3, tk, d), card, tdt)
    before = FLASH_FWD.launches
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal)
    tol_o, tol_l = TOL[dtype]
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_l


def test_flash_kernel_segments_and_masked_rows(card):
    g = torch.Generator().manual_seed(3)
    q, k, v = (_rand(g, (2, 2, 90, 64), card) for _ in range(3))
    seg = torch.tensor(np.sort(np.random.RandomState(0).randint(
        0, 4, size=(2, 90)), axis=1), dtype=torch.int32, device=card)
    o, lse = flash_attention_with_lse(q, k, v, causal=True,
                                      q_segment_ids=seg, kv_segment_ids=seg)
    o_ref, lse_ref = flash_attention_reference(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # Tq > Tk, causal: the first rows see no key at all
    o, lse = flash_attention_with_lse(q, k[:, :, :50], v[:, :, :50],
                                      causal=True)
    assert torch.all(o[:, :, :40] == 0) and torch.all(lse[:, :, :40] <= -1e29)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d", [(8, 1024, 64),    # the training step
                                   (2, 512, 128)])   # D = 128
def test_flash_kernel_matches_plain_at_full_size(card, dtype, b, t, d):
    """The tensor-core forward at the training step's shape and at
    D = 128, causal: o and lse within tolerance, and bitwise equal on a
    second run (no atomics: every sum in a fixed order)."""
    g = torch.Generator().manual_seed(b + t + d)
    tdt = getattr(torch, dtype)
    q, k, v = (_rand(g, (b, 12, t, d), card, tdt) for _ in range(3))
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    o2, lse2 = flash_attention_with_lse(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    tol_o, tol_l = TOL[dtype]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_l


def test_flash_kernel_rejects_what_it_cannot_run(card):
    q = torch.zeros((1, 1, 8, 32), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_with_lse(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        x = torch.zeros((1, 1, 8, 64), device=card, dtype=torch.float16)
        flash_attention_with_lse(x, x, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["SHD", "SH1D"])
def test_paged_kernel_matches_plain(card, dtype, layout):
    """float32 output from float32 math for both arenas: 1e-4."""
    g = torch.Generator().manual_seed(1)
    s, h, d, blen, width = 5, 3, 64, 16, 8
    n = s * width + 1
    ka = _rand(g, (n, h, blen, d), card, getattr(torch, dtype))
    va = _rand(g, (n, h, blen, d), card, getattr(torch, dtype))
    q = _rand(g, (s, h, 1, d) if layout == "SH1D" else (s, h, d), card)
    tables = (torch.randperm(n - 1, generator=g) + 1).reshape(s, width).to(
        card, torch.int32)
    pos = torch.tensor([0, 7, 16, 64, 127], dtype=torch.int32, device=card)
    before = PAGED_DECODE.launches
    out = paged_decode_attention(q, ka, va, tables, pos)
    torch.cuda.synchronize()
    assert PAGED_DECODE.launches == before + 1
    ref = paged_decode_attention_reference(q, ka, va, tables, pos)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernel_matches_plain_at_chunk_edges(card, dtype, d):
    """Positions at and across the 64-key chunks' edges (one to four
    chunks live) and the last position of the table, M * block_len - 1:
    within 1e-4 of the plain version, and bitwise equal on a second run
    (the combine merges the chunks in a fixed order)."""
    g = torch.Generator().manual_seed(d)
    s, h, blen, width = 8, 3, 16, 16
    n = s * width + 1
    ka, va = (_rand(g, (n, h, blen, d), card, getattr(torch, dtype))
              for _ in range(2))
    tables = (torch.randperm(n - 1, generator=g) + 1).reshape(s, width).to(
        card, torch.int32)
    q = _rand(g, (s, h, d), card)
    pos = torch.tensor([0, 63, 64, 65, 127, 128, 200, width * 16 - 1],
                       dtype=torch.int32, device=card)
    out = paged_decode_attention(q, ka, va, tables, pos)
    again = paged_decode_attention(q, ka, va, tables, pos)
    ref = paged_decode_attention_reference(q, ka, va, tables, pos)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 1e-4


def test_paged_kernel_never_reads_past_pos(card):
    """NaN in every K/V row past each slot's live prefix (the rest of its
    last block and every block after it, so whole 64-key chunks past
    pos), and in the scratch block, must not reach the output."""
    g = torch.Generator().manual_seed(2)
    s, h, d, blen, width = 3, 2, 64, 16, 12
    n = s * width + 1
    ka, va = (_rand(g, (n, h, blen, d), card) for _ in range(2))
    tables = torch.arange(1, n, dtype=torch.int32, device=card).reshape(
        s, width)
    pos = torch.tensor([5, 70, 130], dtype=torch.int32, device=card)
    q = _rand(g, (s, h, d), card)
    ref = paged_decode_attention_reference(q, ka, va, tables, pos)
    for si in range(s):
        last, off = divmod(int(pos[si]), blen)
        ka[tables[si, last], :, off + 1:] = float("nan")
        va[tables[si, last], :, off + 1:] = float("nan")
        for c in range(last + 1, width):
            ka[tables[si, c]] = float("nan")
            va[tables[si, c]] = float("nan")
    ka[0] = va[0] = float("nan")
    out = paged_decode_attention(q, ka, va, tables, pos)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


def test_paged_kernel_rejects_misaligned_arenas(card):
    """The kernel reads K/V rows as 16-byte vectors: an arena whose data
    starts off a 16-byte boundary is refused, never read."""
    s, h, d, blen, width = 2, 2, 64, 16, 2
    n = s * width + 1
    flat = torch.zeros(n * h * blen * d + 1, device=card)
    ka = flat[1:].view(n, h, blen, d)            # contiguous, 4 bytes off
    va = torch.zeros_like(ka)
    tables = torch.arange(1, n, dtype=torch.int32, device=card).reshape(
        s, width)
    pos = torch.zeros(s, dtype=torch.int32, device=card)
    q = torch.zeros((s, h, d), device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(q, ka, va, tables, pos)


def _bwd_case(card, dtype, tq, tk, d, causal, segmented=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    tdt = getattr(torch, dtype)
    q = _rand(g, (2, 3, tq, d), card, tdt)
    k = _rand(g, (2, 3, tk, d), card, tdt)
    v = _rand(g, (2, 3, tk, d), card, tdt)
    seg = None
    if segmented:
        seg = torch.tensor(np.sort(np.random.RandomState(seed).randint(
            0, 4, size=(2, tq)), axis=1), dtype=torch.int32, device=card)
    o, lse = flash_attention_reference(q, k, v, causal=causal,
                                       q_segment_ids=seg, kv_segment_ids=seg)
    do = _rand(g, o.shape, card, tdt)
    dlse = _rand(g, lse.shape, card)
    return q, k, v, o, lse, do, dlse, seg


def _run_bwd(q, k, v, o, lse, do, dlse, seg, causal):
    from bigdl_tpu_torch.ops.flash_attention import _flash_bwd
    return _flash_bwd(q, k, v, o, lse, do, dlse, seg, seg, causal,
                      1.0 / np.sqrt(q.shape[-1]))


def _check_bwd(args, dtype, causal):
    """Both backward kernels launched once each, every gradient within
    TOL_BWD of the plain backward's, and dq = 0 on rows that see no key."""
    q, k, v, o, lse, do, dlse, seg = args
    tq, tk = q.shape[2], k.shape[2]
    before = (FLASH_BWD_DKV.launches, FLASH_BWD_DQ.launches)
    got = _run_bwd(*args, causal)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DKV.launches, FLASH_BWD_DQ.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_backward_reference(
        q, k, v, o, lse, do, dlse, causal=causal, q_segment_ids=seg,
        kv_segment_ids=seg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        ref = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL_BWD[dtype] * max(ref, 1e-6), (name, err, ref)
    if tq > tk and causal:
        # rows 0..tq-tk-1 see no key: they give dq = 0
        assert torch.all(got[0][:, :, :tq - tk] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,causal,d,segmented", [
    (128, 128, True, 64, False),      # aligned, causal
    (100, 100, True, 64, False),      # unaligned T
    (90, 40, True, 64, False),        # Tq > Tk: fully masked rows
    (64, 200, True, 64, False),       # Tk > Tq
    (70, 70, True, 128, False),       # D = 128
    (33, 17, False, 64, False),       # not causal
    (96, 96, True, 64, True),         # segmented
    (77, 77, True, 128, True),        # segmented, D = 128, unaligned
    (1024, 1024, True, 64, False)])   # long rows: the most terms a sum
def test_flash_bwd_kernels_match_plain(card, dtype, tq, tk, causal, d,
                                       segmented):
    args = _bwd_case(card, dtype, tq, tk, d, causal, segmented, seed=tq + d)
    _check_bwd(args, dtype, causal)


def test_flash_bwd_kernels_match_plain_float32_d128_long(card):
    """float32 at D = 128 over 512 rows: the 3xTF32 products with the
    largest accumulators and the 32-row streamed tiles."""
    args = _bwd_case(card, "float32", 512, 512, 128, True, seed=11)
    _check_bwd(args, "float32", True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_are_bitwise_repeatable(card, dtype):
    args = _bwd_case(card, dtype, 200, 200, 64, True, seed=5)
    first = _run_bwd(*args, True)
    second = _run_bwd(*args, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_runs_the_kernels(card):
    """torch.autograd through flash_attention on CUDA tensors launches
    one forward and one of each backward kernel, and matches autograd
    through the plain reference."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (_rand(g, (2, 4, 150, 64), card).requires_grad_()
               for _ in range(3))
    before = [kern.launches for kern in (FLASH_FWD, FLASH_BWD_DKV,
                                         FLASH_BWD_DQ)]
    o = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(((o - 1.0) ** 2).sum(), (q, k, v))
    after = [kern.launches for kern in (FLASH_FWD, FLASH_BWD_DKV,
                                        FLASH_BWD_DQ)]
    assert after == [n + 1 for n in before]
    o_ref, _ = flash_attention_reference(q, k, v, causal=True)
    want = torch.autograd.grad(((o_ref - 1.0) ** 2).sum(), (q, k, v))
    for a, b in zip(grads, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_flash_bwd_rejects_what_it_cannot_run(card):
    args = list(_bwd_case(card, "float32", 16, 16, 64, True))
    args[5] = args[5].to(torch.bfloat16)      # do in another dtype
    with pytest.raises(ValueError, match="do must be"):
        _run_bwd(*args, True)


# --------------------------------------------------------------------------- #
# the serving engine on the card: warmup, CUDA graphs, replay vs eager        #
# --------------------------------------------------------------------------- #

ENGINE_LM = dict(vocab_size=97, hidden_size=128, n_head=2, n_layers=2,
                 max_len=128)
ENGINE_KW = dict(slots=4, cache_len=128, block_len=16, max_new_tokens=8,
                 prefill_buckets=(16, 32, 64), attention_impl="flash",
                 decode_attn="paged_kernel")
HEAD = 32                  # the radix pair's shared head: 2 whole blocks


def _engine_lm(card):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(attention_impl="flash", device=card,
                         **ENGINE_LM).build(seed=0)


def _engine(lm, kind, cuda_graphs=None):
    """A plain engine, or a linear or tree speculative one whose drafter
    is a second model holding the target's weights."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
    spec = None
    if kind != "plain":
        draft = TransformerLM(attention_impl="flash", device=lm.device,
                              **ENGINE_LM)
        draft.params = lm.params
        spec = SpecConfig(k=3, draft=draft, tree=kind == "tree")
    return LMServingEngine(lm, spec=spec, cuda_graphs=cuda_graphs,
                           device=lm.device, **ENGINE_KW)


def _engine_prompts():
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 98, size=n) for n in (5, 40, 50, 63)]
    prompts[2][:HEAD] = prompts[1][:HEAD]      # a radix hit, suffix 18
    return prompts


def _launch_counts():
    from bigdl_tpu_torch.ops import KERNELS
    return {k.symbol: k.launches for k in KERNELS}


@pytest.mark.parametrize("kind", ["plain", "linear", "tree"])
def test_engine_on_card_with_graphs_streams_equal_generate(card, kind):
    """warmup() and warmup_prefix() on the card (the paged kernel gets
    device block tables), then greedy and sampled streams through
    replayed graphs, each equal to offline generate; the traffic the
    warmups covered captures nothing new, and the kernels' launches are
    counted through the replays."""
    from bigdl_tpu_torch.models.transformer.generate import generate
    lm = _engine_lm(card)
    eng = _engine(lm, kind)
    prompts = _engine_prompts()
    try:
        assert eng.cuda_graphs
        assert eng.warmup() == len(ENGINE_KW["prefill_buckets"])
        # every (suffix bucket, chain bucket) pair: the second round's
        # prompts also hit the blocks the first round cached
        assert eng.warmup_prefix() == 3 * 4
        warm = eng.stats()["cuda_graphs"]["captures"]
        before = _launch_counts()
        for temperature in (0.0, 0.7):
            streams = [eng.submit(p, max_new_tokens=8,
                                  temperature=temperature, rng=i)
                       for i, p in enumerate(prompts)]
            for i, (p, s) in enumerate(zip(prompts, streams)):
                want = generate(lm, lm.params, p[None], 8,
                                temperature=temperature, rng=i,
                                device=card).numpy()[0]
                np.testing.assert_array_equal(s.result(timeout=120), want)
        st = eng.stats()
        assert st["cuda_graphs"]["captures"] == warm
        assert st["cuda_graphs"]["replays"] > 0
        assert st["kvcache"]["prefix_cache"]["hits"] >= 2
        assert st["prefix_prefill_cache"]["hits"] >= 2
        assert st["prefix_prefill_cache"]["misses"] == 0
        after = _launch_counts()
        assert after["bigdl_flash_fwd"] > before["bigdl_flash_fwd"]
        if kind == "plain":
            assert after["bigdl_paged_decode"] > before["bigdl_paged_decode"]
        else:
            assert st["spec"]["drafted"] > 0
            assert eng.draft.decode_compiles == 1
    finally:
        eng.close()


def _same(tag, got, want, diffs):
    """Bitwise equal, or within 1e-6 with the difference recorded."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, tag
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    diffs[tag] = diff
    assert diff <= 1e-6, (tag, diff)


def _replay_and_eager(graph, eager, fn, diffs, tag):
    """``fn(engine)`` on both engines: equal host results, equal arenas
    (the scratch block aside) and equal kernel launches."""
    counts = []
    outs = []
    for eng in (graph, eager):
        before = _launch_counts()
        outs.append(fn(eng))
        torch.cuda.synchronize()
        after = _launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
    if outs[0] is not None:
        _same(tag, outs[0], outs[1], diffs)
    assert counts[0] == counts[1], (tag, counts)
    for name in ("k", "v", "ks", "vs"):
        a, b = getattr(graph.pool, name), getattr(eager.pool, name)
        if a is not None:
            _same(f"{tag} arena {name}", a[:, 1:].cpu(), b[:, 1:].cpu(),
                  diffs)
    return counts[0]


@pytest.mark.parametrize("kind", ["plain", "linear", "tree"])
def test_replayed_steps_equal_eager_steps(card, kind):
    """Every step an engine captures, replayed, against the same step run
    eagerly (``cuda_graphs=False``) on the same arenas and inputs: host
    logits, written arena rows and kernel launches counted through the
    replay all equal."""
    lm = _engine_lm(card)
    graph, eager = _engine(lm, kind), _engine(lm, kind, cuda_graphs=False)
    diffs = {}
    try:
        assert graph.cuda_graphs and not eager.cuda_graphs
        for eng in (graph, eager):
            eng.warmup()
            eng.warmup_prefix(suffix_lens=[18], prefix_blocks=[2])
        g = torch.Generator().manual_seed(7)
        for name in ("k", "v"):
            fill = torch.randn(getattr(graph.pool, name).shape, generator=g)
            getattr(graph.pool, name).copy_(fill)
            getattr(eager.pool, name).copy_(fill)
        captures = graph.graphs.captures
        rng = np.random.RandomState(1)
        S, M = graph.slots, graph.table_width
        n = graph.pool.shape[1]
        tables = rng.randint(1, n, size=(S, M)).astype(np.int32)
        pos = np.asarray([0, 17, 70, 120], np.int32)
        # prefill buckets, first chunk and a suffix after 2 cached blocks
        for b, ts in ((16, 9), (32, 32), (64, 50)):
            ids = np.zeros((1, b), np.int64)
            ids[0, :ts] = rng.randint(0, 97, size=ts)
            blocks = [int(i) for i in rng.choice(np.arange(1, n), 8, False)]
            x = graph._prefill_x(ids, ts, 0, blocks)
            c = _replay_and_eager(graph, eager, lambda e: e.prefill_cache(
                e._params, {}, x).cpu(), diffs, f"prefill {b}")
            assert c["bigdl_flash_fwd"] == ENGINE_LM["n_layers"]
        ids = np.zeros((1, 32), np.int64)
        ids[0, :18] = rng.randint(0, 97, size=18)
        xs = graph._prefill_x(ids, 18, 32, blocks)
        _replay_and_eager(graph, eager, lambda e: e.prefix_prefill_cache(
            e._params, {}, xs).cpu(), diffs, "suffix prefill")
        if kind == "plain":
            token = rng.randint(0, 97, size=S).astype(np.int64)
            c = _replay_and_eager(graph, eager, lambda e: e._decode(
                token, pos, tables), diffs, "decode")
            assert c["bigdl_paged_decode"] == ENGINE_LM["n_layers"]
        else:
            rungs = (range(len(graph._tree_shapes)) if kind == "tree"
                     else [None])
            for rung in rungs:
                w = (graph._tree_shapes[rung].width if rung is not None
                     else graph.spec.k + 1)
                tokens = rng.randint(0, 97, size=(S, w)).astype(np.int32)
                ncand = np.asarray([w, 1, 0, w], np.int32)
                _replay_and_eager(graph, eager, lambda e: e._verify(
                    tokens, pos, ncand, tables, rung), diffs,
                    f"verify rung {rung}")
            if kind == "tree":
                dmax = graph._commit_dmax
                src = np.tile(np.arange(1, dmax + 1, dtype=np.int32), (S, 1))
                src[0, 0] = dmax + 1
                _replay_and_eager(graph, eager, lambda e: e._commit(
                    src, pos, tables), diffs, "commit")
            # the drafter's steps on its own dense arena
            for name in ("k", "v"):
                fill = torch.randn(getattr(graph.draft, name).shape,
                                   generator=g)
                getattr(graph.draft, name).copy_(fill)
                getattr(eager.draft, name).copy_(fill)
            token = rng.randint(0, 97, size=S).astype(np.int64)
            dpos = pos.astype(np.int64)
            _replay_and_eager(graph, eager, lambda e: e.draft._decode(
                token, dpos), diffs, "drafter decode")
            ids = np.zeros((1, 32), np.int64)
            ids[0, :20] = rng.randint(0, 97, size=20)
            xd = graph.draft._prefill_x(ids, 20, 2)
            _replay_and_eager(graph, eager, lambda e: e.draft.prefill_cache(
                e.draft._params, {}, xd), diffs, "drafter prefill")
            _same("drafter arena", graph.draft.k.cpu(), eager.draft.k.cpu(),
                  diffs)
        assert graph.graphs.captures == captures     # every step replayed
        assert eager.graphs.captures == 0
        print(f"[{kind}] max |replay - eager|: {diffs}")
    finally:
        graph.close()
        eager.close()


# --------------------------------------------------------------------------- #
# quantization on the card: the int8 and fp8 products, the int8 engines      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m", [8, 40, 1024])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768),
                                 (60, 50)])
def test_int8_product_on_card_equals_cpu(card, m, k, n):
    """``torch._int_mm`` on the card (padded to its shapes: rows above 16,
    k and n multiples of 8) gives the CPU's int32 accumulators bitwise,
    and qmatmul_i8 the CPU's output."""
    from bigdl_tpu_torch.quant import (int_mm, qmatmul_i8, quantize_array,
                                       quantize_per_token)
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g)
    qw = quantize_array(torch.randn(k, n, generator=g) * 0.05, (0,),
                        compute="int8")
    xq, _ = quantize_per_token(x)
    xq_card, _ = quantize_per_token(x.to(card))
    assert torch.equal(xq_card.cpu(), xq)
    acc = int_mm(xq.to(card), qw.to(card).q)
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc.cpu(), int_mm(xq, qw.q))
    y = qmatmul_i8(x.to(card), qw.to(card)).cpu()
    torch.testing.assert_close(y, qmatmul_i8(x, qw), rtol=1e-6, atol=0)


@pytest.mark.parametrize("m", [8, 40])
def test_fp8_product_on_card_matches_plain(card, m):
    """``torch._scaled_mm`` on e4m3 operands against the float32 product
    of the same e4m3 values: within 1e-3 of the output's max (Hopper's
    fp8 products accumulate at reduced precision)."""
    from bigdl_tpu_torch.quant import qmatmul_f8, quantize_array
    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, 768, generator=g)
    qw = quantize_array(torch.randn(768, 3072, generator=g), (0,))
    want = qmatmul_f8(x, qw)
    got = qmatmul_f8(x.to(card), qw.to(card)).cpu()
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


def _int8_engine(lm, kind, cuda_graphs=None):
    """An int8 target (dequant), a float target on int8 KV arenas, or a
    float target with the default int8-compute drafter."""
    from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
    kw = dict(ENGINE_KW, cuda_graphs=cuda_graphs, device=lm.device)
    if kind == "int8_target":
        return LMServingEngine(lm.quantize("int8"), **kw)
    if kind == "int8_kv":
        return LMServingEngine(lm, **dict(kw, kv_quant="int8",
                                          decode_attn="gather"))
    return LMServingEngine(lm, spec=SpecConfig(k=3, drafter_compute="int8"),
                           **kw)


@pytest.mark.parametrize("kind", ["int8_target", "int8_kv", "int8_drafter"])
def test_int8_replayed_steps_equal_eager_steps(card, kind):
    """The int8 engines' captured steps, replayed, against the same steps
    run eagerly on the same arenas and inputs: host logits, written
    arena rows (int8 rows and their scales) and kernel launches."""
    lm = _engine_lm(card)
    graph, eager = _int8_engine(lm, kind), _int8_engine(lm, kind, False)
    diffs = {}
    try:
        for eng in (graph, eager):
            eng.warmup()
            eng.warmup_prefix(suffix_lens=[18], prefix_blocks=[2])
        g = torch.Generator().manual_seed(7)
        for name in ("k", "v", "ks", "vs"):
            a = getattr(graph.pool, name)
            if a is None:
                continue
            fill = (torch.randint(-127, 128, a.shape, generator=g,
                                  dtype=torch.int8)
                    if a.dtype == torch.int8
                    else torch.rand(a.shape, generator=g) * 0.05)
            a.copy_(fill)
            getattr(eager.pool, name).copy_(fill)
        captures = graph.graphs.captures
        rng = np.random.RandomState(1)
        S, M = graph.slots, graph.table_width
        n = graph.pool.shape[1]
        tables = rng.randint(1, n, size=(S, M)).astype(np.int32)
        pos = np.asarray([0, 17, 70, 120], np.int32)
        blocks = [int(i) for i in rng.choice(np.arange(1, n), 8, False)]
        for b, ts in ((16, 9), (64, 50)):
            ids = np.zeros((1, b), np.int64)
            ids[0, :ts] = rng.randint(0, 97, size=ts)
            x = graph._prefill_x(ids, ts, 0, blocks)
            c = _replay_and_eager(graph, eager, lambda e: e.prefill_cache(
                e._params, {}, x).cpu(), diffs, f"prefill {b}")
            assert c["bigdl_flash_fwd"] == ENGINE_LM["n_layers"]
        ids = np.zeros((1, 32), np.int64)
        ids[0, :18] = rng.randint(0, 97, size=18)
        xs = graph._prefill_x(ids, 18, 32, blocks)
        _replay_and_eager(graph, eager, lambda e: e.prefix_prefill_cache(
            e._params, {}, xs).cpu(), diffs, "suffix prefill")
        if kind != "int8_drafter":
            token = rng.randint(0, 97, size=S).astype(np.int64)
            c = _replay_and_eager(graph, eager, lambda e: e._decode(
                token, pos, tables), diffs, "decode")
            want = ENGINE_LM["n_layers"] if kind == "int8_target" else 0
            assert c["bigdl_paged_decode"] == want
        else:
            assert graph.draft.compute_mode == "int8"
            tokens = rng.randint(0, 97, size=(S, 4)).astype(np.int32)
            ncand = np.asarray([4, 1, 0, 4], np.int32)
            _replay_and_eager(graph, eager, lambda e: e._verify(
                tokens, pos, ncand, tables), diffs, "verify")
            token = rng.randint(0, 97, size=S).astype(np.int64)
            dpos = pos.astype(np.int64)
            _replay_and_eager(graph, eager, lambda e: e.draft._decode(
                token, dpos), diffs, "int8 drafter decode")
            ids = np.zeros((1, 32), np.int64)
            ids[0, :20] = rng.randint(0, 97, size=20)
            xd = graph.draft._prefill_x(ids, 20, 2)
            _replay_and_eager(graph, eager, lambda e: e.draft.prefill_cache(
                e.draft._params, {}, xd), diffs, "int8 drafter prefill")
            _same("drafter arena", graph.draft.k.cpu(), eager.draft.k.cpu(),
                  diffs)
        assert graph.graphs.captures == captures     # every step replayed
        assert eager.graphs.captures == 0
        assert all(d == 0.0 for d in diffs.values()), diffs
        print(f"[{kind}] max |replay - eager|: {diffs}")
    finally:
        graph.close()
        eager.close()


# --------------------------------------------------------------------------- #
# the host KV tier on the card: hibernate/resume through graphs, export/adopt #
# --------------------------------------------------------------------------- #

def _tier_engine(lm, kv_quant, cuda_graphs=None):
    from bigdl_tpu_torch.serving import HostBlockStore, LMServingEngine
    # no prefix cache: every run of the prompts takes the same graphs
    kw = dict(ENGINE_KW, cuda_graphs=cuda_graphs, device=lm.device,
              enable_prefix_cache=False,
              kvtier=HostBlockStore(host_bytes=1 << 28,
                                    name=f"card-{kv_quant}-{cuda_graphs}"))
    if kv_quant:
        kw.update(kv_quant="int8", decode_attn="gather")
    return LMServingEngine(lm, **kw)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_hibernate_resume_on_card_equals_eager(card, kv_quant):
    """Each stream hibernated after its first token and resumed (one of
    them after losing its payload) on a graphed engine: the arena
    addresses hold (scales too), nothing is captured after warmup, and
    every stream is bitwise the eager engine's uninterrupted stream, so
    every replayed step after a resume produced the eager step's
    token."""
    lm = _engine_lm(card)
    prompts = _engine_prompts()
    new = 60                         # prompt + 60 <= cache_len 128
    graph, eager = _tier_engine(lm, kv_quant), \
        _tier_engine(lm, kv_quant, cuda_graphs=False)
    try:
        for eng in (graph, eager):
            eng.warmup()
        want = [eager.generate(p, max_new_tokens=new, timeout=120)
                for p in prompts]
        ptrs = graph.cache_buffer_pointers()
        assert len(ptrs) == (4 if kv_quant else 2)
        captures = graph.graphs.captures
        got = [graph.generate(p, max_new_tokens=new, timeout=120)
               for p in prompts]
        streams = []
        for p in prompts:
            s = graph.submit(p, max_new_tokens=new)
            next(s.tokens(timeout=120))
            assert graph.hibernate(s, timeout=120)
            streams.append(s)
        graph.kvtier.get(("session", streams[1].request_id), pop=True)
        for s in streams:
            assert graph.resume(s)
        resumed = [s.result(timeout=120) for s in streams]
        torch.cuda.synchronize()
        for a, b, c in zip(got, resumed, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
        assert graph.resume_re_prefills == 1 and graph.resumes == 4
        assert graph.cache_buffer_pointers() == ptrs
        assert graph.graphs.captures == captures
    finally:
        graph.close()
        eager.close()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_export_adopt_on_card_equals_cpu(card, kv_quant):
    """The same arena contents exported from a pool on the card and one
    on the host give bitwise the same wire payload, and adopting it
    writes bitwise the same rows, in place, through pinned staging in
    slices of one block."""
    from bigdl_tpu_torch.serving.kvcache import BlockPool
    geom = dict(n_layers=2, n_heads=3, head_dim=64, block_len=16,
                num_blocks=12, kv_quant=kv_quant)
    pools = [BlockPool(device=d, **geom) for d in (card, "cpu")]
    g = torch.Generator().manual_seed(3)
    for name in ("k", "v", "ks", "vs"):
        a = getattr(pools[1], name)
        if a is None:
            continue
        fill = (torch.randint(-127, 128, a.shape, generator=g,
                              dtype=torch.int8) if a.dtype == torch.int8
                else torch.randn(a.shape, generator=g))
        for p in pools:
            getattr(p, name).copy_(fill)
    ids = [3, 7, 1, 9]
    wires = [p.export_chain(ids, chunk_bytes=p.wire_block_bytes)
             for p in pools]
    for key in wires[1]:
        np.testing.assert_array_equal(wires[0][key], wires[1][key])
    dst = [BlockPool(device=d, **geom) for d in (card, "cpu")]
    ptr = dst[0].k.data_ptr()
    w = wires[1]
    fresh = [p.adopt_chain(w["k"], w["v"], w.get("ks"), w.get("vs"),
                           extra_blocks=2, chunk_bytes=p.block_bytes)
             for p in dst]
    assert fresh[0] == fresh[1]
    torch.cuda.synchronize()
    for name in ("k", "v", "ks", "vs"):
        a = getattr(dst[0], name)
        if a is not None:
            assert torch.equal(a.cpu(), getattr(dst[1], name))
    assert dst[0].k.data_ptr() == ptr


# --------------------------------------------------------------------------- #
# several engines on one card: captures beside replays, the migration hop     #
# --------------------------------------------------------------------------- #

def _warm(eng, prompts):
    """warmup(), then warmup_prefix() for every pair a replica can meet:
    each prompt against each whole-block head it shares with any prompt
    (itself included, for a repeat)."""
    B = eng.block_len
    eng.warmup()
    for p in prompts:
        seen = set()
        for q in prompts:
            n, cap = 0, min((len(p) - 1) // B, len(q) // B)
            while n < cap and np.array_equal(p[n * B:(n + 1) * B],
                                             q[n * B:(n + 1) * B]):
                n += 1
            if n and n not in seen:
                seen.add(n)
                eng.warmup_prefix(suffix_lens=[len(p) - n * B],
                                  prefix_blocks=[n])


def test_two_engines_one_captures_while_the_other_replays(card):
    """Engine A decodes through replayed graphs on its worker's stream
    (a feeder keeps it busy) while engine B, built meanwhile, captures
    its whole warmup on the caller's thread: A replays during B's
    captures, no capture is invalidated, and both engines' streams
    equal offline generate."""
    import threading
    from bigdl_tpu_torch.models.transformer.generate import generate
    from bigdl_tpu_torch.serving import LMServingEngine
    lm = _engine_lm(card)
    prompts = _engine_prompts()
    kw = dict(ENGINE_KW, enable_prefix_cache=False, device=card)
    a = LMServingEngine(lm, name="card-a", **kw)
    b = None
    stop = threading.Event()
    fed = []

    def feed():
        while not stop.is_set():
            batch = [a.submit(p, max_new_tokens=60) for p in prompts]
            fed.append(batch)
            for s in batch:
                s.result(timeout=120)

    feeder = threading.Thread(target=feed)
    try:
        a.warmup()
        feeder.start()
        while not fed or not fed[0][0].generated.size:
            time.sleep(0.001)
        replays = a.graphs.replays
        b = LMServingEngine(lm, name="card-b", **kw)
        assert b.warmup() == len(ENGINE_KW["prefill_buckets"])
        assert a.graphs.replays > replays       # A replayed meanwhile
        stop.set()
        feeder.join(120)
        assert b.graphs.captures == len(ENGINE_KW["prefill_buckets"]) + 1
        got_b = [b.generate(p, max_new_tokens=8, timeout=120)
                 for p in prompts]
        want = [generate(lm, lm.params, p[None], 60, device=card).numpy()[0]
                for p in prompts]
        for batch in fed:
            for s, w in zip(batch, want):
                np.testing.assert_array_equal(s.result(timeout=120), w)
        for p, gb, w in zip(prompts, got_b, want):
            np.testing.assert_array_equal(gb, w[:len(p) + 8])
        assert a.kernel_launches()["bigdl_paged_decode"] > 0
        assert b.kernel_launches()["bigdl_flash_fwd"] > 0
        assert a.graphs.captures == len(ENGINE_KW["prefill_buckets"]) + 1
        assert a._params["embed"].data_ptr() == \
            b._params["embed"].data_ptr()
    finally:
        stop.set()
        if feeder.is_alive():
            feeder.join(120)
        a.close()
        if b is not None:
            b.close()


def _coordinator(lm, prompts, cuda_graphs=None):
    from bigdl_tpu_torch.serving import DisaggCoordinator
    co = DisaggCoordinator(lm, name=f"card-disagg-{cuda_graphs}",
                           cuda_graphs=cuda_graphs, device=lm.device,
                           migrate_base_delay_s=0.001, **ENGINE_KW)
    co.warmup()
    for eng in co.prefill + co.decode:
        _warm(eng, prompts)
    return co


def _disagg_run(co, prompts, temperature):
    streams = [co.submit(p, max_new_tokens=8, temperature=temperature,
                         rng=i) for i, p in enumerate(prompts)]
    return [s.result(timeout=120) for s in streams]


@pytest.mark.parametrize("spec", [None, "serving.migrate:backend_lost:p=0.5"])
def test_disagg_through_graphs_equals_eager(card, monkeypatch, spec):
    """One prefill and one decode replica through replayed graphs, greedy
    and at 0.7 (and with half the payloads lost, so the decode replica
    re-prefills through its prefill graphs): every stream bitwise the
    eager coordinator's; the prefill replica never launches the paged
    kernel, the decode replica launches the flash kernel only in
    re-prefills; nothing is captured after warmup, and both replicas'
    arena addresses hold across every export and adopt."""
    from bigdl_tpu_torch.resilience import faults
    lm = _engine_lm(card)
    prompts = _engine_prompts()
    graph = _coordinator(lm, prompts)
    eager = _coordinator(lm, prompts, cuda_graphs=False)
    try:
        engines = graph.prefill + graph.decode
        ptrs = [e.cache_buffer_pointers() for e in engines]
        captures = [e.graphs.captures for e in engines]
        outs = {}
        for co in (graph, eager):
            if spec:
                monkeypatch.setenv(faults.ENV_SPEC, spec)
                monkeypatch.setenv(faults.ENV_SEED, "3")
                faults.refresh_from_env()
            outs[co.name] = [_disagg_run(co, prompts, t) for t in (0.0, 0.7)]
            monkeypatch.delenv(faults.ENV_SPEC, raising=False)
            faults.refresh_from_env()
        torch.cuda.synchronize()
        for g, e in zip(outs[graph.name], outs[eager.name]):
            for a, b in zip(g, e):
                np.testing.assert_array_equal(a, b)
        st = graph.stats()
        assert st["migrations"] == 2 * len(prompts)
        assert st["re_prefills"] == st["lost_payloads"]
        if spec:
            assert st["lost_payloads"] > 0
        pre, dec = graph.prefill[0], graph.decode[0]
        assert pre.kernel_launches()["bigdl_paged_decode"] == 0
        assert pre.kernel_launches()["bigdl_flash_fwd"] > 0
        assert dec.kernel_launches()["bigdl_paged_decode"] > 0
        plain = dec.stats()["prefill_cache"]
        assert dec.kernel_launches()["bigdl_flash_fwd"] == (
            ENGINE_LM["n_layers"] * (plain["hits"] + plain["misses"]))
        assert [e.cache_buffer_pointers() for e in engines] == ptrs
        assert [e.graphs.captures for e in engines] == captures
        assert pre._decode_exec.compiles == 0
    finally:
        graph.close()
        eager.close()


# --------------------------------------------------------------------------- #
# MoE serving and gradient accumulation on the card                           #
# --------------------------------------------------------------------------- #

def _grads_close(got, want, tol):
    """Each leaf within ``tol`` of the tree's max |g| (the key bias's
    gradient is rounding noise, so no per-leaf ratio for it)."""
    from bigdl_tpu_torch.utils.params import tree_leaves
    scale = max(b.abs().max().item() for b in tree_leaves(want))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert (a - b).abs().max().item() <= tol * scale


def test_moe_engine_on_card_streams_equal_generate(card):
    """An MoE model (4 experts a block, dense routing on every cached
    path) behind the engine with graphs: greedy streams equal offline
    generate, no capture after warmup, both kernels launched; its
    replayed prefill and decode steps equal the eager steps."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.generate import generate
    from bigdl_tpu_torch.serving import LMServingEngine
    lm = TransformerLM(attention_impl="flash", device=card, moe_experts=4,
                       **ENGINE_LM).build(seed=0)
    eng = LMServingEngine(lm, device=card, **ENGINE_KW)
    eager = LMServingEngine(lm, device=card, cuda_graphs=False, **ENGINE_KW)
    prompts = _engine_prompts()
    diffs = {}
    try:
        eng.warmup()
        eng.warmup_prefix()
        warm = eng.stats()["cuda_graphs"]["captures"]
        before = _launch_counts()
        streams = [eng.submit(p, max_new_tokens=8) for p in prompts]
        for p, s in zip(prompts, streams):
            want = generate(lm, lm.params, p[None], 8,
                            device=card).numpy()[0]
            np.testing.assert_array_equal(s.result(timeout=120), want)
        after = _launch_counts()
        assert eng.stats()["cuda_graphs"]["captures"] == warm
        for k in ("bigdl_flash_fwd", "bigdl_paged_decode"):
            assert after[k] > before[k], k
        eager.warmup()
        # the served traffic wrote the graph engine's arenas: start both
        # from the same contents
        g = torch.Generator().manual_seed(7)
        for name in ("k", "v"):
            fill = torch.randn(getattr(eng.pool, name).shape, generator=g)
            getattr(eng.pool, name).copy_(fill)
            getattr(eager.pool, name).copy_(fill)
        rng = np.random.RandomState(2)
        S, M = eng.slots, eng.table_width
        n = eng.pool.shape[1]
        tables = rng.randint(1, n, size=(S, M)).astype(np.int32)
        pos = np.asarray([0, 17, 70, 120], np.int32)
        ids = np.zeros((1, 32), np.int64)
        ids[0, :29] = rng.randint(0, 97, size=29)
        blocks = [int(i) for i in rng.choice(np.arange(1, n), 8, False)]
        x = eng._prefill_x(ids, 29, 0, blocks)
        _replay_and_eager(eng, eager, lambda e: e.prefill_cache(
            e._params, {}, x).cpu(), diffs, "moe prefill 32")
        token = rng.randint(0, 97, size=S).astype(np.int64)
        c = _replay_and_eager(eng, eager, lambda e: e._decode(
            token, pos, tables), diffs, "moe decode")
        assert c["bigdl_paged_decode"] == ENGINE_LM["n_layers"]
        assert eng.stats()["cuda_graphs"]["captures"] == warm
    finally:
        eng.close()
        eager.close()


@pytest.mark.parametrize("moe", [0, 4])
def test_grad_accumulation_on_card_matches_full_batch(card, moe):
    """The accumulated step (2 and 4 micro-batches) against the full
    batch on the card: loss within 1e-5 relative, every gradient leaf
    within 1e-3 of the tree's max |g|, and the three flash kernels
    launched exactly n times a layer.  The MoE case routes at capacity
    per micro-batch, so it is held against the CPU's accumulated step
    instead of the full batch."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import accumulated_loss_and_grads
    from bigdl_tpu_torch.utils.params import tree_map
    kw = dict(ENGINE_LM, moe_experts=moe)
    lm = TransformerLM(attention_impl="flash", device=card, **kw).build(3)
    cpu = TransformerLM(device="cpu", **kw)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 98, size=(8, 65)).astype(np.float32)
    x, y = (torch.from_numpy(a) for a in (ids[:, :-1], ids[:, 1:]))
    full = accumulated_loss_and_grads(lm, crit, lm.params, x.to(card),
                                      y.to(card), 1)
    for n in (2, 4):
        before = _launch_counts()
        loss, grads, _ = accumulated_loss_and_grads(
            lm, crit, lm.params, x.to(card), y.to(card), n)
        torch.cuda.synchronize()
        after = _launch_counts()
        for k in ("bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                  "bigdl_flash_bwd_dq"):
            assert after[k] - before[k] == n * kw["n_layers"], k
        if moe:
            want_loss, want, _ = accumulated_loss_and_grads(
                cpu, crit, tree_map(lambda t: t.cpu(), lm.params), x, y, n)
        else:
            want_loss, want = full[0], full[1]
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        _grads_close(tree_map(lambda t: t.cpu(), grads),
                     tree_map(lambda t: t.cpu(), want), 1e-3)


# --------------------------------------------------------------------------- #
# observability on the card: flight dumps beside a capture, the ledger     #
# against the allocator, diagnose_cuda beside a busy kernel                 #
# --------------------------------------------------------------------------- #

def test_fault_bundles_while_another_engine_captures(card, tmp_path,
                                                     monkeypatch):
    """Engine A decodes with a latency fault at serving.cancel firing
    every round, each fire dumping a fault_injected bundle from A's
    worker (dedup off), while engine B captures its warmup on the
    caller's thread with a fault site inside its decode step, so a
    bundle is also dumped on the capturing thread inside
    ``torch.cuda.graph``: no dump synchronises the card, every capture
    succeeds, and B's replayed streams equal an eager engine's."""
    import json
    import threading
    import bigdl_tpu_torch.serving.lm_engine as lm_engine
    from bigdl_tpu_torch.obs import flight
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import LMServingEngine
    lm = _engine_lm(card)
    prompts = _engine_prompts()
    kw = dict(ENGINE_KW, enable_prefix_cache=False, device=card)
    old = flight.get_flight_recorder()
    rec = flight.configure(enabled=True, out_dir=str(tmp_path),
                           incidents_path=str(tmp_path / "INCIDENTS.json"),
                           dedup_window_s=0.0, max_bundles=0)
    monkeypatch.setenv(faults.ENV_SPEC, "serving.cancel:latency:ms=1;"
                       "capture.decode:latency:ms=1")
    faults.refresh_from_env()
    a = LMServingEngine(lm, name="flight-a", **kw)
    b = c = None
    stop = threading.Event()

    def feed():
        while not stop.is_set():
            for s in [a.submit(p, max_new_tokens=60) for p in prompts]:
                s.result(timeout=120)

    step = lm_engine._decode_step_paged

    def step_with_a_fault_site(*args, **kwargs):
        faults.fault_point("capture.decode",
                           capturing=torch.cuda.is_current_stream_capturing())
        return step(*args, **kwargs)

    feeder = threading.Thread(target=feed)
    try:
        a.warmup()
        feeder.start()
        while rec.bundles_written == 0:
            time.sleep(0.001)
        b = LMServingEngine(lm, name="flight-b", **kw)
        monkeypatch.setattr(lm_engine, "_decode_step_paged",
                            step_with_a_fault_site)
        assert b.warmup() == len(ENGINE_KW["prefill_buckets"])
        monkeypatch.setattr(lm_engine, "_decode_step_paged", step)
        rec.enabled = False
        stop.set()
        feeder.join(120)
        assert b.graphs.captures == len(ENGINE_KW["prefill_buckets"]) + 1
        docs = [json.load(open(p)) for p in tmp_path.glob("FLIGHT_*.json")]
        sites = [d["detail"]["site"] for d in docs]
        # the warm pass and the capture pass each crossed the site once
        assert sites.count("capture.decode") == 2
        assert sites.count("serving.cancel") >= 1
        assert all(d["platform"]["platform"] == "gpu" for d in docs)
        got = [b.generate(p, max_new_tokens=8, timeout=120) for p in prompts]
        c = LMServingEngine(lm, name="flight-c", cuda_graphs=False, **kw)
        want = [c.generate(p, max_new_tokens=8, timeout=120)
                for p in prompts]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    finally:
        stop.set()
        if feeder.is_alive():
            feeder.join(120)
        monkeypatch.setattr(lm_engine, "_decode_step_paged", step)
        monkeypatch.delenv(faults.ENV_SPEC)
        faults.refresh_from_env()
        flight._GLOBAL = old
        a.close()
        for e in (b, c):
            if e is not None:
                e.close()


def test_reconcile_on_card_reads_the_arenas_exactly(card):
    """After warmup the ledger reconciles against the CUDA allocator:
    verdict ``reconciled``, the KV arenas' and the staged params' exact
    bytes, the graph pool attributed once, and a drift the allocator's
    reserved bytes cover."""
    from bigdl_tpu_torch.obs import MemoryLedger, MetricRegistry, set_ledger
    from bigdl_tpu_torch.quant.transform import params_nbytes
    from bigdl_tpu_torch.serving import LMServingEngine
    lm = _engine_lm(card)
    led = MemoryLedger(registry=MetricRegistry())
    old = set_ledger(led)
    eng = LMServingEngine(lm, name="led-card", device=card, **ENGINE_KW)
    try:
        eng.warmup()
        torch.cuda.synchronize()
        rec = led.reconcile(card)
        rows = {r["name"]: r for r in led.entries()}
        L, N, H, B, D = eng.pool.shape
        assert rec["verdict"] == "reconciled"
        assert rows["led-card/kv_arena"]["nbytes"] == 2 * L * N * H * B * D * 4
        assert rows["led-card/staged"]["nbytes"] == params_nbytes(lm.params)
        pool = rows["led-card/graph_pool"]["nbytes"]
        assert pool == eng.graphs.pool_bytes() and pool > 0
        stats = led.backend_stats(card)
        assert stats["bytes_in_use"] == torch.cuda.memory_reserved(card)
        assert rec["drift_bytes"] >= 0
        assert 0 < led.used_fraction(card) < 1
    finally:
        eng.close()
        set_ledger(old)


def test_diagnose_cuda_returns_while_a_kernel_spins(card):
    """A kernel busy on another stream for seconds: diagnose_cuda() (a
    /proc scan that never calls into CUDA) returns inside 1 s."""
    from bigdl_tpu_torch.device import diagnose_cuda
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(4_000_000_000)      # ~2 s of device clock
    t0 = time.perf_counter()
    out = diagnose_cuda()
    took = time.perf_counter() - t0
    busy = not side.query()
    side.synchronize()
    assert isinstance(out, str) and out
    assert busy, "the spinning kernel ended before diagnose_cuda returned"
    assert took < 1.0


# --------------------------------------------------------------------- #
# the padded-batch serving stack                                        #
# --------------------------------------------------------------------- #
def _scoring_lm(card):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(attention_impl="auto", device=card,
                         **ENGINE_LM).build(seed=0)


def _score_inputs():
    rng = np.random.RandomState(6)
    return [rng.randint(1, 98, size=(n, 64)).astype(np.float32)
            for n in (1, 3, 2, 4, 1, 7)]


def test_padded_engine_through_graphs_equals_eager(card):
    """A TransformerLM scored through the padded engine's replayed
    graphs answers exactly as the same engine does eagerly: four
    captures at warmup, none after, 2 flash launches a replay."""
    from bigdl_tpu_torch.serving import ServingEngine
    lm = _scoring_lm(card)
    xs = _score_inputs()
    kw = dict(input_shape=(64,), max_batch_size=4, max_wait_ms=1.0,
              device=card)
    with ServingEngine(lm, cuda_graphs=False, name="eager", **kw) as eng:
        want = [eng.predict(x, timeout=120) for x in xs]
    with ServingEngine(lm, name="graphs", **kw) as eng:
        assert eng.warmup() == 3 and eng.graphs.captures == 3
        before = FLASH_FWD.launches
        replays = eng.graphs.replays
        got = [eng.predict(x, timeout=120) for x in xs]
        assert eng.graphs.captures == 3
        done = eng.graphs.replays - replays
        assert done >= len(xs)
        assert FLASH_FWD.launches - before == ENGINE_LM["n_layers"] * done
        assert eng.stats()["compile_cache"]["hit_rate"] == 1.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_two_padded_engines_capture_and_replay_side_by_side(card):
    """Engine A answers a stream of requests through replayed graphs on
    its batcher's worker while engine B, built meanwhile, captures its
    warmup on the caller's thread: no capture is invalidated, B answers
    one request a batch bitwise as A does, and A's batched answers (other
    buckets, so other product shapes) agree within float32 rounding."""
    import threading
    from bigdl_tpu_torch.serving import ServingEngine
    lm = _scoring_lm(card)
    xs = _score_inputs()
    kw = dict(input_shape=(64,), max_batch_size=4, max_wait_ms=1.0,
              device=card)
    a = ServingEngine(lm, name="pad-a", **kw)
    b = None
    stop = threading.Event()
    fed = []

    def feed():
        while not stop.is_set():
            fed.append([a.submit(x) for x in xs])
            for f in fed[-1]:
                f.result(timeout=120)

    feeder = threading.Thread(target=feed)
    try:
        a.warmup()
        want = [a.predict(x, timeout=120) for x in xs]
        feeder.start()
        while not fed:
            time.sleep(0.001)
        replays = a.graphs.replays
        b = ServingEngine(lm, name="pad-b", **kw)
        assert b.warmup() == 3
        stop.set()
        feeder.join(120)
        assert a.graphs.replays > replays
        for batch in fed:
            for f, w in zip(batch, want):
                np.testing.assert_allclose(f.result(timeout=120), w,
                                           rtol=1e-5, atol=1e-5)
        for x, w in zip(xs, want):
            np.testing.assert_array_equal(b.predict(x, timeout=120), w)
        assert a.graphs.captures == b.graphs.captures == 3
    finally:
        stop.set()
        if feeder.is_alive():
            feeder.join(120)
        a.close()
        if b is not None:
            b.close()


def test_module_backward_runs_the_flash_pair(card):
    """The OO shell's backward on a causal MultiHeadAttention goes
    through the flash forward and both backward kernels, and agrees with
    the same module on plain attention within 1e-3 of each leaf's
    max |g|.  The key bias's gradient is zero in exact arithmetic (it
    shifts every score of a row alike), so each leaf's max |g| has a
    floor of the tree's largest."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import pytree

    def build(impl):
        return nn.Sequential(
            nn.MultiHeadAttention(128, 2, causal=True, attention_impl=impl),
            nn.Linear(128, 128)).build(0, device=card)

    rng = np.random.RandomState(0)
    x = rng.randn(2, 96, 128).astype(np.float32)
    g = rng.randn(2, 96, 128).astype(np.float32)
    counts = {k: k.launches for k in (FLASH_FWD, FLASH_BWD_DKV,
                                      FLASH_BWD_DQ)}
    fast, plain = build("auto"), build("xla")
    gi = fast.backward(x, g)
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in counts.items())
    gi_ref = plain.backward(x, g)
    pairs = [(gi, gi_ref)] + list(zip(pytree.tree_leaves(fast.grad_params),
                                      pytree.tree_leaves(plain.grad_params)))
    floor = max(v.abs().max().item() for _, v in pairs)
    for u, v in pairs:
        scale = max(v.abs().max().item(), 1e-3 * floor)
        assert (u - v).abs().max().item() <= 1e-3 * scale


# --------------------------------------------------------------------- #
# the forward's key tiles and the tuned prefill                          #
# --------------------------------------------------------------------- #
TILE_CASES = [(200, 200, True, False), (70, 150, True, False),
              (150, 70, True, False), (90, 90, True, True),
              (33, 17, False, False)]


@pytest.mark.parametrize("dtype,d", sorted(FLASH_TILES))
def test_every_forward_tile_matches_plain(card, dtype, d):
    """Each (block_q, block_k) pair the forward kernel was built for
    agrees with the plain version: causal, Tq != Tk both ways (rows that
    see no key), segmented, full."""
    tdt = getattr(torch, dtype)
    tol_o, tol_l = TOL[dtype]
    for bq, bk in FLASH_TILES[(dtype, d)]:
        for i, (tq, tk, causal, segmented) in enumerate(TILE_CASES):
            g = torch.Generator().manual_seed(bk * 10 + i)
            q = _rand(g, (2, 3, tq, d), card, tdt)
            k = _rand(g, (2, 3, tk, d), card, tdt)
            v = _rand(g, (2, 3, tk, d), card, tdt)
            seg = None
            if segmented:
                seg = torch.tensor(np.sort(np.random.RandomState(i).randint(
                    0, 4, size=(2, tq)), axis=1), dtype=torch.int32,
                    device=card)
            before = FLASH_FWD.launches
            o, lse = flash_attention_with_lse(
                q, k, v, causal=causal, q_segment_ids=seg,
                kv_segment_ids=seg, block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            assert FLASH_FWD.launches == before + 1
            o_ref, lse_ref = flash_attention_reference(
                q, k, v, causal=causal, q_segment_ids=seg,
                kv_segment_ids=seg)
            assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
            assert (lse - lse_ref).abs().max().item() <= tol_l


def test_pair_outside_the_tiles_raises_before_a_launch(card):
    g = torch.Generator().manual_seed(0)
    before = FLASH_FWD.launches
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        q, k, v = (_rand(g, (1, 2, 64, 64), card, tdt) for _ in range(3))
        bad = [(64, 48), (32, 32), (128, 64), (64, 256)]
        # float32 at 128 keys would not fit; bf16 at D 64 takes 64 and 128
        bad.append((64, 128) if dtype == "float32" else (64, 32))
        for bq, bk in bad:
            with pytest.raises(ValueError, match="takes"):
                flash_attention(q, k, v, causal=True, block_q=bq,
                                block_k=bk)
            with pytest.raises(ValueError, match="takes"):
                flash_attention_with_lse(q, k, v, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before


def test_tuned_prefill_bucket_replays_with_the_tuned_tile(card, tmp_path,
                                                           monkeypatch):
    """Under a cache for this card, an "auto" engine resolves each prefill
    bucket on its own: 16 and 32 the kernel at the tuned 64x64 tile (for
    16 a tuned loss to the plain core, which never takes the card from
    the kernel), 64 the default tile (no verdict); decode keeps the paged
    kernel under a verdict for the gather.  The captures record those
    tiles, the replays launch the kernel for every bucket, and every
    stream equals offline generate on plain attention."""
    import json
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.generate import generate
    from bigdl_tpu_torch.ops import autotune
    from bigdl_tpu_torch.serving import LMServingEngine
    path = tmp_path / "tune.json"
    key = lambda t: autotune.attention_key(t, 64, "float32", True)  # noqa
    path.write_text(json.dumps({
        "producer": autotune.PRODUCER, "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(card),
        "winners": {key(16): {"use_flash": False, "block_q": 64,
                              "block_k": 64},
                    key(32): {"use_flash": True, "block_q": 64,
                              "block_k": 64},
                    autotune.paged_key(64, ENGINE_KW["block_len"],
                                       "float32"): {"use_kernel": False}}}))
    monkeypatch.setenv("BIGDL_TPU_TORCH_TUNE_CACHE", str(path))
    autotune.clear_cache()
    recorded = []
    real = FLASH_FWD.launch

    def spy(*args):
        recorded.append((args[9], args[14]))   # (Tq, block_k)
        return real(*args)

    monkeypatch.setattr(FLASH_FWD, "launch", spy)
    lm = TransformerLM(attention_impl="auto", device=card,
                       **ENGINE_LM).build(seed=0)
    plain = TransformerLM(attention_impl="xla", device=card, **ENGINE_LM)
    plain.params = lm.params
    kw = dict(ENGINE_KW, attention_impl="auto", decode_attn="auto",
              enable_prefix_cache=False)
    try:
        with LMServingEngine(lm, device=card, **kw) as eng:
            assert eng.stats()["prefill_attention"] == {
                "16": "flash 64x64", "32": "flash 64x64",
                "64": "flash 64x32"}
            assert eng.decode_attn == "paged_kernel"
            assert eng.warmup() == 3
            warm = eng.stats()["cuda_graphs"]["captures"]
            assert set(recorded) == {(16, 64), (32, 64), (64, 32)}
            prompts = [np.random.RandomState(n).randint(1, 98, size=n)
                       for n in (10, 20, 50)]
            before = FLASH_FWD.launches
            for p in prompts:
                got = eng.submit(p, max_new_tokens=8).result(timeout=120)
                want = generate(plain, plain.params, p[None], 8,
                                device=card).numpy()[0]
                np.testing.assert_array_equal(np.asarray(got), want)
            # every bucket's prefill runs the kernel, once a layer
            assert FLASH_FWD.launches - before == 3 * ENGINE_LM["n_layers"]
            assert eng.stats()["cuda_graphs"]["captures"] == warm
    finally:
        autotune.clear_cache()
