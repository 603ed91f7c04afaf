"""bigdl_tpu_torch sampled and speculative serving on the CPU.

Cross-framework (the JAX package as the reference, the same weights and
numpy inputs): the acceptance functions of ``serving/spec/verify.py``,
the tree shapes and ``SpecConfig`` validation, sampled offline
``generate`` token for token, and the verify and commit steps (logits
within 1e-5 relative, written arena rows within 1e-6, every other row
unchanged).  Port only: every engine stream, greedy or sampled, linear
or tree, model or n-gram drafter, equals the port's offline
``generate`` at batch 1 (sizes as the reference's spec tests).
Categorical draws are held exactly; a mismatch is a tie only where the
top two of ``logits / T + gumbel`` lie within TIE_GAP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import generate as jgen
from bigdl_tpu.serving.spec import verify as jver

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.transformer import generate as tgen
from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
from bigdl_tpu_torch.serving.spec import (NgramDrafter, TreeShape,
                                          default_tree_shapes)
from bigdl_tpu_torch.serving.spec import verify as tver
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import params_from_numpy

TIE_GAP = 1e-4
LM_KW = dict(vocab_size=31, hidden_size=16, n_head=2, n_layers=1, max_len=64,
             pos_encoding="rope")
ENGINE_KW = dict(slots=4, cache_len=48, block_len=4, max_new_tokens=12,
                 prefill_buckets=(8, 16), device="cpu")


def _port_of(jm, **kw):
    tm = TransformerLM(device="cpu", **kw)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return tm


def _same_draw(got, want, row, temperature, key, clamp=True):
    """A categorical draw equals jax's, or the two are a tie."""
    if got == want:
        return True
    denom = max(temperature, 1e-6) if clamp else temperature
    z = np.sort(keychain.gumbel(key, (1, row.shape[-1]))[0]
                + np.asarray(row, np.float32) / np.float32(denom))
    return z[-1] - z[-2] < TIE_GAP


# --------------------------------------------------------------------------- #
# verify.py against the reference                                             #
# --------------------------------------------------------------------------- #

def _rows_and_keys(n, vocab, seed):
    rng = np.random.RandomState(seed)
    rows = (rng.randn(n, vocab) * 2).astype(np.float32)
    keys = keychain.split(keychain.prng_key(seed), n)
    return rows, keys


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3, 1e-7])
def test_pick_and_draft_pick_match_reference(temperature):
    rows, keys = _rows_and_keys(40, 53, 1)
    for row, key in zip(rows, keys):
        for clamp in (True, False):
            if temperature < 1e-6 and not clamp:
                continue       # unclamped 1e-7 only on a first token
            got = tver.pick_token(row, temperature, key, clamp)
            want = jver.pick_token(row, temperature, key, clamp)
            assert _same_draw(got, want, row, temperature, key, clamp)
        for mode in tver.SAMPLING_MODES:
            got = tver.draft_pick(row, temperature, key, mode)
            want = jver.draft_pick(row, temperature, key, mode)
            fk = (keychain.fold_in(key, tver.FOLD_DRAFT)
                  if mode == "rejection" else key)
            assert _same_draw(got, want, row, temperature, fk)
        assert tver.pick_token(row, temperature, None, True) == \
            int(np.argmax(row))


@pytest.mark.parametrize("mode", ["replay", "rejection"])
def test_accept_row_and_walk_match_reference(mode):
    target, keys = _rows_and_keys(60, 41, 2)
    draft, _ = _rows_and_keys(60, 41, 3)
    draft = target + 0.5 * draft                   # a drafter near p
    for i in range(0, 60, 4):
        for temperature in (0.0, 0.8):
            rows, qrows, ks = target[i:i + 4], draft[i:i + 4], keys[i:i + 4]
            drafts = [tver.draft_pick(q, temperature, k, mode)
                      for q, k in zip(qrows[:3], ks[:3])]
            for j in range(3):
                assert (tver.accept_row(rows[j], drafts[j], temperature,
                                        ks[j], mode, qrows[j])
                        == jver.accept_row(rows[j], drafts[j], temperature,
                                           ks[j], mode, qrows[j]))
            assert (tver.accept_walk(rows, drafts, temperature, ks, mode,
                                     qrows)
                    == jver.accept_walk(rows, drafts, temperature, ks, mode,
                                        qrows))


def test_accept_walk_unit():
    """Replay accepts exactly the matching prefix and emits the target
    token at the first mismatch (mirrors the reference's unit test)."""
    v = 8
    rows = np.full((4, v), -10.0, np.float32)
    rows[0, 2] = rows[1, 5] = rows[2, 1] = rows[3, 7] = 10.0
    assert tver.accept_walk(rows, [2, 5, 4], 0.0, None, "replay") == \
        ([2, 5, 1], 2)
    assert tver.accept_walk(rows, [2, 5, 1], 0.0, None, "replay") == \
        ([2, 5, 1, 7], 3)
    assert tver.accept_walk(rows, [0, 5, 1], 0.0, None, "replay") == ([2], 0)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_tree_accept_walk_matches_reference(temperature):
    shape = [-1, 0, 1, 2, 0, 1]
    ts, js = TreeShape(shape), jver.TreeShape(shape)
    target, keys = _rows_and_keys(6 * 30, 13, 4)
    rng = np.random.RandomState(5)
    for i in range(30):
        rows = target[6 * i:6 * i + 6]
        # half the nodes carry the target's own greedy pick, so paths
        # go deep and through alternates
        tokens = rng.randint(0, 13, size=6)
        tokens[rng.rand(6) < 0.5] = int(np.argmax(rows[0]))
        for n_cand in (None, 4):
            assert (tver.tree_accept_walk(ts, tokens, rows, temperature,
                                          keys[6 * i:], n_cand)
                    == jver.tree_accept_walk(js, tokens, rows, temperature,
                                             keys[6 * i:], n_cand))


def test_tree_accept_walk_unit():
    shape = TreeShape([-1, 0, 1, 0])   # spine 0-1-2, alternate 3 off root
    v = 8
    rows = np.full((4, v), -10.0, np.float32)
    rows[0, 6] = rows[3, 2] = 10.0
    rows[1, 1] = rows[2, 1] = 10.0
    assert tver.tree_accept_walk(shape, [9, 4, 5, 6], rows, 0.0, None) == \
        ([6, 2], [0, 3])
    rows2 = np.full((4, v), -10.0, np.float32)
    rows2[0, 4] = rows2[1, 5] = rows2[2, 7] = 10.0
    assert tver.tree_accept_walk(shape, [9, 4, 5, 6], rows2, 0.0, None) == \
        ([4, 5, 7], [0, 1, 2])
    assert tver.tree_accept_walk(shape, [9, 4, 5, 6], rows, 0.0, None,
                                 n_cand=3) == ([6], [0])


def _shape_fields(s):
    return (s.parents, s.width, s.depths, s.max_depth, s.anc.tolist(),
            s.children, s.spine, s.is_chain, s.alt_counts, s.alt_rank,
            s.describe())


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
def test_tree_shapes_match_reference(k):
    for n_alt in (None, 0, 1, k):
        got = [_shape_fields(s) for s in default_tree_shapes(k, n_alt)]
        want = [_shape_fields(s) for s in jver.default_tree_shapes(k, n_alt)]
        assert got == want
    shapes = default_tree_shapes(3)
    assert [s.width for s in shapes] == [2, 3, 4, 7]
    assert np.array_equal(shapes[2].anc, np.tril(np.ones((4, 4), bool)))
    for bad, match in (([-1, 1], "earlier"), ([-1, 0, 0, 2], "leaves"),
                       ([-1, 0, 1, 1, 2], "spine")):
        with pytest.raises(ValueError, match=match):
            TreeShape(bad)
        with pytest.raises(ValueError, match=match):
            jver.TreeShape(bad)


SPEC_CASES = [
    dict(k=0), dict(sampling="nucleus"), dict(ema_alpha=0.0),
    dict(min_rounds=0), dict(probe_interval=0), dict(k=4),
    dict(k=2, tree=True, sampling="rejection"),
    dict(k=2, drafter_compute="ngram", sampling="rejection"),
    dict(k=2, tree_shapes=[[-1, 0]]), dict(k=3, tree=True),
    dict(k=3, tree=True, tree_alts=4), dict(k=2, tree=True, init_rung=9),
    dict(k=2, tree=True, promote_above=0.2, stepdown_below=0.5),
    dict(k=1, tree=True, tree_shapes=[[-1, 0], [-1, 0, 1]]),
    dict(k=3, tree=True, tree_shapes=[[-1, 0, 1], [-1, 0]]),
    dict(k=2, drafter_compute="fp16"), dict(k=2, drafter_compute="ngram"),
    dict(k=2, drafter_compute="ngram", draft=object()),
    dict(k=2, ngram_max=0), dict(k=5, tree=True, tree_alts=2,
                                 sampling="replay", ngram_max=2),
]


@pytest.mark.parametrize("kw", SPEC_CASES,
                         ids=[str(i) for i in range(len(SPEC_CASES))])
def test_spec_config_validates_as_reference(kw):
    try:
        want = jver.SpecConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tver.SpecConfig(**kw)
        assert str(got.value) == str(e)
        return
    got = tver.SpecConfig(**kw)
    assert got.describe() == want.describe()
    assert got.init_rung == want.init_rung


# --------------------------------------------------------------------------- #
# sampled offline generate and the verify steps against the reference         #
# --------------------------------------------------------------------------- #

def _pair(pos="learned", seed=3):
    kw = dict(vocab_size=29, hidden_size=32, n_head=4, n_layers=2,
              max_len=48, pos_encoding=pos)
    jm = JaxLM(attention_impl="xla", **kw).build(seed=seed)
    return jm, _port_of(jm, attention_impl="xla", **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batch", [1, 2])
def test_sampled_generate_token_exact_vs_jax(batch, seed):
    jm, tm = _pair()
    ids = np.random.RandomState(seed).randint(1, 30, size=(batch, 7)).astype(
        np.int32)
    want = np.asarray(jgen.generate(jm, jm.params, jnp.asarray(ids), 9,
                                    temperature=0.7,
                                    rng=jax.random.PRNGKey(seed)))
    got = tgen.generate(tm, tm.params, ids, 9, temperature=0.7, rng=seed,
                        device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # a (2,) key goes in as the seed it came from
    np.testing.assert_array_equal(
        tgen.generate(tm, tm.params, ids, 9, temperature=0.7,
                      rng=np.asarray(jax.random.PRNGKey(seed)),
                      device="cpu").numpy(), want)


def _arenas(seed, L=2, N=13, H=4, B=4, D=8):
    rng = np.random.RandomState(seed)
    ka = rng.randn(L, N, H, B, D).astype(np.float32)
    va = rng.randn(L, N, H, B, D).astype(np.float32)
    ids = np.arange(1, N)
    rng.shuffle(ids)
    # slot 0 mid-chain, slot 1 near the end of its chain (padded rows
    # clamp and go to scratch), slot 2 idle (all-scratch table)
    tables = np.zeros((3, 4), np.int32)
    tables[0] = ids[:4]
    tables[1] = ids[4:8]
    return ka, va, tables


def _check_arena(name, got, want, before, written):
    """Rows written by the step within 1e-6 of the reference's; every
    other row of every block but the scratch block unchanged."""
    got, want, before = got[:, 1:], np.asarray(want)[:, 1:], before[:, 1:]
    mask = np.zeros(got.shape[:2] + got.shape[3:4], bool)  # (L, N-1, B)
    for blk, off in written:
        mask[:, blk - 1, off] = True
    g = np.moveaxis(got, 2, 3)[mask]
    np.testing.assert_allclose(g, np.moveaxis(want, 2, 3)[mask], rtol=0,
                               atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(np.moveaxis(got, 2, 3)[~mask],
                                  np.moveaxis(before, 2, 3)[~mask],
                                  err_msg=name)


def _written(tables, pos, n_cand, store):
    out = set()
    for s in range(len(pos)):
        for j in range(n_cand[s]):
            p = pos[s] + store[j]
            out.add((int(tables[s, p // 4]), int(p % 4)))
    return out


def _logits_close(got, want, live):
    want = np.asarray(want)
    for s in live:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[s]).max())


@pytest.mark.parametrize("pos_enc", ["learned", "rope"])
def test_verify_step_matches_jax(pos_enc):
    jm, tm = _pair(pos_enc)
    ka, va, tables = _arenas(0)
    w = 4
    tokens = np.random.RandomState(1).randint(0, 29, size=(3, w)).astype(
        np.int32)
    pos = np.asarray([5, 13, 0], np.int32)
    n_cand = np.asarray([4, 2, 0], np.int32)
    rl, rka, rva = jgen._verify_step_paged(
        jm, jm.params, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(n_cand), jnp.asarray(tables), jnp.asarray(ka),
        jnp.asarray(va))
    tka, tva = torch.from_numpy(ka.copy()), torch.from_numpy(va.copy())
    logits, k_out, v_out = tgen._verify_step_paged(
        tm, tm.params, *(torch.from_numpy(a) for a in
                         (tokens, pos, n_cand, tables)), tka, tva)
    assert k_out is tka and v_out is tva and logits.shape == (3, w, 29)
    _logits_close(logits.numpy(), rl, live=(0, 1))
    written = _written(tables, pos, n_cand, range(w))
    _check_arena("k", tka.numpy(), rka, ka, written)
    _check_arena("v", tva.numpy(), rva, va, written)


@pytest.mark.parametrize("pos_enc", ["learned", "rope"])
def test_tree_verify_and_commit_match_jax(pos_enc):
    """The widest default rung at k = 3 (spine 3, alternates off nodes
    0, 1, 2), then the accepted-path commit: slot 0 took the alternate
    at depth 2, slot 1 the one at depth 1, slot 2 is idle."""
    jm, tm = _pair(pos_enc)
    shp = default_tree_shapes(3)[-1]
    assert shp.width == 7 and not shp.is_chain
    ka, va, tables = _arenas(2)
    tokens = np.random.RandomState(3).randint(0, 29, size=(3, 7)).astype(
        np.int32)
    pos = np.asarray([5, 9, 0], np.int32)
    n_cand = np.asarray([7, 7, 0], np.int32)
    depths = np.asarray(shp.depths, np.int32)
    rl, rka, rva = jgen._tree_verify_step_paged(
        jm, jm.params, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(n_cand), jnp.asarray(tables), jnp.asarray(ka),
        jnp.asarray(va), depths=depths, anc=shp.anc)
    tka, tva = torch.from_numpy(ka.copy()), torch.from_numpy(va.copy())
    targs = [torch.from_numpy(a) for a in (tokens, pos, n_cand, tables)]
    logits, _, _ = tgen._tree_verify_step_paged(
        tm, tm.params, *targs, tka, tva, depths=shp.depths, anc=shp.anc)
    _logits_close(logits.numpy(), rl, live=(0, 1))
    written = _written(tables, pos, n_cand, range(7))
    _check_arena("k", tka.numpy(), rka, ka, written)
    _check_arena("v", tva.numpy(), rva, va, written)
    # the commit, on the reference's arenas after its verify step
    src = np.tile(np.arange(1, 4, dtype=np.int32), (3, 1))
    src[0, 1] = 5                       # path 0 -> 1 -> 5
    src[1, 0] = 4                       # path 0 -> 4
    ck, cv = jgen._tree_commit_paged(jnp.asarray(src), jnp.asarray(pos),
                                     jnp.asarray(tables), rka, rva)
    tka = torch.from_numpy(np.asarray(rka).copy())
    tva = torch.from_numpy(np.asarray(rva).copy())
    tgen._tree_commit_paged(torch.from_numpy(src), torch.from_numpy(pos),
                            torch.from_numpy(tables), tka, tva)
    moved = {(int(tables[0, 7 // 4]), 7 % 4), (int(tables[1, 10 // 4]),
                                                10 % 4)}
    _check_arena("k commit", tka.numpy(), ck, np.asarray(rka), moved)
    _check_arena("v commit", tva.numpy(), cv, np.asarray(rva), moved)
    np.testing.assert_array_equal(tka.numpy()[:, tables[0, 1], :, 3],
                                  np.asarray(rka)[:, tables[0, 2], :, 2])


# --------------------------------------------------------------------------- #
# the port's engines against the port's offline generate                      #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def lm():
    return _port_of(JaxLM(**LM_KW).build(seed=0), **LM_KW)


def _drafter(lm, scale=0.05, seed=1, vocab=None):
    """A float drafter: the target's weights plus seeded noise (accepts
    most drafts, not all); ``scale=None`` gives all-zero weights, whose
    logits rows are constant, so it always drafts token 0."""
    kw = dict(LM_KW, vocab_size=vocab or LM_KW["vocab_size"])
    d = TransformerLM(device="cpu", **kw)
    if vocab is not None:
        return d.build(seed)
    g = torch.Generator().manual_seed(seed)

    def noisy(t):
        if isinstance(t, dict):
            return {k: noisy(v) for k, v in t.items()}
        if scale is None:
            return torch.zeros_like(t)
        return t + scale * torch.randn(t.shape, generator=g)
    d.params = noisy(lm.params)
    return d


def _ref(lm, prompt, max_new, temperature=0.0, seed=None):
    return tgen.generate(lm, lm.params, np.asarray(prompt)[None], max_new,
                         temperature=temperature, rng=seed,
                         device="cpu").numpy()[0]


@pytest.fixture(scope="module")
def spec_engine(lm):
    eng = LMServingEngine(lm, spec=SpecConfig(k=3, draft=_drafter(lm)),
                          **ENGINE_KW)
    eng.warmup()
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def tree_engine(lm):
    eng = LMServingEngine(lm, spec=SpecConfig(k=3, draft=_drafter(lm),
                                              tree=True, promote_above=0.5),
                          **ENGINE_KW)
    eng.warmup()
    yield eng
    eng.close()


SAMPLED = [(6, 0.7, 3), (11, 1.3, 4), (20, 0.7, 5)]


def test_sampled_serving_with_prefix_sharing_exact(lm):
    """temperature > 0 without speculation: the engine replays offline
    generate()'s key chain, also on the prefix-hit path."""
    with LMServingEngine(lm, slots=2, cache_len=24, block_len=4,
                         temperature=0.7, prefill_buckets=(4, 8, 16),
                         device="cpu") as eng:
        p = np.arange(1, 13)      # 12 tokens: 3 full blocks, 2 matchable
        for seed in (0, 3):
            out = eng.generate(p, max_new_tokens=6, rng=seed, timeout=60)
            np.testing.assert_array_equal(out, _ref(lm, p, 6, 0.7, seed))
        assert eng.radix.hits >= 1
        # a (2,) key, the engine default temperature overridden by 0
        np.testing.assert_array_equal(
            eng.generate(p, max_new_tokens=6, rng=keychain.prng_key(7),
                         timeout=60), _ref(lm, p, 6, 0.7, 7))
        np.testing.assert_array_equal(
            eng.generate(p, max_new_tokens=6, temperature=0.0, timeout=60),
            _ref(lm, p, 6))
        assert eng.stats()["spec"] is None


@pytest.mark.parametrize("which", ["spec_engine", "tree_engine"])
def test_spec_greedy_and_sampled_exact(which, request, lm):
    eng = request.getfixturevalue(which)
    rng = np.random.default_rng(0)
    cases = [(rng.integers(1, 32, size=n).astype(np.int32), 0.0, None)
             for n in (5, 9, 14)]
    cases += [(rng.integers(1, 32, size=n).astype(np.int32), t, s)
              for n, t, s in SAMPLED]
    streams = [eng.submit(p, max_new_tokens=12, temperature=t, rng=s)
               for p, t, s in cases]
    for (p, t, s), stm in zip(cases, streams):
        np.testing.assert_array_equal(stm.result(timeout=60),
                                      _ref(lm, p, 12, t, s))
    spec = eng.stats()["spec"]
    assert spec["drafted"] > 0 and spec["acceptance_rate"] > 0.0
    assert spec["draft"]["compute_mode"] == "f32"
    assert eng.metrics.snapshot()["spec"]["drafted"] == spec["drafted"]
    if which == "tree_engine":
        assert spec["tree_rounds"] > 0 and len(spec["slot_rungs"]) == 4


@pytest.mark.parametrize("which", ["spec_engine", "tree_engine"])
def test_spec_eos_mid_window_truncates_exactly(which, request, lm):
    eng = request.getfixturevalue(which)
    p = np.asarray([3, 9, 14, 2, 6], np.int32)
    for t, s in ((0.0, None), (0.9, 11)):
        ref = _ref(lm, p, 12, t, s)
        gen = ref[len(p):]
        eos = int(gen[min(3, len(gen) - 1)])
        first_hit = int(np.argmax(gen == eos))
        out = eng.submit(p, max_new_tokens=12, eos_id=eos, temperature=t,
                         rng=s).result(timeout=60)
        np.testing.assert_array_equal(out, ref[:len(p) + first_hit + 1])


@pytest.mark.parametrize("which", ["spec_engine", "tree_engine"])
def test_spec_budget_boundaries(which, request, lm):
    """k_eff (or the tree's width) clamps to the remaining budget:
    max_new 1 finishes at prefill, 2 is a plain round; all exact."""
    eng = request.getfixturevalue(which)
    p = np.asarray([7, 1, 22], np.int32)
    for m in (1, 2, 3, 5):
        for t, s in ((0.0, None), (0.8, m)):
            np.testing.assert_array_equal(
                eng.submit(p, max_new_tokens=m, temperature=t,
                           rng=s).result(timeout=60),
                _ref(lm, p, m, t, s))


def test_spec_long_prompt_serves_plain(spec_engine, lm):
    """A prompt longer than the largest bucket (16) is admitted in
    chunks and skips speculation, still exact."""
    before = spec_engine.stats()["spec"]["drafted"]
    p = np.arange(1, 21).astype(np.int32)
    np.testing.assert_array_equal(
        spec_engine.submit(p, max_new_tokens=6).result(timeout=60),
        _ref(lm, p, 6))
    assert spec_engine.stats()["spec"]["drafted"] == before


@pytest.mark.parametrize("tree", [False, True])
def test_acceptance_collapse_demotes_and_reprobes(lm, tree):
    """The zero drafter never matches (its spine drafts token 0, its
    alternates tokens 1 and 2, none in the offline stream): the slot
    demotes, re-probes after probe_interval rounds, collapses again, and
    the stream stays the offline trajectory."""
    p = np.asarray([8, 10, 27, 14, 9, 26], np.int32)
    ref = _ref(lm, p, 24)
    assert not {1, 2, 3} & set(ref[len(p):].tolist())   # the premise
    extra = dict(stepdown_below=0.5, promote_above=1.0) if tree else {}
    with LMServingEngine(
            lm, slots=1, cache_len=48, block_len=4, max_new_tokens=24,
            prefill_buckets=(8,), device="cpu",
            spec=SpecConfig(k=3, draft=_drafter(lm, scale=None), tree=tree,
                            ema_alpha=0.5, demote_below=0.5, min_rounds=2,
                            probe_interval=3, **extra)) as eng:
        np.testing.assert_array_equal(
            eng.submit(p, max_new_tokens=24).result(timeout=60), ref)
        spec = eng.stats()["spec"]
        assert spec["acceptance_rate"] == 0.0
        assert spec["demotions"] >= 2 and spec["reprobes"] >= 1
        assert spec["rolled_back"] == spec["drafted"] > 0


def test_rejection_mode_deterministic_and_greedy_exact(lm):
    with LMServingEngine(lm, slots=2, cache_len=48, block_len=4,
                         max_new_tokens=12, prefill_buckets=(8,),
                         device="cpu",
                         spec=SpecConfig(k=2, draft=_drafter(lm),
                                         sampling="rejection")) as eng:
        p = np.asarray([4, 19, 2, 30], np.int32)
        a = eng.submit(p, max_new_tokens=12, temperature=0.8,
                       rng=7).result(timeout=60)
        b = eng.submit(p, max_new_tokens=12, temperature=0.8,
                       rng=7).result(timeout=60)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            eng.submit(p, max_new_tokens=12).result(timeout=60),
            _ref(lm, p, 12))
        assert eng.stats()["spec"]["drafted"] > 0


def test_spec_refusals(lm):
    with pytest.raises(ValueError, match="vocab"):
        LMServingEngine(lm, slots=1, cache_len=32, device="cpu",
                        spec=SpecConfig(k=2, draft=_drafter(lm, vocab=17)))
    # no draft: the default drafter, the target's int8 clone (ported with
    # quantization; refused before it)
    with LMServingEngine(lm, slots=1, cache_len=32, device="cpu",
                         spec=SpecConfig(k=2)) as eng:
        assert eng.draft.dtype_tag == "int8" and eng.draft.model is not lm
    if not torch.cuda.is_available():
        # a spec engine asked for the card (the default) without one
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LMServingEngine(lm, slots=1, cache_len=32,
                            spec=SpecConfig(k=2, draft=lm))


def test_ngram_drafter_determinism_and_vocab_guard():
    d = NgramDrafter(31, slots=2, ngram_max=3)
    d.admit(0, np.asarray([5, 6, 7, 5, 6, 7, 5, 6], np.int32))
    jobs = {0: (4, 0.0, None, (1, 1))}
    a = d.draft_round(jobs)
    assert a == d.draft_round(jobs)      # a pure function of the history
    spine, rows, alts = a[0]
    assert rows is None and len(spine) == 4 and len(alts) == 4
    assert spine[:2] == [7, 5]
    assert d.steps == 0 and d.arena_bytes == 0
    with pytest.raises(ValueError, match="vocab"):
        d.admit(1, np.asarray([3, 31], np.int32))
    d.admit(1, np.asarray([3, 4], np.int32))
    with pytest.raises(ValueError, match="vocab"):
        d.push(1, -1)
    with pytest.raises(ValueError, match="vocab"):
        d.commit(1, 0, [99])
    d.release_all()
    d.admit(0, np.asarray([1, 2, 3], np.int32))
    assert d.draft_round({0: (3, 0.0, None)})[0][0] == [3, 3, 3]


def test_tree_ngram_engine_exact_and_free(lm):
    """Greedy streams settle into the tiny model's attractor, which
    suffix matching predicts: exact, zero drafter steps, accepted > 0;
    a sampled request rides the same engine exactly."""
    with LMServingEngine(lm, slots=2, cache_len=48, block_len=4,
                         max_new_tokens=24, prefill_buckets=(8, 16),
                         device="cpu",
                         spec=SpecConfig(k=4, tree=True,
                                         drafter_compute="ngram")) as eng:
        eng.warmup()
        rng = np.random.default_rng(3)
        cases = [(rng.integers(1, 32, size=10).astype(np.int32), 0.0, None)
                 for _ in range(3)] + [(np.arange(1, 11), 0.7, 2)]
        streams = [eng.submit(p, max_new_tokens=24, temperature=t, rng=s)
                   for p, t, s in cases]
        for (p, t, s), stm in zip(cases, streams):
            np.testing.assert_array_equal(stm.result(timeout=60),
                                          _ref(lm, p, 24, t, s))
        spec = eng.stats()["spec"]
        assert spec["draft_steps"] == 0
        assert spec["draft"]["compute_mode"] == "ngram"
        assert spec["accepted"] > 0 and spec["draft"]["hit_rate"] > 0.0
