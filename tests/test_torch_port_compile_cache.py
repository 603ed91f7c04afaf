"""bigdl_tpu_torch's graph cache (``serving/compile_cache.py``) and the
engine's bounded-entries contract on the CPU, against the JAX package.

On the CPU an entry is the eager function (replay is card-only and is
tested in ``tests/test_torch_port_kernels.py``), so these hold the
bookkeeping: the cache's hit/miss/evict counts, the engine's prefill and
prefix-prefill caches, ``warmup``/``warmup_prefix``, the verify, commit
and drafter-decode counts, all equal to the JAX engine's on the same
weights (built by the JAX package from a seed, carried over through
numpy) and the same traffic, and every stream token-exact against the
JAX engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import CompileCache as JaxCache
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.serving.spec import SpecConfig as JaxSpec

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
from bigdl_tpu_torch.serving.compile_cache import (CompileCache, GraphPool,
                                                   StepGraph,
                                                   input_signature,
                                                   params_dtype_tag)
from bigdl_tpu_torch.utils.params import params_from_numpy

KEYS = ("entries", "hits", "misses", "evictions", "hit_rate")


def _pair(seed=0, vocab=31, hidden=32, heads=2, layers=2, max_len=64):
    kw = dict(vocab_size=vocab, hidden_size=hidden, n_head=heads,
              n_layers=layers, max_len=max_len, pos_encoding="rope")
    jm = JaxLM(attention_impl="xla", **kw).build(seed=seed)
    tm = TransformerLM(device="cpu", **kw)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _counts(stats):
    return {k: stats[k] for k in KEYS}


def _engines(jm, tm, **kw):
    jspec = kw.pop("jspec", None)
    tspec = kw.pop("tspec", None)
    return (JaxEngine(jm, spec=jspec, **kw),
            LMServingEngine(tm, spec=tspec, device="cpu", **kw))


# --------------------------------------------------------------------------- #
# CompileCache units, against the reference's cache                          #
# --------------------------------------------------------------------------- #

def _both_caches(max_entries):
    calls = []

    def jfn(params, buffers, x):
        return x["ids"] * params + x["len"]

    def tfn(params, buffers, x):
        calls.append(1)
        return x["ids"] * params + x["len"]

    return (JaxCache(jfn, max_entries=max_entries),
            CompileCache(tfn, graphs=GraphPool("cpu", capture=False),
                         max_entries=max_entries), calls)


def test_cache_hits_misses_and_warmup_match_reference():
    """Per-leaf (shape, dtype) keys: the same shapes hit, a new leaf
    shape misses; warmup makes entries without counting traffic."""
    jc, tc, calls = _both_caches(4)
    a = {"ids": np.ones((1, 8), np.float32), "len": np.float32(3)}
    b = {"ids": np.ones((1, 8), np.float32), "len": np.float32(9)}
    c = {"ids": np.ones((1, 16), np.float32), "len": np.float32(3)}
    d = {"ids": np.ones((1, 32), np.float32), "len": np.float32(0)}
    jp, tp = jnp.float32(2.0), torch.tensor(2.0)
    for x in (a, b, c):
        want = np.asarray(jc(jp, None, x))
        np.testing.assert_array_equal(tc(tp, None, x).numpy(), want)
    assert _counts(tc.stats()) == _counts(jc.stats())
    assert tc.stats()["misses"] == 2 and tc.stats()["hits"] == 1
    assert tc.warmup_inputs(tp, None, [d, d]) == jc.warmup_inputs(
        jp, None, [d, d]) == 1
    assert _counts(tc.stats()) == _counts(jc.stats())
    assert tc.stats()["entries"] == 3 and tc.stats()["misses"] == 2
    assert len(tc) == len(jc) == 3
    assert len(calls) == 4          # each miss and warmup entry ran once


def test_cache_lru_eviction_matches_reference():
    """Two entries at most: a hit refreshes its entry, the least
    recently used one goes, and a shape seen again after eviction
    misses again."""
    jc, tc, _ = _both_caches(2)
    xs = [{"ids": np.ones((1, n), np.float32), "len": np.float32(1)}
          for n in (4, 8, 16)]
    jp, tp = jnp.float32(1.0), torch.tensor(1.0)
    for i in (0, 1, 0, 2, 1, 0, 2):
        jc(jp, None, xs[i])
        tc(tp, None, xs[i])
        assert _counts(tc.stats()) == _counts(jc.stats())
    st = tc.stats()
    assert st["entries"] == 2 and st["evictions"] == 4
    assert st["hits"] == 1 and st["misses"] == 6


def test_cache_keys_on_params_dtype_and_input_names():
    """float32 and bfloat16 params of one model hold one entry each, as
    the reference's dtype tag keeps them apart; dicts with the same leaves
    under other names do not share an entry."""
    jc, tc, _ = _both_caches(8)
    x = {"ids": np.ones((1, 8), np.float32), "len": np.float32(2)}
    for jp, tp in ((jnp.float32(1.0), torch.tensor(1.0)),
                   (jnp.bfloat16(1.0), torch.tensor(1.0,
                                                    dtype=torch.bfloat16)),
                   (jnp.float32(3.0), torch.tensor(3.0))):
        jc(jp, None, x)
        tc(tp, None, x)
    assert _counts(tc.stats()) == _counts(jc.stats())
    assert tc.stats()["entries"] == 2 and tc.stats()["hits"] == 1
    assert params_dtype_tag({"w": torch.zeros(2)}) == "f32"
    assert params_dtype_tag({"a": {"w": torch.zeros(2,
                                                    dtype=torch.bfloat16)}}) \
        == "bf16"
    y = {"ids2": x["ids"], "len": x["len"]}
    assert input_signature(x) != input_signature(y)
    assert input_signature(np.zeros((2, 3), np.int32)) == ((2, 3), "int32")


def test_inputs_keep_their_shapes_on_the_way_to_the_device():
    """A scalar input (a prompt's length) stays 0-d in its host staging
    and on the device, as a captured graph's static input is made."""
    from bigdl_tpu_torch.serving.compile_cache import _host_tensor, _on_device
    assert _host_tensor(np.int32(7)).shape == ()
    assert _host_tensor(np.arange(6).reshape(2, 3)[:, 1]).is_contiguous()
    x = _on_device({"len": np.int32(5), "ids": np.zeros((1, 4), np.int64)},
                   torch.device("cpu"))
    assert x["len"].shape == () and x["len"].dtype == torch.int32
    assert x["ids"].shape == (1, 4) and x["ids"].dtype == torch.int64


def test_step_graph_and_graph_switch_on_the_cpu(tmp_path):
    """A fixed-shape step is made once; capture needs a CUDA device, and
    an engine asked for graphs off the card refuses."""
    runs = []
    step = StepGraph(lambda x: runs.append(x.clone()) or x + 1,
                     GraphPool("cpu", capture=False))
    for v in (1, 5):
        np.testing.assert_array_equal(
            step(np.full((3,), v, np.int64)).numpy(), v + 1)
    assert step.compiles == 1 and len(runs) == 2
    with pytest.raises(ValueError, match="CUDA device"):
        GraphPool("cpu", capture=True)
    _, tm = _pair(vocab=31, hidden=32, max_len=32)
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        LMServingEngine(tm, cache_len=24, device="cpu", cuda_graphs=True)
    with LMServingEngine(tm, cache_len=24, device="cpu") as eng:
        assert not eng.cuda_graphs
        assert eng.stats()["cuda_graphs"] == {
            "enabled": False, "captures": 0, "replays": 0, "capture_s": 0.0}


# --------------------------------------------------------------------------- #
# the engine's bounded entries, against the JAX engine                        #
# --------------------------------------------------------------------------- #

def test_prefill_entries_equal_distinct_buckets_vs_jax():
    """The mirror of tests/test_lm_serving.py's prefill contract: warmup
    makes one entry per bucket, traffic over all three buckets is hits
    only, the counts equal the JAX engine's, every stream equals it, and
    the arenas keep their buffers (tests/test_lm_serving.py:168)."""
    jm, tm = _pair(vocab=31, hidden=32, max_len=32)
    jeng, teng = _engines(jm, tm, slots=2, cache_len=24, max_new_tokens=4,
                          prefill_buckets=(4, 8, 16))
    try:
        assert jeng.warmup() == 3 and teng.warmup() == 3
        assert teng.warmup() == 0                     # already made
        st = teng.prefill_cache.stats()
        assert st["entries"] == 3 and st["misses"] == 0
        assert teng._decode_exec.compiles == 1
        ptrs = teng.cache_buffer_pointers()
        for t in (2, 4, 6, 9, 16):
            p = np.arange(1, t + 1) % 30 + 1
            np.testing.assert_array_equal(
                teng.generate(p, timeout=60, max_new_tokens=3),
                jeng.generate(p, timeout=60, max_new_tokens=3))
        st = teng.stats()["prefill_cache"]
        assert st["entries"] == 3 and st["misses"] == 0 and st["hits"] == 5
        assert _counts(st) == _counts(jeng.stats()["prefill_cache"])
        assert teng._decode_exec.compiles == 1
        assert teng.cache_buffer_pointers() == ptrs
    finally:
        jeng.close()
        teng.close()


def test_warmup_prefix_counts_and_radix_hits_vs_jax():
    """warmup_prefix makes the same entries as the JAX engine for the
    same suffix_lens/prefix_blocks, under the same LRU bound (the full
    cross product of 2 suffix buckets x 4 chain buckets overflows 5
    entries); a radix hit then prefills its suffix on a warm entry, and
    the stream equals the JAX engine's."""
    jm, tm = _pair(seed=1, vocab=41, hidden=32, max_len=64)
    jeng, teng = _engines(jm, tm, slots=2, cache_len=32, block_len=4,
                          max_new_tokens=4, prefill_buckets=(8, 16),
                          max_cache_entries=5)
    try:
        assert teng.warmup() == jeng.warmup() == 2
        for kw in (dict(suffix_lens=[3, 9], prefix_blocks=[1, 3]),
                   dict(suffix_lens=[5], prefix_blocks=[2]),
                   {},
                   dict(suffix_lens=[6], prefix_blocks=[3])):
            assert teng.warmup_prefix(**kw) == jeng.warmup_prefix(**kw)
            assert _counts(teng.prefix_prefill_cache.stats()) == _counts(
                jeng.prefix_prefill_cache.stats())
        assert teng.prefix_prefill_cache.stats()["evictions"] > 0
        # the last pair warmed: (suffix bucket 8, chain bucket 4)
        assert teng.warmup_prefix(suffix_lens=[6], prefix_blocks=[3]) == 0
        head = np.arange(1, 13) % 40 + 1               # 3 whole blocks
        for p in (head, np.concatenate([head, [7, 9, 2, 30, 11, 5]])):
            np.testing.assert_array_equal(
                teng.generate(p, timeout=60, max_new_tokens=4),
                jeng.generate(p, timeout=60, max_new_tokens=4))
        st = teng.stats()
        assert st["kvcache"]["prefix_cache"]["hits"] >= 1
        assert _counts(st["prefix_prefill_cache"]) == _counts(
            jeng.stats()["prefix_prefill_cache"])
        assert st["prefix_prefill_cache"]["hits"] == 1
        assert st["prefix_prefill_cache"]["misses"] == 0
    finally:
        jeng.close()
        teng.close()


SPEC_TRAFFIC = [(np.asarray([2, 4, 8]), 8, 0.0, None),
                (np.asarray([7, 1, 22, 5, 9]), 10, 0.7, 3),
                (np.arange(1, 12) % 30 + 1, 6, 0.0, None),
                (np.asarray([3, 3, 3, 3]), 12, 1.3, 4),
                (np.arange(5, 20) % 30 + 1, 2, 0.0, None)]


def _drafter_pair(jm_kw, seed):
    jd, td = _pair(seed=seed, **jm_kw)
    return jd, td


@pytest.mark.parametrize("tree", [False, True])
def test_spec_bounded_entries_vs_jax(tree):
    """The mirrors of tests/test_spec_decode.py:189 and
    tests/test_spec_tree.py:181: after mixed lengths, temperatures and
    slot churn the engine holds one verify entry (one per tree rung), one
    commit entry and one drafter decode entry, the same counts as the
    JAX engine, nothing new after warmup, the same streams, and the
    arenas kept their buffers."""
    kw = dict(vocab=31, hidden=32, max_len=64)
    jm, tm = _pair(seed=0, **kw)
    jd, td = _drafter_pair(kw, seed=1)
    jeng, teng = _engines(
        jm, tm, slots=4, cache_len=48, block_len=4, max_new_tokens=12,
        prefill_buckets=(8, 16),
        jspec=JaxSpec(k=3, draft=jd, tree=tree),
        tspec=SpecConfig(k=3, draft=td, tree=tree))
    try:
        jeng.warmup()
        teng.warmup()
        n_verify = len(teng._tree_shapes) if tree else 1
        assert teng._verify_compiles == jeng._verify_compiles == n_verify
        if tree:
            assert teng._commit_compiles == jeng._commit_compiles == 1
        assert teng.draft.decode_compiles == jeng.draft.decode_compiles == 1
        ptrs = teng.cache_buffer_pointers()
        for p, n, t, seed in SPEC_TRAFFIC:
            got = [teng.submit(p, max_new_tokens=n, temperature=t, rng=seed)
                   for _ in range(2)]
            want = [jeng.submit(p, max_new_tokens=n, temperature=t, rng=seed)
                    for _ in range(2)]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.result(timeout=120),
                                              w.result(timeout=120))
        assert teng._verify_compiles == jeng._verify_compiles == n_verify
        assert teng.draft.decode_compiles == jeng.draft.decode_compiles == 1
        tst, jst = teng.stats()["spec"], jeng.stats()["spec"]
        assert tst["verify_compiles"] == jst["verify_compiles"] == n_verify
        if tree:
            assert teng._commit_compiles == jeng._commit_compiles == 1
            assert tst["commit_compiles"] == jst["commit_compiles"] == 1
        assert _counts(tst["draft"]["prefill_cache"]) == _counts(
            jst["draft"]["prefill_cache"])
        assert _counts(teng.stats()["prefill_cache"]) == _counts(
            jeng.stats()["prefill_cache"])
        assert tst["drafted"] > 0
        assert teng.cache_buffer_pointers() == ptrs
    finally:
        jeng.close()
        teng.close()


def test_ngram_drafter_counts_stay_zero():
    """The n-gram drafter has no device work: no drafter entry at all,
    while the verify entries are bounded as for a model drafter."""
    _, tm = _pair(vocab=31, hidden=32, max_len=64)
    with LMServingEngine(tm, slots=2, cache_len=48, block_len=4,
                         prefill_buckets=(8, 16), device="cpu",
                         spec=SpecConfig(k=3, tree=True,
                                         drafter_compute="ngram")) as eng:
        eng.warmup()
        seg = np.asarray([4, 9, 2, 7, 5])
        eng.generate(np.concatenate([seg, seg, seg[:2]]), max_new_tokens=8,
                     timeout=60)
        st = eng.stats()["spec"]
        assert eng.draft.decode_compiles == 0 and st["draft_steps"] == 0
        assert st["verify_compiles"] == len(eng._tree_shapes)
        assert st["commit_compiles"] == 1
