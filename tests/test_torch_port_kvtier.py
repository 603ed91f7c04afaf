"""bigdl_tpu_torch's host KV tier on the CPU against the JAX package
(mirrors all of ``tests/test_kvtier.py`` and
``tests/test_lifecycle.py:201``): the host block store's mechanics,
``block_path`` against the radix keys, the ``on_evict`` funnel, chain
export/adopt (the port's wire payload bitwise the reference's
``export_chain`` for the same arena contents), and hibernate/resume on
the engine held against the JAX package's streams and counters."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer.generate import generate as jax_generate
from bigdl_tpu.serving import BlockPool as JaxPool
from bigdl_tpu.serving import HostBlockStore as JaxStore
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.serving import RadixCache as JaxRadix
from bigdl_tpu.serving.kvtier import block_path as jax_block_path

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import get_registry
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import (HostBlockStore, LMServingEngine,
                                     PoolExhausted, ServingClosed)
from bigdl_tpu_torch.serving.kvcache import BlockPool, RadixCache
from bigdl_tpu_torch.serving.kvtier import block_path
from bigdl_tpu_torch.utils.params import params_from_numpy


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test starts from an empty process-wide registry of the port
    (engines and stores re-register their names as they are built)."""
    get_registry().clear()
    yield


def _payload(n, seed=0, L=1, H=2, B=4, D=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.standard_normal((n, L, H, B, D)).astype(np.float32),
            "v": rng.standard_normal((n, L, H, B, D)).astype(np.float32)}


def _both(fn):
    """Run ``fn(store_class, tag)`` on the port's store and the JAX
    package's; return both results."""
    return fn(HostBlockStore, "port"), fn(JaxStore, "jax")


# --------------------------------------------------------------------------- #
# HostBlockStore                                                              #
# --------------------------------------------------------------------------- #

def test_store_put_get_roundtrip_and_pop():
    def run(cls, tag):
        s = cls(host_bytes=1 << 20, name=f"tp-rt-{tag}")
        p = _payload(2)
        s.put(("a",), p)
        got = s.get(("a",))
        assert np.array_equal(got["k"], p["k"])
        assert np.array_equal(got["v"], p["v"])
        assert s.get(("a",), pop=True) is not None
        assert s.get(("a",)) is None
        st = s.stats()
        st.pop("name")
        return st

    port, ref = _both(run)
    assert port == ref
    assert port["hits"] == 2 and port["misses"] == 1
    assert port["demotions"] == 1


def test_store_lru_spill_order_and_rehydrate(tmp_path):
    one = _payload(1)["k"].nbytes * 2

    def run(cls, tag):
        s = cls(host_bytes=3 * one, spill_dir=str(tmp_path / tag),
                name=f"tp-spill-{tag}")
        for i in range(5):
            s.put(("b", i), _payload(1, seed=i))
        spilled = [k for k, e in s._entries.items() if e.where == "disk"]
        before = s.stats()
        got = s.get(("b", 0))       # rehydrates, spilling the oldest
        assert np.array_equal(got["k"], _payload(1, seed=0)["k"])
        after = s.stats()
        for st in (before, after):
            st.pop("name")
            st.pop("spill_dir")
        return spilled, before, after

    port, ref = _both(run)
    assert port == ref
    assert port[0] == [("b", 0), ("b", 1)]
    assert port[1]["spills"] == 2 and port[1]["drops"] == 0
    assert port[2]["spills"] == 3 and port[2]["corrupt_reads"] == 0


def test_store_drop_without_spill_dir():
    one = _payload(1)["k"].nbytes * 2

    def run(cls, tag):
        s = cls(host_bytes=2 * one, name=f"tp-drop-{tag}")
        for i in range(4):
            s.put(("c", i), _payload(1, seed=i))
        gone, kept = s.get(("c", 0)), s.get(("c", 3))
        assert gone is None and kept is not None
        st = s.stats()
        st.pop("name")
        return st

    port, ref = _both(run)
    assert port == ref
    assert port["drops"] == 2 and port["spills"] == 0


def test_store_corrupt_spill_reads_as_miss(tmp_path):
    one = _payload(1)["k"].nbytes * 2
    s = HostBlockStore(host_bytes=one, spill_dir=str(tmp_path),
                       name="tp-crc")
    s.put(("d", 0), _payload(1))
    s.put(("d", 1), _payload(1, seed=1))     # forces ("d", 0) to disk
    entry = s._entries[("d", 0)]
    assert entry.where == "disk"
    with open(entry.path, "wb") as f:
        f.write(b"not a kv block")
    assert s.get(("d", 0)) is None
    assert s.stats()["corrupt_reads"] == 1
    assert ("d", 0) not in s._entries
    # a lost file reads as a miss too
    s.put(("d", 2), _payload(1, seed=2))     # ("d", 1) to disk
    import os
    os.unlink(s._entries[("d", 1)].path)
    assert s.get(("d", 1)) is None
    assert s.stats()["corrupt_reads"] == 2


def test_store_scales_demote_atomically():
    s = HostBlockStore(host_bytes=1 << 20, name="tp-atomic")
    p = _payload(1)
    with pytest.raises(ValueError, match="atomically"):
        s.put(("e",), {"k": p["k"], "v": p["v"],
                       "ks": np.ones((1, 1, 2, 4), np.float32)})
    with pytest.raises(ValueError, match="missing"):
        s.put(("e",), {"k": p["k"]})


def test_block_path_matches_radix_keys():
    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    assert block_path(toks, 4, 2) == ((3, 1, 4, 1), (5, 9, 2, 6))
    rng = np.random.default_rng(0)
    t = rng.integers(0, 50, 37)
    assert block_path(t, 4, 9) == jax_block_path(t, 4, 9)


def test_tier_metrics_publish_to_registry():
    s = HostBlockStore(host_bytes=1 << 20, name="tp-reg")
    s.put(("m",), _payload(1))
    s.get(("m",))
    s.get(("nope",))
    snap = get_registry().snapshot()
    assert snap["kvtier/tp-reg/demotions"]["value"] == 1
    assert snap["kvtier/tp-reg/hits"]["value"] == 1
    assert snap["kvtier/tp-reg/misses"]["value"] == 1
    assert snap["kvtier/tp-reg/host_bytes"]["value"] > 0
    HostBlockStore(host_bytes=1 << 20, name="tp-reg")
    assert get_registry().snapshot()[
        "kvtier/tp-reg/demotions"]["value"] == 0
    names = {n.split("/", 2)[2] for n in get_registry().names()
             if n.startswith("kvtier/tp-reg/")}
    from bigdl_tpu.obs import get_registry as jax_registry
    JaxStore(host_bytes=1 << 20, name="tp-reg-ref")
    ref = {n.split("/", 2)[2] for n in jax_registry().names()
           if n.startswith("kvtier/tp-reg-ref/")}
    assert names == ref


# --------------------------------------------------------------------------- #
# the single eviction funnel                                                  #
# --------------------------------------------------------------------------- #

def _evictions(pool_cls, radix_cls):
    pool = pool_cls(n_layers=1, n_heads=2, head_dim=4, block_len=4,
                    num_blocks=8)
    cache = radix_cls(pool)
    seen = []
    cache.on_evict = lambda path, block: seen.append(
        (path, block, pool.refcount(block)))
    toks = list(range(12))
    blocks = pool.alloc(3)
    cache.insert(toks, blocks)
    other = pool.alloc(1)
    cache.insert([9, 9, 9, 9], other)
    pool.release(blocks + other)
    assert cache.evict(4) == 4
    return seen, pool.free_count


def test_radix_on_evict_fires_before_release_like_the_reference():
    port, ref = _evictions(BlockPool, RadixCache), \
        _evictions(JaxPool, JaxRadix)
    assert port == ref
    seen = port[0]
    assert seen[0][0] == ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11))
    assert all(rc >= 1 for _, _, rc in seen)   # still allocated


def test_radix_on_evict_raising_hook_degrades_to_drop():
    pool = BlockPool(n_layers=1, n_heads=2, head_dim=4, block_len=4,
                     num_blocks=8)
    cache = RadixCache(pool, on_evict=lambda p, b: 1 / 0)
    blocks = pool.alloc(1)
    cache.insert(list(range(4)), blocks)
    pool.release(blocks)
    assert cache.evict(1) == 1
    assert cache.nodes == 0 and pool.free_count == pool.capacity


# --------------------------------------------------------------------------- #
# export / adopt: bitwise, float and int8, against the reference's wire       #
# --------------------------------------------------------------------------- #

def _filled(quant, ids):
    geom = dict(n_layers=2, n_heads=2, head_dim=4, block_len=4,
                num_blocks=8, kv_quant=quant)
    shape = (2, len(ids), 2, 4, 4)
    fill = np.arange(np.prod(shape)).reshape(shape)
    jp, tp = JaxPool(**geom), BlockPool(device="cpu", **geom)
    assert jp.alloc(len(ids)) == tp.alloc(len(ids)) == ids
    if quant:
        rows = {"k": (fill % 127).astype(np.int8),
                "v": (-fill % 127).astype(np.int8)}
        sfill = np.arange(np.prod(shape[:4]), dtype=np.float32)
        rows["ks"] = sfill.reshape(shape[:4]) * 0.25
        rows["vs"] = sfill.reshape(shape[:4]) * 0.5
    else:
        rows = {"k": fill.astype(np.float32),
                "v": -fill.astype(np.float32)}
    for name, a in rows.items():
        setattr(jp, name, getattr(jp, name).at[:, jnp.asarray(ids)].set(a))
        import torch
        getattr(tp, name)[:, ids] = torch.from_numpy(a)
    return jp, tp, geom


@pytest.mark.parametrize("quant", [None, "int8"])
def test_export_tier_adopt_roundtrip_bit_identical(quant):
    ids = [1, 2, 3]
    jp, tp, geom = _filled(quant, ids)
    wire, jwire = tp.export_chain(ids), jp.export_chain(ids)
    assert set(wire) == set(jwire)
    for key in ("k", "v", "ks", "vs"):
        if key in jwire:
            assert wire[key].dtype == jwire[key].dtype
            np.testing.assert_array_equal(wire[key], jwire[key])
    assert wire["blocks"] == jwire["blocks"] == 3
    if quant:
        assert wire["ks"].shape == (3, 2, 2, 4)
    assert tp.wire_block_bytes == jp.wire_block_bytes
    assert tp.block_bytes == jp.block_bytes
    assert tp.scale_block_bytes == jp.scale_block_bytes
    tier = HostBlockStore(host_bytes=1 << 20, name=f"tp-chain-{quant}")
    tier.put(("chain",), wire)
    back = tier.get(("chain",), pop=True)
    dst, jdst = BlockPool(device="cpu", **geom), JaxPool(**geom)
    dst.alloc(1)                          # adopt lands past a used block
    jdst.alloc(1)
    fresh = dst.adopt_chain(back["k"], back["v"], back.get("ks"),
                            back.get("vs"), extra_blocks=2)
    jfresh = jdst.adopt_chain(back["k"], back["v"], back.get("ks"),
                              back.get("vs"), extra_blocks=2)
    assert fresh == jfresh and len(fresh) == 5
    for key in ("k", "v") + (("ks", "vs") if quant else ()):
        np.testing.assert_array_equal(
            getattr(dst, key)[:, fresh[:3]].numpy(),
            np.asarray(getattr(tp, key)[:, ids]))
        np.testing.assert_array_equal(
            getattr(dst, key).numpy(), np.asarray(getattr(jdst, key)))


def test_adopt_is_all_or_nothing(monkeypatch):
    ids = [1, 2, 3]
    _, tp, geom = _filled(None, ids)
    wire = tp.export_chain(ids, chunk_bytes=1)     # one block a slice
    dst = BlockPool(device="cpu", **geom)
    k0 = dst.k.data_ptr()
    with pytest.raises(PoolExhausted):
        dst.adopt_chain(wire["k"], wire["v"], extra_blocks=5)
    assert dst.free_count == dst.capacity
    with pytest.raises(ValueError, match="scale"):
        dst.adopt_chain(wire["k"], wire["v"], wire["k"][:, :, :, :, 0],
                        wire["k"][:, :, :, :, 0])
    monkeypatch.setenv(faults.ENV_SPEC, "transfer.chunk:transient:after=2")
    faults.refresh_from_env()
    try:
        # every slice past the 2nd keeps failing: the retries run out
        # and escalate to a lost backend
        with pytest.raises(faults.BackendLostError):
            dst.adopt_chain(wire["k"], wire["v"], chunk_bytes=1)
    finally:
        monkeypatch.delenv(faults.ENV_SPEC)
        faults.refresh_from_env()
    assert dst.free_count == dst.capacity
    assert dst.k.data_ptr() == k0                  # the arena in place
    assert not dst.k.any() and not dst.v.any()     # a failed adopt wrote nothing


# --------------------------------------------------------------------------- #
# session hibernation on the engine                                           #
# --------------------------------------------------------------------------- #

_PROMPT = np.arange(1, 9, dtype=np.int32)
_ENG_KW = dict(slots=2, cache_len=56, max_new_tokens=40,
               prefill_buckets=(8,), block_len=4)


@pytest.fixture(scope="module")
def pair():
    kw = dict(vocab_size=31, hidden_size=16, n_head=2, n_layers=1,
              max_len=64, pos_encoding="rope")
    jm = JaxLM(**kw).build(seed=0)
    tm = TransformerLM(device="cpu", **kw)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


@pytest.fixture(scope="module")
def reference_runs(pair):
    """JAX offline generate: the streams every hibernated run matches."""
    jm, _ = pair
    p = jnp.asarray(_PROMPT[None])
    greedy = np.asarray(jax_generate(jm, jm.params, p, 40))[0]
    sampled = np.asarray(jax_generate(jm, jm.params, p, 40,
                                      temperature=0.7,
                                      rng=jax.random.PRNGKey(7)))[0]
    return greedy, sampled


def _engine(tm, tier, **kw):
    return LMServingEngine(tm, kvtier=tier, device="cpu",
                           **dict(_ENG_KW, **kw))


def test_hibernate_resume_bit_exact(pair, reference_runs):
    _, tm = pair
    tier = HostBlockStore(host_bytes=64 << 20, name="tp-hib")
    eng = _engine(tm, tier)
    try:
        ptrs = eng.cache_buffer_pointers()
        st = eng.submit(_PROMPT, max_new_tokens=40)
        next(st.tokens())
        assert eng.hibernate(st)
        stats = eng.stats()
        assert stats["hibernated"] == 1 and stats["hibernations"] == 1
        assert len(eng._free) == eng.slots
        assert eng.pool.free_count + eng.radix.stats()["nodes"] == \
            eng.pool.capacity
        frozen = len(st.generated)
        time.sleep(0.05)
        assert len(st.generated) == frozen
        payload = tier.get(("session", st.request_id))
        n_used = eng._hibernated[st.request_id].n_used
        assert payload["k"].shape == (n_used,) + (1, 2, 4, 8)
        assert eng.resume(st)
        np.testing.assert_array_equal(st.result(timeout=120),
                                      reference_runs[0])
        assert eng.resumes == 1 and eng.resume_re_prefills == 0
        ts = tier.stats()
        assert ts["promotions"] == 1 and ts["demotions"] == 1
        assert tier.promoted_bytes.get()[0] == tier.demoted_bytes.get()[0] \
            == 2 * n_used * eng.pool.block_bytes
        assert ts["promote_bandwidth_mbs"] is None \
            or ts["promote_bandwidth_mbs"] > 0
        assert not eng.hibernate(st)        # finished: a clean refusal
        assert not eng.resume(st)
        assert eng.cache_buffer_pointers() == ptrs
    finally:
        eng.close()


def test_hibernate_answer_waits_for_a_taken_swap(pair, reference_runs):
    """A hibernate() whose timeout runs out after the worker took the
    request answers what the swap did, not False: the stream it reports
    hibernated is hibernated, and resumes exactly."""
    _, tm = pair
    eng = _engine(tm, HostBlockStore(host_bytes=64 << 20, name="tp-race"))
    entered, release = threading.Event(), threading.Event()
    swap = eng._hibernate_one

    def held_swap(slot, st):
        entered.set()
        assert release.wait(60)
        swap(slot, st)

    eng._hibernate_one = held_swap
    answer = []
    try:
        st = eng.submit(_PROMPT, max_new_tokens=40)
        next(st.tokens())
        th = threading.Thread(
            target=lambda: answer.append(eng.hibernate(st, timeout=2.0)))
        th.start()
        assert entered.wait(60)
        th.join(2.5)                      # past the 2 s timeout
        assert th.is_alive() and not answer
        release.set()
        th.join(60)
        assert answer == [True]
        assert st.request_id in eng._hibernated
        assert eng.resume(st)
        np.testing.assert_array_equal(st.result(timeout=120),
                                      reference_runs[0])
    finally:
        release.set()
        eng.close()


def test_hibernate_lost_payload_replays_bit_exact(pair, reference_runs):
    """The tier lost the session: resume re-prefills the prompt and
    replays the emitted tokens through decode without emitting them
    again; the sampled continuation is still exact."""
    _, tm = pair
    tier = HostBlockStore(host_bytes=64 << 20, name="tp-lost")
    eng = _engine(tm, tier)
    try:
        st = eng.submit(_PROMPT, max_new_tokens=40, temperature=0.7, rng=7)
        it = st.tokens()
        for _ in range(3):
            next(it)
        assert eng.hibernate(st)
        before = np.asarray(st.generated)
        assert len(before) >= 3
        assert tier.get(("session", st.request_id), pop=True) is not None
        assert eng.resume(st)
        np.testing.assert_array_equal(st.result(timeout=120),
                                      reference_runs[1])
        np.testing.assert_array_equal(np.asarray(st.generated)[:len(before)],
                                      before)
        assert eng.resume_re_prefills == 1
    finally:
        eng.close()


@pytest.mark.parametrize("tree", [False, True])
def test_hibernated_spec_stream_resumes_on_plain_rows(pair, reference_runs,
                                                      tree):
    """In a speculative engine a resumed stream rides the verify round as
    a one-row candidate (its drafter state did not hibernate); a lost
    payload replays through the verify step.  The drafter (other
    weights) rarely agrees, so a stream takes about a round a token."""
    _, tm = pair
    from bigdl_tpu_torch.serving import SpecConfig
    draft = TransformerLM(device="cpu", vocab_size=31, hidden_size=16,
                          n_head=2, n_layers=1, max_len=64,
                          pos_encoding="rope").build(seed=1)
    tier = HostBlockStore(host_bytes=64 << 20, name=f"tp-spec-{tree}")
    eng = _engine(tm, tier, spec=SpecConfig(k=3, tree=tree, draft=draft))
    try:
        streams = []
        for kw in (dict(), dict(temperature=0.7, rng=7)):
            s = eng.submit(_PROMPT, max_new_tokens=40, **kw)
            next(s.tokens())
            assert eng.hibernate(s)
            streams.append(s)
        a, b = streams
        tier.get(("session", b.request_id), pop=True)
        for s in (a, b):
            assert eng.resume(s)
        np.testing.assert_array_equal(a.result(timeout=120),
                                      reference_runs[0])
        np.testing.assert_array_equal(b.result(timeout=120),
                                      reference_runs[1])
        assert eng.resume_re_prefills == 1 and eng.resumes == 2
    finally:
        eng.close()


def test_hibernate_resume_int8_scales_survive(pair):
    """int8 engine: the session demotes WITH its scales and resumes
    bit-exactly against an uninterrupted int8 run."""
    _, tm = pair
    kw = dict(max_new_tokens=24, kv_quant="int8")
    with LMServingEngine(tm, device="cpu", **dict(_ENG_KW, **kw)) as ref_eng:
        ref = ref_eng.generate(_PROMPT, max_new_tokens=24, timeout=60)
    tier = HostBlockStore(host_bytes=64 << 20, name="tp-hib8")
    eng = _engine(tm, tier, **kw)
    try:
        ptrs = eng.cache_buffer_pointers()
        assert len(ptrs) == 4                       # k, v, ks, vs
        st = eng.submit(_PROMPT, max_new_tokens=24)
        next(st.tokens())
        assert eng.hibernate(st)
        payload = tier.get(("session", st.request_id))
        assert "ks" in payload and "vs" in payload
        assert payload["k"].dtype == np.int8
        assert eng.resume(st)
        np.testing.assert_array_equal(st.result(timeout=120), ref)
        assert eng.cache_buffer_pointers() == ptrs
    finally:
        eng.close()


def test_close_resolves_hibernated_streams(pair):
    _, tm = pair
    eng = _engine(tm, HostBlockStore(host_bytes=64 << 20, name="tp-close"))
    st = eng.submit(_PROMPT, max_new_tokens=40)
    next(st.tokens())
    assert eng.hibernate(st)
    eng.close()
    with pytest.raises(ServingClosed):
        st.result(timeout=10)
    with pytest.raises(ServingClosed):
        eng.resume(st)


def test_cancel_hibernated_stream_without_resume(pair):
    """A hibernated stream is cancellable in place: the idle worker
    wakes, drops the host-tier entry and finishes the stream truncated,
    as the reference's does (``tests/test_lifecycle.py:201``)."""
    jm, tm = pair
    # 40 tokens, not the reference's 12, so that the stream cannot
    # finish before the swap lands on a loaded host
    kw = dict(_ENG_KW, prefill_buckets=(8, 16))
    stats = []
    for eng, tier in (
            (None, JaxStore(host_bytes=64 << 20, name="tp-lc-ref")),
            (None, HostBlockStore(host_bytes=64 << 20, name="tp-lc"))):
        eng = (JaxEngine(jm, kvtier=tier, **kw) if isinstance(tier, JaxStore)
               else LMServingEngine(tm, kvtier=tier, device="cpu", **kw))
        try:
            s = eng.submit(_PROMPT, max_new_tokens=40)
            it = s.tokens()
            for _ in range(2):
                next(it)
            assert eng.hibernate(s, timeout=30.0)
            assert s.cancel() is True
            s.result(timeout=60)
            assert s.truncation.reason == "cancelled"
            assert not tier.contains(("session", s.request_id))
            stats.append((eng.lifecycle_stats(), eng.stats()["hibernated"]))
        finally:
            eng.close()
    assert stats[0] == stats[1]
    assert stats[1][0]["cancelled"] == 1 and stats[1][1] == 0


def test_hibernated_deadline_wakes_the_idle_worker(pair):
    """An idle engine still wakes for a hibernated stream's deadline."""
    _, tm = pair
    eng = _engine(tm, HostBlockStore(host_bytes=64 << 20, name="tp-dl"))
    try:
        s = eng.submit(_PROMPT, max_new_tokens=40, deadline_s=2.0)
        next(s.tokens())
        assert eng.hibernate(s)
        s.result(timeout=60)                 # no resume, no cancel
        assert s.truncation.reason == "deadline"
        assert eng.lifecycle_stats()["expired_midstream"] == 1
    finally:
        eng.close()


# --------------------------------------------------------------------------- #
# oversubscribed session trace                                                #
# --------------------------------------------------------------------------- #

def test_oversubscribed_trace_reuses_tier_like_the_reference(pair):
    """10 sessions over a pool of about 3 chains, twice: evicted prefix
    tails demote into the tier and returning prompts promote them.  All
    ten are queued before the worker takes any (both engines then admit
    in the same rounds), so the tier and radix counters equal the
    reference's, and every stream equals JAX ``generate``."""
    jm, tm = pair
    kw = dict(slots=2, cache_len=32, max_new_tokens=4, prefill_buckets=(32,),
              block_len=4, num_blocks=1 + 3 * 8)
    rng = np.random.default_rng(0)
    head = rng.integers(1, 31, 8)
    prompts = [np.concatenate([head, rng.integers(1, 31, 9)]).astype(
        np.int32) for _ in range(10)]
    want = [np.asarray(jax_generate(jm, jm.params, jnp.asarray(p[None]),
                                    4))[0] for p in prompts]
    out = []
    for make in (lambda t: JaxEngine(jm, kvtier=t, **kw),
                 lambda t: LMServingEngine(tm, kvtier=t, device="cpu", **kw)):
        store = (JaxStore if len(out) == 0 else HostBlockStore)(
            host_bytes=64 << 20, name=f"tp-over-{len(out)}")
        eng = make(store)
        try:
            for _ in range(2):
                with eng._cv:               # queue all before any admits
                    streams = [eng.submit(p) for p in prompts]
                for s, w in zip(streams, want):
                    np.testing.assert_array_equal(s.result(timeout=120), w)
            ts = store.stats()
            for key in ("name", "host_used_bytes", "host_capacity_bytes",
                        "promote_bandwidth_mbs", "spill_dir"):
                ts.pop(key)
            st = eng.stats()
            assert st["kvtier"]["demotions"] == ts["demotions"]
            out.append((ts, st["kvcache"]["prefix_cache"]))
        finally:
            eng.close()
    assert out[0] == out[1]
    ts, rs = out[1]
    assert ts["demotions"] > 0 and ts["hits"] > 0 and ts["promotions"] > 0
    assert ts["hit_rate"] > 0
    assert rs["evictions"] >= ts["demotions"]
