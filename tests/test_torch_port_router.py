"""bigdl_tpu_torch's prefix-affinity routing and routed replica sets on
the CPU, against the JAX package (mirrors all of ``tests/test_router.py``
and ``tests/test_lifecycle.py:298-370``).

Prefix fingerprints are held bit for bit against the reference's; the
summary, router, session table and hedge policy step for step against
the reference's objects on the same inputs; every routed stream (sticky
turns, a hibernation round trip, a replica killed mid-stream or
mid-hibernation, hedged dispatch) token for token against the JAX
package's single engine on the same prompts, seeds and temperatures,
on the same tiny model (vocab 31, hidden 16, 2 heads, 1 layer, rope)."""
import time

import jax
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.resilience.replicaset import HedgePolicy as JaxHedge
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.serving.kvcache.radix import _SIG_ROOT as JAX_SIG_ROOT
from bigdl_tpu.serving.kvcache.radix import \
    prefix_signatures as jax_prefix_signatures
from bigdl_tpu.serving.router import RadixRouter as JaxRouter
from bigdl_tpu.serving.router import RadixSummary as JaxSummary
from bigdl_tpu.serving.router import SessionTable as JaxSessions

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import get_registry
from bigdl_tpu_torch.resilience.errors import BackendLostError
from bigdl_tpu_torch.resilience.replicaset import HedgePolicy
from bigdl_tpu_torch.serving import (BlockPool, HostBlockStore, RadixCache,
                                     ServingDeadlineExceeded)
from bigdl_tpu_torch.serving.kvcache.radix import (_SIG_ROOT, _sig_extend,
                                                   prefix_signatures)
from bigdl_tpu_torch.serving.router import (LMReplicaSet, RadixRouter,
                                            RadixSummary, SessionTable)
from bigdl_tpu_torch.utils.params import params_from_numpy

_PROMPT = np.arange(1, 9, dtype=np.int32)
_ENG_KW = dict(slots=2, cache_len=56, max_new_tokens=24,
               prefill_buckets=(8, 16), block_len=4)
_LC_KW = dict(_ENG_KW, max_new_tokens=12)


@pytest.fixture(autouse=True)
def fresh_registry():
    get_registry().clear()
    yield


def _pool(num_blocks=8, block_len=2):
    return BlockPool(n_layers=1, n_heads=1, head_dim=2, block_len=block_len,
                     num_blocks=num_blocks, device="cpu")


class _FakeReplica:
    """The _Replica protocol the router scores: a name and load."""

    def __init__(self, name, inflight=0, dispatched=0):
        self.name = name
        self.inflight = inflight
        self.dispatched = dispatched


# --------------------------------------------------------------------------- #
# prefix fingerprints                                                         #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("t,block_len,cap", [
    (10, 2, None), (17, 4, None), (64, 16, None), (700, 16, None),
    (33, 4, 3), (2, 2, None), (0, 4, None)])
def test_prefix_signatures_bitwise_the_reference(t, block_len, cap):
    toks = np.random.RandomState(t).randint(0, 50257, size=t)
    got = prefix_signatures(toks, block_len, cap)
    assert got == jax_prefix_signatures(toks, block_len, cap)
    assert all(0 <= s < 1 << 64 for s in got)
    assert _SIG_ROOT == JAX_SIG_ROOT


def test_prefix_signatures_deterministic_and_capped():
    toks = np.arange(10, 20)
    a = prefix_signatures(toks, 2)
    assert a == prefix_signatures(toks.copy(), 2)
    assert len(a) == (10 - 1) // 2
    sig = _sig_extend(_SIG_ROOT, (10, 11))
    assert a[0] == sig and a[1] == _sig_extend(sig, (12, 13))
    other = toks.copy()
    other[2] = 99
    c = prefix_signatures(other, 2)
    assert c[0] == a[0] and c[1] != a[1]
    assert prefix_signatures(np.array([5, 6]), 2) == []
    assert prefix_signatures(np.array([], dtype=np.int32), 2) == []


# --------------------------------------------------------------------------- #
# RadixSummary under the trie's hooks                                         #
# --------------------------------------------------------------------------- #

def test_summary_tracks_insert_and_evict():
    pool = _pool()
    rc = RadixCache(pool)
    summ = RadixSummary("r0")
    rc.attach_summary(summ)
    chain = pool.alloc(3)
    rc.insert(np.arange(10, 16), chain)
    assert len(summ) == rc.nodes == 3
    sigs = prefix_signatures(np.arange(10, 17), 2)
    assert summ.match_blocks(sigs) == 3
    # the trie's node fingerprints are the reference's prompt sigs
    assert sorted(summ._sigs) == sorted(jax_prefix_signatures(
        np.arange(10, 17), 2))
    pool.release(chain)
    v0 = summ.version
    rc.evict(99)
    assert rc.nodes == 0 and len(summ) == 0
    assert summ.match_blocks(sigs) == 0
    assert summ.evicts == 3 and summ.version > v0


def test_summary_attach_replays_existing_trie():
    pool = _pool()
    rc = RadixCache(pool)
    rc.insert(np.arange(20, 26), pool.alloc(3))
    summ = RadixSummary("late")
    rc.attach_summary(summ)
    assert len(summ) == 3
    assert summ.match_blocks(prefix_signatures(np.arange(20, 27), 2)) == 3


def test_summary_match_stops_at_first_gap():
    sigs = prefix_signatures(np.arange(0, 9), 2)
    for cls in (RadixSummary, JaxSummary):
        summ = cls()
        for s in (sigs[0], sigs[1], sigs[3]):
            summ.on_insert(s)
        assert summ.match_blocks(sigs) == 2


# --------------------------------------------------------------------------- #
# RadixRouter scoring, against the reference's router                         #
# --------------------------------------------------------------------------- #

def _routers_with(matches, w=0.7):
    """A port router and a reference router whose summaries match the
    canonical prompt to the given depths; returns both and the sigs."""
    sigs = prefix_signatures(np.arange(100, 117), 4)
    out = []
    for rcls, scls in ((RadixRouter, RadixSummary), (JaxRouter, JaxSummary)):
        r = rcls(affinity_weight=w)
        for name, depth in matches.items():
            s = scls(name)
            for sg in sigs[:depth]:
                s.on_insert(sg)
            r.register(name, s)
        out.append(r)
    return out, sigs


def _pick_both(routers, reps, sigs):
    picks = [r.pick(reps, {"prompt_sigs": sigs}) for r in routers]
    assert picks[0] is picks[1]
    return picks[0]


def test_router_prefers_longest_prefix():
    routers, sigs = _routers_with({"a": 1, "b": 3})
    a, b = _FakeReplica("a"), _FakeReplica("b", inflight=1)
    assert _pick_both(routers, [a, b], sigs) is b
    assert [r.affinity_hits for r in routers] == [1, 1]


def test_router_tie_breaks_least_loaded():
    routers, sigs = _routers_with({"a": 2, "b": 2, "c": 2})
    reps = [_FakeReplica("a", 2, 9), _FakeReplica("b", 1, 5),
            _FakeReplica("c", 1, 4)]
    assert _pick_both(routers, reps, sigs) is reps[2]


def test_router_cold_prompt_declines():
    routers, sigs = _routers_with({"a": 0, "b": 0})
    reps = [_FakeReplica("a"), _FakeReplica("b")]
    assert _pick_both(routers, reps, sigs) is None
    assert _pick_both(routers, reps, []) is None
    for r in routers:
        assert r.cold_dispatches == 1 and r.affinity_hits == 0
    assert routers[0].stats() == routers[1].stats()


def test_router_affinity_weight_trades_against_load():
    hot = _FakeReplica("hot", inflight=10)
    idle = _FakeReplica("idle", inflight=0)
    for w, want in ((0.95, "hot"), (0.2, "idle")):
        routers, sigs = _routers_with({"hot": 4, "idle": 1}, w=w)
        assert _pick_both(routers, [hot, idle], sigs).name == want


def test_router_never_dispatches_to_evicted_chain():
    pool = _pool()
    rc = RadixCache(pool)
    summ = RadixSummary("r0")
    rc.attach_summary(summ)
    chain = pool.alloc(3)
    rc.insert(np.arange(30, 36), chain)
    router = RadixRouter()
    router.register("r0", summ)
    rep = _FakeReplica("r0")
    sigs = prefix_signatures(np.arange(30, 37), 2)
    assert router.pick([rep], {"prompt_sigs": sigs}) is rep
    pool.release(chain)
    rc.evict(99)
    assert router.pick([rep], {"prompt_sigs": sigs}) is None
    assert router.cold_dispatches == 1
    assert get_registry().counter("serving/router/cold_dispatches").value == 1


# --------------------------------------------------------------------------- #
# SessionTable and HedgePolicy, step for step against the reference's         #
# --------------------------------------------------------------------------- #

def test_session_table_record_lookup_hibernate():
    for t in (SessionTable(), JaxSessions()):
        assert t.lookup("s1") is None and t.lookup(None) is None
        t.record("s1", "r0")
        assert t.lookup("s1") == "r0"
        t.mark_hibernated("s1", "r1")
        assert t.lookup("s1") == "r1"
        t.record("s1", "r2")
        assert t.lookup("s1") == "r2"
        t.forget("s1")
        assert t.lookup("s1") is None


def test_session_table_bounded_lru():
    stats = []
    for t in (SessionTable(max_sessions=2), JaxSessions(max_sessions=2)):
        t.record("a", "r0")
        t.record("b", "r0")
        assert t.lookup("a") == "r0"
        t.record("c", "r1")
        assert t.lookup("b") is None
        assert t.lookup("a") == "r0" and t.lookup("c") == "r1"
        t.note_sticky_hit()
        t.note_re_route()
        stats.append(t.stats())
    assert stats[0] == stats[1]
    assert stats[0]["evicted"] == 1


def test_hedge_policy_trigger_and_budget():
    out = []
    for cls in (HedgePolicy, JaxHedge):
        pol = cls(trigger_quantile=0.5, window=16, min_observations=4,
                  max_hedge_fraction=0.5)
        assert pol.trigger_s() is None
        for w in (0.1, 0.2, 0.3, 0.4):
            pol.observe(w)
        trig = pol.trigger_s()
        assert trig is not None and 0.1 <= trig <= 0.4
        for _ in range(4):
            pol.note_dispatch()
        assert pol.should_hedge(trig + 1.0)
        pol.note_fired()
        pol.note_outcome(True)
        assert pol.should_hedge(trig + 1.0)
        pol.note_fired()
        assert not pol.should_hedge(trig + 1.0)
        assert not pol.should_hedge(0.0)
        out.append((trig, pol.stats()))
    assert out[0] == out[1]
    assert out[0][1]["hedges_fired"] == 2 and out[0][1]["hedges_won"] == 1
    snap = get_registry().snapshot()
    assert snap["serving/lifecycle/hedges_fired"]["value"] == 2


# --------------------------------------------------------------------------- #
# LMReplicaSet end to end                                                     #
# --------------------------------------------------------------------------- #

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
def rt_reference(pair):
    """The JAX package's single engine: the streams every routed run of
    the port must equal, on the same prompts, seeds and temperatures."""
    jm, _ = pair
    eng = JaxEngine(jm, **_ENG_KW)
    turn1 = eng.generate(_PROMPT, max_new_tokens=6, temperature=0.7, rng=7)
    prompt2 = np.concatenate([turn1, [3, 5, 2]]).astype(np.int32)
    turn2 = eng.generate(prompt2, max_new_tokens=6, temperature=0.7, rng=8)
    sampled_long = eng.generate(_PROMPT, max_new_tokens=12,
                                temperature=0.7, rng=5)
    hedged = eng.generate(_PROMPT, max_new_tokens=6, temperature=0.7, rng=3)
    greedy4 = eng.generate(_PROMPT, max_new_tokens=4)
    eng.close()
    return {"turn1": turn1, "prompt2": prompt2, "turn2": turn2,
            "sampled_long": sampled_long, "hedged": hedged,
            "greedy4": greedy4}


def _set(tm, name, **kw):
    return LMReplicaSet(tm, 2, name=name, device="cpu",
                        **dict(_ENG_KW, **kw))


def _tiers():
    return dict(kvtier_factory=lambda n: HostBlockStore(host_bytes=32 << 20,
                                                        name=n))


def test_routed_set_sticky_session_bit_exact(pair, rt_reference):
    _, tm = pair
    rs = _set(tm, "t-sticky", router=RadixRouter())
    try:
        t1 = rs.submit(_PROMPT, session_id="chat", max_new_tokens=6,
                       temperature=0.7, rng=7)
        np.testing.assert_array_equal(t1.result(timeout=60),
                                      rt_reference["turn1"])
        t2 = rs.submit(rt_reference["prompt2"], session_id="chat",
                       max_new_tokens=6, temperature=0.7, rng=8)
        np.testing.assert_array_equal(t2.result(timeout=60),
                                      rt_reference["turn2"])
        assert t2.replica_name == t1.replica_name
        st = rs.stats()
        assert st["sessions"]["sticky_hits"] >= 1
        assert st["prefix_cache"]["hits"] >= 1
        assert st["prefix_cache"]["prefill_tokens_saved"] > 0
        summ = st["router"]["summaries"][t1.replica_name]
        assert summ["sigs"] > 0
        assert get_registry().counter("serving/router/sticky_hits").value >= 1
    finally:
        rs.close()


def test_stickiness_survives_hibernation_roundtrip(pair, rt_reference):
    _, tm = pair
    rs = _set(tm, "t-hib", router=RadixRouter(), **_tiers())
    try:
        st = rs.submit(_PROMPT, session_id="hib", max_new_tokens=12,
                       temperature=0.7, rng=5)
        next(st.tokens(timeout=60))
        assert rs.hibernate(st), "stream not seated (finished early?)"
        assert rs.sessions.lookup("hib") == st.replica_name
        assert rs.stats()["hibernations"] == 1
        assert rs.resume(st) is True
        np.testing.assert_array_equal(st.result(timeout=60),
                                      rt_reference["sampled_long"])
        assert rs.stats()["resumes"] == 1
        assert rs.stats()["resume_re_routes"] == 0
    finally:
        rs.close()


def test_router_fallback_when_all_summaries_cold(pair):
    _, tm = pair
    rs = _set(tm, "t-cold", router=RadixRouter())
    try:
        outs = [rs.submit(np.arange(1 + i, 9 + i, dtype=np.int32),
                          max_new_tokens=4) for i in range(3)]
        for s in outs:
            assert s.result(timeout=60).shape[0] == 12
        assert rs.router.cold_dispatches >= 1
        reps = rs.stats()["replicas"]
        assert sum(r["dispatched"] for r in reps.values()) == 3
        assert all(r["inflight"] == 0 for r in reps.values())
    finally:
        rs.close()


def test_kill_replica_mid_stream_replays_bit_exact(pair, rt_reference):
    _, tm = pair
    rs = _set(tm, "t-chaos", router=RadixRouter())
    try:
        st = rs.submit(_PROMPT, session_id="doomed", max_new_tokens=12,
                       temperature=0.7, rng=5)
        it = st.tokens(timeout=60)
        next(it)
        next(it)
        victim = st.replica_name
        rs.kill_replica(victim)
        np.testing.assert_array_equal(st.result(timeout=60),
                                      rt_reference["sampled_long"])
        assert st.re_dispatches == 1 and st.replica_name != victim
        assert rs.stats()["replicas"][victim]["state"] == "draining"
        assert rs.stats()["sessions"]["re_routes"] >= 1
        assert get_registry().counter("resilience/failovers").value == 1
        with pytest.raises(KeyError):
            rs.kill_replica("nobody")
    finally:
        rs.close()


def test_kill_hibernation_holder_resume_re_routes(pair, rt_reference):
    _, tm = pair
    rs = _set(tm, "t-chaos-hib", router=RadixRouter(), **_tiers())
    try:
        st = rs.submit(_PROMPT, session_id="hib2", max_new_tokens=12,
                       temperature=0.7, rng=5)
        next(st.tokens(timeout=60))
        assert rs.hibernate(st)
        victim = st.replica_name
        rs.kill_replica(victim)
        deadline = time.perf_counter() + 30
        while st.re_dispatches == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert rs.resume(st) is True
        np.testing.assert_array_equal(st.result(timeout=60),
                                      rt_reference["sampled_long"])
        assert st.replica_name != victim
        assert (rs.stats()["resume_re_routes"]
                + rs.stats()["sessions"]["re_routes"]) >= 1
    finally:
        rs.close()


def test_kill_last_replica_fails_streams_typed(pair):
    _, tm = pair
    rs = _set(tm, "t-doom", router=RadixRouter())
    try:
        st = rs.submit(_PROMPT, max_new_tokens=12, temperature=0.7, rng=5)
        next(st.tokens(timeout=60))
        for name in list(rs.stats()["replicas"]):
            rs.kill_replica(name)
        with pytest.raises(BackendLostError):
            st.result(timeout=60)
        assert get_registry().gauge("resilience/replicas").value == 0
    finally:
        rs.close()


# --------------------------------------------------------------------------- #
# the routed lifecycle and hedged dispatch (tests/test_lifecycle.py)          #
# --------------------------------------------------------------------------- #

def test_routed_deadline_and_cancel_propagation(pair, rt_reference):
    _, tm = pair
    rs = LMReplicaSet(tm, 2, name="lc-rt", device="cpu", **_LC_KW)
    try:
        rs.warmup()
        s = rs.submit(_PROMPT, max_new_tokens=4, deadline_s=60.0)
        np.testing.assert_array_equal(s.result(timeout=60),
                                      rt_reference["greedy4"])
        assert s.truncation is None
        s2 = rs.submit(_PROMPT, max_new_tokens=12)
        s2.cancel()
        s2.result(timeout=60)
        assert s2.truncation is not None
        assert s2.truncation.reason == "cancelled"
        assert rs.lifecycle_stats()["cancelled"] >= 1
        with pytest.raises(ServingDeadlineExceeded):
            rs.submit(_PROMPT, max_new_tokens=4, deadline_s=0.0)
        reps = rs.stats()["replicas"]
        assert all(r["failures"] == 0 for r in reps.values())
    finally:
        rs.close()


def test_hedged_dispatch_first_completion_wins(pair, rt_reference):
    """Saturate a 2-replica set so queue waits pass the median trigger:
    hedges fire within budget, every result equals the JAX engine's, and
    the losers' cancels free their seats."""
    _, tm = pair
    pol = HedgePolicy(trigger_quantile=0.5, window=64, min_observations=4,
                      max_hedge_fraction=0.5, min_trigger_s=0.0)
    rs = LMReplicaSet(tm, 2, hedge=pol, name="lc-hedge", device="cpu",
                      **_LC_KW)
    try:
        rs.warmup()
        ref = rt_reference["hedged"]
        np.testing.assert_array_equal(
            rs.submit(_PROMPT, max_new_tokens=6, temperature=0.7,
                      rng=3).result(timeout=60), ref)
        for _ in range(8):
            pol.observe(0.0005)
        streams = [rs.submit(_PROMPT, max_new_tokens=6, temperature=0.7,
                             rng=3, hedgeable=True) for _ in range(10)]
        for s in streams:
            np.testing.assert_array_equal(s.result(timeout=120), ref)
        st = pol.stats()
        assert st["hedges_fired"] >= 1
        assert st["hedges_fired"] <= 1 + int(0.5 * st["dispatches"])
        assert st["hedges_won"] + st["hedges_lost"] == st["hedges_fired"]
        assert rs.stats()["hedge"] == pol.stats()
    finally:
        rs.close()
