"""bigdl_tpu_torch's chunked-prefill interleave, disaggregated serving,
retrying transfer and SLO controller on the CPU, against the JAX package
(mirrors ``tests/test_disagg.py:203-413``, ``tests/test_resilience.py:75``
and ``:145-185``, ``tests/test_traffic.py:184-275`` and ``:398``).

The same seed-built params go through the JAX package's co-located
engine (the streams every variant must reproduce) and the port's
engines, on the same tiny model (vocab 31, hidden 16, 2 heads, 1 layer,
rope) and engine arguments.  Streams are token-exact; the counters the
traffic fixes deterministically (prefill passes, migrations, migrated
blocks, lost payloads, re-prefills) equal the JAX package's.  The two
placement tests of the reference are mirrored in
``tests/test_torch_port_placement.py``; here ``try_scale_up`` is held
against ``max_replicas_per_phase``, and a placement slot held by another
rank, with no process world to reach it through, must raise naming the
missing world (the forwarded pairs run in that module's gloo worlds)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer.generate import generate as jax_generate
from bigdl_tpu.obs import registry as jreg
from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu.resilience import retry as jretry
from bigdl_tpu.serving import DisaggCoordinator as JaxCoordinator
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.traffic import SLOController as JaxSLO

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import get_registry
from bigdl_tpu_torch.obs.registry import Histogram, percentile_from_counts
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               TransientBackendError)
from bigdl_tpu_torch.resilience.retry import with_backoff
from bigdl_tpu_torch.serving import (DisaggCoordinator, LMServingEngine,
                                     SpecConfig)
from bigdl_tpu_torch.serving.kvcache import BlockPool
from bigdl_tpu_torch.traffic import SLOController
from bigdl_tpu_torch.utils.params import params_from_numpy
from bigdl_tpu_torch.utils.transfer import chunked_device_put

_LM_KW = dict(vocab_size=31, hidden_size=16, n_head=2, n_layers=1,
              max_len=64, pos_encoding="rope")
_ENG = dict(slots=2, cache_len=48, max_new_tokens=8,
            prefill_buckets=(4, 8, 16))
_SIZES = (5, 12, 23, 9, 17, 30)


@pytest.fixture(autouse=True)
def fresh_registry():
    get_registry().clear()
    yield


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(**_LM_KW).build(seed=0)
    tm = TransformerLM(device="cpu", **_LM_KW)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _prompts(sizes=_SIZES, seed=7, vocab=31):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in sizes]


def _serve_all(target, prompts):
    """Submit every prompt (alternating greedy and sampled, request i
    from seed i) and collect the full streams."""
    streams = [target.submit(p, temperature=0.7 if i % 2 else 0.0, rng=i)
               for i, p in enumerate(prompts)]
    return [s.result(timeout=120) for s in streams]


def _serial(target, prompts):
    out = []
    for i, p in enumerate(prompts):
        s = target.submit(p, temperature=0.7 if i % 2 else 0.0, rng=i)
        out.append(s.result(timeout=120))
    return out


@pytest.fixture(scope="module")
def colocated_ref(pair):
    """The JAX package's co-located engine: the streams every chunked and
    disaggregated run of the port must reproduce token for token."""
    jm, _ = pair
    prompts = _prompts()
    with JaxEngine(jm, **_ENG) as eng:
        outs = _serve_all(eng, prompts)
    return prompts, outs


def _passes(stats):
    """Prefill passes an engine ran: every entry call of its two caches
    (warmup counts neither hits nor misses)."""
    return sum(stats[c]["hits"] + stats[c]["misses"]
               for c in ("prefill_cache", "prefix_prefill_cache"))


def _assert_streams(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------- #
# chunked-prefill interleave                                                  #
# --------------------------------------------------------------------------- #

def test_chunked_prefill_exact_and_itl_split(pair, colocated_ref):
    """A chunk cap bounds the per-round prefill stall without changing a
    token; every gap lands in exactly one of the two split histograms;
    the prefill passes equal the JAX engine's under the same cap."""
    jm, tm = pair
    prompts, ref = colocated_ref
    kw = dict(_ENG, block_len=4, max_prefill_chunk_tokens=8)
    with LMServingEngine(tm, device="cpu", **kw) as eng:
        outs = _serve_all(eng, prompts)
        snap = eng.metrics.snapshot()
        st = eng.stats()
    with JaxEngine(jm, **kw) as jeng:
        jouts = _serial(jeng, prompts)
        jst = jeng.stats()
    _assert_streams(outs, ref)
    _assert_streams(jouts, ref)
    assert st["max_prefill_chunk_tokens"] == jst[
        "max_prefill_chunk_tokens"] == 8
    assert (snap["itl_decode"]["count"]
            + snap["itl_prefill_gap"]["count"]) == snap["itl"]["count"]
    assert snap["itl_decode"]["count"] > 0
    assert snap["itl_prefill_gap"]["count"] > 0     # interleaving happened
    # 8-token chunks, block 4: ceil(t / 8) passes a prompt, radix off
    # the table; the JAX engine (served one by one, so its radix saw
    # every earlier prompt too) makes the same count on the same prompts
    assert _passes(st) == _passes(jst) == sum(-(-n // 8) for n in _SIZES)


def test_chunked_prefill_counts_passes_per_chunk(pair):
    """The pass arithmetic of the chip's P1: a 200-token prompt at a
    128-token cap is 2 passes, with the cap at block multiples (a cap of
    10 at block 4 chunks by 8)."""
    jm, tm = pair
    p = _prompts(sizes=(30,), seed=3)[0]
    want = np.asarray(jax_generate(jm, jm.params, jnp.asarray(p[None]), 4))[0]
    for cap, passes in ((10, 4), (16, 2), (64, 1)):
        with LMServingEngine(tm, device="cpu", slots=1, cache_len=48,
                             block_len=4, prefill_buckets=(4, 8, 16, 32),
                             enable_prefix_cache=False,
                             max_prefill_chunk_tokens=cap) as eng:
            out = eng.generate(p, max_new_tokens=4, timeout=120)
            st = eng.stats()
        np.testing.assert_array_equal(out, want)
        assert st["max_prefill_chunk_tokens"] == min(cap, 64) // 4 * 4
        assert _passes(st) == passes


def test_chunk_cap_must_fit_a_block(pair):
    jm, tm = pair
    kw = dict(slots=1, cache_len=48, block_len=16, prefill_buckets=(4, 8),
              max_prefill_chunk_tokens=8)
    with pytest.raises(ValueError, match="block-aligned"):
        LMServingEngine(tm, device="cpu", **kw)
    with pytest.raises(ValueError, match="block-aligned"):
        JaxEngine(jm, **kw)


# --------------------------------------------------------------------------- #
# end-to-end migration                                                        #
# --------------------------------------------------------------------------- #

def _counts(st):
    return {k: st[k] for k in ("migrations", "adopted", "lost_payloads",
                               "re_prefills")}


def test_disagg_streams_bit_exact(pair, colocated_ref):
    """Greedy and sampled streams through the port's phase replicas equal
    the JAX co-located engine's; every request migrated, counted as the
    JAX coordinator counts."""
    jm, tm = pair
    prompts, ref = colocated_ref
    with DisaggCoordinator(tm, prefill_replicas=1, decode_replicas=1,
                           device="cpu", **_ENG) as co:
        assert co.warmup() > 0
        outs = _serve_all(co, prompts)
        st = co.stats()
    with JaxCoordinator(jm, prefill_replicas=1, decode_replicas=1,
                        **_ENG) as jco:
        jouts = _serve_all(jco, prompts)
        jst = jco.stats()
    _assert_streams(outs, ref)
    _assert_streams(jouts, ref)
    assert _counts(st) == _counts(jst) == dict(
        migrations=len(prompts), adopted=len(prompts), lost_payloads=0,
        re_prefills=0)
    assert st["decode"]["completed"] == len(prompts)
    assert st["migrated_bytes"] == (
        st["migrated_blocks"] * 2 * co.decode[0].pool.block_bytes)
    prefill, decode = (st["engines"]["disagg-prefill0"],
                       st["engines"]["disagg-decode0"])
    assert prefill["phase"] == "prefill" and decode["phase"] == "decode"
    assert prefill["migrated"] == len(prompts)
    # the prefill replica never made a decode step
    assert co.prefill[0]._decode_exec.compiles == 0


def test_disagg_int8_radix_sharing_survives_hop(pair):
    """An int8 target, radix on: repeats dedupe against the DECODE
    replica's trie, so they wire fewer blocks (5 against 10 unshared),
    as in the JAX package, and the streams stay exact against the JAX
    co-located int8 engine."""
    jm, tm = pair
    jq, tq = jm.quantize("int8"), tm.quantize("int8")
    base = np.asarray([3, 9, 27, 14, 8, 26, 11, 5, 19, 22, 7, 30], np.int32)
    prompts = [base, base.copy(), np.concatenate([base, [4, 17, 2]])]
    kw = dict(slots=2, cache_len=48, block_len=4, max_new_tokens=6,
              prefill_buckets=(4, 8, 16), enable_prefix_cache=True)
    with JaxEngine(jq, **kw) as eng:
        ref = _serial(eng, prompts)
    with DisaggCoordinator(tq, prefill_replicas=1, decode_replicas=1,
                           device="cpu", **kw) as co:
        outs = _serial(co, prompts)
        st = co.stats()
    with JaxCoordinator(jq, prefill_replicas=1, decode_replicas=1,
                        **kw) as jco:
        jouts = _serial(jco, prompts)
        jst = jco.stats()
    _assert_streams(outs, ref)
    _assert_streams(jouts, ref)
    assert st["migrations"] == jst["migrations"] == 3
    # 3 blocks of the 12-token prompt; the repeat matches 2 (the match
    # stops at (t-1)//B) and wires 1; the extension matches 3, wires 1
    assert st["migrated_blocks"] == jst["migrated_blocks"] == 5


def test_disagg_defers_under_pool_pressure(pair):
    """A decode pool that seats one chain at a time defers adoptions
    (FIFO) instead of failing them; every stream still completes
    exactly."""
    jm, tm = pair
    prompts = _prompts(sizes=(20, 24, 22), seed=3)
    kw = dict(slots=2, cache_len=32, block_len=4, max_new_tokens=6,
              prefill_buckets=(4, 8, 16), enable_prefix_cache=False,
              num_blocks=1 + 2 * 8)
    with JaxEngine(jm, **kw) as eng:
        ref = _serve_all(eng, prompts)
    with DisaggCoordinator(tm, prefill_replicas=1, decode_replicas=1,
                           device="cpu", **kw) as co:
        outs = _serve_all(co, prompts)
        st = co.stats()
    _assert_streams(outs, ref)
    assert st["migrations"] == st["adopted"] == len(prompts)
    assert co.decode[0].pool.free_count == co.decode[0].pool.capacity


def test_prefill_replica_refusals(pair):
    """A prefill replica neither speculates nor takes int8 KV arenas, in
    the reference's words."""
    jm, tm = pair
    kw = dict(slots=1, cache_len=48, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="cannot speculate"):
        LMServingEngine(tm, device="cpu", migrate=lambda *a: None,
                        spec=SpecConfig(k=2), **kw)
    with pytest.raises(ValueError, match="excludes disaggregated serving"):
        LMServingEngine(tm, device="cpu", migrate=lambda *a: None,
                        kv_quant="int8", **kw)
    with pytest.raises(ValueError, match="excludes disaggregated serving"):
        JaxEngine(jm, migrate=lambda *a: None, kv_quant="int8", **kw)


def test_coordinator_placement_refused_names_its_item(pair):
    """A phase on a slot of another rank is reached only through the
    driver of a process world: with none running, building the pair
    raises naming the missing world and the way to start one, and the
    policy gets its slot back."""
    from bigdl_tpu_torch.serving import (DeviceTopology, PlacementError,
                                         PlacementPolicy)
    _, tm = pair
    pol = PlacementPolicy(DeviceTopology(["cpu"] * 2, per_rank=True))
    with pytest.raises(PlacementError, match="no process world") as e:
        DisaggCoordinator(tm, placement=pol, **_ENG)
    assert "init_world" in str(e.value) and "ranks [0]" in str(e.value)
    assert pol.headroom() == 2


def test_try_scale_up_respects_max_replicas_per_phase(pair, colocated_ref):
    """Scale-up adds a replica to ONE phase up to its ceiling; past it
    the answer is falsy without side effects (the SLO ladder's
    fall-through); the grown pools still serve exactly."""
    _, tm = pair
    prompts, ref = colocated_ref
    with DisaggCoordinator(tm, prefill_replicas=1, decode_replicas=1,
                           max_replicas_per_phase=2, device="cpu",
                           **_ENG) as co:
        assert co.try_scale_up("decode") is True
        assert co.try_scale_up("decode") is False
        assert co.try_scale_up("prefill") is True
        assert co.try_scale_up("prefill") is False
        assert len(co.prefill) == len(co.decode) == 2
        assert co.decode_metrics.slots == co.prefill_metrics.slots == 4
        assert [e.name for e in co.decode] == ["disagg-decode0",
                                               "disagg-decode1"]
        with pytest.raises(ValueError, match="unknown phase"):
            co.try_scale_up("verify")
        _assert_streams(_serve_all(co, prompts), ref)
        st = co.stats()
        assert st["prefill_replicas"] == st["decode_replicas"] == 2
        assert st["migrations"] == len(prompts)
    assert co.try_scale_up("decode") is False       # closed


def test_slo_controllers_watch_per_phase_histograms(pair):
    """The two ladders actuate their own phase: hot TTFT grows the
    prefill pool, a hot decode gap the decode pool."""
    _, tm = pair
    with DisaggCoordinator(tm, prefill_replicas=1, decode_replicas=1,
                           max_replicas_per_phase=2, device="cpu",
                           **_ENG) as co:
        ttft_ctl, itl_ctl = co.slo_controllers(
            ttft_target_s=0.5, itl_target_s=0.05, window_intervals=2,
            hot_streak=2)
        assert ttft_ctl.histogram is co.prefill_metrics.ttft
        assert itl_ctl.histogram is co.decode_metrics.itl_decode
        for _ in range(4):
            co.prefill_metrics.ttft.observe(2.0)
            ttft_ctl.tick()
        assert len(co.prefill) == 2 and len(co.decode) == 1
        for _ in range(4):
            co.decode_metrics.itl_decode.observe(1.0)
            itl_ctl.tick()
        assert len(co.decode) == 2
        assert co.try_scale_up("prefill") is False
        assert co.try_scale_up("decode") is False
        reg = get_registry().snapshot()
        assert "serving/lm/prefill/ttft" in reg
        assert "serving/lm/decode/itl_decode" in reg


# --------------------------------------------------------------------------- #
# the serving.migrate fault site                                              #
# --------------------------------------------------------------------------- #

@pytest.fixture
def both_faults(monkeypatch):
    """Arm the same fault spec in both packages' injectors."""
    def _arm(spec: str, seed: int = 0):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        monkeypatch.setenv(faults.ENV_SEED, str(seed))
        return faults.refresh_from_env(), jfaults.refresh_from_env()

    yield _arm
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    monkeypatch.delenv(faults.ENV_SEED, raising=False)
    faults.refresh_from_env()
    jfaults.refresh_from_env()


@pytest.mark.parametrize("spec,expect", [
    ("serving.migrate:transient:count=2", "retried"),
    ("serving.migrate:backend_lost:p=0.5", "re_prefilled"),
])
def test_migrate_fault_matrix_zero_accepted_loss(pair, colocated_ref,
                                                 both_faults, spec, expect):
    """Transients retry the export under with_backoff; a lost backend
    drops the payload and the decode replica re-prefills.  Either way
    every stream completes exactly, counted as the JAX coordinator counts
    on the same spec and seed."""
    jm, tm = pair
    prompts, ref = colocated_ref
    kw = dict(_ENG, prefill_replicas=1, decode_replicas=1,
              migrate_base_delay_s=0.01)
    both_faults(spec, seed=3)
    with DisaggCoordinator(tm, device="cpu", **kw) as co:
        outs = _serial(co, prompts)
        st = co.stats()
    both_faults(spec, seed=3)
    with JaxCoordinator(jm, **kw) as jco:
        jouts = _serial(jco, prompts)
        jst = jco.stats()
    _assert_streams(outs, ref)
    _assert_streams(jouts, ref)
    assert _counts(st) == _counts(jst)
    assert st["migrations"] == st["decode"]["completed"] == len(prompts)
    assert get_registry().snapshot()["resilience/faults_injected"][
        "value"] > 0
    if expect == "retried":
        assert st["lost_payloads"] == 0 == st["re_prefills"]
        assert get_registry().snapshot()["resilience/retries"]["value"] == 2
    else:
        assert st["lost_payloads"] > 0
        assert st["re_prefills"] == st["lost_payloads"]


# --------------------------------------------------------------------------- #
# BlockPool.warmup_adopt                                                      #
# --------------------------------------------------------------------------- #

def test_warmup_adopt_aims_at_scratch_only():
    """Each width runs the adopt path once into the scratch block: no
    block is taken, no live row is written, the arenas stay put."""
    pool = BlockPool(n_layers=2, n_heads=2, head_dim=3, block_len=4,
                     num_blocks=8, device="cpu")
    ids = pool.alloc(2)
    pool.k[:, ids] = 1.0
    k0, v0 = pool.k.data_ptr(), pool.v.data_ptr()
    assert pool.warmup_adopt([1, 2, 4, 8, 0]) == 4
    assert pool.free_count == pool.capacity - 2
    assert (pool.k.data_ptr(), pool.v.data_ptr()) == (k0, v0)
    assert bool((pool.k[:, ids] == 1.0).all())
    q = BlockPool(n_layers=1, n_heads=2, head_dim=3, block_len=4,
                  num_blocks=4, device="cpu", kv_quant="int8")
    assert q.warmup_adopt([1, 2]) == 2


# --------------------------------------------------------------------------- #
# with_backoff and the retrying transfer (tests/test_resilience.py)           #
# --------------------------------------------------------------------------- #

def _counter(name):
    return get_registry().counter(name).value


def test_with_backoff_retries_then_escalates():
    for fn, lost, trans in ((with_backoff, BackendLostError,
                             TransientBackendError),
                            (jretry.with_backoff, jfaults.BackendLostError,
                             jfaults.TransientBackendError)):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise trans("UNAVAILABLE: relay wobble")
            return "ok"

        assert fn(flaky, retries=4, sleep=lambda s: None) == "ok"
        assert calls["n"] == 3

        def always():
            raise trans("UNAVAILABLE: forever")

        with pytest.raises(lost) as ei:
            fn(always, retries=2, sleep=lambda s: None)
        assert isinstance(ei.value.__cause__, trans)

        def broken():
            raise ValueError("a bug, not a backend")

        with pytest.raises(ValueError):
            fn(broken, retries=5, sleep=lambda s: None)
    assert _counter("resilience/retries") == 4
    assert _counter("resilience/backend_lost") == 1


@pytest.fixture
def inject(monkeypatch):
    def _inject(spec: str, seed: int = 0):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        monkeypatch.setenv(faults.ENV_SEED, str(seed))
        return faults.refresh_from_env()

    yield _inject
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    faults.refresh_from_env()


def test_transfer_retries_and_downshifts(inject):
    """A flaky slice retries with backoff and halves the chunk toward the
    floor; the assembled tensor is still exact."""
    inject("transfer.chunk:transient:count=3")
    x = np.random.RandomState(0).randn(64, 256).astype(np.float32)
    out = chunked_device_put(x, torch.float32, device="cpu",
                             chunk_bytes=16 << 10,        # 16 rows a slice
                             min_chunk_bytes=4 << 10)     # 4-row floor
    np.testing.assert_array_equal(out.numpy(), x)
    assert _counter("resilience/retries") == 3
    # 16K -> 8K -> 4K, then pinned at the floor
    assert _counter("resilience/transfer_downshifts") == 2
    st = faults.active().stats()
    assert st["transfer.chunk:transient:count=3"]["fired"] == 3


def test_transfer_relay_death_is_classified_not_hung(inject):
    inject("transfer.chunk:backend_lost:after=2")
    t0 = time.perf_counter()
    with pytest.raises(BackendLostError):
        chunked_device_put(np.zeros((64, 256), np.float32), torch.float32,
                           device="cpu", chunk_bytes=16 << 10)
    assert time.perf_counter() - t0 < 30.0
    assert _counter("resilience/backend_lost") >= 1


def test_transfer_exhausted_retries_escalate(inject):
    inject("transfer.chunk:transient")
    with pytest.raises(BackendLostError) as ei:
        chunked_device_put(np.zeros((8, 256), np.float32), torch.float32,
                           device="cpu", chunk_bytes=16 << 10,
                           max_retries=2)
    assert isinstance(ei.value.__cause__, TransientBackendError)


# --------------------------------------------------------------------------- #
# the SLO controller (tests/test_traffic.py)                                  #
# --------------------------------------------------------------------------- #

def test_windowed_percentile_from_counts():
    h, jh = Histogram(), jreg.Histogram()
    for hist in (h, jh):
        for _ in range(100):
            hist.observe(0.001)
    old, jold = h.counts(), jh.counts()
    for hist in (h, jh):
        for _ in range(100):
            hist.observe(1.0)
    delta = [a - b for a, b in zip(h.counts(), old)]
    jdelta = [a - b for a, b in zip(jh.counts(), jold)]
    assert delta == jdelta
    assert percentile_from_counts(delta, 99) == pytest.approx(1.0, rel=0.2)
    assert percentile_from_counts(delta, 99) == \
        jreg.percentile_from_counts(jdelta, 99)
    assert percentile_from_counts([0] * len(delta), 99) is None
    assert h.percentile(50) < 0.01


def _ladder(cls, hist_cls):
    h = hist_cls()
    acts = []
    up_budget = [2]

    def scale_up():
        if up_budget[0] > 0:
            up_budget[0] -= 1
            acts.append("up")
            return True
        return False

    c = cls(histogram=h, target_p99_s=0.1, window_intervals=4,
            scale_up=scale_up, set_admission=lambda v: acts.append(("adm", v)),
            admission_levels=[64, 16, 4], hot_streak=2, cool_streak=3)
    for _ in range(10):
        h.observe(0.5)
        c.tick()
    hot = (list(acts), [a["action"] for a in c.actions], c.summary())
    for _ in range(12):
        h.observe(0.001)
        c.tick()
    return hot, acts, [a["action"] for a in c.actions]


def test_slo_controller_scale_then_admission_ladder():
    port = _ladder(SLOController, Histogram)
    assert port == _ladder(JaxSLO, jreg.Histogram)
    (acts, actions, summary), after, _ = port
    assert acts == ["up", "up", ("adm", 16), ("adm", 4)]
    assert summary["scaling_exhausted"]
    assert actions == ["scale_up", "scale_up", "admission_tighten",
                       "admission_tighten", "saturated"]
    assert ("adm", 16) in after[4:] and ("adm", 64) in after[4:]


def _shedding(cls, hist_cls):
    h = hist_cls()
    rejected = [0]
    adm = []
    c = cls(histogram=h, target_p99_s=0.1, window_intervals=2,
            set_admission=adm.append, admission_levels=[64, 4],
            hot_streak=1, cool_streak=2, start_level=1,
            rejections=lambda: rejected[0])
    first = list(adm)
    for _ in range(8):
        rejected[0] += 3
        h.observe(0.001)
        c.tick()
    held = (list(adm), [a["action"] for a in c.actions])
    for _ in range(8):
        h.observe(0.001)
        c.tick()
    return first, held, adm


def test_slo_controller_holds_relax_while_shedding():
    port = _shedding(SLOController, Histogram)
    assert port == _shedding(JaxSLO, jreg.Histogram)
    first, (adm, actions), after = port
    assert first == [4] and adm == [4]
    assert all(a == "hold_shedding" for a in actions)
    assert after == [4, 64]


def test_slo_controller_idle_window_is_not_hot():
    h = Histogram()
    fired = []
    c = SLOController(histogram=h, target_p99_s=0.01, window_intervals=2,
                      set_admission=fired.append, admission_levels=[8, 2],
                      hot_streak=1, cool_streak=1)
    for _ in range(5):
        assert c.tick()["p99_s"] is None
    assert fired == [] and c.actions == []
    h.observe(5.0)
    c.tick()
    assert c.tick()["p99_s"] is not None
    for _ in range(3):
        c.tick()
    assert c.tick()["p99_s"] is None


def test_lm_slot_limit_caps_concurrency_token_exact(pair):
    """The slot limit is an admission cap: clamped to [1, slots], the
    decode step's shape untouched, every stream exact against the JAX
    package's offline generate."""
    jm, tm = pair
    eng = LMServingEngine(tm, device="cpu", slots=2, cache_len=24,
                          max_new_tokens=6, prefill_buckets=(4, 8))
    try:
        eng.warmup()
        assert eng.set_slot_limit(99) == 2
        assert eng.set_slot_limit(0) == 1
        assert eng.set_slot_limit(1) == 1 == eng.slot_limit
        eng.set_max_queue(7)
        assert eng.max_queue == 7
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 31, size=t).astype(np.int32)
                   for t in (4, 7, 5)]
        streams = [eng.submit(p, max_new_tokens=4) for p in prompts]
        for p, s in zip(prompts, streams):
            want = np.asarray(jax_generate(jm, jm.params,
                                           jnp.asarray(p[None]), 4))[0]
            np.testing.assert_array_equal(s.result(timeout=60), want)
        snap = eng.metrics.snapshot()
        assert snap["slot_occupancy"] is not None
        assert snap["slot_occupancy"] <= 0.5 + 1e-9
        st = eng.stats()
        assert st["slot_limit"] == 1 and st["max_queue"] == 7
        # two 16-token blocks a worst-case chain, 12 free: headroom 6
        assert eng.table_width == 2
        assert eng.kvcache_headroom() == eng.pool.free_count // 2 == 6
        assert eng.kvcache_stats()["table_width"] == 2
    finally:
        eng.close()
