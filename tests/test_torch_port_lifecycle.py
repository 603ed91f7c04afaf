"""bigdl_tpu_torch's request lifecycle, registry publishing and fault
sites on the CPU, against the JAX package (mirrors
``tests/test_lifecycle.py:63-226``, ``tests/test_lm_serving.py:298``,
``tests/test_spec_decode.py:249``/``:329``,
``tests/test_spec_tree.py:251``/``:344`` and ``tests/test_quant.py:218``).

The same seed-built params go through the JAX engine (or its offline
``generate``) and the port's engine, on the same tiny model (vocab 31,
hidden 16, 2 heads, 1 layer, rope) and engine arguments.  Streams are
token-exact; truncations the traffic fixes deterministically land at the
same token; ``lifecycle_stats()`` and the registry's key sets equal the
reference's.  Waits are on conditions with generous timeouts, never on
a short wall-clock window."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer.generate import generate as jax_generate
from bigdl_tpu.obs import registry as jreg
from bigdl_tpu.resilience import errors as jerrors
from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.serving.lm_engine import LMMetrics as JaxLMMetrics
from bigdl_tpu.serving.spec import SpecMetrics as JaxSpecMetrics

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import MetricRegistry, get_registry
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import (LMMetrics, LMServingEngine,
                                     ServingDeadlineExceeded,
                                     ServingOverloaded, SpecConfig,
                                     StreamTruncation)
from bigdl_tpu_torch.serving.spec import SpecMetrics
from bigdl_tpu_torch.utils.params import params_from_numpy

_ENG_KW = dict(slots=2, cache_len=56, max_new_tokens=12,
               prefill_buckets=(8, 16), block_len=4)
_PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test starts from an empty process-wide registry of the port
    (engines and stores re-register their names as they are built)."""
    get_registry().clear()
    yield


def _wait(pred, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


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
def refs(pair):
    jm, _ = pair
    out = {}
    for n in (4, 6, 12, 16):
        out[n] = np.asarray(jax_generate(
            jm, jm.params, jnp.asarray(_PROMPT[None]), n))[0]
    return out


@pytest.fixture
def both_faults(monkeypatch):
    """Arm the same fault spec in both packages' injectors (each reads
    ``BIGDL_TPU_FAULTS``); disarm both afterwards."""
    def _arm(spec: str, seed: int = 0):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        monkeypatch.setenv(faults.ENV_SEED, str(seed))
        return faults.refresh_from_env(), jfaults.refresh_from_env()

    yield _arm
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    monkeypatch.delenv(faults.ENV_SEED, raising=False)
    faults.refresh_from_env()
    jfaults.refresh_from_env()


def _port(tm, **kw):
    return LMServingEngine(tm, device="cpu", **dict(_ENG_KW, **kw))


# --------------------------------------------------------------------------- #
# deadlines and cancels on the same traffic, port against reference           #
# --------------------------------------------------------------------------- #

def _queued_behind(eng, prompt, **kw):
    """Occupy both slots with long decodes, then queue one more."""
    busy = [eng.submit(_PROMPT, max_new_tokens=12) for _ in range(2)]
    return busy, eng.submit(prompt, max_new_tokens=12, **kw)


def test_lifecycle_stats_equal_the_reference_on_fixed_traffic(
        pair, refs, both_faults):
    """Four deterministic lifecycle events on each engine: a budget of 0
    shed at enqueue, a request queued behind a full engine whose budget
    runs out in the queue (typed shed, never prefilled), a cancel while
    queued (quiet truncation, no token) and a ``serving.cancel`` fault
    (the client gone at the first round: truncated at 1 token).  The
    counters after each event, and every truncation point, are the
    reference's."""
    jm, tm = pair
    engines = (JaxEngine(jm, **_ENG_KW), _port(tm))
    try:
        def each(fn):
            return [fn(e) for e in engines]

        shed = (jerrors.ServingDeadlineExceeded, ServingDeadlineExceeded)
        for e, err in zip(engines, shed):
            with pytest.raises(err):
                e.submit(_PROMPT, deadline_s=0.0)
        j, t = each(lambda e: e.lifecycle_stats())
        assert j == t and t["expired_preadmission"] == 1

        for e, err in zip(engines, shed):
            busy, late = _queued_behind(e, _PROMPT + 1, deadline_s=0.001)
            with pytest.raises(err):
                late.result(timeout=60)
            assert len(late.generated) == 0
            for b in busy:
                np.testing.assert_array_equal(b.result(timeout=60),
                                              refs[12])
        j, t = each(lambda e: e.lifecycle_stats())
        assert j == t and t["expired_preadmission"] == 2

        for e in engines:
            busy, late = _queued_behind(e, _PROMPT + 2)
            assert late.cancel() is True
            late.result(timeout=60)
            assert late.truncation.reason == "cancelled"
            assert late.truncation.at_tokens == 0
            for b in busy:
                b.result(timeout=60)
        j, t = each(lambda e: e.lifecycle_stats())
        assert j == t and t["cancelled"] == 1

        both_faults("serving.cancel:transient:count=1")
        cut = []
        for e in engines:
            assert _wait(lambda: e.stats()["active"] == 0)
            s = e.submit(_PROMPT, max_new_tokens=12)
            out = s.result(timeout=60)
            cut.append((s.truncation.reason, s.truncation.at_tokens))
            np.testing.assert_array_equal(out, refs[12][:len(out)])
        assert cut[0] == cut[1] == ("cancelled", 1)
        j, t = each(lambda e: e.lifecycle_stats())
        assert j == t and t == {"expired_preadmission": 2,
                                "expired_midstream": 0, "cancelled": 2,
                                "wasted_decode_steps": 0}
    finally:
        for e in engines:
            e.close()


def test_ignored_lifecycle_counts_wasted_steps_like_the_reference(
        pair, refs, both_faults):
    """``honor_lifecycle=False``: a client gone at the first round is
    recorded, not acted on; the stream runs to its budget and every
    round it stays seated counts one wasted decode slot-step."""
    jm, tm = pair
    both_faults("serving.cancel:transient:count=1")
    stats = []
    for eng in (JaxEngine(jm, honor_lifecycle=False, **_ENG_KW),
                _port(tm, honor_lifecycle=False)):
        try:
            s = eng.submit(_PROMPT, max_new_tokens=6)
            np.testing.assert_array_equal(s.result(timeout=60), refs[6])
            assert s.cancel_requested and s.truncation is None
            stats.append(eng.lifecycle_stats())
        finally:
            eng.close()
    assert stats[0] == stats[1]
    assert stats[1]["wasted_decode_steps"] == 5
    assert stats[1]["cancelled"] == 0


# --------------------------------------------------------------------------- #
# the port's lifecycle (mirrors of tests/test_lifecycle.py:63-226)            #
# --------------------------------------------------------------------------- #

def test_deadline_generous_budget_completes_exact(pair, refs):
    _, tm = pair
    with _port(tm) as eng:
        s = eng.submit(_PROMPT, max_new_tokens=4, deadline_s=60.0)
        np.testing.assert_array_equal(s.result(timeout=60), refs[4])
        assert s.truncation is None
        assert s.remaining_s() is not None and not s.expired()
        assert isinstance(StreamTruncation("deadline", 3), StreamTruncation)


def test_deadline_midstream_truncates_prefix_exact(pair, refs,
                                                   both_faults):
    """A budget that runs out mid-decode finishes the stream cleanly
    (typed truncation, no error), its tokens the exact prefix of the
    uninterrupted answer.  A 50 ms latency at the per-round
    ``serving.cancel`` site slows every round (12 rounds take at least
    0.6 s), so the 0.3 s budget always dies mid-stream."""
    _, tm = pair
    with _port(tm) as eng:
        both_faults("serving.cancel:latency:ms=50")
        s = eng.submit(_PROMPT, max_new_tokens=12, deadline_s=0.3)
        out = s.result(timeout=60)
        assert s.truncation is not None
        assert s.truncation.reason == "deadline"
        assert s.truncation.at_tokens == len(s.generated) < 12
        np.testing.assert_array_equal(out, refs[12][:len(out)])
        assert _wait(lambda: eng.stats()["active"] == 0)
        assert eng.lifecycle_stats()["expired_midstream"] == 1


def test_cancel_frees_slot_and_conserves_refcounts(pair, refs):
    _, tm = pair
    with _port(tm, enable_prefix_cache=False) as eng:
        eng.generate(_PROMPT, max_new_tokens=2, timeout=60)
        assert _wait(lambda: eng.stats()["active"] == 0)
        idle_free = eng.pool.free_count
        s = eng.submit(_PROMPT, max_new_tokens=12)
        assert _wait(lambda: len(s.generated) >= 1)
        assert s.cancel() is True
        s.result(timeout=60)
        assert s.truncation.reason == "cancelled"
        assert _wait(lambda: eng.pool.free_count == idle_free)
        assert _wait(lambda: eng.stats()["active"] == 0)
        np.testing.assert_array_equal(
            eng.generate(_PROMPT, max_new_tokens=4, timeout=60), refs[4])
        assert eng.lifecycle_stats()["cancelled"] == 1
        assert s.cancel() is False                  # already done


def test_cancel_eos_same_round_race_conserves_pool(pair, refs):
    """A cancel landing the same round as EOS must neither leak nor
    double-free: free blocks plus the trie's come back to the pool's
    capacity every cycle."""
    _, tm = pair
    with _port(tm) as eng:
        full = eng.generate(_PROMPT, max_new_tokens=6, timeout=60)
        np.testing.assert_array_equal(full, refs[6])
        eos = int(full[len(_PROMPT)])  # EOS == the first generated token
        for i in range(8):
            s = eng.submit(_PROMPT, max_new_tokens=6, eos_id=eos)
            if i % 2:
                time.sleep(0.001 * (i % 4))
            s.cancel()
            s.result(timeout=60)
            assert _wait(lambda: eng.stats()["active"] == 0)
            assert _wait(lambda: eng.pool.free_count
                         + eng.radix.stats()["nodes"] == eng.pool.capacity)
        np.testing.assert_array_equal(
            eng.generate(_PROMPT, max_new_tokens=6, timeout=60), full)


def test_cancel_of_a_finished_stream_is_refused_and_close_drains(pair):
    """A cancel on a finished stream is refused; a stream submitted
    before close still resolves with its tokens."""
    _, tm = pair
    eng = _port(tm)
    s = eng.submit(_PROMPT, max_new_tokens=3)
    s.result(timeout=60)
    assert s.cancel() is False and not s.cancel_requested
    late = eng.submit(_PROMPT, max_new_tokens=3)
    eng.close(timeout=60)
    assert late.result(timeout=10).shape == (11,)


# --------------------------------------------------------------------------- #
# registry publishing and fault sites                                         #
# --------------------------------------------------------------------------- #

def test_lm_metrics_snapshot_and_registry(pair):
    reg = MetricRegistry()
    m = LMMetrics(slots=4).publish_to(reg)
    j = JaxLMMetrics(slots=4).publish_to(jreg.MetricRegistry())
    for x in (m, j):
        x.record_submit()
        x.record_first_token(0.010)
        x.record_step(2, [0.002, 0.003])
        x.record_step(1, [0.004], prefill_interrupted=True)
        x.record_complete()
    snap, jsnap = m.snapshot(), j.snapshot()
    assert snap["tokens"] == 4 and snap["completed"] == 1
    assert snap["slot_occupancy"] == 3 / 8
    for key in ("ttft", "itl", "itl_decode", "itl_prefill_gap"):
        assert snap[key] == jsnap[key]
    assert set(snap) == set(jsnap)
    rsnap = reg.snapshot()
    assert rsnap["serving/lm/slot_occupancy"]["value"] == 3 / 8
    fresh = jreg.MetricRegistry()
    JaxLMMetrics(slots=4).publish_to(fresh)
    assert set(reg.names()) == set(fresh.names())


def test_engine_registry_keys_equal_the_reference(pair):
    """An engine publishes the reference's ``serving/lm/*``,
    ``kvcache/*`` and ``serving/lifecycle/*`` names (the reference's
    memory-ledger names wait for that module's port)."""
    jm, tm = pair
    jeng = JaxEngine(jm, **_ENG_KW)
    try:
        jnames = jreg.MetricRegistry()
        jeng.metrics.publish_to(jnames)
        jeng._publish_kv_metrics(jnames)
        want = set(jnames.names()) | {f"serving/lifecycle/{k}"
                                      for k in jeng.lifecycle}
    finally:
        jeng.close()
    reg = get_registry()
    with _port(tm) as eng:
        got = {n for n in reg.names()
               if n.startswith(("serving/lm/", "kvcache/",
                                "serving/lifecycle/"))
               and not n.startswith("serving/lm/spec/")}
        assert want <= got
        assert got - want <= {n for n in got
                              if n.startswith("serving/lm/spec/")}
        snap = reg.snapshot()
        assert snap["kvcache/arena_bytes"]["value"] == eng.pool.arena_bytes
        eng.generate(_PROMPT, max_new_tokens=3, timeout=60)
        snap = reg.snapshot()
        assert snap["serving/lm/completed"]["value"] == 1
        assert snap["kvcache/prefix_hit_rate"]["value"] == 0.0


def test_spec_metrics_registry_keys_equal_the_reference():
    ours, theirs = MetricRegistry(), jreg.MetricRegistry()
    m = SpecMetrics().publish_to(ours)
    JaxSpecMetrics().publish_to(theirs)
    assert ours.names() == theirs.names()
    m.record_round(3, 2)
    m.record_verify_round(True, 3, 3)
    m.record_demotion(fault=True)
    snap = ours.snapshot()
    assert snap["serving/lm/spec/fault_demotions"]["value"] == 1
    assert snap["serving/lm/spec/demotions"]["value"] == 1
    assert snap["serving/lm/spec/accept_rate"]["value"] == 2 / 3
    assert set(m.snapshot()) == set(JaxSpecMetrics().snapshot())


@pytest.mark.parametrize("tree", [False, True])
def test_verify_fault_demotes_not_kills(pair, refs, both_faults, tree):
    """An injected transient at ``serving.verify`` demotes the
    speculating slots to plain decode for the round (typed, counted);
    the stream completes token-exact against JAX ``generate`` and the
    slot is re-probed."""
    _, tm = pair
    both_faults("serving.verify:transient:count=1")
    reg = get_registry()
    before = reg.counter("resilience/faults_injected").get()[0]
    eng = LMServingEngine(tm, device="cpu", slots=2, cache_len=48,
                          block_len=4, max_new_tokens=16,
                          prefill_buckets=(8,),
                          spec=SpecConfig(k=3, tree=tree, probe_interval=2))
    try:
        eng.warmup()
        p = np.arange(1, 7).astype(np.int32)
        want = np.asarray(jax_generate(pair[0], pair[0].params,
                                       jnp.asarray(p[None]), 16))[0]
        np.testing.assert_array_equal(
            eng.submit(p, max_new_tokens=16).result(timeout=60), want)
        spec = eng.stats()["spec"]
        assert spec["fault_demotions"] == 1
        assert spec["reprobes"] >= 1
        snap = reg.snapshot()
        assert snap["resilience/faults_injected"]["value"] == before + 1
        assert snap["serving/lm/spec/fault_demotions"]["value"] == 1
        if tree:
            for key in ("tree_rounds", "alt_accepts", "tree_depth",
                        "tree_width", "accepted_per_step",
                        "accepted_per_verify_step"):
                assert "serving/lm/spec/" + key in snap
    finally:
        eng.close()


def test_enqueue_fault_is_a_typed_shed(pair, both_faults):
    _, tm = pair
    reg = get_registry()
    with _port(tm) as eng:
        both_faults("serving.enqueue:transient:count=1")
        shed0 = reg.counter("serving/rejected_total").get()[0]
        with pytest.raises(ServingOverloaded, match="serving.enqueue"):
            eng.submit(_PROMPT, max_new_tokens=2)
        assert reg.counter("serving/rejected_total").get()[0] == shed0 + 1
        assert eng.stats()["metrics"]["rejected"] == 1
        assert eng.generate(_PROMPT, max_new_tokens=2,
                            timeout=60).shape == (10,)


def test_quant_gauges_published(pair):
    """``quantize()`` publishes the reference's ``quant/*`` gauges; the
    per-layer names follow the report's paths, which are the JAX
    package's."""
    jm, _ = pair
    kw = dict(vocab_size=97, hidden_size=32, n_head=2, n_layers=2,
              max_len=64, pos_encoding="learned")
    jq = JaxLM(attention_impl="xla", **kw).build(0).quantize("int8")
    tm = TransformerLM(device="cpu", **kw)
    tm.params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, JaxLM(attention_impl="xla", **kw).build(0).params), "cpu")
    q = tm.quantize("int8")
    snap = get_registry().snapshot()
    assert {"quant/bytes_saved", "quant/payload_ratio",
            "quant/max_abs_dequant_error"} <= set(snap)
    assert snap["quant/bytes_saved"]["value"] == \
        q.quant_report["bytes_saved"] == jq.quant_report["bytes_saved"]
    assert set(q.quant_report["per_layer_max_abs_err"]) == \
        set(jq.quant_report["per_layer_max_abs_err"])
    for path in q.quant_report["per_layer_max_abs_err"]:
        assert f"quant/max_abs_dequant_error/{path}" in snap


def test_registry_does_not_keep_a_closed_engine_alive(pair):
    """Neither the process-wide registry nor a finished stream the
    client still holds keeps a closed engine's arenas (or a dropped
    store's payloads) alive: the registry reads the KV gauges as None."""
    import gc
    import weakref

    from bigdl_tpu_torch.serving import HostBlockStore
    _, tm = pair
    store = HostBlockStore(host_bytes=1 << 20, name="tp-weak")
    eng = _port(tm, kvtier=store)
    kept = eng.submit(_PROMPT, max_new_tokens=2)
    kept.result(timeout=60)
    refs = [weakref.ref(eng.pool), weakref.ref(store)]
    eng.close()
    del eng, store
    gc.collect()
    assert all(r() is None for r in refs)
    assert kept.cancel() is False
    snap = get_registry().snapshot()
    assert snap["kvtier/tp-weak/entries"]["value"] is None
    assert snap["kvtier/tp-weak/demotions"]["value"] == 0
