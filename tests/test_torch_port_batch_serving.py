"""bigdl_tpu_torch's padded-batch serving stack on the CPU, against the
JAX package: ``DynamicBatcher``, ``CompileCache`` bookkeeping,
``ServingEngine``, ``ServingMetrics`` and ``HostStager`` (mirrors
``tests/test_serving.py`` but the ``bench.py`` CLI test,
``tests/test_lifecycle.py:228``, ``:251`` and ``:277``,
``tests/test_traffic.py:132`` and ``:160``, ``tests/test_flight.py:251``,
``:304``, ``:343`` and ``:400``, and ``tests/test_obs.py:284``, ``:304``
and ``:486``).

Both packages build the served model from the same seed (bitwise equal
params), so the engines' answers are compared to the reference's at
float32 tolerances.  The slice as a whole: a 2-layer, 32-wide
``TransformerLM`` scored through both packages' ``ServingEngine`` on the
same params, within the LM tests' atol/rtol 1e-4.  Races the reference's
tests leave to the wall clock are driven by events or a virtual clock
here."""
import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving import CompileCache as JaxCompileCache
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.batcher import \
    power_of_two_buckets as jax_power_of_two_buckets
from bigdl_tpu.serving.metrics import LatencyHistogram as JaxHistogram

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import MetricRegistry, get_registry, get_tracer
from bigdl_tpu_torch.obs import flight as flight_mod
from bigdl_tpu_torch.resilience import (ServingDeadlineExceeded,
                                        ServingOverloaded, classify_error,
                                        faults)
from bigdl_tpu_torch.serving import (CompileCache, DynamicBatcher,
                                     HostStager, ServingClosed,
                                     ServingEngine, ServingQueueFull,
                                     power_of_two_buckets)
from bigdl_tpu_torch.serving.batcher import count_rejection
from bigdl_tpu_torch.serving.compile_cache import GraphPool
from bigdl_tpu_torch.serving.metrics import LatencyHistogram, ServingMetrics
from bigdl_tpu_torch.utils.params import params_from_numpy

from test_torch_port_flight import repo_state

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
sys.path.insert(0, os.path.join(REPO, "scripts"))
from validate_trace import validate_trace  # noqa: E402

CPU = dict(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def repo_left_alone():
    before = repo_state()
    yield
    assert repo_state() == before


@pytest.fixture
def inject(monkeypatch):
    def _inject(spec: str, seed: int = 0):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        monkeypatch.setenv(faults.ENV_SEED, str(seed))
        return faults.refresh_from_env()

    yield _inject
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    monkeypatch.delenv(faults.ENV_SEED, raising=False)
    faults.refresh_from_env()


@pytest.fixture
def global_trace():
    tr = get_tracer()
    was, rate = tr.enabled, tr.sample_rate
    tr.clear()
    tr.enable()
    tr.set_sample_rate(1.0)
    yield tr
    tr.enabled = was
    tr.set_sample_rate(rate)
    tr.clear()


@pytest.fixture
def recorder(tmp_path):
    old = flight_mod.get_flight_recorder()
    rec = flight_mod.configure(
        enabled=True, out_dir=str(tmp_path),
        incidents_path=str(tmp_path / "TUNNEL_INCIDENTS.json"))
    yield rec
    flight_mod._GLOBAL = old


def _counter(name):
    return get_registry().counter(name).value


def _tiny(seed=0):
    """The reference tests' model, in both packages, from one seed."""
    return (jnn.Sequential(jnn.Linear(8, 4), jnn.LogSoftMax()).build(seed),
            nn.Sequential(nn.Linear(8, 4), nn.LogSoftMax()).build(seed, **CPU))


def _wedged_run():
    """A run_batch that blocks until released, and the event it sets
    once a batch is inside it."""
    release, entered = threading.Event(), threading.Event()

    def run(x):
        entered.set()
        release.wait(30)
        return x

    return run, release, entered


# --------------------------------------------------------------------------- #
# batcher                                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [1, 5, 24, 32, 33])
def test_power_of_two_buckets(n):
    assert power_of_two_buckets(n) == jax_power_of_two_buckets(n)
    assert power_of_two_buckets(32) == (1, 2, 4, 8, 16, 32)


def test_batcher_empty_queue_timeout_flush():
    """A lone request flushes when its wait budget expires."""
    b = DynamicBatcher(lambda x: x * 2, max_batch_size=64, max_wait_ms=20)
    try:
        y = b.submit(np.ones((3, 2), np.float32)).result(timeout=10)
        np.testing.assert_allclose(y, 2 * np.ones((3, 2)))
    finally:
        b.close()


def test_batcher_pads_to_buckets_and_slices_back():
    shapes = []

    def run(x):
        shapes.append(x.shape)
        return x + 1

    b = DynamicBatcher(run, max_batch_size=16, max_wait_ms=1)
    try:
        for n in (1, 3, 5, 7, 11):
            y = b.submit(np.full((n, 4), n, np.float32)).result(timeout=10)
            assert y.shape == (n, 4)
            np.testing.assert_allclose(y, n + 1)
        assert all(s[0] in (1, 2, 4, 8, 16) for s in shapes), shapes
    finally:
        b.close()


def test_batcher_request_larger_than_max_batch():
    shapes = []

    def run(x):
        shapes.append(x.shape)
        return x * 10

    b = DynamicBatcher(run, max_batch_size=8, max_wait_ms=1)
    try:
        x = np.arange(20 * 3, dtype=np.float32).reshape(20, 3)
        np.testing.assert_allclose(b.submit(x).result(timeout=10), x * 10)
        assert [s[0] for s in shapes] == [8, 8, 4]
    finally:
        b.close()


def test_batcher_queue_full_rejection():
    run, release, entered = _wedged_run()
    m = ServingMetrics()
    b = DynamicBatcher(run, max_batch_size=1, max_wait_ms=0, max_queue=4,
                       metrics=m)
    try:
        first = b.submit(np.ones((1, 2), np.float32))
        assert entered.wait(timeout=10)  # the worker is inside run()
        held = [b.submit(np.ones((1, 2), np.float32)) for _ in range(4)]
        with pytest.raises(ServingQueueFull):
            b.submit(np.ones((1, 2), np.float32))
        assert m.rejected == 1 and m.requests == 5
        release.set()
        for f in [first] + held:
            f.result(timeout=10)
    finally:
        release.set()
        b.close()


def test_batcher_response_order_matches_submission_order():
    done_order = []
    b = DynamicBatcher(lambda x: x, max_batch_size=4, max_wait_ms=5)
    try:
        futs = []
        for i in range(24):
            f = b.submit(np.full((1, 2), i, np.float32))
            f.add_done_callback(lambda _f, i=i: done_order.append(i))
            futs.append(f)
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=10), i)
        assert done_order == sorted(done_order)
    finally:
        b.close()


def test_batcher_close_rejects_new_and_drains_pending():
    b = DynamicBatcher(lambda x: x, max_batch_size=4, max_wait_ms=1)
    f = b.submit(np.ones((2, 2), np.float32))
    b.close()
    assert f.result(timeout=10).shape == (2, 2)
    with pytest.raises(ServingClosed):
        b.submit(np.ones((1, 2), np.float32))


def test_batcher_close_timeout_resolves_inflight_and_queued():
    """close() against a wedged dispatch resolves every accepted future
    with ServingClosed; the late completion afterwards is a no-op."""
    run, release, entered = _wedged_run()
    b = DynamicBatcher(run, max_batch_size=2, max_wait_ms=1)
    try:
        futs = [b.submit(np.ones((1, 3), np.float32)) for _ in range(5)]
        assert entered.wait(timeout=10)
        b.close(timeout=0.3)
        for f in futs:
            with pytest.raises(ServingClosed):
                f.result(timeout=5)
    finally:
        release.set()


def test_batcher_run_error_propagates_to_futures():
    def run(x):
        raise RuntimeError("device fell over")

    b = DynamicBatcher(run, max_batch_size=4, max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="device fell over"):
            b.submit(np.ones((1, 2), np.float32)).result(timeout=10)
    finally:
        b.close()


def test_batcher_pytree_output_slice_back():
    def run(x):
        return {"a": x + 1, "b": (x[:, :1] * 2, x.sum(axis=1))}

    b = DynamicBatcher(run, max_batch_size=8, max_wait_ms=1)
    try:
        for n in (1, 3, 20):
            x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
            y = b.submit(x).result(timeout=10)
            assert set(y) == {"a", "b"}
            np.testing.assert_allclose(y["a"], x + 1)
            np.testing.assert_allclose(y["b"][0], x[:, :1] * 2)
            np.testing.assert_allclose(y["b"][1], x.sum(axis=1))
    finally:
        b.close()


# --------------------------------------------------------------------------- #
# batcher lifecycle (tests/test_lifecycle.py:228-296)                         #
# --------------------------------------------------------------------------- #

def test_batcher_deadline_preadmission_and_queued_expiry():
    run, release, entered = _wedged_run()
    b = DynamicBatcher(run, max_batch_size=1, max_wait_ms=1)
    try:
        with pytest.raises(ServingDeadlineExceeded):
            b.submit(np.ones((1, 2), np.float32), deadline_s=0.0)
        f1 = b.submit(np.ones((1, 2), np.float32))
        assert entered.wait(timeout=10)           # the worker is wedged
        f2 = b.submit(np.ones((1, 2), np.float32), deadline_s=0.01)
        until = time.monotonic() + 0.02
        while time.monotonic() < until:           # f2's budget runs out
            time.sleep(0.005)                     # while it is queued
        release.set()
        assert f1.result(timeout=10).shape == (1, 2)
        with pytest.raises(ServingDeadlineExceeded):
            f2.result(timeout=10)
    finally:
        release.set()
        b.close()


def test_batcher_close_drains_precancelled_future():
    run, release, entered = _wedged_run()
    b = DynamicBatcher(run, max_batch_size=1, max_wait_ms=1)
    f1 = b.submit(np.ones((1, 2), np.float32))
    assert entered.wait(timeout=10)
    f2 = b.submit(np.ones((1, 2), np.float32))
    f3 = b.submit(np.ones((1, 2), np.float32))
    assert f2.cancel()          # the client walks away while queued
    release.set()
    b.close()
    assert f1.result(timeout=10).shape == (1, 2)
    assert f2.cancelled()
    assert f3.result(timeout=10).shape == (1, 2)   # drained, not dropped


def test_batcher_cancelled_future_skipped_at_assembly():
    seen = []
    release, entered = threading.Event(), threading.Event()

    def run(x):
        seen.append(int(x.shape[0]))
        entered.set()
        release.wait(30)
        return x

    b = DynamicBatcher(run, max_batch_size=8, max_wait_ms=1)
    try:
        blocker = b.submit(np.ones((1, 2), np.float32))
        assert entered.wait(timeout=10)
        f = b.submit(np.ones((3, 2), np.float32))
        assert f.cancel()
        release.set()
        blocker.result(timeout=10)
        g = b.submit(np.ones((2, 2), np.float32))
        assert g.result(timeout=10).shape == (2, 2)
        assert seen == [1, 2]    # nothing dispatched for the dead future
        assert _counter("serving/lifecycle/cancelled") >= 1
    finally:
        release.set()
        b.close()


# --------------------------------------------------------------------------- #
# typed sheds (tests/test_traffic.py:132, :160)                               #
# --------------------------------------------------------------------------- #

def test_queue_full_is_typed_and_counted():
    run, release, entered = _wedged_run()
    b = DynamicBatcher(run, max_batch_size=4, max_wait_ms=0.0, max_queue=1,
                       pool=None)
    try:
        before = _counter("serving/rejected_total")
        b.submit(np.zeros((1, 4), np.float32))
        assert entered.wait(timeout=10)
        b.submit(np.zeros((1, 4), np.float32))       # fills the queue
        sheds = 0
        for _ in range(8):
            try:
                b.submit(np.zeros((1, 4), np.float32))
            except ServingQueueFull as e:
                assert isinstance(e, ServingOverloaded)
                assert classify_error(e) == "transient"
                sheds += 1
        assert sheds == 8
        assert _counter("serving/rejected_total") - before == sheds
    finally:
        release.set()
        b.close()


@pytest.mark.faults
def test_serving_enqueue_injection_converts_to_shed(inject):
    inject("serving.enqueue:transient:count=2")
    b = DynamicBatcher(lambda x: x, max_batch_size=4, max_wait_ms=0.0,
                       max_queue=8, pool=None)
    try:
        before = _counter("serving/rejected_total")
        for _ in range(2):
            with pytest.raises(ServingOverloaded):
                b.submit(np.zeros((1, 4), np.float32))
        assert _counter("serving/rejected_total") - before == 2
        np.testing.assert_allclose(
            b.submit(np.ones((2, 4), np.float32)).result(timeout=30),
            np.ones((2, 4), np.float32))
    finally:
        b.close()


def test_batcher_shed_reaches_recorder(tmp_path, recorder):
    recorder.shed_burst_threshold = 3
    for _ in range(3):
        count_rejection()
    assert len(list(tmp_path.glob("FLIGHT_*.json"))) == 1


# --------------------------------------------------------------------------- #
# compile cache bookkeeping against the reference's                           #
# --------------------------------------------------------------------------- #

def _caches(max_entries):
    jm, tm = _tiny()

    def jinfer(params, buffers, x):
        return jm.apply(params, x, buffers=buffers, training=False)[0]

    def tinfer(params, buffers, x):
        return tm.apply(params, x, buffers=buffers, training=False)[0]

    return (jm, JaxCompileCache(jinfer, max_entries=max_entries), tm,
            CompileCache(tinfer, graphs=GraphPool("cpu", False),
                         max_entries=max_entries))


def test_compile_cache_counters_and_warmup():
    jm, jc, tm, tc = _caches(8)
    import jax.numpy as jnp
    assert jc.warmup(jm.params, jm.buffers, [(1, 8), (4, 8)],
                     jnp.float32) == 2
    assert tc.warmup_inputs(tm.params, tm.buffers,
                            [np.zeros((1, 8), np.float32),
                             np.zeros((4, 8), np.float32)]) == 2
    x = np.ones((4, 8), np.float32)
    np.testing.assert_allclose(tc(tm.params, tm.buffers, x).numpy(),
                               np.asarray(jc(jm.params, jm.buffers, x)),
                               **TOL)
    for n in (2, 4, 2):
        x = np.ones((n, 8), np.float32)
        jc(jm.params, jm.buffers, x)
        tc(tm.params, tm.buffers, x)
    js, ts = jc.stats(), tc.stats()
    for k in ("entries", "hits", "misses", "evictions", "hit_rate"):
        assert js[k] == ts[k], k


def test_compile_cache_lru_eviction():
    jm, jc, tm, tc = _caches(2)
    for n in (1, 2, 4, 1):
        x = np.ones((n, 8), np.float32)
        jc(jm.params, jm.buffers, x)
        tc(tm.params, tm.buffers, x)
    js, ts = jc.stats(), tc.stats()
    assert ts["entries"] == 2 and ts["evictions"] == 2 and ts["misses"] == 4
    for k in ("entries", "hits", "misses", "evictions"):
        assert js[k] == ts[k], k


# --------------------------------------------------------------------------- #
# the engine                                                                  #
# --------------------------------------------------------------------------- #

def test_smoke_single_request_through_full_engine():
    """One request through warmup -> batcher -> cache -> staging ->
    device -> response, equal to the reference's engine."""
    jm, tm = _tiny()
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    with JaxServingEngine(jm, input_shape=(8,), max_batch_size=8,
                          max_wait_ms=2.0) as jeng:
        jeng.warmup()
        want = jeng.predict(x, timeout=60)
    with ServingEngine(tm, input_shape=(8,), max_batch_size=8,
                       max_wait_ms=2.0, **CPU) as eng:
        assert eng.warmup() == len(eng.batcher.buckets) == 4
        y = eng.predict(x, timeout=60)
        assert isinstance(y, np.ndarray) and y.dtype == np.float32
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(y, tm.evaluate().forward(x).numpy(),
                                   atol=1e-6)
        one = eng.predict_one(x[0], timeout=60)
        np.testing.assert_allclose(one, want[0], **TOL)
        st = eng.stats()
        assert st["compile_cache"]["hit_rate"] == 1.0
        assert st["metrics"]["examples"] == 4
        assert st["host_transfer"]["batches_staged"] >= 2
        assert st["cuda_graphs"]["enabled"] is False
    with pytest.raises(ServingClosed):
        eng.submit(x)


def test_engine_mixed_sizes_hit_rate_after_warmup():
    jm, tm = _tiny()
    rng = np.random.RandomState(1)
    xs = [rng.randn(n, 8).astype(np.float32)
          for n in (1, 3, 5, 7, 9, 16, 2, 11, 4, 8)]
    with JaxServingEngine(jm, input_shape=(8,), max_batch_size=16,
                          max_wait_ms=1.0) as jeng:
        want = [jeng.predict(x, timeout=60) for x in xs]
    with ServingEngine(tm, input_shape=(8,), max_batch_size=16,
                       max_wait_ms=1.0, **CPU) as eng:
        eng.warmup()
        futs = [eng.submit(x) for x in xs]
        for f, w in zip(futs, want):
            np.testing.assert_allclose(f.result(timeout=60), w, **TOL)
        s = eng.stats()
        assert s["compile_cache"]["hit_rate"] == 1.0
        occ = s["metrics"]["batch_occupancy"]
        assert occ is not None and 0 < occ <= 1.0


def test_module_serve_convenience():
    _, tm = _tiny()
    eng = tm.serve(input_shape=(8,), max_batch_size=4, max_wait_ms=1.0)
    try:
        assert eng.device == torch.device("cpu")
        assert eng.predict(np.zeros((2, 8), np.float32),
                           timeout=60).shape == (2, 4)
    finally:
        eng.close()


def test_engine_refuses_what_the_port_does_not_do():
    _, tm = _tiny()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(tm)              # the card unless asked
    # a slot another rank holds (placement itself is ported)
    from bigdl_tpu_torch.serving import MeshSlice, PlacementError
    with pytest.raises(PlacementError, match="not by this process"):
        ServingEngine(tm, placement=MeshSlice(1, ["cpu"], 1, (1,),
                                              per_rank=True))
    with pytest.raises(ValueError, match="CUDA device"):
        ServingEngine(tm, cuda_graphs=True, **CPU)
    with pytest.raises(ValueError, match="device="):
        ServingEngine(tm, platform="cpu", **CPU)
    with pytest.raises(ValueError, match="bucket"):
        ServingEngine(tm, buckets=(1, 2), max_batch_size=4, **CPU)


def test_host_stager_chunks_and_counts():
    st = HostStager(np.float32, chunk_bytes=7 * 4 * 5, device="cpu")
    x = np.random.RandomState(0).randn(64, 7)
    y = st.stage(x)                       # float64 -> float32 on the wire
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), x.astype(np.float32))
    st.count(np.zeros((2, 7), np.float32))
    assert st.stats() == {"bytes_staged": 66 * 7 * 4, "batches_staged": 2,
                          "chunk_bytes": 140}


def test_host_stager_defaults_to_the_card():
    """The stager lands batches on the card unless the caller asks for
    the host, as the reference's lands them on its accelerator; here,
    with no card, the default raises ``resolve_device``'s error, and
    ``device="cpu"`` stages the rows bitwise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HostStager(np.float32)
    else:
        assert HostStager(np.float32).device.type == "cuda"
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    y = HostStager(np.float32, device="cpu").stage(x)
    assert y.device == torch.device("cpu")
    np.testing.assert_array_equal(y.numpy(), x)


class _TwoHeaded:
    """A duck-typed built module with a nested output (both packages)."""

    def __init__(self, lib_nn, seed=0, **kw):
        self._inner = lib_nn.Sequential(lib_nn.Linear(8, 4),
                                        lib_nn.LogSoftMax()).build(seed, **kw)
        self.params = self._inner.params
        self.buffers = self._inner.buffers

    def _built(self):
        return True

    def apply(self, params, x, buffers=None, training=False, rng=None):
        y, buffers = self._inner.apply(params, x, buffers=buffers,
                                       training=training, rng=rng)
        return {"cls": y, "reg": (y[:, :2] * 2.0, y.sum(1))}, buffers


def test_engine_pytree_outputs_end_to_end():
    jmodel, tmodel = _TwoHeaded(jnn), _TwoHeaded(nn, device="cpu")
    rng = np.random.RandomState(0)
    xs = [rng.randn(n, 8).astype(np.float32) for n in (1, 5, 20)]
    with JaxServingEngine(jmodel, input_shape=(8,), max_batch_size=8,
                          max_wait_ms=1.0) as jeng:
        want = [jeng.predict(x, timeout=120) for x in xs]
    with ServingEngine(tmodel, input_shape=(8,), max_batch_size=8,
                       max_wait_ms=1.0, **CPU) as eng:
        eng.warmup()
        for x, w in zip(xs, want):
            y = eng.predict(x, timeout=120)
            assert set(y) == {"cls", "reg"}
            assert isinstance(y["cls"], np.ndarray)
            for a, b in zip(jax.tree_util.tree_leaves(w),
                            jax.tree_util.tree_leaves(y)):
                np.testing.assert_allclose(b, a, **TOL)
        one = eng.predict_one(rng.randn(8).astype(np.float32), timeout=120)
        assert one["cls"].shape == (4,) and one["reg"][1].shape == ()


def test_engine_rejects_output_leaf_without_batch_dim():
    class _Bad(_TwoHeaded):
        def apply(self, params, x, buffers=None, training=False, rng=None):
            out, b = super().apply(params, x, buffers=buffers,
                                   training=training, rng=rng)
            return {"ok": out["cls"], "scalar": out["cls"].sum()}, b

    with ServingEngine(_Bad(nn, device="cpu"), input_shape=(8,),
                       max_batch_size=4, max_wait_ms=1.0, **CPU) as eng:
        with pytest.raises(TypeError, match="leading batch dim"):
            eng.predict(np.zeros((3, 8), np.float32), timeout=120)


def test_quantized_module_serves_its_int8_payload():
    jm, tm = (jnn.Sequential(jnn.Linear(8, 32), jnn.LogSoftMax()).build(0),
              nn.Sequential(nn.Linear(8, 32), nn.LogSoftMax()).build(0, **CPU))
    jq, tq = jm.quantize(), tm.quantize()
    x = np.random.RandomState(3).randn(5, 8).astype(np.float32)
    with JaxServingEngine(jq, input_shape=(8,), max_batch_size=8) as jeng:
        want = jeng.predict(x, timeout=60)
        jst = jeng.stats()
    with ServingEngine(tq, input_shape=(8,), max_batch_size=8, **CPU) as eng:
        y = eng.predict(x, timeout=60)
        st = eng.stats()
    assert st["quant_dtype"] == jst["quant_dtype"] == "int8"
    assert st["quant_bytes_staged"] == jst["quant_bytes_staged"] > 0
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(y, tq.forward(x).numpy(), atol=1e-6)


def test_serving_concurrent_clients():
    """Four threads on one engine: every response correct, throughput
    accounted (the reference's soak, at a tier-1 size)."""
    _, tm = _tiny()
    errs = []
    with ServingEngine(tm, input_shape=(8,), max_batch_size=16,
                       max_wait_ms=2.0, max_queue=1024, **CPU) as eng:
        eng.warmup()

        def client(seed):
            rng = np.random.RandomState(seed)
            try:
                for _ in range(10):
                    x = rng.randn(int(rng.randint(1, 9)), 8).astype(
                        np.float32)
                    np.testing.assert_allclose(
                        eng.predict(x, timeout=120),
                        tm.evaluate().forward(x).numpy(), atol=1e-6)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs, errs
        snap = eng.stats()
        assert snap["metrics"]["requests"] == 40
        assert snap["compile_cache"]["hit_rate"] == 1.0
        assert snap["metrics"]["throughput_eps"] > 0


# --------------------------------------------------------------------------- #
# the slice as a whole: TransformerLM scoring through both engines            #
# --------------------------------------------------------------------------- #

_LM_KW = dict(vocab_size=61, hidden_size=32, n_head=2, n_layers=2,
              max_len=16)


def test_transformer_lm_scores_through_both_engines():
    """(B, T) 1-based ids in, (B, T, V) log-probs out: a mixed-size
    request list through the reference's and the port's padded engine
    on the same params, within atol/rtol 1e-4."""
    jm = JaxLM(attention_impl="xla", **_LM_KW).build(seed=0)
    tm = TransformerLM(device="cpu", **_LM_KW)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    rng = np.random.RandomState(4)
    xs = [rng.randint(1, 62, size=(n, 16)).astype(np.float32)
          for n in (1, 3, 2, 4, 1, 7)]
    kw = dict(input_shape=(16,), max_batch_size=4, max_wait_ms=1.0)
    with JaxServingEngine(jm, **kw) as jeng:
        want = [jeng.predict(x, timeout=120) for x in xs]
    with ServingEngine(tm, **kw, **CPU) as eng:
        assert eng.warmup() == 3
        futs = [eng.submit(x) for x in xs]
        got = [f.result(timeout=120) for f in futs]
        assert eng.stats()["compile_cache"]["hit_rate"] == 1.0
    for g, w, x in zip(got, want, xs):
        assert g.shape == (x.shape[0], 16, 61)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# metrics (tests/test_serving.py, tests/test_obs.py:284, :304)                #
# --------------------------------------------------------------------------- #

def test_latency_histogram_percentiles_equal_the_reference():
    h, jh = LatencyHistogram(), JaxHistogram()
    assert h.percentile(50) is None
    for ms in range(1, 101):
        h.observe(ms / 1000.0)
        jh.observe(ms / 1000.0)
    for p in (50, 90, 99):
        assert h.percentile(p) == jh.percentile(p)
    assert 0.045 <= h.percentile(50) <= 0.06
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["max_s"] == pytest.approx(0.1)


def test_metrics_export_through_visualization(tmp_path):
    from bigdl_tpu_torch.visualization import ServingSummary
    m = ServingMetrics()
    m.record_submit()
    m.record_batch(3, 4, [0.001, 0.002, 0.003], 0.01)
    m.record_done(0.012)
    s = ServingSummary(str(tmp_path), "serve_app")
    assert s.folder.endswith(os.path.join("serve_app", "serving"))
    m.export_to_summary(s, step=1, cache_stats={"hit_rate": 1.0,
                                                "hits": 3, "misses": 0})
    assert len(s.read_scalar("Serving/ThroughputEPS")) == 1
    assert s.read_scalar("Serving/CacheHitRate")[0][1] == 1.0
    assert s.read_scalar("Serving/LatencyP50")[0][1] == pytest.approx(
        0.012, rel=0.2)
    s.close()


def test_serving_throughput_uses_sliding_window(monkeypatch):
    """On a virtual clock: a burst ages out of the 0.2 s window."""
    import bigdl_tpu_torch.serving.metrics as metrics_mod
    now = [100.0]

    class _Clock:
        @staticmethod
        def perf_counter():
            return now[0]

    monkeypatch.setattr(metrics_mod, "time", _Clock)
    sm = ServingMetrics(throughput_window_s=0.2)
    now[0] += 0.05
    sm.record_batch(100, 128, [0.001], 0.002)
    snap = sm.snapshot()
    assert snap["throughput_eps"] == pytest.approx(100 / 0.05)
    assert snap["throughput_window_s"] == 0.2
    now[0] += 0.3
    snap2 = sm.snapshot()
    assert snap2["throughput_eps"] == 0.0
    assert snap2["throughput_eps_lifetime"] == pytest.approx(100 / 0.35)
    sm.record_batch(50, 64, [0.001], 0.002)
    assert sm.snapshot()["throughput_eps"] == pytest.approx(50 / 0.2)


def test_serving_metrics_publish_to_registry():
    reg = MetricRegistry()
    sm = ServingMetrics().publish_to(reg)
    sm.record_submit()
    sm.record_batch(4, 8, [0.001, 0.002], 0.003)
    snap = reg.snapshot()
    assert snap["serving/requests"]["value"] == 1
    assert snap["serving/examples"]["value"] == 4
    assert snap["serving/device_time"]["count"] == 1
    assert snap["serving/throughput_eps"]["value"] > 0


# --------------------------------------------------------------------------- #
# tracing (tests/test_flight.py:304, :343, :400; tests/test_obs.py:486)       #
# --------------------------------------------------------------------------- #

def test_batch_serving_request_span_trees(global_trace, tmp_path):
    _, tm = _tiny(1)
    rng = np.random.RandomState(0)
    with ServingEngine(tm, input_shape=(8,), max_batch_size=8,
                       max_wait_ms=2.0, **CPU) as eng:
        eng.warmup()
        futs = [eng.submit(rng.randn(n, 8).astype(np.float32))
                for n in (1, 3, 2)]
        for f in futs:
            f.result(timeout=30)
    rids = [f.request_id for f in futs]
    assert len(set(rids)) == 3 and all(rids)
    for rid in rids:
        tree = global_trace.span_tree(rid)
        root = next(n for n in tree["spans"] if n["name"] == "serve/request")
        child_names = {c["name"] for c in root["children"]}
        assert "serve/queue_wait" in child_names
        assert {"serve/assemble", "serve/device"} & child_names
    path = str(tmp_path / "TRACE_REQ.json")
    doc = global_trace.export_request(rids[0], path)
    assert doc["otherData"]["request_id"] == rids[0]
    for e in json.loads(open(path).read())["traceEvents"]:
        if e["ph"] == "M":
            continue
        args = e.get("args", {})
        assert (args.get("request_id") == rids[0]
                or rids[0] in args.get("request_ids", []))


def test_request_ids_minted_even_when_tracing_off():
    tr = get_tracer()
    was = tr.enabled
    tr.enabled = False
    try:
        _, tm = _tiny(1)
        with ServingEngine(tm, input_shape=(8,), max_batch_size=4,
                           max_wait_ms=1.0, **CPU) as eng:
            fut = eng.submit(np.zeros((1, 8), np.float32))
            fut.result(timeout=30)
        assert fut.request_id
    finally:
        tr.enabled = was


def test_sample_rate_zero_keeps_serving_untraced(global_trace):
    global_trace.set_sample_rate(0.0)
    _, tm = _tiny(1)
    with ServingEngine(tm, input_shape=(8,), max_batch_size=4,
                       max_wait_ms=1.0, **CPU) as eng:
        fut = eng.submit(np.zeros((2, 8), np.float32))
        fut.result(timeout=30)
    assert fut.request_id
    assert global_trace.request_events(fut.request_id) == []
    assert global_trace.span_tree(fut.request_id)["span_count"] == 0


def test_serving_smoke_emits_full_phase_trace(global_trace, tmp_path):
    _, tm = _tiny(1)
    rng = np.random.RandomState(0)
    with ServingEngine(tm, input_shape=(8,), max_batch_size=8,
                       max_wait_ms=2.0, **CPU) as eng:
        eng.warmup()
        futs = [eng.submit(rng.randn(n, 8).astype(np.float32))
                for n in (1, 3, 2, 5, 1)]
        outs = [f.result(timeout=30) for f in futs]
    assert [o.shape[0] for o in outs] == [1, 3, 2, 5, 1]
    path = str(tmp_path / "TRACE_SERVE.json")
    global_trace.export_chrome(path)
    assert validate_trace(path) == []
    events = json.loads(open(path).read())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    for phase in ("serve/queue_wait", "serve/assemble", "serve/device",
                  "serve/h2d", "serve/slice_back"):
        assert phase in names, (phase, sorted(names))
    instants = {e["name"] for e in events if e["ph"] == "i"}
    assert "serve/enqueue" in instants and "serve/cache_hit" in instants
    enq = [e for e in events if e["name"] == "serve/enqueue"]
    assert len(enq) == 5 and all("queue_depth" in e["args"] for e in enq)
