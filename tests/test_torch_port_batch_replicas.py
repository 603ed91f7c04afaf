"""bigdl_tpu_torch's padded-batch ``ReplicaSet`` and the host ``Engine``
pools on the CPU, against the JAX package (mirrors
``tests/test_resilience.py:187``, ``:371``, ``:407``, ``:449``, ``:471``
and ``:490``, ``tests/test_traffic.py:430`` and ``:457``, and
``tests/test_flight.py:421``).

The served model is built from one seed in both packages, so a replica
set's answers are held to the reference engine's at float32 tolerances
and, bitwise, to the port's single engine (every replica freezes the
same params: the reference's acceptance contract).  The reference's
chaos soaks race a live SLO controller and a sampler against the wall
clock; here the controller ticks by hand after latency it has seen, the
load runs on a virtual clock, and the sampler samples on demand."""
import json
import threading
import time

import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.resilience import ReplicaSet as JaxReplicaSet
from bigdl_tpu.resilience import faults as jfaults

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.obs import (StallWatchdog, TimeSeriesSampler, Tracer,
                                 get_registry, get_tracer, set_sampler)
from bigdl_tpu_torch.obs import flight as flight_mod
from bigdl_tpu_torch.resilience import BackendLostError, ReplicaSet, faults
from bigdl_tpu_torch.serving import ServingClosed, ServingEngine
from bigdl_tpu_torch.traffic import SLOController, TraceLoadGenerator
from bigdl_tpu_torch.utils.engine import Engine, ThreadPool

from test_torch_port_flight import repo_state

CPU = dict(device="cpu")
pytestmark = pytest.mark.faults


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


def _counter(name: str) -> float:
    return get_registry().counter(name).value


def _models(seed=0, width=4):
    return (jnn.Sequential(jnn.Linear(8, width), jnn.LogSoftMax()).build(seed),
            nn.Sequential(nn.Linear(8, width), nn.LogSoftMax()).build(
                seed, **CPU))


def _single(model, xs, **kw):
    with ServingEngine(model, input_shape=(8,), max_wait_ms=1.0, **CPU,
                       **kw) as eng:
        return [eng.predict(x, timeout=60) for x in xs]


# --------------------------------------------------------------------------- #
# the Engine host pools                                                       #
# --------------------------------------------------------------------------- #

def test_engine_init_backend_loss_surfaces(inject):
    inject("engine.init:backend_lost:count=1")
    with pytest.raises(BackendLostError):
        Engine.init(platform="cpu")
    Engine.reset()
    Engine.init(platform="cpu")      # count exhausted: the next init works
    assert Engine.is_initialized() and Engine.core_number() == 1
    assert Engine.node_number() == 1
    assert Engine.default() is Engine.default_or_create()
    assert Engine.model().size == 1
    Engine.reset()
    with pytest.raises(RuntimeError, match="Engine.init"):
        Engine.core_number()
    with pytest.raises(ValueError, match="platform"):
        Engine.init(platform="tpu")


def test_thread_pool_waits_and_surfaces_task_errors():
    pool = ThreadPool(2)
    try:
        assert pool.invoke_and_wait([lambda: 1, lambda: 2]) == [1, 2]
        release = threading.Event()
        futs = pool.invoke_and_wait2([lambda: 3, lambda: release.wait(30)],
                                     timeout=0.05)
        assert futs[0].result() == 3 and not futs[1].done()
        release.set()

        def boom():
            raise KeyError("task failed")

        with pytest.raises(KeyError):
            pool.invoke_and_wait2([lambda: 4, boom], timeout=5)
    finally:
        pool.shutdown()


# --------------------------------------------------------------------------- #
# failover                                                                    #
# --------------------------------------------------------------------------- #

def test_replica_set_matches_engine_without_faults():
    jm, tm = _models()
    xs = np.random.RandomState(5).randn(6, 8).astype(np.float32)
    with JaxReplicaSet(jm, n_replicas=2, input_shape=(8,), max_batch_size=8,
                       max_wait_ms=1.0) as jrs:
        want = jrs.predict(xs, timeout=60)
    with ReplicaSet(tm, n_replicas=2, input_shape=(8,), max_batch_size=8,
                    max_wait_ms=1.0, **CPU) as rs:
        y = rs.predict(xs, timeout=60)
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(y, _single(tm, [xs],
                                                 max_batch_size=8)[0])
        one = rs.predict_one(xs[0], timeout=60)
        np.testing.assert_allclose(one, y[0], rtol=1e-6, atol=1e-6)
        assert set(rs.stats()["replicas"]) == {"r0", "r1"}
    with pytest.raises(ServingClosed):
        rs.submit(xs)


def test_replica_death_failover_loses_no_requests(inject, monkeypatch):
    """One of two replicas dies mid-stream: every accepted request
    resolves with exactly the single engine's answer, the batch fails
    over, and the dead replica's circuit opens."""
    jm, tm = _models()
    xs = np.random.RandomState(3).randn(12, 8).astype(np.float32)
    rows = [xs[i:i + 1] for i in range(len(xs))]
    expected = _single(tm, rows, max_batch_size=4)
    inject("serving.dispatch:die:name=r1,after=3")
    failovers0 = _counter("resilience/failovers")
    rs = ReplicaSet(tm, n_replicas=2, input_shape=(8,), max_batch_size=4,
                    max_wait_ms=1.0, failure_threshold=2, cooldown_s=300.0,
                    **CPU)
    try:
        got = [rs.predict(r, timeout=60) for r in rows]
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g, e)
        st = rs.stats()
        assert st["replicas"]["r1"]["state"] == "open"
        assert st["replicas"]["r0"]["state"] == "healthy"
        assert _counter("resilience/failovers") - failovers0 >= 1
        assert st["replicas"]["r1"]["dispatched"] >= 2
    finally:
        rs.close()
    jfaults.refresh_from_env()      # the reference's own injector
    jrs = JaxReplicaSet(jm, n_replicas=2, input_shape=(8,),
                        max_batch_size=4, max_wait_ms=1.0,
                        failure_threshold=2, cooldown_s=300.0)
    try:
        for g, r in zip(got, rows):
            np.testing.assert_allclose(g, jrs.predict(r, timeout=60),
                                       rtol=1e-5, atol=1e-5)
        # the same fault schedule trips the same breaker in the reference
        jst = jrs.stats()["replicas"]
        assert {k: v["state"] for k, v in jst.items()} == {
            k: v["state"] for k, v in st["replicas"].items()}
    finally:
        jrs.close()
        monkeypatch.delenv(faults.ENV_SPEC)
        jfaults.refresh_from_env()


def test_circuit_breaker_open_halfopen_close(inject):
    """On an injectable clock: consecutive failures open the circuit;
    after the cooldown one half-open probe runs; a failed probe
    re-opens, a successful one closes."""
    clk = {"t": 0.0}
    inject("serving.dispatch:die:name=r0,count=3")
    _, tm = _models()
    rs = ReplicaSet(tm, n_replicas=2, input_shape=(8,), max_batch_size=4,
                    max_wait_ms=1.0, failure_threshold=2, cooldown_s=5.0,
                    clock=lambda: clk["t"], **CPU)
    x = np.ones((1, 8), np.float32)
    try:
        rs.predict(x, timeout=60)
        rs.predict(x, timeout=60)
        assert rs.stats()["replicas"]["r0"]["state"] == "open"
        rs.predict(x, timeout=60)
        assert rs.stats()["replicas"]["r0"]["dispatched"] == 2
        clk["t"] = 6.0
        rs.predict(x, timeout=60)           # the probe fails: re-open
        assert rs.stats()["replicas"]["r0"]["state"] == "open"
        clk["t"] = 8.0
        rs.predict(x, timeout=60)
        assert rs.stats()["replicas"]["r0"]["dispatched"] == 3
        clk["t"] = 12.0
        rs.predict(x, timeout=60)           # the probe succeeds: close
        assert rs.stats()["replicas"]["r0"]["state"] == "healthy"
        rs.predict(x, timeout=60)
        assert rs.stats()["replicas"]["r0"]["dispatched"] == 5
        assert faults.active().stats()[
            "serving.dispatch:backend_lost:count=3,name=r0"]["fired"] == 3
    finally:
        rs.close()


def test_all_replicas_dead_is_bounded_backend_lost(inject):
    inject("serving.dispatch:die")
    _, tm = _models()
    rs = ReplicaSet(tm, n_replicas=2, input_shape=(8,), max_batch_size=4,
                    max_wait_ms=1.0, failure_threshold=1, cooldown_s=300.0,
                    **CPU)
    try:
        lost0 = _counter("resilience/backend_lost")
        with pytest.raises(BackendLostError):
            rs.submit(np.ones((1, 8), np.float32)).result(timeout=60)
        assert _counter("resilience/backend_lost") - lost0 == 1
    finally:
        rs.close()


def test_quantized_replica_coexists_and_fails_over_exactly(inject):
    """A heterogeneous set: the int8 clone beside its float original
    behind one batcher; per-replica exactness, and once the float
    replica dies every answer is the int8 engine's."""
    _, model = _models(width=32)
    qmodel = model.quantize()
    xs = np.random.RandomState(7).randn(10, 8).astype(np.float32)
    rows = [xs[i:i + 1] for i in range(len(xs))]
    kw = dict(max_batch_size=4)
    exp32, exp8 = _single(model, rows, **kw), _single(qmodel, rows, **kw)
    assert any(not np.array_equal(a, b) for a, b in zip(exp32, exp8))
    inject("serving.dispatch:die:name=r0,after=2")
    failovers0 = _counter("resilience/failovers")
    rs = ReplicaSet([model, qmodel], failure_threshold=2, cooldown_s=300.0,
                    input_shape=(8,), max_wait_ms=1.0, **kw, **CPU)
    try:
        assert rs._replicas[0].engine.quant_dtype == "f32"
        assert rs._replicas[1].engine.quant_dtype == "int8"
        got = [rs.predict(r, timeout=60) for r in rows]
        for g, a, b in zip(got, exp32, exp8):
            assert np.array_equal(g, a) or np.array_equal(g, b)
        st = rs.stats()
        assert st["replicas"]["r0"]["state"] == "open"
        assert st["replicas"]["r1"]["state"] == "healthy"
        assert _counter("resilience/failovers") - failovers0 >= 1
        assert np.array_equal(got[-1], exp8[-1])
    finally:
        rs.close()
    with pytest.raises(ValueError, match="one module per replica"):
        ReplicaSet([model, qmodel], n_replicas=3, **CPU)


def test_replicaset_scale_to():
    _, tm = _models()
    x = np.linspace(-1, 1, 16, dtype=np.float32).reshape(2, 8)
    ups, downs = (_counter("resilience/scale_ups"),
                  _counter("resilience/scale_downs"))
    with ReplicaSet(tm, n_replicas=1, input_shape=(8,), max_batch_size=8,
                    **CPU) as rs:
        assert rs.warmup() == 4
        ref = rs.predict(x, timeout=60)
        assert rs.scale_to(3) == 3
        assert len([r for r in rs.stats()["replicas"].values()
                    if r["state"] != "draining"]) == 3
        np.testing.assert_array_equal(rs.predict(x, timeout=60), ref)
        assert rs.try_scale_up(max_replicas=3) is False
        assert rs.scale_to(1) == 1
        np.testing.assert_array_equal(rs.predict(x, timeout=60), ref)
        assert _counter("resilience/scale_ups") - ups == 2
        assert _counter("resilience/scale_downs") - downs == 2
        assert rs.try_scale_up() is True
        assert len(rs.stats()["replicas"]) == 2


# --------------------------------------------------------------------------- #
# the chaos soaks, made deterministic                                         #
# --------------------------------------------------------------------------- #

def test_chaos_soak_zero_accepted_loss(inject):
    """A bursty trace against a 2-replica set while r1 dies, every
    dispatch drags 25 ms and one staged chunk wobbles: every accepted
    request completes with the healthy set's exact answer, and the SLO
    controller (ticked after it has seen the drag) tightens admission so
    the burst is shed, typed and counted, instead of queued."""
    _, tm = _models()

    def payload(idx: int) -> np.ndarray:
        return np.full((1, 8), (idx % 5) * 0.5 - 1.0, np.float32)

    refs = {i: _single(tm, [payload(i)], max_batch_size=8)[0]
            for i in range(5)}
    rs = ReplicaSet(tm, n_replicas=2, input_shape=(8,), max_batch_size=8,
                    max_queue=64, failure_threshold=1, cooldown_s=60.0,
                    **CPU)
    try:
        rs.warmup()
        inject("serving.dispatch:die:name=r1,after=2;"
               "serving.dispatch:latency:ms=25;"
               "transfer.chunk:transient:count=1")
        ctrl = SLOController(
            histogram=rs.metrics.total_latency, target_p99_s=0.005,
            interval_s=0.05, window_intervals=4,
            set_admission=rs.batcher.set_max_queue,
            admission_levels=[64, 2, 1], hot_streak=2, cool_streak=50)
        for i in range(6):     # latency the controller then sees
            np.testing.assert_array_equal(
                rs.predict(payload(i), timeout=60), refs[i % 5])
        actions = [ctrl.tick()["action"] for _ in range(4)]
        assert actions.count("admission_tighten") == 2
        assert rs.batcher.max_queue == 1

        before = _counter("serving/rejected_total")
        gen = TraceLoadGenerator(kind="bursty", rate_rps=60, duration_s=2.0,
                                 seed=11)
        t = [0.0]
        report = gen.run(lambda a: rs.submit(payload(a.index)),
                         clock=lambda: t[0],
                         sleep=lambda s: t.__setitem__(0, t[0] + s))
        lost = []
        for a, fut in report.accepted:
            try:
                if not np.array_equal(fut.result(timeout=60),
                                      refs[a.index % 5]):
                    lost.append((a.index, "mismatch"))
            except Exception as e:  # noqa: BLE001
                lost.append((a.index, repr(e)))
        assert report.offered > 40
        assert lost == []
        assert len(report.shed) > 0 and report.accepted
        assert _counter("serving/rejected_total") - before == \
            len(report.shed)
        assert report.errors == []
        st = faults.active().stats()
        assert any(k.startswith("serving.dispatch:backend_lost")
                   and v["fired"] >= 1 for k, v in st.items())
        assert st["transfer.chunk:transient:count=1"]["fired"] == 1
        assert rs.stats()["replicas"]["r1"]["state"] in ("open",
                                                         "half_open")
    finally:
        rs.close()


def test_chaos_soak_span_trees_and_bundles(tmp_path, monkeypatch):
    """r1 dies mid-load while a watchdog stall fires: every accepted
    request has a span tree (the failover hop in the re-dispatched
    ones'), and the recorder writes exactly one bundle per distinct
    incident, each with a time-series window that covers it.  The two
    incidents are the test's own (the fault and its explicit watchdog).
    The engines' shared dispatch watchdog is off here: it fires on a
    dispatch held past 10x the median of sub-millisecond ones, which a
    loaded host produces at random (a 7-22 ms dispatch against a 0.4-0.5
    ms median), and that third incident is the host's, not the soak's.
    Its bundle is pinned where it is made to happen on purpose
    (``test_dispatch_stall_is_an_incident_of_its_own``)."""
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG", "0")
    monkeypatch.setenv(faults.ENV_SPEC, "serving.dispatch:die:name=r1,"
                       "after=3")
    monkeypatch.setenv(faults.ENV_SEED, "0")
    faults.refresh_from_env()
    tr = get_tracer()
    was, rate = tr.enabled, tr.sample_rate
    tr.clear()
    tr.enable()
    tr.set_sample_rate(1.0)
    old = flight_mod.get_flight_recorder()
    recorder = flight_mod.configure(
        enabled=True, out_dir=str(tmp_path),
        incidents_path=str(tmp_path / "TUNNEL_INCIDENTS.json"))
    sampler = TimeSeriesSampler(get_registry(), interval_s=30.0,
                                capacity=512)
    prev = set_sampler(sampler)
    _, tm = _models()
    rng = np.random.RandomState(3)
    try:
        rs = ReplicaSet(tm, n_replicas=2, input_shape=(8,),
                        max_batch_size=4, max_wait_ms=1.0,
                        failure_threshold=2, cooldown_s=300.0, **CPU)
        try:
            futs = []
            for i in range(12):
                sampler.sample_now()
                if i == 6:
                    wd = StallWatchdog(
                        "soak", deadline_s=0.01, poll_s=30.0,
                        tracer=Tracer(enabled=False),
                        capture={"diagnose_cuda": lambda: "dummy"})
                    wd.step_started()
                    wd._inflight_since -= 0.02   # held past its deadline
                    assert wd.check_now() is not None
                    wd.step_finished()
                    wd.stop()
                futs.append(rs.submit(rng.randn(1, 8).astype(np.float32)))
                assert futs[-1].result(timeout=60).shape == (1, 4)
            assert rs.stats()["replicas"]["r1"]["state"] == "open"
        finally:
            rs.close()
    finally:
        set_sampler(prev)
        flight_mod._GLOBAL = old
        tr.enabled = was
        tr.set_sample_rate(rate)
        monkeypatch.delenv(faults.ENV_SPEC, raising=False)
        faults.refresh_from_env()
    rids = [f.request_id for f in futs]
    assert all(rids) and len(set(rids)) == 12
    failover_rids = []
    for rid in rids:
        roots = [n["name"] for n in tr.span_tree(rid)["spans"]]
        assert "serve/request" in roots
        if any(ev.get("name") == "resilience/failover"
               for ev in tr.request_events(rid)):
            failover_rids.append(rid)
    assert failover_rids, "no request recorded its failover hop"
    flat = json.dumps(tr.span_tree(failover_rids[0]))
    assert "resilience/failover" in flat and "resilience/dispatch" in flat
    tr.clear()
    by_kind = {}
    for b in sorted(tmp_path.glob("FLIGHT_*.json")):
        doc = json.loads(b.read_text())
        by_kind.setdefault(doc["flight"], []).append(doc)
    assert set(by_kind) == {"fault_injected", "stall"}, set(by_kind)
    assert [len(v) for v in by_kind.values()] == [1, 1]
    for kind, (doc,) in by_kind.items():
        ts = [r["t_unix"] for r in doc["timeseries"]]
        assert ts and min(ts) <= doc["ts_unix"], kind
        assert doc["state"]["replicaset"]["replicas"]["r0"]["state"] \
            == "healthy"
    ledger = json.loads(open(recorder.incidents_path).read())
    assert len(ledger["incidents"]) == 2
    assert all(r.get("flight") for r in ledger["incidents"])


def test_dispatch_stall_is_an_incident_of_its_own(tmp_path, monkeypatch):
    """The engines' shared dispatch watchdog records a stall bundle of
    its own (key ``serve_dispatch``) when a dispatch is held past 10x
    the median: the third incident a loaded host can add to the chaos
    soak, which therefore runs with the dispatch watchdog off.  Here a
    latency fault holds the 7th dispatch 0.3 s after six fast ones."""
    from bigdl_tpu_torch.obs import shared_watchdog
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG", "1")
    monkeypatch.setenv(faults.ENV_SPEC,
                       "serving.dispatch:latency:ms=300,after=6")
    monkeypatch.setenv(faults.ENV_SEED, "0")
    faults.refresh_from_env()
    old = flight_mod.get_flight_recorder()
    flight_mod.configure(enabled=True, out_dir=str(tmp_path),
                         incidents_path=str(tmp_path / "INC.json"))
    _, tm = _models()
    try:
        with ServingEngine(tm, input_shape=(8,), max_wait_ms=1.0,
                           **CPU) as eng:
            wd = eng.watchdog
            assert wd is shared_watchdog("serve_dispatch")
            for _ in range(6):
                eng.predict(np.ones((1, 8), np.float32), timeout=60)
            fut = eng.submit(np.ones((1, 8), np.float32))
            time.sleep(0.1)  # the 7th dispatch is held in flight
            wd.check_now()   # unless the poller fired it first
            assert fut.result(timeout=60).shape == (1, 4)
    finally:
        flight_mod._GLOBAL = old
        monkeypatch.delenv(faults.ENV_SPEC, raising=False)
        faults.refresh_from_env()
    kinds = [json.loads(b.read_text()) for b in tmp_path.glob("FLIGHT_*")]
    stalls = [d for d in kinds if d["flight"] == "stall"]
    assert [d["detail"]["watchdog"] for d in stalls] == ["serve_dispatch"]


def test_engine_rearms_the_shared_watchdog_from_defaults(monkeypatch):
    """A ServingEngine re-arms the process-wide dispatch watchdog with
    every knob from its own environment: a deadline or k an earlier
    user left on it does not carry over, so no dispatch is held to a
    deadline its engine's settings never asked for."""
    from bigdl_tpu_torch.obs import shared_watchdog
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG", "1")
    monkeypatch.delenv("BIGDL_TPU_WATCHDOG_K", raising=False)
    monkeypatch.delenv("BIGDL_TPU_WATCHDOG_DEADLINE_S", raising=False)
    shared_watchdog("serve_dispatch").reset(k=2.0, deadline_s=0.001)
    _, tm = _models()
    with ServingEngine(tm, input_shape=(8,), **CPU) as eng:
        assert eng.watchdog.k == 10.0 and eng.watchdog.deadline_s is None
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG_DEADLINE_S", "7")
    with ServingEngine(tm, input_shape=(8,), **CPU) as eng:
        assert eng.watchdog.deadline_s == 7.0
