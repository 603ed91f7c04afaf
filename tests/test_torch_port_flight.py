"""bigdl_tpu_torch's time-series sampler, flight recorder and stall
watchdog on the CPU, against the JAX package (mirrors
``tests/test_flight.py:83-300`` and ``:363``, and the watchdog tests of
``tests/test_obs.py``).

A port bundle carries every section of the reference's, with
``diagnose_cuda`` where the reference writes ``diagnose_tpu`` and a
``platform`` stamp beside it.  The flight hooks of the port (the fault
injector, the host tier's corrupt spill, the LM engine's state and
request providers, the replica set's state) each land in a bundle.
Every recorder here writes to a temporary directory: an autouse fixture
holds ``TUNNEL_INCIDENTS.json`` and ``flight/`` at the repository root
byte for byte unchanged across every test.  The dedup-expiry test moves
the recorder's clock instead of sleeping."""
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from bigdl_tpu.obs import flight as jflight

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import (Histogram, MemoryLedger, MetricRegistry,
                                 StallWatchdog, TimeSeriesSampler, Tracer,
                                 env_watchdog_enabled, env_watchdog_kwargs,
                                 get_registry, get_sampler, get_tracer,
                                 set_ledger, set_sampler, shared_watchdog,
                                 thread_stacks)
from bigdl_tpu_torch.obs import flight as flight_mod
from bigdl_tpu_torch.obs.flight import FlightRecorder
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import LMServingEngine
from bigdl_tpu_torch.serving.errors import count_rejection
from bigdl_tpu_torch.serving.kvtier import HostBlockStore

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

#: every section of a port bundle: the reference's, with diagnose_cuda
#: in place of diagnose_tpu, plus the platform stamp
BUNDLE_KEYS = {"flight", "ts_unix", "ts", "detail", "spans",
               "active_requests", "timeseries", "state", "registry",
               "diagnose_cuda", "platform", "complete"}


def repo_state():
    """Bytes of the repository's own incident log and flight bundles."""
    out = {}
    p = os.path.join(REPO, "TUNNEL_INCIDENTS.json")
    if os.path.exists(p):
        out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    d = os.path.join(REPO, "flight")
    if os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            f = os.path.join(d, name)
            out[f] = (hashlib.sha256(open(f, "rb").read()).hexdigest()
                      if os.path.isfile(f) else "dir")
    return out


@pytest.fixture(autouse=True)
def repo_left_alone():
    """No test here writes the repository's incident log or bundles."""
    before = repo_state()
    yield
    assert repo_state() == before


def _wait(pred, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


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
    """The process-wide recorder armed into a temporary directory (the
    bundles and the incident log both land there); restored after."""
    old = flight_mod.get_flight_recorder()
    rec = flight_mod.configure(
        enabled=True, out_dir=str(tmp_path),
        incidents_path=str(tmp_path / "TUNNEL_INCIDENTS.json"))
    yield rec
    flight_mod._GLOBAL = old


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


def _bundles(path):
    return sorted(path.glob("FLIGHT_*.json"))


def _load(path):
    with open(path) as f:
        return json.load(f)


def _check_schema(doc):
    assert set(doc) == BUNDLE_KEYS, set(doc) ^ BUNDLE_KEYS
    assert doc["complete"] is True
    assert isinstance(doc["diagnose_cuda"], str) and doc["diagnose_cuda"]
    assert doc["platform"] == {"platform": "cpu"}
    for key in ("spans", "timeseries"):
        assert isinstance(doc[key], list)
    for key in ("detail", "state", "active_requests", "registry"):
        assert isinstance(doc[key], dict)


# --------------------------------------------------------------------- #
# telemetry time-series
# --------------------------------------------------------------------- #

def test_sampler_counter_values_and_deltas():
    reg = MetricRegistry(max_metrics=64)
    reg.counter("app/requests").add(3)
    s = TimeSeriesSampler(reg, interval_s=0.01, capacity=16)
    row1 = s.sample_now()
    reg.counter("app/requests").add(2)
    row2 = s.sample_now()
    assert row1["metrics"]["app/requests"]["value"] == 3.0
    assert row2["metrics"]["app/requests"]["value"] == 5.0
    assert row2["metrics"]["app/requests"]["delta"] == 2.0
    assert row2["t_unix"] >= row1["t_unix"]


def test_sampler_windowed_histogram_percentiles():
    reg = MetricRegistry(max_metrics=64)
    h = Histogram()
    reg.register("app/latency", h, replace=True)
    for _ in range(100):
        h.observe(0.001)
    s = TimeSeriesSampler(reg, capacity=16)
    s.sample_now()
    for _ in range(50):
        h.observe(1.0)
    row = s.sample_now()
    m = row["metrics"]["app/latency"]
    assert m["count"] == 150 and m["count_delta"] == 50
    assert 0.9 <= m["p50_s"] <= 1.2
    assert 0.9 <= m["p99_s"] <= 1.2


def test_sampler_ring_bounded_and_window_trim():
    reg = MetricRegistry(max_metrics=8)
    reg.gauge("g").set(1.0)
    s = TimeSeriesSampler(reg, capacity=5)
    for _ in range(9):
        s.sample_now()
    assert len(s) == 5
    assert len(s.window()) == 5
    assert all(r["t_unix"] >= time.time() - 1.0 for r in s.window(last_s=1.0))
    pairs = s.series("g", "value")
    assert [v for _, v in pairs] == [1.0] * 5
    assert [t for t, _ in pairs] == sorted(t for t, _ in pairs)


def test_sampler_background_thread():
    reg = MetricRegistry(max_metrics=8)
    reg.counter("ticks").add(1)
    s = TimeSeriesSampler(reg, interval_s=0.02, capacity=64)
    with s:
        assert _wait(lambda: len(s) >= 3, timeout=10.0)
    n = len(s)
    time.sleep(0.06)
    assert len(s) == n
    s.stop()


def test_sampler_reports_registry_cardinality():
    reg = MetricRegistry(max_metrics=16)
    reg.counter("a").add(1)
    reg.gauge("b").set(2.0)
    s = TimeSeriesSampler(reg, capacity=4)
    row = s.sample_now()
    assert row["metrics"]["obs/registry_cardinality"]["value"] == 2.0


def test_global_sampler_install_and_restore():
    s = TimeSeriesSampler(MetricRegistry(max_metrics=8), capacity=4)
    prev = set_sampler(s)
    try:
        assert get_sampler() is s
    finally:
        set_sampler(prev)
    assert get_sampler() is prev


# --------------------------------------------------------------------- #
# flight recorder: bundles, dedup, triggers
# --------------------------------------------------------------------- #

def test_recorder_disabled_by_default_records_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_FLIGHT", raising=False)
    rec = FlightRecorder(out_dir=str(tmp_path))
    assert rec.enabled is False
    assert rec.record("stall", {"x": 1}) is None
    assert rec.note_shed() is None
    assert _bundles(tmp_path) == []
    # the process-wide recorder is off too unless the env var arms it
    assert flight_mod._env_enabled() is False


def test_bundle_schema_pointer_and_correlation(tmp_path, recorder,
                                               global_trace):
    sampler = TimeSeriesSampler(get_registry(), capacity=32)
    prev = set_sampler(sampler)
    try:
        with global_trace.span("lm/request", cat="serve",
                               request_ids=["r1-1"]):
            pass
        sampler.sample_now()
        recorder.register_state("pool", lambda: {"free": 7})
        recorder.register_requests("eng", lambda: ["r1-1", "r1-2"])
        path = recorder.record("backend_lost",
                               {"reason": "no_replica_available"},
                               key="replicaset")
    finally:
        set_sampler(prev)
        recorder.unregister("pool")
        recorder.unregister("eng")
    assert path is not None and os.path.exists(path)
    assert os.path.basename(path).startswith("FLIGHT_")
    doc = _load(path)
    _check_schema(doc)
    assert doc["flight"] == "backend_lost"
    assert doc["detail"]["reason"] == "no_replica_available"
    assert any(s.get("name") == "lm/request" for s in doc["spans"])
    assert doc["timeseries"], "time-series window missing"
    assert doc["state"]["pool"] == {"free": 7}
    assert doc["active_requests"]["eng"] == ["r1-1", "r1-2"]
    ledger = _load(recorder.incidents_path)
    (row,) = ledger["incidents"]
    assert os.path.abspath(row["flight"]) == os.path.abspath(path)
    assert row["stage"] == "flight/backend_lost" and row["rc"] == 0


def test_bundle_sections_match_the_reference(tmp_path):
    """One incident through both recorders: the port's sections are the
    reference's, diagnose_tpu renamed diagnose_cuda, plus platform."""
    docs = []
    for mod, sub in ((flight_mod, "port"), (jflight, "ref")):
        rec = mod.FlightRecorder(
            enabled=True, out_dir=str(tmp_path / sub),
            incidents_path=str(tmp_path / sub / "INC.json"))
        docs.append(_load(rec.record("stall", {"watchdog": "w"}, key="w")))
    port, ref = docs
    want = (set(ref) - {"diagnose_tpu"}) | {"diagnose_cuda", "platform"}
    assert set(port) == want == BUNDLE_KEYS
    assert port["detail"] == ref["detail"]
    assert _load(tmp_path / "port" / "INC.json")["incidents"][0]["stage"] \
        == _load(tmp_path / "ref" / "INC.json")["incidents"][0]["stage"]


def test_one_bundle_per_distinct_incident(tmp_path, recorder):
    p1 = recorder.record("fault_injected", {"site": "a"}, key="a")
    p2 = recorder.record("fault_injected", {"site": "a"}, key="a")
    p3 = recorder.record("fault_injected", {"site": "b"}, key="b")
    p4 = recorder.record("stall", {"watchdog": "serve"}, key="serve")
    assert p1 is not None and p2 is None
    assert p3 is not None and p4 is not None
    assert len(_bundles(tmp_path)) == 3
    assert recorder.bundles_written == 3


def test_dedup_window_expiry_rearms(tmp_path, recorder, monkeypatch):
    """The reference's version sleeps past a 50 ms window and fails
    whenever a dump outlasts it; here the recorder's clock moves."""
    now = [time.time()]
    monkeypatch.setattr(flight_mod.time, "time", lambda: now[0])
    recorder.dedup_window_s = 0.05
    assert recorder.record("stall", key="w") is not None
    now[0] += 0.049
    assert recorder.record("stall", key="w") is None
    now[0] += 0.002
    assert recorder.record("stall", key="w") is not None
    assert recorder.bundles_written == 2


def test_provider_failure_is_captured_not_fatal(tmp_path, recorder):
    recorder.register_state("bad", lambda: 1 / 0)
    try:
        path = recorder.record("stall", key="x")
    finally:
        recorder.unregister("bad")
    doc = _load(path)
    assert "capture failed" in doc["state"]["bad"]


def test_shed_burst_threshold_fires_once(tmp_path, recorder):
    recorder.shed_burst_threshold = 5
    for _ in range(4):
        assert recorder.note_shed() is None
    assert recorder.note_shed() is not None
    for _ in range(10):
        assert recorder.note_shed() is None
    (bundle,) = _bundles(tmp_path)
    doc = _load(bundle)
    assert doc["flight"] == "shed_burst"
    assert doc["detail"]["sheds_in_window"] >= 5


def test_engine_shed_reaches_recorder(tmp_path, recorder):
    """count_rejection() (every typed shed of the LM engine) feeds the
    burst detector without an engine running."""
    recorder.shed_burst_threshold = 3
    for _ in range(3):
        count_rejection()
    assert len(_bundles(tmp_path)) == 1


def test_watchdog_stall_dumps_bundle(tmp_path, recorder):
    wd = StallWatchdog("flighttest", deadline_s=0.01, poll_s=30.0,
                       tracer=Tracer(enabled=False),
                       capture={"diagnose_cuda": lambda: "dummy"})
    wd.step_started()
    try:
        time.sleep(0.02)
        event = wd.check_now()
    finally:
        wd.step_finished()
        wd.stop()
    assert event is not None
    (bundle,) = _bundles(tmp_path)
    doc = _load(bundle)
    assert doc["flight"] == "stall"
    assert doc["detail"]["watchdog"] == "flighttest"
    assert "thread_stacks" not in doc["detail"]


def test_cli_dump_writes_bundle_and_ledger_row(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BIGDL_TPU_FLIGHT", None)
    proc = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.obs.flight", "dump",
         "probe", "1", "--dir", str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["flight"] == "probe_death"
    _check_schema(_load(out["path"]))
    ledger = _load(tmp_path / "TUNNEL_INCIDENTS.json")
    (row,) = ledger["incidents"]
    assert row["stage"] == "probe" and row["rc"] == 1
    assert row["flight"] == os.path.basename(out["path"])


# --------------------------------------------------------------------- #
# the port's flight hooks
# --------------------------------------------------------------------- #

def _tiny_lm():
    return TransformerLM(vocab_size=31, hidden_size=16, n_head=2,
                         n_layers=1, max_len=32, pos_encoding="rope",
                         device="cpu").build(seed=0)


_ENG_KW = dict(slots=2, cache_len=24, block_len=4, max_new_tokens=6,
               prefill_buckets=(4, 8, 16), device="cpu")


def test_lm_serving_request_span_trees(global_trace):
    eng = LMServingEngine(_tiny_lm(), **_ENG_KW)
    try:
        eng.warmup()
        rng = np.random.RandomState(1)
        streams = [eng.submit(
            rng.randint(1, 31, size=n).astype(np.int32) + 1,
            max_new_tokens=4) for n in (4, 7)]
        for s in streams:
            s.result(timeout=60)
        assert _wait(lambda: eng.metrics.completed == 2)
    finally:
        eng.close()
    for s in streams:
        assert s.request_id
        tree = global_trace.span_tree(s.request_id)
        root = next((n for n in tree["spans"]
                     if n["name"] == "lm/request"), None)
        assert root is not None, [n["name"] for n in tree["spans"]]
        names = {c["name"] for c in root["children"]}
        assert "lm/queue_wait" in names
        assert "lm/prefill" in names
        assert "lm/decode_round" in names or "lm/verify_round" in names
        assert root["args"]["emitted"] >= 1
    enq = [e for e in global_trace.events() if e.get("name") == "lm/enqueue"]
    assert len(enq) == 2


def test_fault_injection_dumps_one_bundle_per_site(tmp_path, recorder,
                                                   inject):
    inj = inject("serving.enqueue:transient;transfer.chunk:transient")
    for _ in range(3):
        for site in ("serving.enqueue", "transfer.chunk"):
            with pytest.raises(Exception):
                inj.check(site)
    docs = [_load(b) for b in _bundles(tmp_path)]
    assert sorted(d["detail"]["site"] for d in docs) == [
        "serving.enqueue", "transfer.chunk"]
    assert all(d["flight"] == "fault_injected" for d in docs)
    for d in docs:
        _check_schema(d)


def test_corrupt_spill_raises_an_incident(tmp_path, recorder):
    rng = np.random.default_rng(0)

    def payload():
        return {"k": rng.standard_normal((1, 1, 2, 4, 3)).astype(np.float32),
                "v": rng.standard_normal((1, 1, 2, 4, 3)).astype(np.float32)}

    one = payload()["k"].nbytes * 2
    spill = tmp_path / "spill"
    s = HostBlockStore(host_bytes=one, spill_dir=str(spill),
                       name="flight-crc")
    s.put(("d", 0), payload())
    s.put(("d", 1), payload())      # forces ("d", 0) to disk
    with open(s._entries[("d", 0)].path, "wb") as f:
        f.write(b"not a kv block")
    assert s.get(("d", 0)) is None
    (bundle,) = _bundles(tmp_path)
    doc = _load(bundle)
    assert doc["flight"] == "kvtier_spill_corrupt"
    assert doc["detail"]["store"] == "flight-crc"
    assert "CRC" in doc["detail"]["error"] or "Error" in doc["detail"]["error"]


def test_engine_state_and_requests_ride_bundles(tmp_path, recorder):
    # a ledger made under this recorder registers its table with it
    old = set_ledger(MemoryLedger(registry=MetricRegistry()))
    eng = LMServingEngine(_tiny_lm(), name="flight-eng", **_ENG_KW)
    try:
        eng.warmup()
        prompt = np.arange(1, 8, dtype=np.int32)
        stream = eng.submit(prompt, max_new_tokens=4)
        path = recorder.record("stall", {"watchdog": "unit"}, key="eng")
        stream.result(timeout=60)
    finally:
        eng.close()
        set_ledger(old)
    doc = _load(path)
    state = doc["state"]["lm_engine/flight-eng"]
    assert state["name"] == "flight-eng" and state["slots"] == 2
    rids = doc["active_requests"]["lm_engine/flight-eng"]
    assert isinstance(rids, list)
    assert set(rids) <= {stream.request_id}
    # the ledger's table rides every bundle too
    table = doc["state"]["memledger"]["table"]
    assert {"flight-eng/kv_arena", "flight-eng/staged"} <= {
        r["name"] for r in table}


def test_replicaset_state_rides_bundles(tmp_path, recorder):
    from bigdl_tpu_torch.serving.router import LMReplicaSet
    rs = LMReplicaSet(_tiny_lm(), 2, name="flight-rs", **_ENG_KW)
    try:
        path = recorder.record("backend_lost", {"reason": "unit"}, key="rs")
    finally:
        rs.close()
    doc = _load(path)
    st = doc["state"]["lm_replicaset"]
    assert st["name"] == "flight-rs"
    assert len(st["replicas"]) == 2


def test_recorder_defaults_point_at_the_working_directory(tmp_path,
                                                          monkeypatch):
    """The trap: an armed recorder with no paths writes ./flight/ and
    ./TUNNEL_INCIDENTS.json of the working directory, which from the
    repository root are its own files.  Run from a temporary directory,
    the defaults land there and nowhere else."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIGDL_TPU_FLIGHT_DIR", raising=False)
    rec = FlightRecorder(enabled=True)
    assert rec.out_dir == os.path.join(str(tmp_path), "flight")
    path = rec.record("stall", key="cwd")
    assert os.path.dirname(path) == str(tmp_path / "flight")
    assert (tmp_path / "TUNNEL_INCIDENTS.json").exists()


# --------------------------------------------------------------------- #
# watchdog
# --------------------------------------------------------------------- #

def test_watchdog_stalled_step_produces_diagnose_cuda_event():
    tr = Tracer(enabled=False)
    wd = StallWatchdog("test_stall", deadline_s=0.05, min_samples=5,
                       poll_s=30.0, tracer=tr)
    try:
        wd.step_started()
        time.sleep(0.08)
        ev = wd.check_now()
        assert ev is not None and ev["kind"] == "stall"
        assert ev["watchdog"] == "test_stall"
        assert ev["inflight_s"] >= 0.05
        # the default capture ran the real /proc scan
        assert isinstance(ev["diagnose_cuda"], str) and ev["diagnose_cuda"]
        assert "diagnose_tpu" not in ev
        stacks = "\n".join(ev["thread_stacks"].values())
        assert "test_watchdog_stalled_step" in stacks
        assert wd.check_now() is None
        assert wd.stall_count == 1 and wd.last_event is ev
        (trace_ev,) = tr.events()
        assert trace_ev["name"] == "stall:test_stall"
        assert trace_ev["args"]["diagnose_cuda"] == ev["diagnose_cuda"]
        assert not tr.enabled
        wd.step_finished()
        wd.step_started()
        time.sleep(0.08)
        assert wd.check_now() is not None
        wd.step_finished()
    finally:
        wd.stop()


def test_watchdog_median_rule_needs_min_samples():
    wd = StallWatchdog("t", k=2.0, min_samples=3, poll_s=30.0,
                       tracer=Tracer(enabled=False))
    try:
        for _ in range(2):
            with wd.step():
                time.sleep(0.005)
        wd.step_started()
        time.sleep(0.03)
        assert wd.check_now() is None
        wd.step_finished()
        assert wd.median() is not None
        wd.step_started()
        time.sleep(0.5)
        ev = wd.check_now()
        assert ev is not None and ev["steps_observed"] == 3
        wd.step_finished()
    finally:
        wd.stop()


def test_watchdog_background_thread_fires():
    fired = []
    wd = StallWatchdog("bg", deadline_s=0.05, poll_s=0.02,
                       tracer=Tracer(enabled=False),
                       on_stall=fired.append,
                       capture={"diagnose_cuda": lambda: "probe-ok"})
    try:
        wd.step_started()
        assert _wait(lambda: bool(fired), timeout=10.0)
        assert fired[0]["diagnose_cuda"] == "probe-ok"
        wd.step_finished()
    finally:
        wd.stop()


def test_watchdog_reset_and_shared_instances():
    wd = shared_watchdog("test_shared_port")
    assert shared_watchdog("test_shared_port") is wd
    with wd.step():
        pass
    assert wd.median() is not None
    wd.reset(k=3.0, deadline_s=1.5)
    assert wd.median() is None and wd.k == 3.0 and wd.deadline_s == 1.5
    wd.stop()


def test_watchdog_env_knobs(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_WATCHDOG", raising=False)
    assert env_watchdog_enabled()
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG", "0")
    assert not env_watchdog_enabled()
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG_K", "4.5")
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG_DEADLINE_S", "12")
    assert env_watchdog_kwargs() == {"k": 4.5, "deadline_s": 12.0}
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG_K", "junk")
    assert "k" not in env_watchdog_kwargs()


def test_thread_stacks_names_live_threads():
    stacks = thread_stacks()
    assert any("MainThread" in k for k in stacks)
    assert "test_thread_stacks_names_live_threads" in \
        stacks.get("MainThread", "")
