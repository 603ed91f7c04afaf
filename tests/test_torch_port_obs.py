"""bigdl_tpu_torch.obs and .resilience on the CPU: the metric registry,
the span tracer and the fault injector against the JAX package's copies
(``tests/test_obs.py``, ``tests/test_resilience.py``): the same calls
give the same snapshots, percentiles, events and fault patterns."""
import json
import os
import sys
import threading
import time

import pytest

from bigdl_tpu.obs import registry as jreg
from bigdl_tpu.obs import tracer as jtr
from bigdl_tpu.resilience import errors as jerr
from bigdl_tpu.resilience import faults as jfaults

from bigdl_tpu_torch.obs import (Counter, FnGauge, Gauge, Histogram,
                                 MetricRegistry, Tracer, get_registry,
                                 mint_request_id, percentile_from_counts)
from bigdl_tpu_torch.obs import registry as treg
from bigdl_tpu_torch.resilience import errors as terr
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import errors as serving_errors

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from validate_trace import validate_trace  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test starts from an empty process-wide registry of the port
    (engines and stores re-register their names as they are built)."""
    get_registry().clear()
    yield



# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #

def test_registry_get_or_create_and_type_guard():
    reg = MetricRegistry()
    c = reg.counter("train/steps", unit="steps")
    assert reg.counter("train/steps") is c
    c.add(2)
    assert reg.snapshot()["train/steps"]["value"] == 2.0
    with pytest.raises(TypeError):
        reg.gauge("train/steps")
    with pytest.raises(ValueError):
        reg.register("train/steps", Gauge())
    g = Gauge(unit="x")
    assert reg.register("train/steps", g, replace=True) is g
    assert reg.get("train/steps") is g
    with pytest.raises(TypeError, match="snapshot"):
        reg.register("nope", object())


def test_registry_snapshot_mixes_kinds_like_the_reference():
    """The same registrations in both registries give equal snapshots."""
    snaps = []
    for mod in (treg, jreg):
        reg = mod.MetricRegistry()
        reg.counter("c", unit="s").set(4.0, n=2)
        reg.gauge("g").set(7.5)
        reg.register("fn", mod.FnGauge(lambda: 3.0))
        h = reg.histogram("h")
        for v in (0.001, 0.002, 0.003):
            h.observe(v)
        snaps.append((reg.snapshot(), reg.names()))
    (t, tn), (j, jn) = snaps
    assert t == j and tn == jn == ["c", "fn", "g", "h"]
    assert t["c"] == {"value": 4.0, "n": 2, "unit": "s"}
    assert t["h"]["count"] == 3 and t["h"]["p50_s"] > 0


def test_fn_gauge_swallows_capture_errors():
    def boom():
        raise RuntimeError("x")
    assert FnGauge(boom).snapshot() == {"value": None}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_percentiles_equal_the_reference(seed):
    """The serving metrics' histogram is the reference's log-bucket one:
    the same observations give the same percentiles, counts and
    snapshots."""
    import numpy as np
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.lognormal(-5, 2, 300), [0.0, 1e-6, 150.0]])
    t, j = Histogram(), jreg.Histogram()
    for x in xs:
        t.observe(float(x))
        j.observe(float(x))
    assert t.counts() == j.counts()
    for p in (1, 25, 50, 90, 99, 100):
        assert t.percentile(p) == j.percentile(p)
    assert t.snapshot() == j.snapshot()
    assert treg._EDGES == jreg._EDGES
    assert treg.OVERFLOW_EDGE == jreg.OVERFLOW_EDGE


def test_percentile_from_counts_cases_equal_the_reference():
    n = len(treg._EDGES) + 1
    empty = [0] * n
    single = list(empty)
    single[7] = 42
    over = list(empty)
    over[-1] = 5
    mixed = list(empty)
    mixed[3], mixed[-1] = 90, 10
    torn = list(mixed)
    torn[0] = -7
    cases = [([], 99), (empty, 50), (single, 1), (single, 100),
             (over, 99), (mixed, 50), (mixed, 99), (torn, 50)]
    for counts, p in cases:
        assert percentile_from_counts(counts, p) == \
            jreg.percentile_from_counts(counts, p), (counts[:8], p)
    assert percentile_from_counts(empty, 50) is None
    assert percentile_from_counts(single, 50) == treg._EDGES[7]
    assert percentile_from_counts(over, 99) == treg.OVERFLOW_EDGE
    assert percentile_from_counts(over, 99, overflow=123.0) == 123.0
    assert percentile_from_counts(torn, 50) == treg._EDGES[3]


def test_histogram_windowed_percentile_via_counts_delta():
    h = Histogram()
    for _ in range(100):
        h.observe(0.001)
    before = h.counts()
    for _ in range(100):
        h.observe(1.0)
    delta = [c - p for c, p in zip(h.counts(), before)]
    p50 = percentile_from_counts(delta, 50)
    assert p50 is not None and 0.9 <= p50 <= 1.2


def test_registry_caps_cardinality_and_reports_it():
    reg = MetricRegistry(max_metrics=10)
    for i in range(10):
        reg.counter("ok/%d" % i).add(1)
    extra = reg.counter("over/0")
    extra.add(5)
    assert extra.get()[0] == 5.0 and "over/0" not in reg.names()
    assert reg.cardinality() == 10 and reg.overflow_total() == 1
    reg.register("over/1", Counter(), replace=True)
    assert "over/1" not in reg.names() and reg.overflow_total() == 2
    reg.counter("ok/3").add(1)
    assert reg.overflow_total() == 2
    snap = reg.snapshot()
    assert snap["obs/registry_cardinality"]["value"] == 10.0
    assert snap["obs/registry_overflow_total"]["value"] == 2.0
    assert "obs/registry_cardinality" not in reg.names()
    reg.clear()
    assert reg.cardinality() == 0 and reg.overflow_total() == 0


def test_registry_cap_env_knob(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_REGISTRY_MAX", "12")
    assert MetricRegistry().max_metrics == 12 == \
        jreg.MetricRegistry().max_metrics
    monkeypatch.setenv("BIGDL_TPU_REGISTRY_MAX", "1")  # floor of 8
    assert MetricRegistry().max_metrics == 8
    monkeypatch.setenv("BIGDL_TPU_REGISTRY_MAX", "many")
    assert MetricRegistry().max_metrics == \
        MetricRegistry.DEFAULT_MAX_METRICS
    monkeypatch.delenv("BIGDL_TPU_REGISTRY_MAX")
    assert MetricRegistry().max_metrics == \
        MetricRegistry.DEFAULT_MAX_METRICS == \
        jreg.MetricRegistry.DEFAULT_MAX_METRICS


# --------------------------------------------------------------------- #
# tracer
# --------------------------------------------------------------------- #

def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    with tr.span("a", cat="t", k=1):
        pass
    tr.instant("b")
    tr.add_complete("c", time.perf_counter(), 0.1)
    assert len(tr) == 0
    assert tr.span("x") is tr.span("y")      # one shared no-op


def test_span_nesting_across_threads():
    tr = Tracer(enabled=True)
    # all three threads alive at once, so their idents are distinct
    together = threading.Barrier(3, timeout=60)

    def work(label):
        together.wait()
        with tr.span(f"outer/{label}", cat="t"):
            with tr.span(f"inner/{label}", cat="t"):
                time.sleep(0.002)
        together.wait()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = tr.events()
    assert len(events) == 6
    by_tid = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    assert len(by_tid) == 3
    for evs in by_tid.values():
        inner = next(e for e in evs if e["name"].startswith("inner/"))
        outer = next(e for e in evs if e["name"].startswith("outer/"))
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1


def test_span_records_error_and_traced_ring():
    tr = Tracer(enabled=True)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("no")
    (ev,) = tr.events()
    assert ev["args"]["error"] == "ValueError: no"
    ring = Tracer(capacity=4, enabled=True)

    @ring.traced(cat="t")
    def f(x):
        return x + 1

    for i in range(10):
        assert f(i) == i + 1
    assert len(ring.events()) == 4


def test_chrome_and_jsonl_round_trips(tmp_path):
    tr = Tracer(enabled=True)
    t0 = time.perf_counter()
    with tr.span("phase/a", cat="t", rows=3):
        tr.instant("marker", cat="t")
        time.sleep(0.002)
    tr.add_complete("phase/b", t0, time.perf_counter() - t0, cat="t")
    path = str(tmp_path / "trace.json")
    doc = tr.export_chrome(path)
    loaded = json.loads(open(path).read())
    assert loaded == json.loads(json.dumps(doc))
    assert {e["ph"] for e in loaded["traceEvents"]} == {"X", "i", "M"}
    assert validate_trace(path) == []
    rows_path = str(tmp_path / "events.jsonl")
    assert tr.export_jsonl(rows_path) == 3
    rows = [json.loads(line) for line in open(rows_path)]
    # ordered by start time: the retroactive span began first
    assert [r["name"] for r in rows] == ["phase/b", "phase/a", "marker"]


def test_request_ids_sampling_and_span_tree():
    ids = {mint_request_id() for _ in range(100)}
    assert len(ids) == 100
    assert all(i.startswith("r%d-" % os.getpid()) for i in ids)
    rids = ["r1-%d" % i for i in range(400)]
    for rate in (1.0, 0.0, 0.5):
        t, j = Tracer(enabled=True, sample_rate=rate), \
            jtr.Tracer(enabled=True, sample_rate=rate)
        assert [t.sampled(r) for r in rids] == [j.sampled(r) for r in rids]
    half = Tracer(enabled=True, sample_rate=0.5)
    frac = sum(half.sampled(r) for r in rids) / len(rids)
    assert 0.3 < frac < 0.7
    assert not Tracer(enabled=False).sampled("r1-1")
    tr = Tracer(enabled=True)
    t0 = time.perf_counter()
    with tr.span("lm/prefill", request_id="r9-1"):
        tr.instant("lm/radix_match", request_id="r9-1")
    tr.add_complete("lm/request", t0 - 0.001,
                    time.perf_counter() - t0 + 0.01,
                    args={"request_id": "r9-1"})
    tree = tr.span_tree("r9-1")
    assert tree["span_count"] == 3
    (root,) = tree["spans"]
    assert root["name"] == "lm/request"
    assert root["children"][0]["name"] == "lm/prefill"
    assert root["children"][0]["children"][0]["name"] == "lm/radix_match"


def test_tracer_env_knobs(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_TRACE", "1")
    monkeypatch.setenv("BIGDL_TPU_TRACE_SAMPLE", "0.25")
    tr = Tracer()
    assert tr.enabled and tr.sample_rate == 0.25
    monkeypatch.setenv("BIGDL_TPU_TRACE", "0")
    monkeypatch.setenv("BIGDL_TPU_TRACE_SAMPLE", "x")
    tr = Tracer()
    assert not tr.enabled and tr.sample_rate == 1.0


def test_set_capacity_keeps_the_newest_and_counts_dropped():
    tr = Tracer(capacity=8, enabled=True)
    for i in range(6):
        tr.instant(f"e{i}")
    assert tr.dropped == 0
    tr.set_capacity(4)
    assert [e["name"] for e in tr.events()] == ["e2", "e3", "e4", "e5"]
    assert tr.dropped == 2                     # the two a smaller ring let go
    for i in range(6, 9):
        tr.instant(f"e{i}")
    assert [e["name"] for e in tr.events()] == ["e5", "e6", "e7", "e8"]
    assert tr.dropped == 5
    tr.set_capacity(16)                        # growing keeps every event
    assert len(tr) == 4 and tr.dropped == 5
    with pytest.raises(ValueError):
        tr.set_capacity(0)


def test_dropped_counts_against_a_swapped_in_ring_and_resets_on_enable():
    from collections import deque
    tr = Tracer(enabled=False)
    tr.enable()
    tr._events = deque(maxlen=3)               # a ring replaced from outside
    t = time.perf_counter()
    for i in range(5):
        tr.add_complete(f"s{i}", t, 0.001)
    assert len(tr) == 3 and tr.dropped == 2
    tr.clear()
    assert tr.dropped == 2                     # since tracing was turned on
    tr.enable()                                # already on: kept
    assert tr.dropped == 2
    tr.disable()
    tr.enable()
    assert tr.dropped == 0
    tr.disable()


def test_exports_carry_the_epoch_and_dropped(tmp_path):
    tr = Tracer(capacity=2, enabled=True)
    for i in range(3):
        with tr.span("lm/request", request_id="r1-1", i=i):
            pass
    doc = tr.export_chrome(str(tmp_path / "t.json"))
    assert doc["otherData"]["epoch_perf"] == tr._epoch_perf
    assert doc["otherData"]["dropped"] == 1
    assert validate_trace(str(tmp_path / "t.json")) == []
    req = tr.export_request("r1-1")
    assert req["otherData"]["epoch_perf"] == tr._epoch_perf
    assert req["otherData"]["dropped"] == 1


def test_cpu_span_records_the_threads_cpu_time():
    tr = Tracer(enabled=True)
    with tr.cpu_span("work", cat="t", n=3):
        sum(i * i for i in range(20000))
    with tr.cpu_span("wait", cat="t"):
        time.sleep(0.05)
    t0, c0 = time.perf_counter(), time.thread_time_ns()
    tr.add_complete("later", t0, time.perf_counter() - t0, cat="t",
                    args={"k": 1}, cpu_ns0=c0)
    work, wait, later = tr.events()
    assert work["args"]["n"] == 3 and work["args"]["cpu_us"] > 0
    assert 0 <= wait["args"]["cpu_us"] < 0.5 * wait["dur"]
    assert later["args"] == {"k": 1, "cpu_us": later["args"]["cpu_us"]}
    assert later["args"]["cpu_us"] >= 0
    off = Tracer(enabled=False)
    assert off.cpu_span("x") is off.span("y")  # the shared no-op


def _gc_quiet():
    """Automatic collections off, so a test's forced pass is the only
    one; restored by the caller."""
    import gc
    was = gc.isenabled()
    gc.disable()
    return was


def test_gc_pass_is_a_span_while_enabled():
    import gc
    was = _gc_quiet()
    tr = Tracer(enabled=False)
    try:
        tr.enable()
        assert sum(1 for cb in gc.callbacks if cb is tr._gc_watch) == 1
        tr.enable()                            # a second enable hooks once
        assert sum(1 for cb in gc.callbacks if cb is tr._gc_watch) == 1
        gc.collect()
        (ev,) = [e for e in tr.events() if e["name"] == "py/gc"]
        assert ev["ph"] == "X" and ev["args"]["generation"] == 2
        assert ev["args"]["collected"] >= 0 and ev["dur"] >= 0
        assert ev["tid"] == threading.get_ident()
    finally:
        tr.disable()
        if was:
            gc.enable()


def test_gc_callback_leaves_with_disable_and_a_disabled_tracer_has_none():
    import gc
    was = _gc_quiet()
    try:
        before = list(gc.callbacks)
        off = Tracer(enabled=False)
        on_by_arg = Tracer(enabled=True)       # only enable() hooks
        assert gc.callbacks == before
        tr = Tracer(enabled=False)
        tr.enable()
        watch = tr._gc_watch
        assert watch in gc.callbacks
        tr.disable()
        assert watch not in gc.callbacks and gc.callbacks == before
        gc.collect()
        assert not [e for t in (off, on_by_arg, tr) for e in t.events()
                    if e["name"] == "py/gc"]
    finally:
        if was:
            gc.enable()


def test_gc_pass_inside_a_locked_section_is_parked_not_deadlocked():
    tr = Tracer(enabled=True)
    t = time.perf_counter()
    with tr._lock:                             # as if a pass ran in events()
        tr._gc_pass(t, 0.001, {"generation": 0, "collected": 0})
    assert [e["name"] for e in tr.events()] == ["py/gc"]
    tr._gc_pass(t, 0.001, {"generation": 1, "collected": 2})
    assert len(tr) == 2


# --------------------------------------------------------------------- #
# resilience: taxonomy and the injector
# --------------------------------------------------------------------- #

@pytest.fixture
def inject(monkeypatch):
    """Arm the port's injector through the env path; disarm after."""
    def _inject(spec: str, seed: int = 0):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        monkeypatch.setenv(faults.ENV_SEED, str(seed))
        return faults.refresh_from_env()

    yield _inject
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    monkeypatch.delenv(faults.ENV_SEED, raising=False)
    faults.refresh_from_env()


def test_classify_error_taxonomy_equals_the_reference():
    cases = [RuntimeError("UNAVAILABLE: Socket closed"),
             RuntimeError("DEADLINE_EXCEEDED: 30s"),
             RuntimeError("Unable to initialize backend 'x'"),
             ValueError("bad shape"), KeyError("velocity"),
             RuntimeError("something else entirely"),
             RuntimeError("backend lost mid-copy")]
    for exc in cases:
        assert terr.classify_error(exc) == jerr.classify_error(exc)
    for t_cls, j_cls in ((terr.TransientBackendError,
                          jerr.TransientBackendError),
                         (terr.BackendLostError, jerr.BackendLostError),
                         (terr.ServingOverloaded, jerr.ServingOverloaded),
                         (terr.ServingDeadlineExceeded,
                          jerr.ServingDeadlineExceeded)):
        assert terr.classify_error(t_cls("x")) == \
            jerr.classify_error(j_cls("x"))
    assert issubclass(terr.ServingDeadlineExceeded, terr.ServingOverloaded)
    # both import paths name the same classes
    assert serving_errors.ServingOverloaded is terr.ServingOverloaded
    assert serving_errors.ServingDeadlineExceeded is \
        terr.ServingDeadlineExceeded
    assert issubclass(serving_errors.ServingQueueFull,
                      terr.ServingOverloaded)


def test_injector_refuses_activation_without_env(monkeypatch):
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    faults.refresh_from_env()
    assert faults.active() is None
    with pytest.raises(RuntimeError, match="refusing"):
        faults.install(faults.FaultInjector("transfer.chunk:transient"))
    faults.fault_point("transfer.chunk")      # inactive: a no-op
    faults.install(None)


def test_malformed_spec_raises_loudly():
    for bad in ("transfer.chunk", "transfer.chunk:explode",
                "transfer.chunk:transient:count",
                "transfer.chunk:transient:frequency=2", " ; "):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
        with pytest.raises(ValueError):
            jfaults.parse_spec(bad)


def test_probabilistic_specs_equal_the_reference_pattern():
    def pattern(mod, spec, seed, n=48, **ctx):
        inj = mod.FaultInjector(spec, seed=seed)
        exc = (terr if mod is faults else jerr).TransientBackendError
        out = []
        for _ in range(n):
            try:
                inj.check("s", **ctx)
                out.append(0)
            except exc:
                out.append(1)
        return out, inj.stats()

    for spec in ("s:transient:p=0.5", "s:transient:after=3,count=2",
                 "s:transient:p=0.3;s:transient:p=0.9,count=4",
                 "s:transient:name=r1"):
        for seed in (0, 7):
            assert pattern(faults, spec, seed, name="r1") == \
                pattern(jfaults, spec, seed, name="r1")
    p7, _ = pattern(faults, "s:transient:p=0.5", 7)
    assert p7 == pattern(faults, "s:transient:p=0.5", 7)[0]
    assert p7 != pattern(faults, "s:transient:p=0.5", 8)[0]
    assert 0 < sum(p7) < 48


def test_injector_kinds_and_the_registry_counter(inject):
    reg = get_registry()
    before = reg.counter("resilience/faults_injected").get()[0]
    inj = inject("a:backend_lost:count=1;b:die;c:latency:ms=1")
    assert faults.active() is inj
    with pytest.raises(terr.BackendLostError):
        faults.fault_point("a")
    faults.fault_point("a")                    # count reached: quiet
    with pytest.raises(terr.BackendLostError):
        faults.fault_point("b")
    faults.fault_point("c")                    # latency: sleeps, returns
    assert reg.counter("resilience/faults_injected").get()[0] == before + 3
    assert inj.stats()["a:backend_lost:count=1"] == {"seen": 2, "fired": 1}


def test_request_context_roundtrip_and_clear():
    from bigdl_tpu_torch.obs import (clear_request_context,
                                     get_request_context,
                                     set_request_context)
    assert get_request_context() == ()
    set_request_context(["r1-1", "r1-2"])
    try:
        assert get_request_context() == ("r1-1", "r1-2")
        seen = {}
        t = threading.Thread(
            target=lambda: seen.setdefault("ctx", get_request_context()))
        t.start()
        t.join(60)
        assert not t.is_alive() and seen["ctx"] == ()
    finally:
        clear_request_context()
    assert get_request_context() == ()
