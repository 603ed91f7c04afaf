"""bigdl_tpu_torch's memory ledger on the CPU, against the JAX package
(mirrors all 17 tests of ``tests/test_memledger.py``).

The port's registration, attribution, budget and watermark rules are
the reference's; its backend is the CUDA caching allocator, read
through :meth:`MemoryLedger.backend_stats`, which on the CPU returns
``None`` (the degraded verdict, drift pinned at 0).  A captured step
files a row with its graph-pool bytes and no cost.  The ledger table of
one LM engine equals the JAX engine's row for row for the subsystems
both have (``kvcache``, ``params``, ``spec``); the engine's admission
defers past the watermark, dumps one ``mem_pressure`` bundle, and
admits once the budget lifts, streams exact.  Every recorder writes to
a temporary directory; ``TUNNEL_INCIDENTS.json`` and ``flight/`` at
the repository root stay byte for byte unchanged."""
import gc
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.obs import MetricRegistry as JaxRegistry
from bigdl_tpu.obs import ledger as jledger
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.serving.spec import SpecConfig as JaxSpecConfig

from bigdl_tpu_torch.device import _diagnose_memory, diagnose_cuda
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import MetricRegistry
from bigdl_tpu_torch.obs import flight as flight_mod
from bigdl_tpu_torch.obs.ledger import MemoryLedger, get_ledger, set_ledger
from bigdl_tpu_torch.obs.registry import Histogram
from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
from bigdl_tpu_torch.serving.compile_cache import CompileCache, GraphPool
from bigdl_tpu_torch.serving.kvtier import HostBlockStore
from bigdl_tpu_torch.traffic import SLOController
from bigdl_tpu_torch.utils.params import params_from_numpy

from test_torch_port_flight import repo_state

PORT_BUNDLE_KEYS = {"flight", "ts_unix", "ts", "detail", "spans",
                    "active_requests", "timeseries", "state", "registry",
                    "diagnose_cuda", "platform", "complete"}


@pytest.fixture(autouse=True)
def repo_left_alone():
    before = repo_state()
    yield
    assert repo_state() == before


@pytest.fixture
def ledger():
    """A fresh process-wide ledger over a private registry; the old one
    is restored afterwards."""
    led = MemoryLedger(registry=MetricRegistry(), budget_bytes=None)
    old = set_ledger(led)
    yield led
    set_ledger(old)


@pytest.fixture
def recorder(tmp_path):
    old = flight_mod.get_flight_recorder()
    rec = flight_mod.configure(
        enabled=True, out_dir=str(tmp_path),
        incidents_path=str(tmp_path / "TUNNEL_INCIDENTS.json"))
    yield rec
    flight_mod._GLOBAL = old


def _wait(pred, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# --------------------------------------------------------------------- #
# registration / attribution
# --------------------------------------------------------------------- #

def test_register_release_and_attribution(ledger):
    ledger.register("params", "m/staged", 1000, note="quant=f32")
    ledger.register("kvcache", "m/kv_arena", lambda: 2048,
                    shape=(2, 4, 8), dtype="float32")
    assert ledger.attribution() == {"params": 1000, "kvcache": 2048}
    assert ledger.total_bytes() == 3048
    rows = ledger.entries()
    assert [r["name"] for r in rows] == ["m/kv_arena", "m/staged"]
    kv = rows[0]
    assert kv["nbytes"] == 2048 and kv["shape"] == [2, 4, 8]
    assert not kv["stale"]
    assert ledger.release("params", "m/staged")
    assert not ledger.release("params", "m/staged")
    assert ledger.attribution() == {"kvcache": 2048}


def test_reregister_replaces_latest_owner_wins(ledger):
    ledger.register("params", "m/staged", 100)
    ledger.register("params", "m/staged", 900)
    assert ledger.attribution() == {"params": 900}
    assert len(ledger.entries()) == 1


def test_live_tensor_weakref_goes_stale(ledger):
    arr = torch.zeros((16, 16), dtype=torch.float32)
    ledger.register("kvcache", "pool", arr)
    row = ledger.entries()[0]
    assert row["nbytes"] == 16 * 16 * 4
    assert row["shape"] == [16, 16] and not row["stale"]
    assert row["dtype"] == "torch.float32"
    del arr
    gc.collect()
    row = ledger.entries()[0]
    assert row["stale"] and row["nbytes"] == 0
    assert ledger.attribution() == {"kvcache": 0}


def test_non_weakrefable_falls_back_to_static(ledger):
    class Buf:
        __slots__ = ("nbytes", "shape", "dtype")

        def __init__(self):
            self.nbytes = 8 * 8 * 4
            self.shape = (8, 8)
            self.dtype = "float32"

    ledger.register("host_stager", "buf", Buf())
    row = ledger.entries()[0]
    assert row["nbytes"] == 8 * 8 * 4 and not row["stale"]


def test_raising_provider_reports_stale(ledger):
    def boom():
        raise RuntimeError("backend gone")

    ledger.register("spec", "draft", boom)
    row = ledger.entries()[0]
    assert row["stale"] and row["nbytes"] == 0


# --------------------------------------------------------------------- #
# headroom / watermark
# --------------------------------------------------------------------- #

def test_headroom_against_injected_budget():
    led = MemoryLedger(registry=MetricRegistry(), budget_bytes=1000,
                       watermark=0.9)
    led.register("params", "m", 500)
    assert led.used_fraction() == 0.5
    assert led.headroom() == 0.5
    assert not led.over_watermark()
    led.register("kvcache", "arena", 450)
    assert led.over_watermark()
    assert led.headroom() == pytest.approx(0.05)


def test_unknown_budget_is_permissive(ledger, monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_MEM_BUDGET", raising=False)
    ledger.register("params", "m", 10**12)
    assert ledger.headroom() is None
    assert not ledger.over_watermark()


def test_env_budget_and_watermark(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_MEM_BUDGET", "1000")
    monkeypatch.setenv("BIGDL_TPU_MEM_WATERMARK", "0.5")
    led = MemoryLedger(registry=MetricRegistry())
    led.register("params", "m", 600)
    assert led.capacity_bytes() == 1000
    assert led.watermark == 0.5
    assert led.over_watermark()


# --------------------------------------------------------------------- #
# executable rows from the graph cache
# --------------------------------------------------------------------- #

def test_compile_cache_files_rows(ledger):
    def infer(params, buffers, x):
        return torch.as_tensor(x) @ params["w"]

    params = {"w": torch.ones((8, 4))}
    cache = CompileCache(infer, graphs=GraphPool("cpu", capture=False),
                         name="unit")
    assert cache.stats()["ledger_tag"] == "unit"
    y = cache(params, {}, np.ones((2, 8), np.float32))
    assert tuple(y.shape) == (2, 4)
    (row,) = ledger.executables()
    assert row["tag"] == "unit"
    # no XLA cost analysis exists for a CUDA graph: the memory half
    # carries the owner's pool bytes (None without capture), cost None
    assert row["cost"] is None
    assert set(row["memory"]) == {"temp_bytes", "argument_bytes",
                                  "output_bytes", "alias_bytes",
                                  "code_bytes", "pool_bytes"}
    assert row["memory"]["pool_bytes"] is None
    assert row["memory"]["code_bytes"] == 0
    # pool bytes never join the attribution through the rows
    assert "executables" not in ledger.attribution()


def test_compile_cache_eviction_releases_ledger_rows(ledger):
    def infer(params, buffers, x):
        return torch.as_tensor(x) * 2.0

    cache = CompileCache(infer, graphs=GraphPool("cpu", capture=False),
                         max_entries=1, name="evict")
    cache({}, {}, np.ones((2,), np.float32))
    assert len(ledger.executables()) == 1
    first_key = ledger.executables()[0]["key"]
    cache({}, {}, np.ones((4,), np.float32))
    rows = ledger.executables()
    assert len(rows) == 1 and rows[0]["key"] != first_key
    assert cache.stats()["evictions"] == 1


# --------------------------------------------------------------------- #
# reconciliation
# --------------------------------------------------------------------- #

def test_reconcile_degrades_on_cpu(ledger):
    ledger.register("params", "m", 4096)
    assert MemoryLedger.backend_stats(torch.device("cpu")) is None
    rec = ledger.reconcile(torch.device("cpu"))
    assert rec["verdict"] == "degraded"
    assert rec["backend_bytes_in_use"] is None
    assert rec["drift_bytes"] == 0 and isinstance(rec["drift_bytes"], int)
    assert rec["ledger_bytes"] == 4096
    assert ledger.summary()["last_reconcile"]["verdict"] == "degraded"


def test_reconcile_against_fake_backend(ledger, monkeypatch):
    ledger.register("params", "m", 1000)
    monkeypatch.setattr(
        MemoryLedger, "backend_stats",
        staticmethod(lambda device=None: {"bytes_in_use": 1500,
                                          "bytes_limit": 4000}))
    rec = ledger.reconcile()
    assert rec["verdict"] == "reconciled"
    assert rec["drift_bytes"] == 500
    assert ledger.capacity_bytes() == 4000
    assert ledger.used_fraction() == 1500 / 4000


# --------------------------------------------------------------------- #
# mem_pressure flight bundle
# --------------------------------------------------------------------- #

def test_mem_pressure_fires_one_bundle(tmp_path, recorder):
    led = MemoryLedger(registry=MetricRegistry(), budget_bytes=1000,
                       watermark=0.9)
    old = set_ledger(led)
    try:
        led.register("kvcache", "arena", 950, shape=(2, 4),
                     dtype="float32")
        path = led.check_pressure(context={"site": "unit"})
        assert path is not None and os.path.exists(path)
        bundle = json.load(open(path))
        assert set(bundle) == PORT_BUNDLE_KEYS
        assert bundle["flight"] == "mem_pressure"
        detail = bundle["detail"]
        assert detail["site"] == "unit"
        assert detail["attribution"] == {"kvcache": 950}
        assert detail["table"][0]["name"] == "arena"
        assert detail["used_fraction"] >= 0.9
        assert led.check_pressure() is None
        assert recorder.bundles_written == 1
        led.release("kvcache", "arena")
        led.register("kvcache", "arena", 100)
        assert led.check_pressure() is None
    finally:
        set_ledger(old)


def test_check_pressure_noop_without_budget(ledger, recorder, monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_MEM_BUDGET", raising=False)
    ledger.register("kvcache", "arena", 10**12)
    assert ledger.check_pressure() is None
    assert recorder.bundles_written == 0


# --------------------------------------------------------------------- #
# SLO scale-up consults the ledger
# --------------------------------------------------------------------- #

class _FakeLedger:
    def __init__(self, over):
        self.over = over
        self.calls = 0

    def over_watermark(self, device=None):
        self.calls += 1
        return self.over


def test_slo_scale_up_refused_below_watermark():
    h = Histogram()
    fake = _FakeLedger(over=True)
    ups, adm = [], []
    c = SLOController(histogram=h, target_p99_s=0.1, window_intervals=2,
                      scale_up=lambda: ups.append(1) or True,
                      set_admission=adm.append, admission_levels=[64, 4],
                      ledger=fake, hot_streak=1, cool_streak=2)
    for _ in range(4):
        h.observe(0.5)
        c.tick()
    assert ups == []
    assert fake.calls >= 1
    assert adm == [4]
    assert c.summary()["scaling_exhausted"]
    acts = [a["action"] for a in c.actions]
    assert "scale_up" not in acts and "admission_tighten" in acts
    fake.over = False
    for _ in range(10):
        h.observe(0.001)
        c.tick()
    for _ in range(4):
        h.observe(0.5)
        c.tick()
    assert ups


def test_slo_without_ledger_scales_as_before():
    h = Histogram()
    ups = []
    c = SLOController(histogram=h, target_p99_s=0.1, window_intervals=2,
                      scale_up=lambda: ups.append(1) or True,
                      hot_streak=1, cool_streak=2)
    for _ in range(3):
        h.observe(0.5)
        c.tick()
    assert ups


def test_slo_gate_on_a_real_ledger_matches_the_reference():
    """The same histogram traffic against a real ledger past its
    watermark in both packages: the same actions, tick for tick."""
    from bigdl_tpu.obs.registry import Histogram as JaxHistogram
    from bigdl_tpu.traffic import SLOController as JaxSLO
    runs = []
    for led_cls, reg_cls, hist_cls, slo_cls in (
            (MemoryLedger, MetricRegistry, Histogram, SLOController),
            (jledger.MemoryLedger, JaxRegistry, JaxHistogram, JaxSLO)):
        led = led_cls(registry=reg_cls(), budget_bytes=1000, watermark=0.9)
        led.register("kvcache", "arena", 950)
        h = hist_cls()
        ups, adm = [], []
        c = slo_cls(histogram=h, target_p99_s=0.1, window_intervals=2,
                    scale_up=lambda: ups.append(1) or True,
                    set_admission=adm.append, admission_levels=[64, 8, 4],
                    ledger=led, hot_streak=1, cool_streak=2)
        for i in range(8):
            h.observe(0.5)
            c.tick()
            if i == 3:
                led.release("kvcache", "arena")
        runs.append(([a["action"] for a in c.actions], ups, adm))
    assert runs[0] == runs[1]
    # refused while over the watermark; no cool window re-armed it
    assert runs[0][1] == [] and runs[0][2] == [8, 4]


# --------------------------------------------------------------------- #
# diagnose_cuda memory section
# --------------------------------------------------------------------- #

def test_diagnose_cuda_memory_note(ledger):
    assert _diagnose_memory() == []
    ledger.register("params", "m", 2048)
    notes = _diagnose_memory()
    assert len(notes) == 1 and notes[0].startswith("memory: ")
    assert "2048" in notes[0] and "1 subsystems" in notes[0]
    t0 = time.perf_counter()
    out = diagnose_cuda()
    assert time.perf_counter() - t0 < 1.0
    assert "memory: " in out


# --------------------------------------------------------------------- #
# the LM engine's rows, against the JAX engine's
# --------------------------------------------------------------------- #

_LM_KW = dict(vocab_size=31, hidden_size=16, n_head=2, n_layers=1,
              max_len=32, pos_encoding="rope")
_ENG_KW = dict(slots=2, cache_len=24, block_len=4, max_new_tokens=6,
               prefill_buckets=(4, 8, 16))


def _port_lm(jm):
    tm = TransformerLM(device="cpu", **_LM_KW)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return tm


def test_engine_ledger_table_equals_the_reference():
    jm, jd = JaxLM(**_LM_KW).build(seed=0), JaxLM(**_LM_KW).build(seed=1)
    tm, td = _port_lm(jm), _port_lm(jd)
    pled = MemoryLedger(registry=MetricRegistry())
    jled = jledger.MemoryLedger(registry=JaxRegistry())
    pold, jold = set_ledger(pled), jledger.set_ledger(jled)
    try:
        jeng = JaxEngine(jm, name="tbl", spec=JaxSpecConfig(k=3, draft=jd),
                         **_ENG_KW)
        teng = LMServingEngine(tm, name="tbl", device="cpu",
                               spec=SpecConfig(k=3, draft=td), **_ENG_KW)
        try:
            subs = ("kvcache", "params", "spec")
            prow = [r for r in pled.entries() if r["subsystem"] in subs]
            jrow = [r for r in jled.entries() if r["subsystem"] in subs]
            assert prow == jrow
            assert {r["subsystem"] for r in prow} == set(subs)
            pa, ja = pled.attribution(), jled.attribution()
            assert {s: pa[s] for s in subs} == {s: ja[s] for s in subs}
            prec = pled.reconcile(torch.device("cpu"))
            jrec = jled.reconcile(jax.devices("cpu")[0])
            assert prec["verdict"] == jrec["verdict"] == "degraded"
            assert prec["drift_bytes"] == jrec["drift_bytes"] == 0
            assert prec["backend_bytes_in_use"] is None
            assert jrec["backend_bytes_in_use"] is None
            # the reference adds its executables' generated code, a
            # subsystem the port does not have
            assert prec["ledger_bytes"] == jrec["ledger_bytes"] \
                - ja.get("executables", 0)
        finally:
            jeng.close()
            teng.close()
        # close releases both engines' rows
        assert not [r for r in pled.entries() if r["name"].startswith("tbl/")]
        assert not [r for r in jled.entries() if r["name"].startswith("tbl/")]
    finally:
        set_ledger(pold)
        jledger.set_ledger(jold)


def test_engine_files_step_rows_and_tier_rows(ledger):
    jm = JaxLM(**_LM_KW).build(seed=0)
    store = HostBlockStore(host_bytes=1 << 20, name="led-tier")
    eng = LMServingEngine(_port_lm(jm), name="rows", device="cpu",
                          kvtier=store, **_ENG_KW)
    try:
        eng.warmup()
        tags = {r["tag"] for r in ledger.executables()}
        assert {"lm/rows/prefill", "lm/rows/decode"} <= tags
        assert all(r["cost"] is None for r in ledger.executables())
        names = {r["name"] for r in ledger.entries()}
        assert {"led-tier/host_resident", "led-tier/promoted_bytes",
                "rows/kv_arena", "rows/staged"} <= names
        # no capture on the CPU: no graph-pool row
        assert "graphs" not in ledger.attribution()
    finally:
        eng.close()


def test_admission_defers_past_the_watermark(tmp_path, recorder):
    """O2 on the CPU: a budget the engine's bytes already cross defers
    every admission and dumps ONE mem_pressure bundle with the table;
    lifting the budget admits them all, streams equal an ungated
    engine's."""
    jm = JaxLM(**_LM_KW).build(seed=0)
    tm = _port_lm(jm)
    prompts = [np.arange(1, n + 1, dtype=np.int32) % 30 + 1
               for n in (5, 7, 9, 11)]
    with LMServingEngine(tm, name="ungated", device="cpu",
                         **_ENG_KW) as ref:
        want = [ref.generate(p, max_new_tokens=6, timeout=60)
                for p in prompts]
    led = MemoryLedger(registry=MetricRegistry(), budget_bytes=1,
                       watermark=0.9)
    old = set_ledger(led)
    try:
        eng = LMServingEngine(tm, name="gated", device="cpu", **_ENG_KW)
        try:
            eng.warmup()
            streams = [eng.submit(p, max_new_tokens=6) for p in prompts]
            assert _wait(lambda: recorder.bundles_written >= 1, 30.0)
            time.sleep(0.3)
            assert not any(s.done() for s in streams)
            assert eng.metrics.completed == 0
            (bundle,) = sorted(tmp_path.glob("FLIGHT_*.json"))
            doc = json.load(open(bundle))
            assert doc["flight"] == "mem_pressure"
            assert doc["detail"]["site"] == "lm_admission/gated"
            assert {"gated/kv_arena", "gated/staged"} <= {
                r["name"] for r in doc["detail"]["table"]}
            led.budget_bytes = None   # lift it
            got = [s.result(timeout=60) for s in streams]
        finally:
            eng.close()
    finally:
        set_ledger(old)
    assert recorder.bundles_written == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_process_ledger_is_lazy_and_swappable():
    led = MemoryLedger(registry=MetricRegistry())
    old = set_ledger(led)
    try:
        assert get_ledger() is led
    finally:
        set_ledger(old)
    assert set_ledger(None) is old
    fresh = get_ledger()
    assert isinstance(fresh, MemoryLedger) and fresh is not old
    set_ledger(old)
