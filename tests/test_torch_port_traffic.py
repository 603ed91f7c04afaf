"""bigdl_tpu_torch's traffic harness on the CPU, against the JAX package
(mirrors ``tests/test_traffic.py:59-130`` and ``:277-392``).

Seeded numpy inputs give the same load-generator traces, arrival for
arrival, in both packages (every kind, with deadline and cancel menus);
one goodput curve gives the same knee; one incident file gives the same
chaos schedule (exactly on the sites both engines cross, and up to
``PORT_SITES`` on the two the port's engine lacks).  A chaos run over
the port's LM engine loses no accepted request and keeps every stream
exact.  Every incident file lives in a temporary directory."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu import traffic as jtraffic
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer.generate import generate as jax_generate

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import flight as flight_mod
from bigdl_tpu_torch.obs import get_registry
from bigdl_tpu_torch.resilience import ServingOverloaded, faults
from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
from bigdl_tpu_torch.traffic import (ChaosReplayer, TraceLoadGenerator,
                                     append_incident, build_schedule,
                                     detect_knee, inter_incident_gaps,
                                     load_incidents)
from bigdl_tpu_torch.traffic.chaos import PORT_SITES
from bigdl_tpu_torch.utils.params import params_from_numpy

from test_torch_port_flight import repo_state


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


def _fake_clock():
    t = [0.0]
    return (lambda: t[0]), (lambda s: t.__setitem__(0, t[0] + s))


# --------------------------------------------------------------------------- #
# deterministic traces                                                        #
# --------------------------------------------------------------------------- #

def test_trace_deterministic_and_seed_sensitive():
    mk = lambda seed: TraceLoadGenerator(  # noqa: E731
        kind="bursty", rate_rps=30, duration_s=4, seed=seed).trace()
    a, b = mk(7), mk(7)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.at_s == y.at_s and x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)
    c = mk(8)
    assert [x.at_s for x in c] != [x.at_s for x in a]


def test_trace_kinds_shape():
    for kind, lo, hi in (("poisson", 0.6, 1.5), ("bursty", 0.6, 1.5),
                         ("diurnal", 0.3, 1.1)):
        n = len(TraceLoadGenerator(kind=kind, rate_rps=50, duration_s=6,
                                   seed=3).trace())
        assert lo <= n / (50 * 6) <= hi, (kind, n)
    g = TraceLoadGenerator(kind="diurnal", rate_rps=40, duration_s=3,
                           seed=1, prompt_lens=(4, 8), max_news=(2, 6))
    tr = g.trace()
    assert all(0 < a.at_s < 3 for a in tr)
    assert all(tr[i].at_s <= tr[i + 1].at_s for i in range(len(tr) - 1))
    assert {a.prompt_len for a in tr} <= {4, 8}
    assert {a.max_new for a in tr} <= {2, 6}
    with pytest.raises(ValueError):
        TraceLoadGenerator(kind="sawtooth")


def test_open_loop_arrivals_never_wait_on_completions():
    gen = TraceLoadGenerator(kind="poisson", rate_rps=100, duration_s=1,
                             seed=0)
    clock, sleep = _fake_clock()
    submitted = []
    report = gen.run(lambda a: submitted.append((a.index, clock())) or a,
                     clock=clock, sleep=sleep)
    sched = gen.trace()
    assert report.offered == len(sched) == len(submitted)
    for (idx, t), arr in zip(submitted, sched):
        assert idx == arr.index
        assert abs(t - arr.at_s) < 1e-9


def test_open_loop_shed_and_error_accounting():
    gen = TraceLoadGenerator(kind="poisson", rate_rps=50, duration_s=1,
                             seed=2)
    clock, sleep = _fake_clock()

    def submit(a):
        if a.index % 3 == 0:
            raise ServingOverloaded("full up")
        if a.index % 3 == 1:
            raise ValueError("not an overload")
        return a.index

    report = gen.run(submit, clock=clock, sleep=sleep)
    n = report.offered
    assert len(report.shed) == len([i for i in range(n) if i % 3 == 0])
    assert len(report.errors) == len([i for i in range(n) if i % 3 == 1])
    assert len(report.accepted) == n - len(report.shed) - len(report.errors)
    s = report.summary()
    assert s["offered"] == n and s["shed"] == len(report.shed)


_TRACE_KW = dict(rate_rps=25, duration_s=3, seed=11, vocab=50257,
                 prompt_lens=(17, 64, 200, 511), max_news=(16, 32, 64),
                 deadline_menu=(1.0, 2.0, None), deadline_fraction=0.7,
                 cancel_after_menu=(0.5, None), cancel_fraction=0.4)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_trace_equals_the_reference(kind):
    """One configuration, both packages: the same arrivals, exactly."""
    port = TraceLoadGenerator(kind=kind, **_TRACE_KW)
    ref = jtraffic.TraceLoadGenerator(kind=kind, **_TRACE_KW)
    assert port.config() == ref.config()
    a, b = port.trace(), ref.trace()
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert (x.index, x.at_s, x.max_new, x.deadline_s, x.cancel_after_s) \
            == (y.index, y.at_s, y.max_new, y.deadline_s, y.cancel_after_s)
        assert x.prompt.dtype == y.prompt.dtype
        np.testing.assert_array_equal(x.prompt, y.prompt)
    assert any(x.deadline_s is not None for x in a)
    assert any(x.cancel_after_s is not None for x in a)


# --------------------------------------------------------------------------- #
# the knee                                                                    #
# --------------------------------------------------------------------------- #

def test_detect_knee():
    curve = [{"offered_rps": o, "goodput_rps": g}
             for o, g in ((4, 3.9), (8, 7.8), (16, 12.0), (32, 12.4))]
    k = detect_knee(curve)
    assert k["knee_rps"] == 8.0
    assert k["peak_goodput_rps"] == 12.4
    assert k["saturated"]
    k2 = detect_knee([{"offered_rps": 4, "goodput_rps": 3.9},
                      {"offered_rps": 8, "goodput_rps": 7.9}])
    assert k2["knee_rps"] == 8.0 and not k2["saturated"]
    assert detect_knee([])["knee_rps"] is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knee_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    offered = np.sort(rng.uniform(1, 128, size=9))
    rows = [{"offered_rps": float(o),
             "goodput_rps": float(min(o, 40.0) * rng.uniform(0.8, 1.0)),
             "other": "ignored"} for o in offered]
    rows.append({"offered_rps": None, "goodput_rps": 3.0})
    for eff in (0.85, 0.95):
        assert detect_knee(rows, efficiency=eff) == \
            jtraffic.detect_knee(rows, efficiency=eff)


# --------------------------------------------------------------------------- #
# incident log + chaos schedule                                               #
# --------------------------------------------------------------------------- #

def test_incident_log_roundtrip(tmp_path):
    p = str(tmp_path / "INC.json")
    assert load_incidents(p) == []
    append_incident("bench", 124, p, now=100.0)
    append_incident("profile", 0, p, now=700.0)
    append_incident("lm", 124, p, now=1900.0)
    rows = load_incidents(p)
    assert [r["stage"] for r in rows] == ["bench", "profile", "lm"]
    assert inter_incident_gaps(rows) == [600.0, 1200.0]
    # the reference reads the port's log row for row
    assert jtraffic.load_incidents(p) == rows


def test_incident_log_tolerates_corruption(tmp_path):
    p = tmp_path / "INC.json"
    p.write_text("{ not json")
    assert load_incidents(str(p)) == []
    append_incident("bench", 124, str(p), now=5.0)
    assert len(load_incidents(str(p))) == 1
    p.write_text('{"incidents": [{"ts_unix": 1.0, "stage": "a", "rc": 1},'
                 ' {"stage": "no-ts"}, "junk"]}')
    rows = load_incidents(str(p))
    assert len(rows) == 1 and rows[0]["stage"] == "a"


def _write_log(path, rows):
    for i, (stage, rc) in enumerate(rows):
        append_incident(stage, rc, str(path), now=600.0 * (i + 1) + 40.0 * i)


def test_build_schedule_deterministic_and_mapped(tmp_path):
    p = tmp_path / "INC.json"
    _write_log(p, (("bench", 124), ("lm", 124), ("profile", 0),
                   ("attention", 124), ("probe", 124), ("deadline", 124)))
    a = build_schedule(6.0, path=str(p), seed=9)
    assert a == build_schedule(6.0, path=str(p), seed=9)
    assert a != build_schedule(6.0, path=str(p), seed=10)
    assert all(0 < e["at_s"] < 6.0 for e in a)
    assert all(e["spec"].endswith(":count=1") for e in a)
    # only sites the port's engine crosses
    assert {e["site"] for e in a} <= {"transfer.chunk", "serving.verify",
                                      "serving.enqueue", "serving.cancel"}
    want = {"bench": "transfer.chunk", "attention": "transfer.chunk",
            "lm": "serving.verify", "profile": "serving.enqueue",
            "probe": "serving.enqueue", "deadline": "serving.cancel"}
    for e in a:
        assert e["site"] == want[e["source_stage"]]
    b = build_schedule(4.0, path=str(tmp_path / "missing.json"), seed=0)
    assert len(b) >= 2 and all(0 < e["at_s"] < 4.0 for e in b)


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_schedule_equals_the_reference(tmp_path, seed):
    """One incident file, both packages: on stages whose sites both
    engines cross, the schedules are equal event for event; on a mixed
    log, every field but the site is, and each site is the reference's
    moved through PORT_SITES."""
    shared = tmp_path / "SHARED.json"
    _write_log(shared, (("bench", 124), ("profile", 0), ("cancel", 124),
                        ("attention", 124), ("pipeline", 124)))
    for dur in (3.0, 30.0, 6000.0):
        assert build_schedule(dur, path=str(shared), seed=seed) == \
            jtraffic.build_schedule(dur, path=str(shared), seed=seed)
    mixed = tmp_path / "MIXED.json"
    _write_log(mixed, (("bench", 124), ("lm", 124), ("probe", 1),
                       ("profile", 0), ("serve", 124)))
    port = build_schedule(20.0, path=str(mixed), seed=seed)
    ref = jtraffic.build_schedule(20.0, path=str(mixed), seed=seed)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        site = PORT_SITES.get(r["site"], r["site"])
        assert p == dict(r, site=site,
                         spec=r["spec"].replace(r["site"], site, 1))


@pytest.mark.faults
def test_chaos_replayer_arms_and_fires(monkeypatch):
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    faults.refresh_from_env()
    sched = [{"at_s": 0.0, "site": "serving.enqueue", "kind": "transient",
              "spec": "serving.enqueue:transient:count=1"}]
    rep = ChaosReplayer(sched)
    with rep:
        deadline = time.perf_counter() + 5.0
        fired = False
        while time.perf_counter() < deadline and not fired:
            try:
                faults.fault_point("serving.enqueue", n=1)
            except Exception:
                fired = True
            time.sleep(0.01)
        assert fired
        s = rep.summary()
        assert s["armed"] == 1 and s["fired"] == 1
    assert faults.active() is None
    assert faults.ENV_SPEC not in os.environ
    faults.fault_point("serving.enqueue", n=1)


def test_chaos_replayer_refuses_to_clobber_explicit_spec(monkeypatch, inject):
    inject("transfer.chunk:transient:count=1")
    with pytest.raises(RuntimeError):
        ChaosReplayer([]).start()


@pytest.mark.faults
def test_injector_stats_aggregate_identical_specs(inject):
    spec = "transfer.chunk:transient:count=1"
    inj = inject(spec + ";" + spec)
    with pytest.raises(Exception):
        inj.check("transfer.chunk")
    st = inj.stats()
    assert list(st) == ["transfer.chunk:transient:count=1"]
    assert st["transfer.chunk:transient:count=1"]["fired"] == 1
    assert st["transfer.chunk:transient:count=1"]["seen"] >= 1


# --------------------------------------------------------------------------- #
# O3 on the CPU: chaos over the LM engine, zero accepted loss               #
# --------------------------------------------------------------------------- #

_LM_KW = dict(vocab_size=31, hidden_size=16, n_head=2, n_layers=1,
              max_len=64, pos_encoding="rope")


@pytest.mark.faults
def test_chaos_over_the_engine_loses_no_accepted_request(tmp_path,
                                                         monkeypatch):
    """A schedule of serving.verify and serving.enqueue transients fires
    while a poisson trace runs against a speculative engine: every
    accepted stream equals offline generate, sheds are typed, and the
    recorder writes one bundle per site."""
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    faults.refresh_from_env()
    jm = JaxLM(**_LM_KW).build(seed=0)
    tm = TransformerLM(device="cpu", **_LM_KW)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    gen = TraceLoadGenerator(kind="poisson", rate_rps=40, duration_s=1.0,
                             seed=5, vocab=30, prompt_lens=(3, 6, 9),
                             max_news=(4, 8))
    sched = [{"at_s": at, "site": site, "kind": "transient",
              "spec": f"{site}:transient:count=1"}
             for at, site in ((0.05, "serving.verify"),
                              (0.1, "serving.enqueue"),
                              (0.3, "serving.verify"),
                              (0.4, "serving.enqueue"))]
    old = flight_mod.get_flight_recorder()
    rec = flight_mod.configure(
        enabled=True, out_dir=str(tmp_path),
        incidents_path=str(tmp_path / "TUNNEL_INCIDENTS.json"))
    eng = LMServingEngine(tm, slots=4, cache_len=24, block_len=4,
                          prefill_buckets=(4, 8, 16), device="cpu",
                          spec=SpecConfig(k=2, draft=tm), name="chaos")
    try:
        eng.warmup()
        with ChaosReplayer(sched) as chaos:
            report = gen.run(lambda a: eng.submit(a.prompt,
                                                  max_new_tokens=a.max_new))
            results = [(a, h.result(timeout=120)) for a, h in report.accepted]
            deadline = time.perf_counter() + 10
            while (chaos.summary()["fired"] < 4
                   and time.perf_counter() < deadline):
                # traffic past the trace's end meets events still armed
                try:
                    eng.generate(np.array([1, 2, 3], np.int32),
                                 max_new_tokens=4)
                except ServingOverloaded:
                    pass
            fired = chaos.summary()["fired"]
    finally:
        eng.close()
        flight_mod._GLOBAL = old
    assert report.errors == []
    assert len(report.accepted) + len(report.shed) == report.offered
    assert fired == 4
    for a, got in results:
        want = np.asarray(jax_generate(jm, jm.params,
                                       jnp.asarray(a.prompt[None]),
                                       a.max_new))[0]
        np.testing.assert_array_equal(got, want)
    kinds = {}
    for b in tmp_path.glob("FLIGHT_*.json"):
        doc = json.load(open(b))
        kinds.setdefault(doc["detail"].get("site"), []).append(doc)
    assert {k: len(v) for k, v in kinds.items()} == {
        "serving.verify": 1, "serving.enqueue": 1}
    assert get_registry().counter("resilience/faults_injected").value >= 4
