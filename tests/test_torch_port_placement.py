"""bigdl_tpu_torch's serving placement against the JAX package's, on the
CPU (mirrors ``tests/test_placement.py`` and the two placement tests of
``tests/test_disagg.py``): ``DeviceTopology``, ``MeshSlicer``,
``PlacementPolicy`` (slots, headroom, phase tags, gauges, error texts),
``serving_tp_rules`` and ``shard_params_chunked``, the graph cache's
placement tag, and ``placement=`` on ``ServingEngine``,
``LMServingEngine``, ``ReplicaSet`` and ``DisaggCoordinator``.

The reference runs in this process on the conftest's eight virtual CPU
devices.  The port's slots of one device run in this process on CPU
slots (``DeviceTopology(["cpu"] * 8)``, ids by position).  Its
tensor-parallel slots run in gloo worlds of 2 and 4 ranks, each spawned
once for the module from ``tests/_torch_placement_ranks.py`` (which
imports no JAX) over a ``file://`` store; every rank builds the same
seeded models and is handed the same requests.  Tolerances: padded-batch
outputs within 1e-5 of the reference's and of the unplaced oracle (a
row-parallel layer sums its shards in another order); greedy LM streams
token for token.
"""
import os
import pickle
import re
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.serving import placement as jpl
from bigdl_tpu_torch.serving import (DeviceTopology, MeshSlice, MeshSlicer,
                                     PlacementError, PlacementPolicy,
                                     shard_params_chunked)
from tests import _torch_placement_ranks as ranks

TOL = 1e-5
CPU8 = ["cpu"] * 8
FWD_JOBS = ("fwd_replicaset", "fwd_failover", "fwd_scale", "fwd_disagg",
            "fwd_cancel", "fwd_remote_pair", "fwd_build_fails")
WORLD_JOBS = {2: ("topology", "rules", "serve", "serve_int8", "replicaset",
                  "lm_serve", "serve_lifecycle", "lm_lifecycle") + FWD_JOBS,
              4: ("topology", "rules", "serve", "refusals") + FWD_JOBS}


@pytest.fixture
def inject(monkeypatch):
    from bigdl_tpu_torch.resilience import faults

    def _inject(spec: str, seed: int = 0):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        monkeypatch.setenv(faults.ENV_SEED, str(seed))
        return faults.refresh_from_env()

    yield _inject
    monkeypatch.delenv(faults.ENV_SPEC, raising=False)
    monkeypatch.delenv(faults.ENV_SEED, raising=False)
    faults.refresh_from_env()


def _jmlp(seed=ranks.MLP_SEED):
    return jnn.Sequential(jnn.Linear(16, 64), jnn.ReLU(),
                          jnn.Linear(64, 64), jnn.ReLU(),
                          jnn.Linear(64, 10)).build(seed)


def _jlm():
    from bigdl_tpu.models.transformer import TransformerLM
    m = TransformerLM(**ranks.LM)
    m.build(ranks.LM_SEED)
    return m


def _ref_keystr(path) -> str:
    """The reference's key path with a QTensor child's flat index as the
    port writes it (``[<flat index 0>]`` -> ``[0]``)."""
    return re.sub(r"\[<flat index (\d+)>\]", r"[\1]",
                  jax.tree_util.keystr(path))


def _ref_serve(model, x, placement=None, name="oracle"):
    from bigdl_tpu.serving import ServingEngine
    with ServingEngine(model, input_shape=(16,), buckets=(8,), name=name,
                       placement=placement) as eng:
        eng.warmup()
        return eng._run_batch(x)


def _ref_streams(placement=None):
    from bigdl_tpu.serving import LMServingEngine
    eng = LMServingEngine(_jlm(), name="ref", placement=placement,
                          **ranks.LM_ENGINE)
    try:
        eng.warmup()
        return [list(eng.submit(np.asarray(p)).tokens())
                for p in ranks.LM_PROMPTS]
    finally:
        eng.close()


def _port_streams(**kw):
    from bigdl_tpu_torch.serving import LMServingEngine
    eng = LMServingEngine(ranks.lm(), name="port", **ranks.LM_ENGINE, **kw)
    try:
        eng.warmup()
        streams = [eng.submit(np.asarray(p)) for p in ranks.LM_PROMPTS]
        return [list(s.tokens(timeout=120)) for s in streams], eng.stats()
    finally:
        eng.close()


def _ref_policy(fake_mesh, slots, tp):
    return jpl.PlacementPolicy(jpl.DeviceTopology(fake_mesh), slots=slots,
                               tp=tp)


def _ref_replicaset(model, fake_mesh, tp):
    """The reference's ReplicaSet of 2 over two TP ``tp`` slots (its
    ``test_replicaset_two_slots_tp2_matches_oracle``): the rows of one
    batch."""
    from bigdl_tpu.resilience import ReplicaSet
    rs = ReplicaSet(model, n_replicas=2, input_shape=(16,), buckets=(8,),
                    max_batch_size=8, max_wait_ms=1.0,
                    placement=_ref_policy(fake_mesh, 2, tp))
    try:
        rs.warmup()
        return rs.predict(ranks.batch(), timeout=120)
    finally:
        rs.close()


def _ref_pair(placement, prompts=ranks.LM_PROMPTS, **kw):
    """The reference's DisaggCoordinator, 1 prefill + 1 decode: the
    greedy streams of ``prompts`` (one after another) and its hop
    counters."""
    from bigdl_tpu.serving.disagg import DisaggCoordinator
    with DisaggCoordinator(_jlm(), prefill_replicas=1, decode_replicas=1,
                           placement=placement,
                           **{**ranks.LM_ENGINE, **kw}) as co:
        co.warmup()
        streams = [list(co.submit(np.asarray(p)).tokens()) for p in prompts]
        st = co.stats()
    return streams, {k: st[k] for k in ("migrations", "migrated_blocks",
                                        "lost_payloads", "adopted")}


# --------------------------------------------------------------------- #
# the reference's results, and the gloo worlds                          #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref(fake_mesh):
    """The reference's padded-batch outputs (unplaced, and placed at TP 1,
    2 and 4), its int8 ones, its rules' specs and its LM streams."""
    x = ranks.batch()
    out = {"oracle": _ref_serve(_jmlp(), x),
           "int8_oracle": _ref_serve(_jmlp().quantize(), x, name="oq")}
    for tp in (1, 2, 4):
        out[f"tp{tp}"] = _ref_serve(_jmlp(), x, _ref_policy(
            fake_mesh, 1, tp).acquire(), name=f"tp{tp}")
    from bigdl_tpu.serving import ServingEngine
    with ServingEngine(_jmlp().quantize(), input_shape=(16,), buckets=(8,),
                       name="tpq", placement=_ref_policy(
                           fake_mesh, 1, 2).acquire()) as qe:
        out["int8_tp2"] = qe._run_batch(x)
        out["int8_specs"] = {
            (k, leaf): tuple(getattr(qe._params[k]["weight"], leaf)
                             .sharding.spec)
            for k in ("0", "2") for leaf in ("q", "scale")}
    for tp in (2, 4):
        slot = _ref_policy(fake_mesh, 1, tp).acquire()
        for label, m in (("float", _jmlp()), ("int8", _jmlp().quantize())):
            rules = jpl.serving_tp_rules(m, slot.mesh)
            out[f"rules{tp}_{label}"] = {
                _ref_keystr(p): (tuple(s.spec) if s is not None else None)
                for p, s in ((p, rules(p, leaf)) for p, leaf in
                             jax.tree_util.tree_flatten_with_path(
                                 m.params)[0])}
    out["streams"] = _ref_streams()
    out["streams_tp2"] = _ref_streams(_ref_policy(fake_mesh, 1, 2).acquire())
    # the forwarded sets' counterparts: the world of 2 holds two TP1
    # slots, the world of 4 two TP2 slots
    for tp in (1, 2):
        out[f"rs_tp{tp}"] = _ref_replicaset(_jmlp(), fake_mesh, tp)
        out[f"rs_int8_tp{tp}"] = _ref_replicaset(_jmlp().quantize(),
                                                 fake_mesh, tp)
        out[f"pair_tp{tp}"] = _ref_pair(_ref_policy(fake_mesh, 2, tp))
    from bigdl_tpu.serving import ServingEngine
    xs = np.random.RandomState(3).randn(12, 16).astype(np.float32)
    with ServingEngine(_jmlp(), input_shape=(16,), max_batch_size=4,
                       max_wait_ms=1.0) as single:
        out["failover"] = [single.predict(xs[i:i + 1], timeout=120)
                           for i in range(len(xs))]
    pol = _ref_policy(fake_mesh, 4, 1)
    held = pol.acquire()
    head = list(range(2, 19))
    out["remote_pair"] = _ref_pair(
        pol, (head + [40, 41], head + [50], ranks.LM_PROMPTS[2]),
        enable_prefix_cache=True, prefill_buckets=(32,))
    pol.release(held)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ref):
    """The worlds of 2 and 4 ranks, each spawned once; the port's
    unplaced LM streams are computed here while the ranks run."""
    outs, ctxs = {}, {}
    for n, jobs in WORLD_JOBS.items():
        outs[n] = tmp_path_factory.mktemp(f"placement_world{n}")
        ctxs[n] = ranks.start(n, jobs, outs[n])
    deadline = time.monotonic() + 300
    try:
        port_streams, _ = _port_streams(device="cpu")
    finally:
        for n, ctx in ctxs.items():
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise AssertionError(f"the {n} ranks did not finish "
                                         "in time")

    def world(n):
        def result(name, rank=0):
            path = os.path.join(str(outs[n]), f"{name}.{rank}.pkl")
            assert os.path.exists(path), f"rank {rank} wrote no {name}"
            with open(path, "rb") as f:
                res = pickle.load(f)
            assert "error" not in res, res.get("error")
            return res["ok"]
        return result

    out = {n: world(n) for n in WORLD_JOBS}
    out["port_streams"] = port_streams
    return out


# --------------------------------------------------------------------- #
# topology / slicer / policy                                            #
# --------------------------------------------------------------------- #
def test_topology_detects_this_process(fake_mesh):
    """No card here: the live set is empty (never the host in its
    place), ``detect("cpu")`` is the host, and an explicit list has ids
    by position with the reference's describe() keys."""
    topo = DeviceTopology.detect()
    assert topo.n_devices == torch.cuda.device_count()
    assert not topo.degraded and not topo.per_rank
    host = DeviceTopology.detect("cpu")
    assert host.n_devices == 1 and host.platform == "cpu"
    assert host.device_kind == "cpu"
    eight = DeviceTopology(CPU8)
    d, jd = eight.describe(), jpl.DeviceTopology(fake_mesh).describe()
    assert d.keys() == jd.keys()
    assert d["n_devices"] == jd["n_devices"] == 8
    assert [r["id"] for r in d["devices"]] == [r["id"]
                                              for r in jd["devices"]]
    assert d["devices"][0].keys() == jd["devices"][0].keys()
    assert d["platform"] == jd["platform"] == "cpu"


def test_topology_degrades_gracefully_when_the_query_fails(monkeypatch):
    """A device query that raises gives an empty degraded topology, not
    a raise; carving from it fails loudly, as in the reference."""
    def boom():
        raise RuntimeError("device query failed")
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    topo = DeviceTopology.detect()
    assert topo.degraded and topo.n_devices == 0
    assert topo.platform == "unknown" and topo.device_kind == "unknown"
    with pytest.raises(PlacementError) as got:
        MeshSlicer(topo).carve(1, tp=1)
    with pytest.raises(jpl.PlacementError) as want:
        jpl.MeshSlicer(jpl.DeviceTopology(devices=(), degraded=True)).carve(
            1, tp=1)
    assert str(got.value) == str(want.value)
    assert "degraded" in str(got.value)


def test_placement_defaults_to_the_cards_never_the_host(monkeypatch):
    """The default policy carves the cards; with none it refuses rather
    than serve from the host, which only ``detect("cpu")`` names."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(PlacementError, match="0-device topology"):
        PlacementPolicy()
    assert PlacementPolicy(DeviceTopology.detect("cpu")).acquire().device \
        == torch.device("cpu")


def test_placement_and_the_rank_module_import_no_jax():
    """The placement package is the port's (no JAX, no reference), and
    the spawned ranks' module imports neither, so a rank starts without
    JAX."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "bigdl_tpu_torch/serving/placement").glob("*.py"))
    files.append(root / "tests/_torch_placement_ranks.py")
    assert len(files) == 8
    assert root / "bigdl_tpu_torch/serving/placement/forward.py" in files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "bigdl_tpu"), (f, name)


def test_slicer_carves_disjoint_contiguous_slots(fake_mesh):
    slicer = MeshSlicer(DeviceTopology(CPU8))
    jslicer = jpl.MeshSlicer(jpl.DeviceTopology(fake_mesh))
    for tp in (1, 2, 4, 8):
        assert slicer.max_slots(tp) == jslicer.max_slots(tp)
    slices = slicer.carve(3, tp=1)
    assert [s.slot_id for s in slices] == [0, 1, 2]
    assert [s.device_ids for s in slices] == [
        s.device_ids for s in jslicer.carve(3, tp=1)]
    assert [s.tag for s in slices] == [s.tag for s in jslicer.carve(3, 1)]
    assert len({s.tag for s in slices}) == 3
    assert all(s.device == torch.device("cpu") and s.mesh is None
               and s.holds_this_rank() for s in slices)
    assert slices[1].replicated() == slices[1].input_sharding() \
        == torch.device("cpu")
    assert [s.describe() for s in slices] == [
        s.describe() for s in jslicer.carve(3, tp=1)]
    for args in ((9, 1), (3, 4), (0, 1)):
        with pytest.raises(PlacementError) as got:
            slicer.carve(*args)
        with pytest.raises(jpl.PlacementError) as want:
            jslicer.carve(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(PlacementError) as got:
        slicer.max_slots(0)
    with pytest.raises(jpl.PlacementError) as want:
        jslicer.max_slots(0)
    assert str(got.value) == str(want.value)


def test_tensor_parallel_slot_needs_a_process_world():
    """tp > 1 is DTensor over one rank per device: with no world
    running, carving it raises and names the way to start one."""
    with pytest.raises(PlacementError, match="one rank per device") as e:
        MeshSlicer(DeviceTopology(CPU8)).carve(1, tp=2)
    assert "init_world" in str(e.value) and "torchrun" in str(e.value)
    with pytest.raises(PlacementError, match="one rank per device"):
        PlacementPolicy(DeviceTopology(CPU8), slots=2, tp=4)


def test_policy_acquire_release_headroom(fake_mesh):
    pol = PlacementPolicy(DeviceTopology(CPU8), slots=3, tp=1)
    jpol = _ref_policy(fake_mesh, 3, 1)
    assert pol.slots_total == 3 and pol.headroom() == 3
    a, b = pol.acquire(), pol.acquire()
    ja, jb = jpol.acquire(), jpol.acquire()
    assert (a.slot_id, b.slot_id) == (ja.slot_id, jb.slot_id) == (0, 1)
    assert pol.headroom() == jpol.headroom() == 1
    assert pol.acquire().slot_id == jpol.acquire().slot_id == 2
    assert pol.acquire() is None and jpol.acquire() is None
    pol.release(a)
    jpol.release(ja)
    assert pol.headroom() == 1
    assert pol.acquire().slot_id == jpol.acquire().slot_id == 0
    pol.release(b)
    jpol.release(jb)
    for port_call, ref_call in (
            (lambda: pol.release(b), lambda: jpol.release(jb)),
            (lambda: pol.release(MeshSlice(9, ["cpu"], 1, (6,))),
             lambda: jpol.release(jpl.MeshSlice(9, fake_mesh[6:7], 1)))):
        with pytest.raises(PlacementError) as got:
            port_call()
        with pytest.raises(jpl.PlacementError) as want:
            ref_call()
        assert str(got.value) == str(want.value)
    st, jst = pol.stats(), jpol.stats()
    assert st == jst
    assert repr(pol) == repr(jpol)


def test_policy_gauges_equal_the_reference(fake_mesh):
    """The same leases on both policies publish the same
    ``serving/placement/*`` gauges, a phase's set back to 0 on release."""
    from bigdl_tpu.obs import get_registry as jreg
    from bigdl_tpu_torch.obs import get_registry
    names = ("slots_total", "slots_used", "devices_per_slot",
             "phase/prefill", "phase/decode")

    def gauges(reg):
        snap = reg.snapshot()
        return {n: snap[f"serving/placement/{n}"]["value"] for n in names}

    pol = PlacementPolicy(DeviceTopology(CPU8), slots=4, tp=1)
    jpol = _ref_policy(fake_mesh, 4, 1)
    held = []
    for phase in ("prefill", "decode", "decode", None):
        held.append((pol.acquire(phase=phase), jpol.acquire(phase=phase)))
    assert gauges(get_registry()) == gauges(jreg())
    assert gauges(get_registry())["phase/decode"] == 2
    for s, js in held[1:3]:
        pol.release(s)
        jpol.release(js)
    assert gauges(get_registry()) == gauges(jreg())
    assert gauges(get_registry())["phase/decode"] == 0
    assert pol.phase_counts() == jpol.phase_counts() == {
        "prefill": 1, "untagged": 1}
    for s, js in (held[0], held[3]):
        pol.release(s)
        jpol.release(js)


def test_placement_phase_tags_and_gauges(fake_mesh):
    """Mirror of tests/test_disagg.py's phase-tag test on the port."""
    from bigdl_tpu_torch.obs import get_registry
    pol = PlacementPolicy(DeviceTopology(CPU8[:4]), slots=4, tp=1)
    a = pol.acquire(phase="prefill")
    b = pol.acquire(phase="decode")
    c = pol.acquire(phase="decode")
    d = pol.acquire()
    assert pol.phase_of(a) == "prefill" and pol.phase_of(c) == "decode"
    assert pol.phase_of(d) is None
    assert pol.phase_counts() == {"prefill": 1, "decode": 2, "untagged": 1}
    snap = get_registry().snapshot()
    assert snap["serving/placement/phase/prefill"]["value"] == 1
    assert snap["serving/placement/phase/decode"]["value"] == 2
    st = pol.stats()
    assert st["phase_counts"]["decode"] == 2
    assert {s["phase"] for s in st["slots"]} == {"prefill", "decode", None}
    pol.release(b)
    pol.release(c)
    assert pol.phase_counts() == {"prefill": 1, "untagged": 1}
    assert get_registry().snapshot()[
        "serving/placement/phase/decode"]["value"] == 0
    e = pol.acquire(phase="prefill")
    assert pol.phase_counts()["prefill"] == 2
    for s in (a, d, e):
        pol.release(s)


# --------------------------------------------------------------------- #
# staging, the graph cache's tag                                        #
# --------------------------------------------------------------------- #
def test_shard_params_chunked_onto_a_one_device_slot():
    """A leaf already on the slot's device is kept (no copy); a host
    leaf crosses in chunks and lands intact; a QTensor keeps its
    compute mode on a slot of one device."""
    slot = PlacementPolicy(DeviceTopology(CPU8), slots=1).acquire()
    m = ranks.mlp()
    placed = shard_params_chunked(m.params, lambda p, l: None, slot)
    for k in ("0", "2", "4"):
        for leaf in ("weight", "bias"):
            assert placed[k][leaf] is m.params[k][leaf]
    x = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    got = shard_params_chunked({"w": x}, lambda p, l: None, slot,
                               chunk_bytes=4096)["w"]
    assert got.device == slot.device
    np.testing.assert_array_equal(got.numpy(), x)
    q = ranks.mlp().quantize("int8", compute="int8")
    placed = shard_params_chunked(q.params, lambda p, l: None, slot)
    w, w0 = placed["0"]["weight"], q.params["0"]["weight"]
    assert w.compute == w0.compute == "int8"
    assert torch.equal(w.q, w0.q) and torch.equal(w.scale, w0.scale)


def test_compile_cache_keys_separate_placements():
    from bigdl_tpu.serving.compile_cache import CompileCache as JaxCache
    from bigdl_tpu_torch.serving.compile_cache import CompileCache, GraphPool

    def fn(p, b, x):
        return x

    tags = ("slot0:tp2:d0,1", "slot1:tp2:d2,3")
    a, b = (CompileCache(fn, graphs=GraphPool("cpu", False),
                         placement_tag=t, name="infer") for t in tags)
    ja, jb = (JaxCache(fn, placement_tag=t, name="infer") for t in tags)
    x = np.zeros((4, 8), np.float32)
    assert a.key_for(x) != b.key_for(x)
    assert a.key_for(x)[:3] == b.key_for(x)[:3]  # only the tag differs
    assert a.key_for(x)[-1] == ja.key_for(x)[-1] == tags[0]
    assert (a.ledger_tag, b.ledger_tag) == (ja.ledger_tag, jb.ledger_tag) \
        == ("infer@slot0:tp2:d0,1", "infer@slot1:tp2:d2,3")
    plain = CompileCache(fn, graphs=GraphPool("cpu", False), name="infer")
    assert plain.ledger_tag == "infer" and plain.key_for(x)[-1] == ""


# --------------------------------------------------------------------- #
# engines on slots of one device                                        #
# --------------------------------------------------------------------- #
def test_engine_one_device_slot_matches_the_reference_and_the_oracle(ref):
    from bigdl_tpu_torch.obs.ledger import get_ledger
    from bigdl_tpu_torch.serving import ServingEngine
    x = ranks.batch()
    pol = PlacementPolicy(DeviceTopology(CPU8), slots=2)
    pol.acquire()
    slot = pol.acquire()
    with ServingEngine(ranks.mlp(), input_shape=(16,), buckets=(8,),
                       name="tp1", placement=slot) as eng:
        assert eng.warmup() == 1
        y = eng._run_batch(x)
        np.testing.assert_allclose(y, ref["tp1"], atol=TOL)
        np.testing.assert_allclose(y, ref["oracle"], atol=TOL)
        st = eng.stats()
        assert st["compile_cache"]["hit_rate"] == 1.0
        assert st["placement"] == {"slot_id": 1, "tp": 1, "device_ids": [1]}
        assert st["compile_cache"]["ledger_tag"] == \
            "serve/tp1/infer@slot1:tp1:d1"
        assert eng.stager.stage(x).device == slot.device
        rows = {r["name"]: r.get("device") for r in get_ledger().entries()}
        assert rows["tp1/staged"] == rows["tp1/bytes_staged"] == slot.tag
    with ServingEngine(ranks.mlp().quantize(), input_shape=(16,),
                       buckets=(8,), name="tp1q", placement=slot) as qe:
        assert qe.quant_dtype == "int8" and qe._quant_bytes_staged > 0
        np.testing.assert_allclose(qe._run_batch(x), ref["int8_oracle"],
                                   atol=TOL)


def test_lm_engine_one_device_slot_is_token_exact(ref):
    """Greedy decode through a slot of one device replays the unplaced
    engine's streams and the reference's token for token."""
    slot = PlacementPolicy(DeviceTopology(CPU8), slots=1).acquire()
    got, st = _port_streams(placement=slot)
    assert got == ref["streams"]
    assert st["placement"] == {"slot_id": 0, "tp": 1, "device_ids": [0]}
    assert st["prefill_cache"]["ledger_tag"] == \
        "lm/port/prefill@slot0:tp1:d0"
    plain, _ = _port_streams(device="cpu")
    assert got == plain


# --------------------------------------------------------------------- #
# placement-aware ReplicaSet                                            #
# --------------------------------------------------------------------- #
def _replicaset(model, pol, n, **kw):
    from bigdl_tpu_torch.resilience import ReplicaSet
    return ReplicaSet(model, n_replicas=n, input_shape=(16,),
                      max_wait_ms=1.0, placement=pol,
                      **{"buckets": (8,), "max_batch_size": 8, **kw})


@pytest.mark.parametrize("int8", [False, True])
def test_replicaset_two_slots_matches_oracle(ref, int8):
    x = ranks.batch()
    model = ranks.mlp().quantize() if int8 else ranks.mlp()
    pol = PlacementPolicy(DeviceTopology(CPU8), slots=2)
    rs = _replicaset(model, pol, 2)
    try:
        rs.warmup()
        np.testing.assert_allclose(
            rs.predict(x, timeout=60),
            ref["int8_oracle"] if int8 else ref["oracle"], atol=TOL)
        st = rs.stats()
        assert st["replicas"]["r0"]["placement"]["device_ids"] == [0]
        assert st["replicas"]["r1"]["placement"]["device_ids"] == [1]
        assert st["placement"]["slots_used"] == 2
    finally:
        rs.close()
    assert pol.headroom() == 2  # close released both slots


def test_replicaset_refuses_more_replicas_than_slots(fake_mesh):
    from bigdl_tpu.resilience import ReplicaSet as JaxReplicaSet
    pol = PlacementPolicy(DeviceTopology(CPU8), slots=2)
    with pytest.raises(PlacementError, match="exhausted") as got:
        _replicaset(ranks.mlp(), pol, 3)
    assert pol.headroom() == 2  # the built replicas gave theirs back
    with pytest.raises(jpl.PlacementError) as want:
        JaxReplicaSet(_jmlp(), n_replicas=3, input_shape=(16,),
                      buckets=(8,), max_batch_size=8,
                      placement=_ref_policy(fake_mesh, 2, 1))
    assert str(got.value) == str(want.value)


def test_scale_to_is_headroom_capped_and_releases_on_shrink():
    pol = PlacementPolicy(DeviceTopology(CPU8), slots=3)
    rs = _replicaset(ranks.mlp(), pol, 2)
    try:
        assert rs.scale_to(5) == 3          # one free slot: growth stops
        assert pol.headroom() == 0
        assert rs.try_scale_up() is False   # packed: refuse
        assert rs.scale_to(1) == 1          # shrink releases slots
        assert pol.headroom() == 2
        assert rs.try_scale_up() is True    # room again
        assert pol.headroom() == 1
    finally:
        rs.close()
    assert pol.headroom() == 3


def test_replica_death_failover_with_placement_loses_no_requests(inject):
    """Replica death with placement on loses no accepted request: the
    batch fails over to the other slot, outputs stay exact, and the dead
    replica keeps its slot (it may half-open and recover)."""
    from bigdl_tpu_torch.serving import ServingEngine
    model = ranks.mlp()
    xs = np.random.RandomState(3).randn(12, 16).astype(np.float32)
    with ServingEngine(model, input_shape=(16,), max_batch_size=4,
                       max_wait_ms=1.0, device="cpu") as single:
        expected = [single.predict(xs[i:i + 1], timeout=60)
                    for i in range(len(xs))]
    inject("serving.dispatch:die:name=r1,after=3")
    pol = PlacementPolicy(DeviceTopology(CPU8), slots=2)
    rs = _replicaset(model, pol, 2, buckets=None, max_batch_size=4,
                     failure_threshold=2, cooldown_s=300.0)
    try:
        got = [rs.predict(xs[i:i + 1], timeout=60) for i in range(len(xs))]
        for g, e in zip(got, expected):
            np.testing.assert_allclose(g, e, atol=TOL)
        st = rs.stats()
        assert st["replicas"]["r1"]["state"] == "open"
        assert st["replicas"]["r0"]["state"] == "healthy"
        assert st["replicas"]["r1"]["placement"]["slot_id"] == 1
        assert pol.headroom() == 0
    finally:
        rs.close()
    assert pol.headroom() == 2


def test_slo_ladder_falls_to_admission_when_placement_is_packed():
    """SLOController.scale_up wired to try_scale_up takes the one free
    slot, then falls through to admission tightening instead of
    oversubscribing devices."""
    from bigdl_tpu_torch.obs.registry import Histogram
    from bigdl_tpu_torch.traffic import SLOController
    pol = PlacementPolicy(DeviceTopology(CPU8[:2]), slots=2)
    rs = _replicaset(ranks.mlp(), pol, 1)
    try:
        h = Histogram()
        adm = []
        c = SLOController(histogram=h, target_p99_s=0.01,
                          window_intervals=2, scale_up=rs.try_scale_up,
                          set_admission=adm.append,
                          admission_levels=[64, 8], hot_streak=1,
                          cool_streak=99)
        for _ in range(6):
            h.observe(5.0)
            c.tick()
        actions = [a["action"] for a in c.actions]
        assert actions[0] == "scale_up"
        assert "admission_tighten" in actions
        assert adm == [8]
        assert rs.stats()["placement"]["slots_used"] == 2
    finally:
        rs.close()


# --------------------------------------------------------------------- #
# DisaggCoordinator                                                     #
# --------------------------------------------------------------------- #
def test_try_scale_up_gates_on_placement(worlds):
    """Mirror of tests/test_disagg.py's scale-up test: a replica per
    phase-tagged slot, a full device set refuses (falsy), the grown pool
    serves the unplaced streams, and close releases every slot."""
    from bigdl_tpu_torch.serving import DisaggCoordinator
    pol = PlacementPolicy(DeviceTopology(CPU8[:3]), slots=3)
    with DisaggCoordinator(ranks.lm(), prefill_replicas=1,
                           decode_replicas=1, placement=pol,
                           **ranks.LM_ENGINE) as co:
        assert pol.phase_counts() == {"prefill": 1, "decode": 1}
        assert co.try_scale_up("decode") is True
        assert len(co.decode) == 2
        assert pol.phase_counts() == {"prefill": 1, "decode": 2}
        assert co.try_scale_up("prefill") is False  # device set full
        assert len(co.prefill) == 1
        assert co.stats()["phase_counts"] == {"prefill": 1, "decode": 2}
        streams = [co.submit(np.asarray(p)) for p in ranks.LM_PROMPTS]
        got = [list(s.tokens(timeout=120)) for s in streams]
        with pytest.raises(ValueError, match="unknown phase"):
            co.try_scale_up("verify")
    assert got == worlds["port_streams"]
    assert pol.headroom() == 3


def test_disagg_refuses_a_replica_without_a_free_slot():
    from bigdl_tpu_torch.serving import DisaggCoordinator
    pol = PlacementPolicy(DeviceTopology(CPU8[:1]), slots=1)
    with pytest.raises(RuntimeError, match="no free placement slot"):
        DisaggCoordinator(ranks.lm(), prefill_replicas=1,
                          decode_replicas=1, placement=pol,
                          **ranks.LM_ENGINE)
    assert pol.headroom() == 1


# --------------------------------------------------------------------- #
# tensor-parallel slots: the gloo worlds                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", sorted(WORLD_JOBS))
def test_world_topology(worlds, n):
    """With a world running, the live set is one device per rank, ids by
    rank, gathered on every rank; a gloo world has no card to detect."""
    for rank in range(n):
        got = worlds[n]("topology", rank)
        d = got["describe"]
        assert got["per_rank"] and d["n_devices"] == n
        assert [r["id"] for r in d["devices"]] == list(range(n))
        assert [r["process_index"] for r in d["devices"]] == list(range(n))
        assert d["platform"] == "cpu" and not d["degraded"]
        assert got["cpu"] == n and got["cuda_degraded"]


@pytest.mark.parametrize("n", sorted(WORLD_JOBS))
def test_world_rules_match_the_reference(worlds, ref, n):
    """Every leaf path gets the reference's col/row/None decision at TP
    n, float and int8 (q and scale shard together under col, the (out,
    1) scale replicates under row, the TP4 head's 10 rows replicate)."""
    got = worlds[n]("rules")
    for label in ("float", "int8"):
        assert got[label] == ref[f"rules{n}_{label}"]


@pytest.mark.parametrize("n", sorted(WORLD_JOBS))
def test_world_shard_params_chunked_lands_sharded_and_intact(worlds, ref, n):
    for rank in range(n):
        got = worlds[n]("rules", rank)
        rules = ref[f"rules{n}_float"]
        for name, (spec, rows, intact) in got["sharded"].items():
            want = rules[name] or ()
            assert spec == tuple(want) + (None,) * (len(spec) - len(want))
            assert intact, name
        spec, local, full = got["multi_chunk"]
        assert spec == ("model", None) and local == (64 // n, 128)
        np.testing.assert_array_equal(
            full, np.random.RandomState(0).randn(64, 128).astype(np.float32))


@pytest.mark.parametrize("n", sorted(WORLD_JOBS))
def test_world_engine_tp_slot_matches_the_oracle(worlds, ref, n):
    """The tentpole: a model served tensor-parallel across a slot's
    ranks agrees with the unsharded engine and the reference's TP-n
    engine; warmup means traffic is all hits; requests submitted on
    every rank run the same batches."""
    y0 = worlds[n]("serve", 0)["y"]
    for rank in range(n):
        got = worlds[n]("serve", rank)
        np.testing.assert_array_equal(got["y"], y0)
        np.testing.assert_allclose(got["y"], ref["oracle"], atol=TOL)
        np.testing.assert_allclose(got["y"], ref[f"tp{n}"], atol=TOL)
        np.testing.assert_allclose(got["submitted"], ref["oracle"],
                                   atol=TOL)
        assert got["made"] == 1 and got["hit_rate"] == 1.0
        assert got["placement"] == {"slot_id": 0, "tp": n,
                                    "device_ids": list(range(n))}
        assert got["w0"] == ("model", None) and not got["cuda_graphs"]


@pytest.mark.parametrize("n", sorted(WORLD_JOBS))
def test_world_placed_input_stager_lands_on_the_slot(worlds, n):
    for rank in range(n):
        got = worlds[n]("serve", rank)
        assert got["stage_device"] == got["slot_device"] == "cpu"


def test_world_engine_tp2_int8_matches_the_int8_oracle(worlds, ref):
    """QTensor q and its (out, 1) scale shard together column-parallel,
    the scale replicates under row, as the reference's specs say; the
    shards serve in the dequant compute mode."""
    for rank in range(2):
        got = worlds[2]("serve_int8", rank)
        assert got["quant_dtype"] == "int8" and got["staged"] > 0
        np.testing.assert_allclose(got["y"], ref["int8_oracle"], atol=TOL)
        np.testing.assert_allclose(got["y"], ref["int8_tp2"], atol=TOL)
        specs = {k: v + (None,) * (2 - len(v))
                 for k, v in ref["int8_specs"].items()}
        assert got["q"] == specs[("0", "q")] == ("model", None)
        assert got["scale"] == specs[("0", "scale")] == ("model", None)
        assert got["row_scale"] == specs[("2", "scale")] == (None, None)
        assert got["compute"] == "dequant"


def test_world_replicaset_on_a_tp2_slot(worlds, ref):
    for rank in range(2):
        got = worlds[2]("replicaset", rank)
        np.testing.assert_allclose(got["y"], ref["oracle"], atol=TOL)
        np.testing.assert_allclose(got["rows"], ref["oracle"], atol=TOL)
        assert got["device_ids"] == [0, 1] and got["slots_used"] == 1
        assert got["headroom_after"] == 1


def test_world_lm_engine_tp2_is_token_exact(worlds, ref):
    """Greedy decode through a TP2 slot: every rank streams the
    reference's TP2 placed engine's tokens, which are the unplaced
    engines' of both packages; a model built on plain attention decodes
    through the gather, eagerly (the default off a card)."""
    for rank in range(2):
        got = worlds[2]("lm_serve", rank)
        assert got["streams"] == ref["streams_tp2"] == ref["streams"]
        assert got["streams"] == worlds["port_streams"]
        assert got["placement"] == {"slot_id": 0, "tp": 2,
                                    "device_ids": [0, 1]}
        assert got["decode_attn"] == "gather"
        assert got["attention_impl"] == "xla" and not got["cuda_graphs"]
        assert got["ledger_tag"] == "lm/tp/prefill@slot0:tp2:d0,1"
        assert got["embed"] == "DTensor"


def test_world_lm_engine_tp2_keeps_the_kernels_token_exact(worlds, ref):
    """A TP2 slot leaves the model's attention as it was built: the
    default ("auto") and the kernels asked for by name (the flash
    forward and the paged decode; their wrappers take the whole q/k/v
    and the plain arenas, and run their plain versions on these CPU
    tensors) stream the greedy tokens on every rank."""
    for rank in range(2):
        got = worlds[2]("lm_serve", rank)
        assert got["default"] == got["kernels"] == ref["streams"]
        assert got["default_impl"][2] == "auto"
        assert got["kernels_impl"] == ("flash", "paged_kernel", "flash")


def test_world_lm_engine_tp2_lifecycle_in_lockstep(worlds):
    """The ranks of a TP2 slot see different things (a cancel and a
    blown deadline on one rank only, a queue bound on one rank only, a
    hibernation asked on one rank and its resume on the other) and still
    run the same rounds: every stream ends alike on both ranks, the
    untouched ones are the unplaced engine's, and the hibernated stream
    resumes bit-exactly."""
    got = [worlds[2]("lm_lifecycle", rank) for rank in range(2)]
    port = worlds["port_streams"]
    for key in ("streams", "after", "long", "long_ref", "lifecycle",
                "hib_counts"):
        assert got[0][key] == got[1][key], key
    s0, s1, s2, s3 = got[0]["streams"]
    assert s0 == s3 == (port[0], None)
    assert s1[1] == "cancelled" and s2[1] in ("deadline",
                                              "ServingDeadlineExceeded")
    assert got[0]["after"] == (port[2], None)
    assert got[0]["refused"] == ([], "ServingOverloaded")
    assert got[1]["refused"] == ([], "ServingQueueFull")
    assert got[0]["long"] == got[0]["long_ref"]
    assert len(got[0]["long"]) == 56 and got[0]["hib_counts"] == (1, 1)
    assert got[0]["hibernated"] and got[1]["resumed"]


def test_world_engine_tp2_lifecycle_in_lockstep(worlds, ref):
    """The padded-batch engine on a TP2 slot: a future cancelled on rank
    0 only and a deadline blown on rank 1 only end alike on both ranks,
    a request one rank's queue bound refused is shed on the other, and
    every other row is the oracle's."""
    for rank in range(2):
        got = worlds[2]("serve_lifecycle", rank)
        for i, (how, y) in enumerate(got["rows"]):
            want = {2: "CancelledError", 5: "ServingDeadlineExceeded"}
            assert how == want.get(i, "ok"), (rank, i, how)
            if how == "ok":
                np.testing.assert_allclose(y, ref["oracle"][i:i + 1],
                                           atol=TOL)
        np.testing.assert_allclose(got["after"], ref["oracle"][:1], atol=TOL)
    assert worlds[2]("serve_lifecycle", 0)["refused"] == "ServingQueueFull"
    assert worlds[2]("serve_lifecycle", 1)["refused"] == "ServingOverloaded"


def test_world_lm_engine_tp2_speculates_token_exact(worlds, ref):
    """Draft-verify on a TP2 slot (the default int8 drafter runs plain on
    each rank, the verify steps sharded), linear and tree: the streams
    are the greedy ones on every rank."""
    for rank in range(2):
        got = worlds[2]("lm_serve", rank)
        assert got["spec"] == got["spec_tree"] == ref["streams"]
        assert got["spec_verify_compiles"] == 1


def test_world_placement_errors(worlds, ref):
    """In a world of 4 carved into two TP2 slots: an engine on the other
    group's slot raises PlacementError on every rank; a replica set and
    a disaggregated pair spanning both groups build on every rank, serve
    from the driver (rank 0) and give the policy its slots back."""
    for rank in range(4):
        got = worlds[4]("refusals", rank)
        assert "not by this process" in got["engine"]
        assert got["headroom_after_set"] == 2
        assert got["headroom_after_disagg"] == 2
    got = worlds[4]("refusals", 0)
    np.testing.assert_allclose(got["replicaset"], ref["oracle"], atol=TOL)
    assert got["disagg"] == ref["streams"][0]


# --------------------------------------------------------------------- #
# forwarded sets (serving.placement.forward): every rank builds and     #
# closes, rank 0 drives; world of 4 = two TP2 slots, world of 2 = two   #
# per-rank TP1 slots                                                    #
# --------------------------------------------------------------------- #
WORLDS = pytest.mark.parametrize("world", [2, 4])


def _ids(world, slot):
    tp = world // 2
    return list(range(slot * tp, (slot + 1) * tp))


@WORLDS
def test_world_forwarded_replicaset_matches_the_reference(worlds, ref,
                                                          world):
    """A ReplicaSet of 2 over slots on other ranks, float32 and int8:
    every batch's rows within 1e-5 of the reference's placed set (its
    ``test_replicaset_two_slots_tp2_matches_oracle`` and the int8 one)
    and of the oracle, both replicas dispatching; the placement stats;
    both slots back after close on every rank."""
    tp = world // 2
    got = worlds[world]("fwd_replicaset", 0)
    for label, oracle, placed in (
            ("float", ref["oracle"], ref[f"rs_tp{tp}"]),
            ("int8", ref["int8_oracle"], ref[f"rs_int8_tp{tp}"])):
        assert got[label + "_made"] == 2
        for y in got[label]:
            np.testing.assert_allclose(y, placed, atol=TOL)
            np.testing.assert_allclose(y, oracle, atol=TOL)
        st = got[label + "_stats"]
        assert st["device_ids"] == [_ids(world, 0), _ids(world, 1)]
        assert st["slots_used"] == 2 and min(st["dispatched"]) >= 1
    for rank in range(world):
        got = worlds[world]("fwd_replicaset", rank)
        assert got["float_headroom"] == got["int8_headroom"] == 2


def test_world_forwarded_replicaset_off_the_driver(worlds, ref):
    """Both replicas on ranks other than the driver (slot 0 held first):
    the set's first replica, whose engine the batcher and ``stats()``
    consult, is a handle that asks its rank; the rows are the
    reference's."""
    got = worlds[4]("fwd_replicaset", 0)
    for y in got["off_driver"]:
        np.testing.assert_allclose(y, ref["rs_tp1"], atol=TOL)
    assert got["off_driver_stats"] == {"r0": ([1], 1), "r1": ([2], 1)}
    assert got["off_driver_cache"]["misses"] >= 1


@WORLDS
def test_world_forwarded_submit_is_the_drivers(worlds, world):
    """On a rank other than the driver, submit raises PlacementError
    naming the driver, for a replica set and a disaggregated pair."""
    for rank in range(1, world):
        for job in ("fwd_replicaset", "fwd_disagg"):
            msg = worlds[world](job, rank)["refused"]
            assert "driver, world rank 0" in msg and f"rank {rank}" in msg


@WORLDS
def test_world_forwarded_build_failure_fails_every_rank(worlds, ref, world):
    """A forwarded set whose build fails raises on every rank within
    seconds and gives the slots back: a ReplicaSet of 3 on two slots
    (PlacementError, the slots exhausted), a pair of 2 prefill + 1
    decode (RuntimeError, no free placement slot), and a set whose
    second module cannot be served (slot 1's ranks raise its error, every
    other rank the same class naming the first of them).  A set built
    next in the same world serves the oracle's rows."""
    first_bad = _ids(world, 1)[0]
    for rank in range(world):
        got = worlds[world]("fwd_build_fails", rank)
        assert got["replicaset"][0] == "PlacementError"
        assert "none free" in got["replicaset"][1]
        assert got["pair"][0] == "RuntimeError"
        assert "no free placement slot" in got["pair"][1]
        cls, msg = got["bad_module"]
        assert cls not in ("BackendLostError", "PlacementError"), msg
        if rank not in _ids(world, 1):
            assert (f"world rank {first_bad} could not build its part"
                    in msg), msg
        for label in ("replicaset", "pair", "bad_module"):
            assert got[label + "_headroom"] == 2
            assert got[label + "_s"] < 10, (label, got[label + "_s"])
    np.testing.assert_allclose(worlds[world]("fwd_build_fails", 0)["after"],
                               ref["oracle"], atol=TOL)


@WORLDS
def test_world_forwarded_failover_loses_no_requests(worlds, ref, world):
    """Placed failover across ranks (the reference's
    ``test_replica_death_failover_with_placement_loses_no_requests``):
    r1's ranks raise BackendLostError from its 3rd dispatch on; the
    driver sees the same class, so only r1's breaker opens, r1 keeps
    slot 1, and every one of the 12 rows is the single engine's."""
    got = worlds[world]("fwd_failover", 0)
    for g, e, r in zip(got["got"], got["expected"], ref["failover"]):
        np.testing.assert_allclose(g, e, atol=TOL)
        np.testing.assert_allclose(g, r, atol=TOL)
    assert got["replicas"]["r0"] == ("healthy", 0, 0)
    state, slot_id, failures = got["replicas"]["r1"]
    assert (state, slot_id) == ("open", 1) and failures == 2


@WORLDS
def test_world_forwarded_scale_to_reaches_the_other_slot(worlds, ref,
                                                         world):
    """scale_to builds a replica on the other slot's ranks, as far as
    the headroom goes; try_scale_up is refused when packed; a shrink
    drains it and gives the slot back."""
    got = worlds[world]("fwd_scale", 0)
    assert got["grown"] == 2 and got["headroom_grown"] == 0
    assert got["dispatched"] == {"r0": 1, "r1": 1}
    for y in got["rows"] + [got["after"]]:
        np.testing.assert_allclose(y, ref["oracle"], atol=TOL)
    assert not got["packed"]
    assert got["shrunk"] == 1 and got["headroom_shrunk"] == 1
    for rank in range(world):
        assert worlds[world]("fwd_scale", rank)["headroom_closed"] == 2


@WORLDS
def test_world_forwarded_disagg_is_token_exact(worlds, ref, world):
    """A disaggregated pair over slots on other ranks (decode on slot 0,
    prefill on slot 1, as the reference acquires them): greedy streams
    token for token the reference pair's on the same slots and the
    port's unplaced engine's, with the reference's migrations and
    migrated blocks; under ``serving.migrate:backend_lost`` every
    payload is lost, the decode slot re-prefills each, and the streams
    are unchanged."""
    tp = world // 2
    got = worlds[world]("fwd_disagg", 0)
    streams, st = ref[f"pair_tp{tp}"]
    assert got["clean"] == streams == worlds["port_streams"]
    mine = got["clean_stats"]
    assert (mine["migrations"], mine["migrated_blocks"],
            mine["lost_payloads"], mine["adopted"]) == (
        st["migrations"], st["migrated_blocks"], st["lost_payloads"],
        st["adopted"]) == (3, mine["migrated_blocks"], 0, 3)
    assert mine["re_prefills"] == 0
    assert mine["phase_counts"] == {"decode": 1, "prefill": 1}
    assert got["clean_placement"] == {
        "fwd-clean-decode0": {"slot_id": 0, "tp": tp,
                              "device_ids": _ids(world, 0)},
        "fwd-clean-prefill0": {"slot_id": 1, "tp": tp,
                               "device_ids": _ids(world, 1)}}
    lost = got["lost_stats"]
    assert got["lost"] == got["clean"]
    assert lost["re_prefills"] == lost["lost_payloads"] == 3
    assert lost["migrated_blocks"] == 0
    for rank in range(world):
        got = worlds[world]("fwd_disagg", rank)
        assert got["clean_headroom"] == got["lost_headroom"] == 2


@WORLDS
def test_world_forwarded_cancel_reaches_the_decode_rank(worlds, world):
    """The client cancels on the driver after two tokens while the
    decode replica (on rank 1 in the world of 4; the driver's own, fed
    by rank 1's prefill, in the world of 2) decodes: the decode engine
    retires the stream as cancelled, and the client's stream ends
    truncated with the tokens it had."""
    got = worlds[world]("fwd_cancel", 0)
    assert got["truncation"] == "cancelled"
    assert got["tokens"] == worlds["port_streams"][0][:len(got["tokens"])]
    assert 2 <= len(got["tokens"]) < 56
    life = got["lifecycle"]
    assert life["fwd-cancel-decode0"]["cancelled"] == 1
    assert life["fwd-cancel-prefill0"]["cancelled"] == 0
    decode = got["placement"]["fwd-cancel-decode0"]["device_ids"]
    assert decode == ([1] if world == 4 else [0])


@WORLDS
def test_world_forwarded_pair_peeks_the_decode_radix(worlds, ref, world):
    """A pair with the prefix cache on, two prompts sharing a 17-token
    head served one after the other (in the world of 4 both replicas on
    ranks other than the driver): the second hop skips the block the
    decode radix holds, so the migrated blocks and the streams are the
    reference pair's."""
    got = worlds[world]("fwd_remote_pair", 0)
    streams, st = ref["remote_pair"]
    assert got["streams"] == streams
    assert got["stats"]["migrated_blocks"] == st["migrated_blocks"] == 4
    assert got["stats"]["migrations"] == st["migrations"] == 3
    if world == 4:
        assert got["placement"] == {
            "fwd-remote-decode0": {"slot_id": 1, "tp": 1, "device_ids": [1]},
            "fwd-remote-prefill0": {"slot_id": 2, "tp": 1,
                                    "device_ids": [2]}}
    for rank in range(world):
        assert worlds[world]("fwd_remote_pair", rank)["headroom"] == world
