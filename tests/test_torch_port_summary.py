"""bigdl_tpu_torch's TensorBoard summaries, phase metrics, the training
loop's summary and watchdog hooks, and the emergency checkpoint after a
failure inside the update, on the CPU against the JAX package (mirrors
all 10 tests of ``tests/test_visualization.py``, the metrics tests of
``tests/test_obs.py`` near ``:209``, and ``tests/test_resilience.py``'s
emergency checkpoint for a failure inside the update).

A port ``FileWriter`` writes the reference's bytes for a scalar and a
histogram, and each package's reader parses the other's files.  The
repair of the in-place update: a built-in method stages every new
tensor out of place and commits them in one pass, so an ``Adam``
subclass raising inside ``update`` at iteration 3 (after staging one
leaf) leaves iteration 2 on the model; the port and the JAX package
then write the same emergency pair, and resuming the port's pair ends
where an uninterrupted run does.  A user's in-place method that raises
after writing a leaf still writes no pair."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu import visualization as jvis
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.utils import lm_corpus as jax_lm_corpus
from bigdl_tpu.models.utils import lm_dataset as jax_lm_dataset
from bigdl_tpu.optim.metrics import Metrics as JaxMetrics

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.utils import SYNTH_CORPUS, lm_corpus, lm_dataset
from bigdl_tpu_torch.obs import MetricRegistry, get_registry
from bigdl_tpu_torch.obs import flight as flight_mod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import stages_updates
from bigdl_tpu_torch.optim.optimizer import named_leaves
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.params import params_from_numpy, tree_leaves
from bigdl_tpu_torch.visualization import (Event, FileWriter, ObsSummary,
                                           RecordWriter, TrainSummary,
                                           ValidationSummary, crc32c,
                                           decode_event, histogram,
                                           list_tags, masked_crc32c,
                                           read_records, read_scalar, scalar)

from test_torch_port_flight import repo_state

RTOL, ATOL = 1e-6, 1e-7
EPS = 1e-3


@pytest.fixture(autouse=True)
def repo_left_alone():
    before = repo_state()
    yield
    assert repo_state() == before


def _counter(name):
    return get_registry().counter(name).value


# --------------------------------------------------------------------- #
# tfevents: crc, records, protos, writer and reader
# --------------------------------------------------------------------- #

def test_crc32c_known_vectors():
    assert crc32c(b"") == 0x0
    assert crc32c(b"a") == 0xC1D04330
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43


def test_masked_crc_matches_tf_masking():
    crc = crc32c(b"123456789")
    expected = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    assert masked_crc32c(b"123456789") == expected
    assert masked_crc32c(b"123456789") == jvis.masked_crc32c(b"123456789")


def test_record_roundtrip(tmp_path):
    p = str(tmp_path / "rec")
    w = RecordWriter(p)
    payloads = [b"hello", b"", b"x" * 1000]
    for pl in payloads:
        w.write(pl)
    w.close()
    assert list(read_records(p)) == payloads
    assert list(jvis.read_records(p)) == payloads


def test_record_truncation_tolerated(tmp_path):
    p = str(tmp_path / "rec")
    w = RecordWriter(p)
    w.write(b"complete")
    w.close()
    with open(p, "ab") as f:
        f.write(b"\x99" * 7)
    assert list(read_records(p)) == [b"complete"]


def test_event_proto_roundtrip():
    ev = Event(wall_time=123.5, step=7,
               values=[scalar("Loss", 0.25), scalar("Throughput", 1e4)])
    dec = decode_event(ev.encode())
    assert dec.step == 7 and abs(dec.wall_time - 123.5) < 1e-9
    assert {v.tag: v.simple_value for v in dec.values} == \
        {"Loss": 0.25, "Throughput": pytest.approx(1e4)}


def test_event_proto_parses_with_tensorflow_proto():
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    ev = Event(wall_time=9.75, step=42,
               values=[scalar("acc", 0.5), histogram("w", [0.1, -0.2, 0.0])])
    tf_ev = event_pb2.Event()
    tf_ev.ParseFromString(ev.encode())
    assert tf_ev.step == 42 and tf_ev.wall_time == 9.75
    vals = {v.tag: v for v in tf_ev.summary.value}
    assert vals["acc"].simple_value == 0.5
    h = vals["w"].histo
    assert h.num == 3 and h.min == -0.2 and h.max == pytest.approx(0.1)
    assert sum(h.bucket) == 3


def test_histogram_buckets():
    v = histogram("h", np.array([0.0, 1e-13, 5.0, -3.0]))
    h = v.histo
    assert h.num == 4
    assert h.sum == pytest.approx(2.0 + 1e-13)
    assert sum(h.bucket) == 4
    assert all(b >= 0 for b in h.bucket)
    assert h.bucket_limit == sorted(h.bucket_limit)


def test_filewriter_reader_roundtrip(tmp_path):
    d = str(tmp_path / "logs")
    w = FileWriter(d)
    for step in range(5):
        w.add_summary(scalar("Loss", 1.0 / (step + 1)), step)
    w.close()
    got = read_scalar(d, "Loss")
    assert [s for s, _v, _t in got] == [0, 1, 2, 3, 4]
    assert got[0][1] == pytest.approx(1.0)
    assert got[4][1] == pytest.approx(0.2)
    assert list_tags(d) == ["Loss"]


def test_train_summary_triggers(tmp_path):
    ts = TrainSummary(str(tmp_path), "app")
    assert ts.get_summary_trigger("Loss") is not None
    assert ts.get_summary_trigger("Parameters") is None
    ts.set_summary_trigger("Parameters", optim.Trigger.several_iteration(10))
    assert ts.should_record("Parameters", {"neval": 10})
    assert not ts.should_record("Parameters", {"neval": 11})
    with pytest.raises(ValueError):
        ts.set_summary_trigger("Bogus", optim.Trigger.several_iteration(1))
    ts.add_scalar("Loss", 0.5, 1)
    assert ts.read_scalar("Loss")[0][:2] == (1, 0.5)
    ts.close()
    assert "train" in os.listdir(os.path.join(str(tmp_path), "app"))


def _write_events(mod, d):
    w = mod.FileWriter(str(d))
    w.add_summary(mod.scalar("Loss", 0.123456), 3)
    rng = np.random.RandomState(0)
    w.add_summary(mod.histogram("layers/w", rng.randn(257) * 1e-2), 3)
    w.add_summary([mod.scalar("LearningRate", 3e-4),
                   mod.scalar("Throughput", 8192.5)], 4)
    w.close()
    (path,) = [os.path.join(str(d), f) for f in os.listdir(str(d))]
    return path


def test_event_bytes_equal_the_reference(tmp_path, monkeypatch):
    """Under one clock, the port's file and the reference's are the same
    bytes (their names too), and each package reads the other's."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    port = _write_events(__import__("bigdl_tpu_torch.visualization",
                                    fromlist=["x"]), tmp_path / "port")
    ref = _write_events(jvis, tmp_path / "ref")
    assert os.path.basename(port) == os.path.basename(ref)
    assert open(port, "rb").read() == open(ref, "rb").read()
    for reader, path in ((jvis, port), (
            __import__("bigdl_tpu_torch.visualization", fromlist=["x"]), ref)):
        assert reader.list_tags(path) == ["LearningRate", "Loss",
                                          "Throughput", "layers/w"]
        assert reader.read_scalar(path, "Loss")[0][:2] == \
            (3, pytest.approx(0.123456))
    evs = [decode_event(p) for p in read_records(ref)]
    (h,) = [v.histo for e in evs for v in e.values if v.histo is not None]
    assert h.num == 257 and sum(h.bucket) == 257


# --------------------------------------------------------------------- #
# phase metrics and the registry export
# --------------------------------------------------------------------- #

def test_metrics_summary_units():
    m = Metrics()
    m.set("computing time", 3.0, parallel=2)
    m.set("batches", 6.0, parallel=2, unit="batches")
    m.add("records", 10.0, unit="")
    out = m.summary()
    assert "computing time : 1.5 s" in out
    assert "batches : 3.0 batches" in out
    assert "batches : 3.0 s" not in out
    assert "records : 10.0" in out and "records : 10.0 s" not in out
    scaled = m.summary(unit_scale=1e-3)
    assert "computing time : 1500.0 s" in scaled
    assert "batches : 3.0 batches" in scaled
    jm = JaxMetrics()
    jm.set("computing time", 3.0, parallel=2)
    jm.set("batches", 6.0, parallel=2, unit="batches")
    jm.add("records", 10.0, unit="")
    assert jm.summary() == out


def test_metrics_aggregate_single_process_noop(monkeypatch):
    m = Metrics()
    m.set("shard data time", 2.0, parallel=4)
    out = m.aggregate()
    assert out is m
    assert m.get("shard data time") == (2.0, 4)
    # across ranks: one all_reduce sum of every counter, then the mean
    # (here two ranks whose counters are equal, so the mean is the value)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    calls = []

    def all_reduce(t, op=None, group=None):
        calls.append(t.clone())
        t.mul_(2)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    out = m.aggregate()
    assert out is not m and len(calls) == 1
    assert out.get("shard data time") == (2.0, 4)


def test_metrics_publish_to_registry_live():
    reg = MetricRegistry()
    m = Metrics().publish_to(reg)
    m.set("computing time", 1.0)
    assert reg.snapshot()["train/computing time"]["value"] == 1.0
    m.add("computing time", 0.5)
    assert reg.snapshot()["train/computing time"]["value"] == 1.5
    m2 = Metrics().publish_to(reg)
    m2.set("computing time", 9.0)
    assert reg.snapshot()["train/computing time"]["value"] == 9.0


def test_registry_export_through_visualization(tmp_path):
    reg = MetricRegistry()
    reg.counter("train/loss_sum").set(1.5)
    h = reg.histogram("serving/latency")
    h.observe(0.01)
    s = ObsSummary(str(tmp_path), "app")
    wrote = reg.export_to_summary(s, step=3)
    assert wrote >= 3
    vals = s.read_scalar("Obs/train/loss_sum")
    assert vals and vals[0][:2] == (3, 1.5)
    lat = s.read_scalar("Obs/serving/latency/p50_s")
    assert lat and lat[0][1] > 0
    s.close()


# --------------------------------------------------------------------- #
# the training loop's summaries, watchdog and escalation
# --------------------------------------------------------------------- #

_KW = dict(hidden_size=32, n_head=2, n_layers=2, max_len=16)


def _corpora():
    tok, dic = jax_lm_corpus(SYNTH_CORPUS, 100)
    ttok, tdic = lm_corpus(SYNTH_CORPUS, 100)
    return (tok, dic), (ttok, tdic)


def _crit(lib):
    return lib.TimeDistributedCriterion(lib.ClassNLLCriterion(), True)


def _port_pair(seed=2, method=None, end=6):
    (tok, dic), (ttok, tdic) = _corpora()
    kw = dict(_KW, vocab_size=dic.vocab_size())
    jm = JaxLM(attention_impl="xla", **kw).build(seed=seed)
    tm = TransformerLM(attention_impl="xla", device="cpu", **kw)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    opt = optim.LocalOptimizer(tm, lm_dataset(ttok, tdic, 16, 4, packed=True),
                               _crit(tnn))
    opt.set_optim_method(method or optim.Adam(learning_rate=3e-3))
    opt.set_end_when(optim.Trigger.max_iteration(end))
    return jm, tm, opt, (tok, dic)


def test_named_leaves_are_the_reference_tags():
    jm, tm, _, _ = _port_pair()
    want = ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jm.params)[0]]
    assert [n for n, _ in named_leaves(tm.params)] == want


def test_optimizer_writes_summaries(tmp_path):
    _, tm, opt, _ = _port_pair(end=4)
    ts = TrainSummary(str(tmp_path), "job")
    ts.set_summary_trigger("Parameters", optim.Trigger.several_iteration(2))
    vs = ValidationSummary(str(tmp_path), "job")
    (_, _), (ttok, tdic) = _corpora()
    losses = []
    opt.set_train_summary(ts).set_validation_summary(vs) \
       .set_validation(optim.Trigger.several_iteration(2),
                       lm_dataset(ttok, tdic, 16, 4, packed=True),
                       [optim.Loss(_crit(tnn))])
    orig = opt._record_train_summary

    def spy(loss_val, *a, **k):
        losses.append(loss_val)
        return orig(loss_val, *a, **k)

    opt._record_train_summary = spy
    opt.optimize()
    got = ts.read_scalar("Loss")
    assert [s for s, _v, _t in got] == [1, 2, 3, 4]
    assert [v for _s, v, _t in got] == [np.float32(x) for x in losses]
    lrs = ts.read_scalar("LearningRate")
    assert lrs and all(v == pytest.approx(3e-3) for _s, v, _t in lrs)
    thr = ts.read_scalar("Throughput")
    assert thr and all(v > 0 for _s, v, _t in thr)
    val = vs.read_scalar("Loss")
    # the reference's step: the iteration just finished (neval - 1)
    assert [s for s, _v, _t in val] == [1, 3]
    ts.flush()
    names = [n for n, _ in named_leaves(tm.params)]
    tags = set(list_tags(ts.folder))
    assert set(names) <= tags
    # one histogram per leaf at each Parameters step (2 and 4)
    steps = {}
    for payload in read_records(ts.writer._event_writer.path):
        ev = decode_event(payload)
        for v in ev.values:
            if v.histo is not None:
                steps.setdefault(ev.step, []).append(v.tag)
    assert sorted(steps) == [2, 4]
    assert all(sorted(t) == sorted(names) for t in steps.values())
    assert len(opt.summary_ms["parameters"]) == 2
    assert len(opt.summary_ms["scalars"]) == 4
    ts.close()
    vs.close()
    assert get_registry().snapshot()["train/computing time"]["value"] > 0


class _SleepyAdam(optim.Adam):
    """Adam whose ``at``-th update sleeps ``s`` seconds."""

    def __init__(self, at, s, **kw):
        super().__init__(**kw)
        self.at, self.s, self.updates = at, s, 0

    def stage(self, grads, state, params, epoch=1):
        self.updates += 1
        if self.updates == self.at:
            time.sleep(self.s)
        return super().stage(grads, state, params, epoch)


def test_stall_escalates_to_a_checkpoint_at_the_next_iteration(
        tmp_path, monkeypatch):
    """O4 on the CPU: a step past the watchdog's deadline fires one
    stall bundle, and the loop writes an emergency pair at the iteration
    that step completes, equal to an undisturbed run's weights there."""
    # the deadline rule alone (a k this large never fires on a median):
    # a step of this loaded CPU never takes 1.5 s, the sleep takes 3.5
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG", "1")
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG_K", "1000")
    monkeypatch.setenv("BIGDL_TPU_WATCHDOG_DEADLINE_S", "1.5")
    old = flight_mod.get_flight_recorder()
    rec = flight_mod.configure(
        enabled=True, out_dir=str(tmp_path / "flight"),
        incidents_path=str(tmp_path / "INC.json"))
    emerg = _counter("resilience/emergency_checkpoints")
    try:
        _, tm, opt, _ = _port_pair(
            method=_SleepyAdam(5, 3.5, learning_rate=3e-3))
        opt.set_checkpoint(str(tmp_path / "ck"),
                           optim.Trigger.several_iteration(1000))
        opt.optimize()
    finally:
        flight_mod._GLOBAL = old
    assert _counter("resilience/emergency_checkpoints") - emerg == 1
    found = file_io.latest_checkpoint(str(tmp_path / "ck"))
    assert found is not None and found[2] == 5
    bundles = [json.load(open(p))
               for p in (tmp_path / "flight").glob("FLIGHT_*.json")]
    assert [b["flight"] for b in bundles] == ["stall"]
    assert bundles[0]["detail"]["watchdog"] == "train_step"
    assert rec.bundles_written == 1
    _, tm5, opt5, _ = _port_pair(end=5)
    opt5.optimize()
    saved = TransformerLM.load(found[0], device="cpu")
    for a, b in zip(tree_leaves(saved.params), tree_leaves(tm5.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# the emergency checkpoint after a failure inside the update
# --------------------------------------------------------------------- #

class _FailingAdam(optim.Adam):
    """Adam whose 3rd update raises after staging one leaf (``fail_at``
    None: never)."""

    def __init__(self, fail_at=3, **kw):
        super().__init__(**kw)
        self.fail_at, self.updates, self.staged_leaves = fail_at, 0, 0

    def stage(self, grads, state, params, epoch=1):
        self.updates += 1
        self.staged_leaves = 0
        return super().stage(grads, state, params, epoch)

    def _post_step(self, w_new, w_old, lr):
        self.staged_leaves += 1
        if self.updates == self.fail_at and self.staged_leaves == 2:
            raise RuntimeError("injected failure inside update")
        return super()._post_step(w_new, w_old, lr)


class _JaxFailingAdam(joptim.Adam):
    """The reference's Adam whose 3rd update raises on the device (a
    host callback inside the jitted step)."""

    def update(self, grads, state, params, epoch=1):
        new_params, new_state = super().update(grads, state, params, epoch)

        def boom(it):
            if int(it) == 3:
                raise RuntimeError("injected failure inside update")

        jax.debug.callback(boom, new_state["iteration"])
        return new_params, new_state


class _JaxUndonatedOptimizer(joptim.LocalOptimizer):
    """The reference's loop with its step jitted without donation.  Its
    step donates the params and the optimizer state, so a failure raised
    while the step runs (as the callback above does) deletes the arrays
    the emergency checkpoint would write; here they stay alive, as on a
    backend that ignores donation."""

    def _build_step(self):
        return jax.jit(super()._build_step().__wrapped__)


def _jax_opt(jm, tok, dic, method, end=6):
    jopt = _JaxUndonatedOptimizer(
        jm, jax_lm_dataset(tok, dic, 16, 4, packed=True), _crit(jnn))
    jopt.set_optim_method(method)
    jopt.set_end_when(joptim.Trigger.max_iteration(end))
    return jopt


def _leaves_by_name(params):
    return {n: (a.numpy() if hasattr(a, "numpy") else np.asarray(a))
            for n, a in named_leaves(params)}


def _jax_leaves_by_name(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_failure_inside_update_writes_the_reference_pair(tmp_path):
    """Both packages' Adam raise inside the update of iteration 3; both
    write an emergency pair of iteration 2, equal to each package's own
    uninterrupted iteration 2 bitwise and to each other within 1e-6
    (float32 gradients of two implementations; Adam's eps is 1e-3 so
    that a leaf whose exact gradient is zero, attn/bk, does not turn
    their noise into full steps of opposite sign).  Resuming the port's
    pair and finishing equals the uninterrupted run within 1e-6/1e-7."""
    adam = dict(learning_rate=3e-3, eps=EPS)
    jm, tm, opt, (tok, dic) = _port_pair(method=_FailingAdam(**adam))
    assert stages_updates(opt.optim_method)
    opt.set_checkpoint(str(tmp_path / "port"),
                       optim.Trigger.several_iteration(1000))
    emerg = _counter("resilience/emergency_checkpoints")
    with pytest.raises(RuntimeError, match="inside update"):
        opt.optimize()
    assert _counter("resilience/emergency_checkpoints") - emerg == 1
    assert opt.optim_method.staged_leaves == 2   # one leaf staged first

    jopt = _jax_opt(jm, tok, dic, _JaxFailingAdam(**adam))
    jopt.set_checkpoint(str(tmp_path / "ref"),
                        joptim.Trigger.several_iteration(1000))
    with pytest.raises(Exception, match="inside update"):
        jopt.optimize()

    pairs = {}
    for side in ("port", "ref"):
        found = file_io.latest_checkpoint(str(tmp_path / side))
        assert found is not None and found[2] == 2
        assert sorted(os.listdir(str(tmp_path / side))) == [
            "model.2", "state.2"]
        pairs[side] = found
    snaps = {k: file_io.load(v[1]) for k, v in pairs.items()}
    for key in ("neval", "records_processed", "epoch"):
        assert snaps["port"]["driver_state"][key] == \
            snaps["ref"]["driver_state"][key]
    assert snaps["port"]["driver_state"]["records_processed"] == 8
    assert int(snaps["port"]["optim_state"]["iteration"]) == \
        int(snaps["ref"]["optim_state"]["iteration"]) == 2

    # each pair is its own package's iteration 2, bitwise
    _, tm2, opt2, _ = _port_pair(method=optim.Adam(**adam), end=2)
    opt2.optimize()
    jm2 = JaxLM(attention_impl="xla",
                **dict(_KW, vocab_size=dic.vocab_size())).build(seed=2)
    _jax_opt(jm2, tok, dic, joptim.Adam(**adam), end=2).optimize()
    # the pairs are format 1: each package reads the other's model file
    template = JaxLM(attention_impl="xla",
                     **dict(_KW, vocab_size=dic.vocab_size()))
    port_pair = _leaves_by_name(
        TransformerLM.load(pairs["port"][0], device="cpu").params)
    port_pair_in_jax = _jax_leaves_by_name(
        jnn.Module.load(pairs["port"][0], template=template).params)
    ref_pair = _jax_leaves_by_name(
        jnn.Module.load(pairs["ref"][0], template=template).params)
    ref_pair_in_port = _leaves_by_name(
        TransformerLM.load(pairs["ref"][0], device="cpu").params)
    port_own, ref_own = (_leaves_by_name(tm2.params),
                         _jax_leaves_by_name(jm2.params))
    assert set(port_pair) == set(ref_pair) == set(port_own)
    for name in port_pair:
        np.testing.assert_array_equal(port_pair[name], port_own[name])
        np.testing.assert_array_equal(port_pair_in_jax[name],
                                      port_pair[name])
        np.testing.assert_array_equal(ref_pair[name], ref_own[name])
        np.testing.assert_array_equal(ref_pair_in_port[name], ref_pair[name])
        np.testing.assert_allclose(port_pair[name], ref_pair[name],
                                   rtol=RTOL, atol=1e-6, err_msg=name)
    for a, b in zip(jax.tree_util.tree_leaves(
                        snaps["port"]["optim_state"]["m"]),
                    jax.tree_util.tree_leaves(
                        snaps["ref"]["optim_state"]["m"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)

    # resume the port's pair and finish: the uninterrupted run's end
    _, tm_a, opt_a, _ = _port_pair(method=optim.Adam(**adam))
    opt_a.optimize()
    _, tm_c, opt_c, _ = _port_pair(
        seed=11, method=_FailingAdam(fail_at=None, **adam))
    opt_c.resume_from(str(tmp_path / "port"))
    assert opt_c.state["neval"] == 3
    opt_c.optimize()
    for a, c in zip(tree_leaves(tm_a.params), tree_leaves(tm_c.params)):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=RTOL,
                                   atol=ATOL)


class _InPlaceThenRaise(optim.OptimMethod):
    """A user's method with only an in-place ``update``: its 3rd call
    writes the first leaf, then raises."""

    def __init__(self):
        self.calls = 0

    def update(self, grads, state, params, epoch=1):
        self.calls += 1
        with torch.no_grad():
            for w, g in zip(tree_leaves(params), tree_leaves(grads)):
                w.sub_(0.01 * g)
                if self.calls == 3:
                    raise RuntimeError("in-place update failed midway")
        state["iteration"] += 1
        return params, state


class _JaxPlainThenRaise(joptim.OptimMethod):
    """The reference's counterpart of ``_InPlaceThenRaise``: the same
    step, functional, raising on the device in its 3rd update."""

    def update(self, grads, state, params, epoch=1):
        new = jax.tree_util.tree_map(lambda w, g: w - 0.01 * g, params,
                                     grads)
        it = state["iteration"] + 1

        def boom(i):
            if int(i) == 3:
                raise RuntimeError("in-place update failed midway")

        jax.debug.callback(boom, it)
        return new, {"iteration": it}


def test_in_place_user_method_failure_writes_the_reference_pair(tmp_path):
    """A user's in-place method writes its first leaf, then raises in
    its 3rd update: the loop rolls the update back to its snapshot and
    writes the emergency pair of iteration 2, as the reference (whose
    updates are functional) does for any method: the same driver state,
    and params within 1e-6 of the reference's."""
    jm, tm, opt, (tok, dic) = _port_pair(method=_InPlaceThenRaise())
    assert not stages_updates(opt.optim_method)
    opt.set_checkpoint(str(tmp_path / "port"),
                       optim.Trigger.several_iteration(1000))
    emerg = _counter("resilience/emergency_checkpoints")
    with pytest.raises(RuntimeError, match="midway"):
        opt.optimize()
    assert _counter("resilience/emergency_checkpoints") - emerg == 1

    jopt = _jax_opt(jm, tok, dic, _JaxPlainThenRaise())
    jopt.set_checkpoint(str(tmp_path / "ref"),
                        joptim.Trigger.several_iteration(1000))
    with pytest.raises(Exception, match="midway"):
        jopt.optimize()

    pairs = {}
    for side in ("port", "ref"):
        found = file_io.latest_checkpoint(str(tmp_path / side))
        assert found is not None and found[2] == 2
        assert sorted(os.listdir(str(tmp_path / side))) == [
            "model.2", "state.2"]
        pairs[side] = found
    snaps = {k: file_io.load(v[1]) for k, v in pairs.items()}
    for key in ("neval", "records_processed", "epoch"):
        assert snaps["port"]["driver_state"][key] == \
            snaps["ref"]["driver_state"][key]
    assert snaps["port"]["driver_state"]["records_processed"] == 8
    assert int(snaps["port"]["optim_state"]["iteration"]) == \
        int(snaps["ref"]["optim_state"]["iteration"]) == 2
    template = JaxLM(attention_impl="xla",
                     **dict(_KW, vocab_size=dic.vocab_size()))
    port_pair = _leaves_by_name(
        TransformerLM.load(pairs["port"][0], device="cpu").params)
    ref_pair = _jax_leaves_by_name(
        jnn.Module.load(pairs["ref"][0], template=template).params)
    assert set(port_pair) == set(ref_pair)
    for name in port_pair:
        np.testing.assert_allclose(port_pair[name], ref_pair[name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # the weights the loop left are the pair's: the partial write of
    # the failed update was rolled back
    for name, leaf in _leaves_by_name(tm.params).items():
        np.testing.assert_array_equal(leaf, port_pair[name])


class _ListMomentThenRaise(optim.OptimMethod):
    """A user's in-place method that keeps its moments in a list and a
    log of its calls in another: its 3rd call appends to the log, writes
    a moment and a weight, then raises."""

    def __init__(self):
        self.calls = 0
        self.after2 = None

    def init_state(self, params):
        return {"iteration": 0, "log": [],
                "moments": [torch.zeros_like(w) for w in tree_leaves(params)]}

    def update(self, grads, state, params, epoch=1):
        self.calls += 1
        state["log"].append(self.calls)
        with torch.no_grad():
            for w, g, m in zip(tree_leaves(params), tree_leaves(grads),
                               state["moments"]):
                m.mul_(0.9).add_(g)
                w.sub_(0.01 * m)
                if self.calls == 3:
                    raise RuntimeError("in-place update failed midway")
        state["iteration"] += 1
        if self.calls == 2:
            self.after2 = ([m.clone() for m in state["moments"]],
                           [w.clone() for w in tree_leaves(params)])
        return params, state


def test_in_place_failure_restores_state_kept_in_lists(tmp_path):
    """The snapshot reaches a moment kept in a list and a list the
    failed update appended to: the loop is left with iteration 2's
    weights, moments and log, bit for bit, and writes them as the
    emergency pair."""
    method = _ListMomentThenRaise()
    _, tm, opt, _ = _port_pair(method=method)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1000))
    emerg = _counter("resilience/emergency_checkpoints")
    with pytest.raises(RuntimeError, match="midway"):
        opt.optimize()
    assert _counter("resilience/emergency_checkpoints") - emerg == 1
    state = method._state
    assert state["iteration"] == 2 and state["log"] == [1, 2]
    moments, weights = method.after2
    assert len(state["moments"]) == len(moments)
    for a, b in zip(state["moments"] + tree_leaves(tm.params),
                    moments + weights):
        assert torch.equal(a, b)
    found = file_io.latest_checkpoint(str(tmp_path))
    assert found is not None and found[2] == 2
    saved = file_io.load(found[1])["optim_state"]
    assert list(saved["log"]) == [1, 2]
    for a, b in zip(saved["moments"], moments):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_update_snapshot_restores_tables_tuples_and_arrays():
    """``UpdateSnapshot`` puts back a Table's entries, the tensors under
    a tuple and a numpy array's values, and refuses a leaf it cannot
    restore before the update runs."""
    from bigdl_tpu_torch.optim.optimizer import UpdateSnapshot
    from bigdl_tpu_torch.utils.table import Table
    w = torch.arange(4.0)
    t = Table(torch.ones(2), "tag")
    state = {"pair": (torch.zeros(3), 7), "table": t,
             "host": np.arange(3.0)}
    snap = UpdateSnapshot()
    snap.take({"w": w}, state)
    w.add_(1)
    state["pair"][0].fill_(5)
    t[1].mul_(3)
    t[3] = "extra"
    state["host"][:] = -1
    state["new"] = 1
    snap.restore()
    assert torch.equal(w, torch.arange(4.0))
    assert torch.equal(state["pair"][0], torch.zeros(3))
    assert torch.equal(t[1], torch.ones(2)) and sorted(t.keys()) == [1, 2]
    np.testing.assert_array_equal(state["host"], np.arange(3.0))
    assert "new" not in state
    with pytest.raises(TypeError, match="cannot restore"):
        snap.take({"w": w}, {"opaque": object()})


@pytest.mark.parametrize("method", ["sgd", "sgd_nesterov", "adam", "adamw",
                                    "adagrad"])
def test_staged_update_equals_the_reference_step(method):
    """Stage-then-commit keeps the reference's arithmetic: one update of
    each built-in method on seeded leaves equals the JAX package's."""
    rng = np.random.RandomState(4)
    p = {"a": rng.randn(3, 4).astype(np.float32),
         "b": {"c": rng.randn(5).astype(np.float32)}}
    g = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(
        np.float32), p)
    kw = {"sgd": dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3),
          "sgd_nesterov": dict(learning_rate=0.1, momentum=0.9,
                               nesterov=True),
          "adam": dict(learning_rate=3e-3, weight_decay=1e-2),
          "adamw": dict(learning_rate=3e-3, weight_decay=1e-2),
          "adagrad": dict(learning_rate=0.1, learning_rate_decay=0.01)}[method]
    name = {"sgd": "SGD", "sgd_nesterov": "SGD", "adam": "Adam",
            "adamw": "AdamW", "adagrad": "Adagrad"}[method]
    tm, jm = getattr(optim, name)(**kw), getattr(joptim, name)(**kw)
    tp = params_from_numpy(p, "cpu")
    tg = params_from_numpy(g, "cpu")
    ts, js = tm.init_state(tp), jm.init_state(
        jax.tree_util.tree_map(jnp.asarray, p))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    for _ in range(3):
        tm.update(tg, ts, tp)
        jp, js = jm.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    assert ts["iteration"] == int(js["iteration"]) == 3
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
