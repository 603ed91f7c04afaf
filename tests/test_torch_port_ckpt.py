"""bigdl_tpu_torch's checkpoints against the JAX package on the CPU:
the filesystem layer, the format-1 model files (read and written by
both packages), ``resume_from`` across packages, the emergency
checkpoint of a crashed loop, preemption, the optimizer-state refusal,
the dictionary file, and the train and eval CLIs.  Mirrors
tests/test_fs_checkpoint.py, tests/test_resilience.py (the mid-epoch
crash and the cold start) and tests/test_optim.py (the method mismatch
and SIGTERM) on a small TransformerLM."""
import io
import os
import pickle
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.utils import lm_corpus as jax_lm_corpus
from bigdl_tpu.models.utils import lm_dataset as jax_lm_dataset
from bigdl_tpu.models.utils import restore_optim_state as jax_restore

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset import text
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.utils import (SYNTH_CORPUS, lm_corpus, lm_dataset,
                                          restore_optim_state)
from bigdl_tpu_torch.obs import get_registry
from bigdl_tpu_torch.resilience.errors import TransientBackendError
from bigdl_tpu_torch.utils import file_io, fs
from bigdl_tpu_torch.utils.params import (params_from_numpy, params_to_numpy,
                                          tree_leaves)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _counter(name):
    return get_registry().counter(name).value


def _lm_kw(vocab, **over):
    kw = dict(vocab_size=vocab, hidden_size=32, n_head=2, n_layers=2,
              max_len=16)
    kw.update(over)
    return kw


def _corpora():
    tok, dic = jax_lm_corpus(SYNTH_CORPUS, 100)
    ttok, tdic = lm_corpus(SYNTH_CORPUS, 100)
    return (tok, dic), (ttok, tdic)


def _crit(lib):
    return lib.TimeDistributedCriterion(lib.ClassNLLCriterion(), True)


# --------------------------------------------------------------------------- #
# the filesystem layer                                                        #
# --------------------------------------------------------------------------- #

class TestFsLayer:
    def test_memory_roundtrip(self):
        fs.atomic_write("memory://ckpt/blob", b"hello")
        assert fs.exists("memory://ckpt/blob")
        with fs.open_file("memory://ckpt/blob") as f:
            assert f.read() == b"hello"
        assert fs.listdir("memory://ckpt") == ["blob"]
        fs.remove("memory://ckpt/blob")
        assert not fs.exists("memory://ckpt/blob")

    def test_local_roundtrip(self, tmp_path):
        p = str(tmp_path / "sub" / "f.bin")
        fs.atomic_write(p, b"xyz")
        with fs.open_file("file://" + p) as f:
            assert f.read() == b"xyz"
        assert os.listdir(tmp_path / "sub") == ["f.bin"]  # no .tmp left

    def test_join_preserves_scheme(self):
        assert fs.join("memory://ckpt", "model.3") == "memory://ckpt/model.3"
        assert fs.join("gs://bucket/dir/", "state.1") == \
            "gs://bucket/dir/state.1"

    def test_unknown_scheme_message(self):
        with pytest.raises(ValueError, match="'gs'"):
            fs.open_file("gs://bucket/x")
        with pytest.raises(ValueError, match="'hdfs'"):
            optim.LocalOptimizer(None, None, None).set_checkpoint(
                "hdfs://nn/ckpt", optim.Trigger.every_epoch())

    def test_register_filesystem_override(self):
        probe = fs.MemoryFileSystem()
        fs.register_filesystem("probe", probe)
        fs.atomic_write("probe://a", b"1")
        assert probe.exists("a")


# --------------------------------------------------------------------------- #
# model files                                                                 #
# --------------------------------------------------------------------------- #

def _audit_globals(raw: bytes) -> list:
    seen = []

    class Audit(pickle.Unpickler):
        def find_class(self, module, name):
            seen.append(f"{module}.{name}")
            return super().find_class(module, name)

    Audit(io.BytesIO(raw)).load()
    return seen


class TestModuleCheckpointFormat:
    def test_no_live_objects_in_checkpoint(self):
        """Model and state files unpickle with numpy alone: no global of
        either package, none of torch."""
        m = TransformerLM(device="cpu", moe_experts=2,
                          **_lm_kw(13)).build(1)
        m.save("memory://fmt/model", overwrite=True)
        file_io.save({"optim_state": file_io.state_to_numpy(
            optim.Adam().init_state(m.params))}, "memory://fmt/state",
            overwrite=True)
        for name in ("model", "state"):
            with fs.open_file(f"memory://fmt/{name}") as f:
                seen = _audit_globals(f.read())
            assert all(s.startswith(("numpy.", "builtins.")) for s in seen), \
                seen

    @pytest.mark.parametrize("over", [
        dict(moe_experts=2, moe_capacity_factor=0.5, moe_aux_weight=0.1),
        dict(pos_encoding="rope", tie_embeddings=False, doc_start_id=3)])
    def test_roundtrip_through_memory_fs(self, over):
        m = TransformerLM(device="cpu", **_lm_kw(13, **over)).build(2)
        x = torch.from_numpy(np.random.RandomState(0).randint(1, 14, (2, 9)))
        want = m.f(m.params, x)
        m.save("memory://rt/model", overwrite=True)
        with pytest.raises(FileExistsError):
            m.save("memory://rt/model")
        loaded = TransformerLM.load("memory://rt/model", device="cpu")
        for k, v in over.items():
            assert getattr(loaded, k) == v, k
        assert torch.equal(loaded.f(loaded.params, x), want)
        assert loaded.buffers.keys() == m.buffers.keys()

    def test_template_restore_is_rename_proof(self):
        m = TransformerLM(device="cpu", **_lm_kw(13)).build(4)
        m.save("memory://tpl/model", overwrite=True)
        state = file_io.load("memory://tpl/model")
        state["spec"]["class"] = "bigdl_tpu_torch.DOES_NOT_EXIST:Nope"
        file_io.save(state, "memory://tpl/model", overwrite=True)
        with pytest.raises(ValueError, match="Nope"):
            TransformerLM.load("memory://tpl/model", device="cpu")
        tpl = TransformerLM(device="cpu", **_lm_kw(13))
        loaded = TransformerLM.load("memory://tpl/model", template=tpl)
        assert loaded is tpl
        for a, b in zip(tree_leaves(loaded.params), tree_leaves(m.params)):
            assert torch.equal(a, b)

    def test_template_tree_mismatch_raises(self):
        m = TransformerLM(device="cpu", **_lm_kw(13)).build(5)
        m.save("memory://mm/model", overwrite=True)
        with pytest.raises(ValueError, match="does not match"):
            TransformerLM.load("memory://mm/model", template=TransformerLM(
                device="cpu", moe_experts=2, **_lm_kw(13)))
        with pytest.raises(ValueError, match="shape"):
            TransformerLM.load("memory://mm/model", template=TransformerLM(
                device="cpu", **_lm_kw(13, hidden_size=16)))

    def test_quantized_model_is_refused(self):
        q = TransformerLM(device="cpu", **_lm_kw(13)).build(0).quantize()
        with pytest.raises(TypeError, match="quantized"):
            q.save("memory://q/model", overwrite=True)

    def test_checkpoint_resume_through_memory_fs(self):
        (_, _), (ttok, tdic) = _corpora()
        ds = lm_dataset(ttok, tdic, 16, 4, packed=True)
        m = TransformerLM(device="cpu", **_lm_kw(tdic.vocab_size())).build(3)
        opt = optim.LocalOptimizer(m, ds, _crit(tnn))
        opt.set_optim_method(optim.SGD(learning_rate=0.1)) \
           .set_end_when(optim.Trigger.max_iteration(3)) \
           .set_checkpoint("memory://ckpt-rt",
                           optim.Trigger.several_iteration(1))
        opt.optimize()
        assert fs.exists("memory://ckpt-rt/model.3")
        assert opt.last_checkpoint["iteration"] == 3
        assert opt.last_checkpoint["bytes"] > 0
        restored = TransformerLM.load("memory://ckpt-rt/model.3",
                                      device="cpu")
        snap = file_io.load("memory://ckpt-rt/state.3")
        assert snap["driver_state"]["neval"] == 4
        assert snap["optim_method"] == "SGD"
        it = snap["optim_state"]["iteration"]
        assert isinstance(it, np.ndarray) and it.dtype == np.int32 \
            and it.shape == () and int(it) == 3
        x = torch.from_numpy(np.random.RandomState(0).randint(1, 10, (2, 9)))
        assert torch.equal(restored.f(restored.params, x), m.f(m.params, x))


# --------------------------------------------------------------------------- #
# across packages                                                             #
# --------------------------------------------------------------------------- #

def _jax_opt(jm, tok, dic, lr=3e-3):
    jopt = joptim.LocalOptimizer(jm, jax_lm_dataset(tok, dic, 16, 4,
                                                    packed=True), _crit(jnn))
    return jopt.set_optim_method(joptim.Adam(learning_rate=lr))


def _port_opt(tm, ttok, tdic, lr=3e-3):
    topt = optim.LocalOptimizer(tm, lm_dataset(ttok, tdic, 16, 4,
                                               packed=True), _crit(tnn))
    return topt.set_optim_method(optim.Adam(learning_rate=lr))


@pytest.mark.parametrize("moe", [0, 4])
def test_jax_checkpoint_resumes_in_port(tmp_path, moe):
    """The JAX package trains 3 Adam steps under set_checkpoint; a fresh
    port model and optimizer resume from that directory, and their 4th
    step's loss equals the JAX package's own resume of it (1e-5).  The
    JAX model file also loads without a template into an equivalent
    port model."""
    (tok, dic), (ttok, tdic) = _corpora()
    kw = _lm_kw(dic.vocab_size(), moe_experts=moe)
    jm = JaxLM(attention_impl="xla", **kw).build(seed=2)
    jopt = _jax_opt(jm, tok, dic)
    jopt.set_end_when(joptim.Trigger.max_iteration(3)) \
        .set_checkpoint(str(tmp_path), joptim.Trigger.several_iteration(1))
    jopt.optimize()

    resumes = _counter("resilience/resumes")
    tm = TransformerLM(attention_impl="xla", device="cpu", **kw).build(9)
    topt = _port_opt(tm, ttok, tdic)
    topt.resume_from(str(tmp_path))
    assert _counter("resilience/resumes") - resumes == 1
    assert topt.state["neval"] == 4
    assert topt.optim_method._state["iteration"] == 3
    assert set(tm.buffers) == ({"aux_loss"} if moe else set())
    loaded = TransformerLM.load(str(tmp_path / "model.3"), device="cpu")
    assert loaded.moe_experts == moe
    x = np.random.RandomState(1).randint(1, dic.vocab_size() + 1,
                                         (2, 9)).astype(np.float32)
    np.testing.assert_allclose(
        loaded.f(loaded.params, torch.from_numpy(x)).numpy(),
        np.asarray(jm.f(jm.params, jnp.asarray(x))), atol=1e-5)

    jm2 = JaxLM(attention_impl="xla", **kw).build(seed=9)
    jopt2 = _jax_opt(jm2, tok, dic).resume_from(str(tmp_path))
    for o, lib in ((topt, optim), (jopt2, joptim)):
        o.set_end_when(lib.Trigger.max_iteration(4))
        o.optimize()
    assert topt.state["loss"] == pytest.approx(jopt2.state["loss"],
                                               rel=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port trains 3 Adam steps of an MoE model under
    set_checkpoint; the JAX package loads model.3 with a template and
    state.3 through its restore_optim_state, and its 4th step agrees
    with a fresh port optimizer's resume of the same pair (1e-5)."""
    (tok, dic), (ttok, tdic) = _corpora()
    kw = _lm_kw(dic.vocab_size(), moe_experts=4)
    tm = TransformerLM(attention_impl="xla", device="cpu", **kw).build(3)
    topt = _port_opt(tm, ttok, tdic)
    topt.set_end_when(optim.Trigger.max_iteration(3)) \
        .set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1))
    topt.optimize()

    jm = jnn.Module.load(str(tmp_path / "model.3"),
                         template=JaxLM(attention_impl="xla", **kw))
    jopt = _jax_opt(jm, tok, dic)
    jmethod = jopt.optim_method
    jax_restore(jopt, jmethod, str(tmp_path / "state.3"))
    assert int(jmethod._state["iteration"]) == 3
    assert jopt.state["neval"] == 4
    x = np.random.RandomState(2).randint(1, dic.vocab_size() + 1,
                                         (2, 9)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jm.f(jm.params, jnp.asarray(x))),
        tm.f(tm.params, torch.from_numpy(x)).numpy(), atol=1e-5)

    topt2 = _port_opt(TransformerLM(attention_impl="xla", device="cpu",
                                    **kw), ttok, tdic)
    topt2.resume_from(str(tmp_path))
    for o, lib in ((topt2, optim), (jopt, joptim)):
        o.set_end_when(lib.Trigger.max_iteration(4))
        o.optimize()
    assert jopt.state["loss"] == pytest.approx(topt2.state["loss"], rel=1e-5)


# --------------------------------------------------------------------------- #
# resilience                                                                  #
# --------------------------------------------------------------------------- #

class _DyingDataSet:
    """A dataset whose k-th training-batch fetch (1-based) raises, or
    runs ``action`` instead when one is given."""

    def __init__(self, inner, at_fetch, action=None):
        self.inner = inner
        self.at_fetch = at_fetch
        self.action = action
        self.fetches = 0

    def size(self):
        return self.inner.size()

    def shuffle(self):
        self.inner.shuffle()

    def data(self, train=True):
        it = self.inner.data(train=train)
        if not train:
            return it

        def gen():
            while True:
                self.fetches += 1
                if self.fetches == self.at_fetch:
                    if self.action is None:
                        raise TransientBackendError(
                            "UNAVAILABLE: relay died mid-epoch (injected)")
                    self.action()
                yield next(it)
        return gen()


def _small_opt(ds, end_iter=6, seed=4, method=None):
    (_, _), (_, tdic) = _corpora()
    m = TransformerLM(device="cpu", **_lm_kw(tdic.vocab_size())).build(seed)
    opt = optim.LocalOptimizer(m, ds, _crit(tnn))
    opt.set_optim_method(method or optim.SGD(learning_rate=0.1, momentum=0.9,
                                             dampening=0.0))
    opt.set_end_when(optim.Trigger.max_iteration(end_iter))
    return m, opt


def _train_ds():
    (_, _), (ttok, tdic) = _corpora()
    return lm_dataset(ttok, tdic, 16, 4, packed=True)


def test_mid_epoch_crash_resume_matches_uninterrupted(tmp_path):
    """Run A trains 6 iterations; run B's data stream dies fetching
    iteration 4's batch (read ahead during iteration 3), writes an
    emergency checkpoint of iteration 3, and a fresh model and optimizer
    resume from it and finish: the weights equal run A's."""
    model_a, opt_a = _small_opt(_train_ds())
    opt_a.optimize()

    emerg = _counter("resilience/emergency_checkpoints")
    model_b, opt_b = _small_opt(_DyingDataSet(_train_ds(), 4))
    opt_b.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1000))
    with pytest.raises(TransientBackendError):
        opt_b.optimize()
    assert _counter("resilience/emergency_checkpoints") - emerg == 1
    found = file_io.latest_checkpoint(str(tmp_path))
    assert found is not None and found[2] == 3
    snap = file_io.load(found[1])
    assert snap["driver_state"]["records_processed"] == 12  # 3 batches

    resumes = _counter("resilience/resumes")
    model_c, opt_c = _small_opt(_train_ds(), seed=11)
    opt_c.resume_from(str(tmp_path))
    assert _counter("resilience/resumes") - resumes == 1
    assert opt_c.state["neval"] == 4
    opt_c.optimize()
    for a, c in zip(tree_leaves(model_a.params), tree_leaves(model_c.params)):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_resume_from_empty_dir_is_cold_start(tmp_path):
    _, opt = _small_opt(_train_ds(), end_iter=2)
    opt.resume_from(str(tmp_path))
    opt.resume_from(str(tmp_path / "missing"))
    assert opt.state.get("neval", 1) == 1
    opt.optimize()
    assert opt.state["neval"] == 3


def test_emergency_checkpoint_never_masks_the_error():
    """A checkpoint that cannot be written leaves the loop's own error
    to surface, and no counter moves."""
    class Broken(fs.MemoryFileSystem):
        def open(self, path, mode="rb"):
            raise OSError("disk full (injected)")

    fs.register_filesystem("broken", Broken())
    emerg = _counter("resilience/emergency_checkpoints")
    _, opt = _small_opt(_DyingDataSet(_train_ds(), 2))
    opt.set_checkpoint("broken://ck", optim.Trigger.several_iteration(1000))
    with pytest.raises(TransientBackendError):
        opt.optimize()
    assert _counter("resilience/emergency_checkpoints") == emerg


def test_resume_refuses_optim_method_mismatch(tmp_path):
    """Mirror of tests/test_optim.py: a matching method restores and the
    loop continues its counter (3 saved + 1 = 4); another method class
    is refused."""
    _, opt = _small_opt(_train_ds(), end_iter=3,
                        method=optim.Adam(learning_rate=0.01))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1))
    opt.optimize()
    path = str(tmp_path / "state.3")
    model2, opt2 = _small_opt(_train_ds(), end_iter=4)
    m2 = optim.Adam(learning_rate=0.01)
    restore_optim_state(opt2, m2, path)
    assert set(m2._state) == {"iteration", "m", "v"}
    opt2.set_optim_method(m2)
    opt2.optimize()
    assert m2._state["iteration"] == 4
    with pytest.raises(SystemExit, match="Adam"):
        restore_optim_state(opt2, optim.SGD(learning_rate=0.01), path)


def test_local_sigterm_checkpoints_and_stops(tmp_path):
    """Mirror of tests/test_optim.py's SIGTERM test: the signal arrives
    while iteration 3's batch is read; the loop finishes that iteration,
    writes one checkpoint and returns, the pair resumes, and the
    previous SIGTERM handler is back once optimize() has returned."""
    before = signal.getsignal(signal.SIGTERM)

    def sigterm():
        # only into the loop's own handler, never the process's default
        assert signal.getsignal(signal.SIGTERM) is not before
        os.kill(os.getpid(), signal.SIGTERM)

    _, opt = _small_opt(_DyingDataSet(_train_ds(), 3, action=sigterm),
                        end_iter=100000)
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(10 ** 9))
    opt.handle_preemption()
    opt.optimize()
    assert signal.getsignal(signal.SIGTERM) is before
    # the read ahead in iteration 2 fetched batch 3: iteration 2 is the
    # one in flight when the signal lands
    assert opt.state["neval"] == 3
    assert sorted(os.listdir(tmp_path)) == ["model.2", "state.2"]
    opt2 = optim.LocalOptimizer(TransformerLM(device="cpu", **_lm_kw(
        opt.model.vocab_size)), _train_ds(), _crit(tnn))
    opt2.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9,
                                    dampening=0.0))
    opt2.resume_from(str(tmp_path))
    assert opt2.state["neval"] == opt.state["neval"]


# --------------------------------------------------------------------------- #
# the dictionary and the CLIs                                                 #
# --------------------------------------------------------------------------- #

def test_dictionary_files_cross_both_ways(tmp_path):
    (_, jdic), (_, tdic) = _corpora()
    tdic.save(str(tmp_path / "port.json"))
    jdic.save(str(tmp_path / "jax.json"))
    from_port = jtext.Dictionary.load(str(tmp_path / "port.json"))
    from_jax = text.Dictionary.load(str(tmp_path / "jax.json"))
    assert from_port.word2index == tdic.word2index == from_jax.word2index
    assert from_jax.vocab_size() == jdic.vocab_size()
    assert from_jax.get_word(3) == jdic.get_word(3)
    text.Dictionary.load(str(tmp_path / "port.json")).save(
        "memory://dict/d.json")
    assert text.Dictionary.load("memory://dict/d.json").word2index == \
        tdic.word2index


@pytest.mark.parametrize("extra", [[], ["--packed", "--moeExperts", "2"]])
def test_train_then_test(tmp_path, capsys, extra):
    """Mirror of tests/test_transformer.py's CLI pair: the train CLI
    checkpoints an epoch and the dictionary, the eval CLI reports the
    loss and the perplexity and generates; ``--resume`` continues the
    run for a second epoch."""
    from bigdl_tpu_torch.models.transformer import test as t_test
    from bigdl_tpu_torch.models.transformer import train as t_train
    ck = tmp_path / "ckpt"
    common = ["--synthetic", "-b", "8", "--hiddenSize", "16", "--nHead", "2",
              "--nLayers", "1", "--seqLength", "16", "--device", "cpu",
              *extra]
    opt = t_train.main(common + ["-e", "1", "--checkpoint", str(ck)])
    n = opt.state["neval"] - 1
    assert (ck / "dictionary.json").exists()
    assert (ck / f"model.{n}").exists() and (ck / f"state.{n}").exists()
    opt2 = t_train.main(common + ["-e", "2", "--resume", str(ck),
                                  "--checkpoint", str(ck)])
    assert opt2.state["epoch"] == 3 and opt2.state["neval"] > n + 1
    n2 = opt2.state["neval"] - 1
    assert file_io.latest_checkpoint(str(ck))[2] == n2
    (method, result), = opt2.validation_results
    assert np.isfinite(result.result()[0])
    capsys.readouterr()
    results, words = t_test.main(
        ["--model", str(ck / f"model.{n2}"), "--dictionary",
         str(ck / "dictionary.json"), "--synthetic", "-b", "8",
         "--seqLength", "16", "--generate", "4", "--device", "cpu",
         *[a for a in extra if a == "--packed"]])
    out = capsys.readouterr().out
    assert "Loss is Loss(" in out and "Perplexity is Perplexity(" in out
    assert "generated:" in out and len(words) == 1 + 4
    (_, loss), = results
    assert np.isfinite(loss.result()[0])
    with pytest.raises(SystemExit, match="--resume"):
        t_train.main(common + ["--resume", str(ck), "--model", "m"])


def test_eval_cli_reads_a_jax_checkpoint(tmp_path, capsys):
    """The JAX train CLI's checkpoint and dictionary evaluate in the
    port's eval CLI to the JAX eval CLI's loss."""
    from bigdl_tpu.models.transformer import test as j_test
    from bigdl_tpu.models.transformer import train as j_train
    from bigdl_tpu_torch.models.transformer import test as t_test
    ck = tmp_path / "jck"
    j_train.main(["--synthetic", "-e", "1", "-b", "8", "--hiddenSize", "16",
                  "--nHead", "2", "--nLayers", "1", "--seqLength", "8",
                  "--checkpoint", str(ck)])
    n = file_io.latest_checkpoint(str(ck))[2]
    args = ["--model", str(ck / f"model.{n}"), "--dictionary",
            str(ck / "dictionary.json"), "--synthetic", "-b", "8",
            "--seqLength", "8"]
    capsys.readouterr()
    j_test.main(args)
    jout = capsys.readouterr().out
    results, _ = t_test.main(args + ["--device", "cpu"])
    (_, loss), = results
    want = float(jout.split("mean: ")[1].split(")")[0])
    assert loss.result()[0] == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_file_io_state_roundtrip():
    """Optimizer state to the file's numpy and back: iteration a 0-d
    int32 on disk and a host int in memory, the moments bitwise."""
    m = TransformerLM(device="cpu", **_lm_kw(13)).build(0)
    st = optim.Adam().init_state(m.params)
    st["iteration"] = 7
    st["m"]["embed"] += 1.5
    disk = file_io.state_to_numpy(st)
    assert disk["iteration"].dtype == np.int32
    back = file_io.state_from_numpy(disk, "cpu")
    assert back["iteration"] == 7
    for a, b in zip(tree_leaves(back["m"]), tree_leaves(st["m"])):
        assert torch.equal(a, b)
    assert params_to_numpy(params_from_numpy(disk["v"], "cpu"))["embed"] \
        .shape == (13, 32)
