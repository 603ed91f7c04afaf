"""The recurrent and text models of bigdl_tpu_torch, Adagrad's loop and
LBFGS against the JAX package on the CPU, and their CLIs
(``bigdl_tpu_torch/models/{rnn,textclassifier,autoencoder}``,
``optim/optim_method.py`` ``LBFGS``/``ls_wolfe`` and the full-batch path
of ``optim/optimizer.py``).

- ``build(seed=1)`` gives the reference's tree bit for bit for
  SimpleRNN, LstmLM, both TextClassifier encoders and the Autoencoder,
  at narrow widths and at the CLIs' widths; TextClassifierWithEmbedding
  too, but for its LookupTable's normal draw (within 4 ulp, as the
  LookupTable alone).  The forward is within 1e-5 of the reference's,
  and a tree the JAX package built crosses over by
  ``load_numpy_tree``.
- Three ``LocalOptimizer`` steps of SimpleRNN (SGD, the rnn CLI's loss)
  and of the Autoencoder (Adagrad, MSE): every loss and parameter within
  1e-5 of the JAX loop's.
- ``ls_wolfe`` and ``LBFGS.optimize`` on a seeded quadratic, and
  ``LocalOptimizer``'s LBFGS path on the Autoencoder's full batch with
  and without the line search: loss histories and parameters within
  1e-5; clipping and accumulation refused with the reference's words.
- The CLIs train, checkpoint and evaluate with ``--synthetic --device
  cpu`` at small sizes; the rnn dictionary round-trips and a checkpoint
  continues.

Card tests (``cuda`` marker, skipped without a card): a training step of
each recurrent cell on the card against the CPU, and NMS on the card
against the CPU.  The card's machine has no JAX: there only the card
tests run, ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_text_models.py``.
"""
import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import models as _jmodels
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
    from bigdl_tpu.models.rnn import LstmLM as JLstmLM
    from bigdl_tpu.models.textclassifier import \
        TextClassifierWithEmbedding as JTextClassifierWithEmbedding
    from bigdl_tpu.models.textclassifier.train import \
        _synthetic_samples as j_synthetic_samples
except ImportError:  # the card's machine: only the card tests run there
    jax = None

from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.utils import pytree

TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's models package exports these two from their modules
jmodels = None if jax is None else SimpleNamespace(
    **{k: getattr(_jmodels, k) for k in ("SimpleRNN", "TextClassifier",
                                         "Autoencoder")},
    LstmLM=JLstmLM, TextClassifierWithEmbedding=JTextClassifierWithEmbedding)


@pytest.fixture(autouse=True)
def _reference(request):
    """The CPU tests compare with the JAX package: without it (the card's
    machine) they skip, decided when each test runs."""
    if jax is None and "cuda" not in request.keywords:
        pytest.skip("needs the JAX package (the reference)")


def _ref_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [a.detach().numpy() for a in pytree.tree_leaves(tree)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_BUILDS = {
    "simple_rnn": (lambda m: m.SimpleRNN(11, 6, 11), (2, 5, 11)),
    "simple_rnn_cli": (lambda m: m.SimpleRNN(4000, 40, 4000), None),
    "lstm_lm": (lambda m: m.LstmLM(11, 6, 11), (2, 5, 11)),
    "lstm_lm_cli": (lambda m: m.LstmLM(4000, 128, 4000), None),
    "text_cnn": (lambda m: m.TextClassifier(5, 8, 54, "cnn"), (2, 54, 8)),
    "text_cnn_cli": (lambda m: m.TextClassifier(20, 100, 500, "cnn"), None),
    "text_lstm": (lambda m: m.TextClassifier(5, 8, 9, "lstm", hidden=6),
                  (2, 9, 8)),
    "text_lstm_cli": (lambda m: m.TextClassifier(20, 100, 500, "lstm"), None),
    "autoencoder": (lambda m: m.Autoencoder(32), (3, 28, 28)),
}


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_build_is_the_references_bit_for_bit(name):
    make, shape = _BUILDS[name]
    ref, port = make(jmodels).build(1), make(tmodels).build(1, device="cpu")
    assert jax.tree_util.tree_structure(_np_tree(ref.params)) == \
        jax.tree_util.tree_structure(pytree.tree_map(lambda a: a.numpy(),
                                                     port.params))
    for x, y in zip(_ref_leaves(ref.params), _port_leaves(port.params)):
        assert x.shape == y.shape and y.dtype == np.float32
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    if shape is None:
        return
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(ref.apply(ref.params, jnp.asarray(x))[0])
    with torch.no_grad():
        got = port.apply(port.params, torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_text_classifier_with_embedding():
    """Bitwise but for the LookupTable's normal draw (within 4 ulp); the
    forward over 1-based ids within 1e-5."""
    ref = jmodels.TextClassifierWithEmbedding(40, 5, 8, 6).build(1)
    port = tmodels.TextClassifierWithEmbedding(40, 5, 8, 6).build(
        1, device="cpu")
    a_emb = np.asarray(ref.params["0"]["weight"])
    b_emb = port.params["0"]["weight"].numpy()
    ulp = np.abs(a_emb.view(np.int32).astype(np.int64)
                 - b_emb.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4
    rest_r = _ref_leaves({k: v for k, v in ref.params.items() if k != "0"})
    rest_p = _port_leaves({k: v for k, v in port.params.items() if k != "0"})
    for x, y in zip(rest_r, rest_p):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    ids = np.random.RandomState(2).randint(1, 41, (3, 7)).astype(np.float32)
    want = np.asarray(ref.apply(ref.params, jnp.asarray(ids))[0])
    port.load_numpy_tree(_np_tree(ref.params))
    with torch.no_grad():
        got = port.apply(port.params, torch.from_numpy(ids))[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_a_reference_tree_crosses_over():
    """An LstmLM the JAX package built (seed 7) loaded into the port's
    architecture gives the reference's log-probs."""
    ref = jmodels.LstmLM(13, 9, 13).build(7)
    port = tmodels.LstmLM(13, 9, 13).load_numpy_tree(_np_tree(ref.params),
                                                     device="cpu")
    x = np.eye(13, dtype=np.float32)[np.random.RandomState(1).randint(
        0, 13, (2, 6))]
    want = np.asarray(ref.apply(ref.params, jnp.asarray(x))[0])
    with torch.no_grad():
        got = port.apply(port.params, torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="does not match|has shape"):
        tmodels.SimpleRNN(13, 9, 13).load_numpy_tree(_np_tree(ref.params),
                                                     device="cpu")


# -------------------------------------------------------------------- #
# the training loop against the reference's                           #
# -------------------------------------------------------------------- #
class _Losses(logging.Handler):
    def __init__(self, prefix="Epoch %d iteration %d"):
        super().__init__(logging.INFO)
        self.prefix = prefix
        self.losses = []

    def emit(self, record):
        if str(record.msg).startswith(self.prefix):
            self.losses.append(float(record.args[-1] if "LBFGS" in
                                     self.prefix else record.args[2]))


def _train(lib, model, samples, batch, steps, method, criterion,
           prefix="Epoch %d iteration %d", configure=None):
    ref = lib == "ref"
    ds = (JDataSet.array([JSample(f, l) for f, l in samples])
          >> JSampleToBatch(batch)) if ref else (
        DataSet.array([Sample(f, l) for f, l in samples])
        >> SampleToBatch(batch))
    opt = (joptim if ref else toptim).Optimizer.create(model, ds, criterion)
    opt.set_optim_method(method).set_end_when(
        (joptim if ref else toptim).Trigger.max_iteration(steps))
    if configure is not None:
        configure(opt)
    logger = logging.getLogger("bigdl_tpu.optim" if ref
                               else "bigdl_tpu_torch.optim")
    handler, level = _Losses(prefix), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.losses, opt


def _lm_samples(n=8, t=5, v=11):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        ids = rng.randint(0, v, t + 1)
        out.append((np.eye(v, dtype=np.float32)[ids[:-1]],
                    (ids[1:] + 1).astype(np.float32)))
    return out


def _ae_samples(n=8):
    rng = np.random.RandomState(4)
    out = []
    for _ in range(n):
        img = rng.rand(28, 28).astype(np.float32)
        out.append((img, img.reshape(-1)))
    return out


_LOOPS = {
    "simple_rnn_sgd": (
        lambda m: m.SimpleRNN(11, 6, 11), _lm_samples,
        lambda lib: lib.SGD(learning_rate=0.1),
        lambda n: n.TimeDistributedCriterion(n.ClassNLLCriterion(), True)),
    "autoencoder_adagrad": (
        lambda m: m.Autoencoder(32), _ae_samples,
        lambda lib: lib.Adagrad(learning_rate=0.01),
        lambda n: n.MSECriterion()),
}


def _run_loops(name, dtype):
    """Both loops over the same 8 records at batch 4 for three steps,
    from the reference's tree cast to ``dtype``."""
    make, data, method, crit = _LOOPS[name]
    samples = [(f.astype(dtype), l.astype(dtype)) for f, l in data()]
    ref = make(jmodels).build(1)
    ref.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                        ref.params)
    port = make(tmodels).load_numpy_tree(_np_tree(ref.params),
                                         device="cpu")
    lr, _ = _train("ref", ref, samples, 4, 3, method(joptim), crit(jnn))
    lp, opt = _train("port", port, samples, 4, 3, method(toptim), crit(tnn))
    assert len(lr) == len(lp) == 3
    assert opt.optim_method._state["iteration"] == 3
    return lr, lp, ref, port


@pytest.mark.parametrize("name", sorted(_LOOPS))
def test_three_local_optimizer_steps_are_the_references(name):
    """8 records at batch 4, three steps (the third after the epoch's
    reshuffle), float32: every loss within 1e-5, and SimpleRNN's
    parameters.  Adagrad's step, lr * g / (|g| + 1e-10), is set by
    rounding where |g| lies within float32 noise of its eps: at batch 4
    one Autoencoder decoder weight, fed by a hidden unit whose
    pre-activation is a near-cancellation of 784 terms, parts by 9e-5
    between the packages (the gradients agree within 4e-10).  So the
    Autoencoder's parameters are held on a float64 run of both loops,
    where that noise lies far below the eps, and its float32 parameters
    within 1e-3 of each leaf's max |w| (the 9e-5 above is 5e-4 of its
    leaf's), so that a fault of the float32 loop alone still shows."""
    lr, lp, ref, port = _run_loops(name, np.float32)
    np.testing.assert_allclose(lp, lr, **TOL)
    if name == "autoencoder_adagrad":
        for x, y in zip(_ref_leaves(ref.params), _port_leaves(port.params)):
            assert np.abs(y - x).max() <= 1e-3 * np.abs(x).max()
        with jax.enable_x64(True):
            lr, lp, ref, port = _run_loops(name, np.float64)
        assert port.params["1"]["weight"].dtype == torch.float64
        np.testing.assert_allclose(lp, lr, **TOL)
    for x, y in zip(_ref_leaves(ref.params), _port_leaves(port.params)):
        np.testing.assert_allclose(y, x, **TOL)


# -------------------------------------------------------------------- #
# LBFGS                                                                #
# -------------------------------------------------------------------- #
def _quadratic(n=12, seed=6):
    rng = np.random.RandomState(seed)
    m = rng.randn(n, n).astype(np.float32)
    a = (m @ m.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    x0 = rng.randn(n).astype(np.float32)

    def jfeval(x):
        f, g = jax.value_and_grad(
            lambda v: 0.5 * v @ jnp.asarray(a) @ v - jnp.asarray(b) @ v)(x)
        return float(f), g

    def tfeval(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = 0.5 * x @ torch.from_numpy(a) @ x - torch.from_numpy(b) @ x
            (g,) = torch.autograd.grad(f, x)
        return float(f.detach()), g
    return x0, jfeval, tfeval


def test_ls_wolfe_on_a_quadratic():
    x0, jfeval, tfeval = _quadratic()
    fj, gj = jfeval(jnp.asarray(x0))
    ft, gt = tfeval(torch.from_numpy(x0))
    dj, dt = -gj, -gt
    for t in (1.0, 0.05, 8.0):
        rj = joptim.ls_wolfe(jfeval, jnp.asarray(x0), t, dj, fj, gj,
                             float(jnp.vdot(gj, dj)))
        rt = toptim.ls_wolfe(tfeval, torch.from_numpy(x0), t, dt, ft, gt,
                             float(torch.dot(gt, dt)))
        assert rt[3] == rj[3] and rt[2] == pytest.approx(rj[2], rel=1e-6)
        assert rt[0] == pytest.approx(rj[0], rel=1e-5)
        np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), **TOL)


@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_optimize_on_a_quadratic(line_search):
    """Two ``optimize`` calls (the second continues the curvature
    pairs): histories and iterates within 1e-5."""
    x0, jfeval, tfeval = _quadratic()
    jm = joptim.LBFGS(max_iter=6, line_search=line_search)
    tm = toptim.LBFGS(max_iter=6, line_search=line_search)
    xj, xt = jnp.asarray(x0), torch.from_numpy(x0)
    for _ in range(2):
        xj, hj = jm.optimize(jfeval, xj)
        xt, ht = tm.optimize(tfeval, xt)
        assert len(ht) == len(hj) > 1
        np.testing.assert_allclose(ht, hj, **TOL)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    assert tm._state["func_evals"] == jm._state["func_evals"]
    assert len(tm._state["old_dirs"]) == len(jm._state["old_dirs"])


@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_full_batch_path_on_the_autoencoder(line_search, tmp_path):
    """Two outer iterations of LBFGS(max_iter=3) through LocalOptimizer
    on 16 records in one batch: each iteration's loss and the parameters
    within 1e-5 of the reference's; validation and a checkpoint after
    each iteration."""
    samples = _ae_samples(16)
    ref = jmodels.Autoencoder(32).build(1)
    port = tmodels.Autoencoder(32).build(1, device="cpu")
    prefix = "LBFGS iteration %d"
    ck = str(tmp_path / "ck")

    def configure(opt):
        ds = DataSet.array([Sample(f, l) for f, l in samples[:8]]) \
            >> SampleToBatch(8)
        opt.set_validation(toptim.Trigger.every_epoch(), ds,
                           [toptim.Loss(tnn.MSECriterion())])
        opt.set_checkpoint(ck, toptim.Trigger.several_iteration(1))
    lr, _ = _train("ref", ref, samples, 16, 2,
                   joptim.LBFGS(max_iter=3, line_search=line_search),
                   jnn.MSECriterion(), prefix)
    lp, opt = _train("port", port, samples, 16, 2,
                     toptim.LBFGS(max_iter=3, line_search=line_search),
                     tnn.MSECriterion(), prefix, configure)
    assert len(lr) == len(lp) == 2 and lp[-1] < lp[0]
    np.testing.assert_allclose(lp, lr, **TOL)
    for x, y in zip(_ref_leaves(ref.params), _port_leaves(port.params)):
        np.testing.assert_allclose(y, x, **TOL)
    assert opt.state["epoch"] == 3 and opt.state["neval"] == 3
    (method, result), = opt.validation_results
    assert str(method) == "Loss" and result.count == 1  # one batch
    assert sorted(os.listdir(ck)) == ["model.1", "model.2", "state.1",
                                      "state.2"]
    # the method's curvature pairs are in the state file and come back
    from bigdl_tpu_torch.utils import file_io
    snap = file_io.load(os.path.join(ck, "state.2"))
    assert snap["optim_method"] == "LBFGS"
    back = file_io.state_from_numpy(snap["optim_state"], "cpu")
    assert len(back["old_dirs"]) == len(opt.optim_method._state["old_dirs"])
    assert all(isinstance(a, torch.Tensor) for a in back["old_dirs"])


@pytest.mark.parametrize("config,match", [
    (lambda o: o.set_constant_gradient_clipping(-1.0, 1.0),
     "gradient clipping is incompatible with LBFGS"),
    (lambda o: o.set_gradient_clipping_by_l2_norm(1.0),
     "gradient clipping is incompatible with LBFGS"),
    (lambda o: o.set_gradient_accumulation(2),
     "set_gradient_accumulation is not supported with LBFGS"),
])
def test_lbfgs_refuses_clipping_and_accumulation(config, match):
    samples = _ae_samples(4)
    for lib, nnlib, models in ((joptim, jnn, jmodels),
                               (toptim, tnn, tmodels)):
        ref = lib is joptim
        model = models.Autoencoder(8).build(1) if ref else \
            models.Autoencoder(8).build(1, device="cpu")
        ds = (JDataSet.array([JSample(f, l) for f, l in samples])
              >> JSampleToBatch(4)) if ref else (
            DataSet.array([Sample(f, l) for f, l in samples])
            >> SampleToBatch(4))
        opt = lib.Optimizer.create(model, ds, nnlib.MSECriterion())
        opt.set_optim_method(lib.LBFGS(max_iter=2))
        config(opt)
        with pytest.raises(ValueError, match=match):
            opt.optimize()


# -------------------------------------------------------------------- #
# CLIs                                                                 #
# -------------------------------------------------------------------- #
_RNN_SMALL = ["--synthetic", "--hiddenSize", "8", "--seqLength", "8",
              "--device", "cpu"]


@pytest.mark.parametrize("cell", ["rnn", "lstm"])
def test_rnn_cli_trains_checkpoints_and_evaluates(cell, tmp_path, capsys):
    from bigdl_tpu.dataset import text as jtext

    from bigdl_tpu_torch.dataset import text
    from bigdl_tpu_torch.models.rnn import test as rnn_test
    from bigdl_tpu_torch.models.rnn import train as rnn_train
    ck = str(tmp_path / "ck")
    opt = rnn_train.main(_RNN_SMALL + ["-e", "2", "--cell", cell,
                                       "--checkpoint", ck])
    (method, result), = opt.validation_results
    assert str(method) == "Loss" and np.isfinite(result.result()[0])
    assert np.isfinite(opt.state["loss"]) and opt.state["neval"] == 7
    assert sorted(os.listdir(ck)) == ["dictionary.json", "model.3",
                                      "model.6", "state.3", "state.6"]
    # the dictionary round-trips, and the reference reads it the same
    dpath = os.path.join(ck, "dictionary.json")
    d, jd = text.Dictionary.load(dpath), jtext.Dictionary.load(dpath)
    words = json.load(open(dpath))
    assert d.vocab_size() == jd.vocab_size() > 10
    for w in list(words if isinstance(words, list) else words)[:5]:
        if isinstance(w, str):
            assert d.get_index(w) == jd.get_index(w)
    capsys.readouterr()
    results = rnn_test.main(["--synthetic", "--model", ck + "/model.6",
                             "--dictionary", dpath, "--seqLength", "8",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Loss is" in out and "Perplexity is" in out
    assert results[0][1].result()[0] > 0
    # a checkpoint continues: one more epoch from model.6
    opt2 = rnn_train.main(_RNN_SMALL + ["-e", "1", "--cell", cell,
                                        "--model", ck + "/model.6"])
    assert opt2.state["loss"] < result.result()[0] * 1.5
    first = rnn_train.main(_RNN_SMALL + ["-e", "1", "--cell", cell])
    assert opt2.state["loss"] < first.state["loss"]


@pytest.mark.parametrize("encoder,flags", [
    ("cnn", ["--seqLength", "54", "--embedDim", "8"]),
    ("lstm", ["--seqLength", "6", "--embedDim", "8"]),
])
def test_text_classifier_cli_trains_and_evaluates(encoder, flags, tmp_path,
                                                  capsys):
    from bigdl_tpu_torch.models.textclassifier import test as tc_test
    from bigdl_tpu_torch.models.textclassifier import train as tc_train
    opt = tc_train.main(["--synthetic", "-e", "1", "-b", "256", "--encoder",
                         encoder, "--device", "cpu"] + flags)
    (method, result), = opt.validation_results
    assert str(method) == "Top1Accuracy" and result.count == 256
    assert np.isfinite(opt.state["loss"]) and opt.state["neval"] == 5
    path = str(tmp_path / "model.bin")
    opt.model.save(path)
    results = tc_test.main(["--synthetic", "--model", path, "-b", "256",
                            "--device", "cpu"] + flags)
    assert "Top1Accuracy is Accuracy(" in capsys.readouterr().out
    assert results[0][1].correct == result.correct


def test_text_classifier_synthetic_samples_are_the_references():
    from bigdl_tpu_torch.models.textclassifier.train import \
        _synthetic_samples
    a = _synthetic_samples(12, 5, 7, 4, seed=9)
    b = j_synthetic_samples(12, 5, 7, 4, seed=9)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.feature, y.feature)
        assert x.label == y.label


def test_text_classifier_cli_reads_news_and_glove(tmp_path):
    """``-f`` with a 20news tree and a GloVe file: the CLI's loaders
    read them (two classes, six documents, 4-d vectors)."""
    from bigdl_tpu_torch.models.textclassifier.train import (
        load_glove, load_news_samples)
    news = tmp_path / "20news-tiny"
    for cat, docs in (("alt", ["good dog", "a good day", "dog day"]),
                      ("sci", ["cold space", "the cold", "space ship"])):
        (news / cat).mkdir(parents=True)
        for i, d in enumerate(docs):
            (news / cat / f"{i}.txt").write_text(d)
    (tmp_path / "glove.6B").mkdir()
    (tmp_path / "glove.6B" / "glove.6B.4d.txt").write_text(
        "good 1 0 0 0\ndog 0 1 0 0\ncold 0 0 1 0\nspace 0 0 0 1\n")
    assert set(load_glove(str(tmp_path / "glove.6B" / "glove.6B.4d.txt"),
                          4)) == {"good", "dog", "cold", "space"}
    train, val = load_news_samples(str(tmp_path), 3, 4)
    assert len(train) == 4 and len(val) == 2
    assert {float(s.label) for s in train + val} == {1.0, 2.0}
    with pytest.raises(SystemExit, match="expected 20news"):
        load_news_samples(str(news), 3, 4)


def test_autoencoder_cli_trains_checkpoints_and_evaluates(tmp_path, capsys):
    from bigdl_tpu_torch.models.autoencoder import test as ae_test
    from bigdl_tpu_torch.models.autoencoder import train as ae_train
    ck = str(tmp_path / "ck")
    opt = ae_train.main(["--synthetic", "-e", "1", "-b", "512",
                         "--checkpoint", ck, "--device", "cpu"])
    assert np.isfinite(opt.state["loss"]) and opt.state["neval"] == 5
    assert sorted(os.listdir(ck)) == ["model.4", "state.4"]
    results = ae_test.main(["--synthetic", "--model", ck + "/model.4",
                            "-b", "512", "--device", "cpu"])
    assert "Loss is" in capsys.readouterr().out
    assert 0 < results[0][1].result()[0] < 1 and results[0][1].count == 1
    # resume_from continues the run's counters and Adagrad's sums
    model = tmodels.Autoencoder(32).build(1, device="cpu")
    from bigdl_tpu_torch.models.autoencoder.train import image_pipeline
    from bigdl_tpu_torch.dataset import mnist
    ds = DataSet.array(mnist.synthetic(2048)) >> image_pipeline(512)
    again = toptim.Optimizer.create(model, ds, tnn.MSECriterion())
    again.set_optim_method(toptim.Adagrad(learning_rate=0.01)).resume_from(
        ck).set_end_when(toptim.Trigger.max_epoch(2))
    again.optimize()
    assert again.state["neval"] == 9
    assert again.optim_method._state["iteration"] == 8


def test_cli_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bigdl_tpu_torch.models.autoencoder import train as ae_train
    from bigdl_tpu_torch.models.rnn import train as rnn_train
    from bigdl_tpu_torch.models.textclassifier import train as tc_train
    for main, argv in ((rnn_train.main, ["--synthetic"]),
                       (tc_train.main, ["--synthetic", "--seqLength", "54"]),
                       (ae_train.main, ["--synthetic"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["-e", "1"])


# -------------------------------------------------------------------- #
# on the card                                                          #
# -------------------------------------------------------------------- #
@pytest.fixture
def card():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bigdl_tpu_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_recurrent_step_on_the_card_equals_the_cpu(cell, card):
    """A Recurrent cell with gate dropout (p 0.3, the same host-drawn
    masks on both devices) under TimeDistributed's head: the loss within
    1e-5 relative and every gradient leaf within 1e-4 of its max |g|."""
    from bigdl_tpu_torch.optim import loss_and_grads
    from bigdl_tpu_torch.utils import keychain

    def make():
        c = {"rnn": lambda: tnn.RnnCell(16, 32),
             "lstm": lambda: tnn.LSTM(16, 32, p=0.3),
             "gru": lambda: tnn.GRU(16, 32, p=0.3)}[cell]()
        return tnn.Sequential(tnn.Recurrent(c), tnn.TimeDistributed(
            tnn.Sequential(tnn.Linear(32, 10), tnn.LogSoftMax())))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 20, 16).astype(np.float32)
    y = (rng.randint(0, 10, (8, 20)) + 1).astype(np.float32)
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True)
    out = []
    for dev in (card, torch.device("cpu")):
        m = make().build(1, device=dev)
        loss, g, _ = loss_and_grads(m, crit, m.params,
                                    torch.as_tensor(x, device=dev),
                                    torch.as_tensor(y, device=dev),
                                    rng=keychain.prng_key(3))
        out.append((float(loss), [a.cpu() for a in pytree.tree_leaves(g)]))
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_nms_on_the_card_equals_the_cpu(card):
    rng = np.random.RandomState(1)
    xy = rng.rand(500, 2) * 300
    boxes = np.concatenate([xy, xy + rng.rand(500, 2) * 60 + 2], 1).astype(
        np.float32)
    scores = (rng.randint(0, 50, 500) / 50.0).astype(np.float32)  # ties
    keep, count = tnn.nms(torch.as_tensor(boxes, device=card), scores, 0.4,
                          60)
    keep_cpu, count_cpu = tnn.nms(torch.from_numpy(boxes), scores, 0.4, 60)
    assert keep.device.type == "cuda"
    assert torch.equal(keep.cpu(), keep_cpu) and int(count) == int(count_cpu)
