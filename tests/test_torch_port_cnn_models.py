"""The image classifiers of bigdl_tpu_torch against the JAX package on the
CPU: LeNet-5, VGG, ResNet, Inception and AlexNet
(``bigdl_tpu_torch/models/{lenet,vgg,resnet,inception,alexnet}``), the
training loop's key chain, the CLIs and the perf harness.

- ``build(seed=1)`` gives the reference's parameters and BN buffers bit
  for bit, for every model; a tree the JAX package built crosses over
  through ``Module.load_numpy_tree``.
- Eval-mode log-probabilities within 1e-4: ResNet-20 (CIFAR, batch 2,
  both layouts), ResNet-50 and Inception v1 (224x224, batch 1) and
  VggForCifar10 (batch 2).  VggForCifar10 in training mode from one key:
  its dropout masks are the reference's bit for bit.
- Three ``LocalOptimizer`` steps of LeNet-5 and of ResNet-20 (batch 4;
  SGD with momentum, nesterov and an ``EpochSchedule`` that changes the
  rate at the epoch rollover after step 2): every loss, parameter and
  BN buffer within 1e-5 of the JAX loop's.
- The CLIs train, checkpoint and evaluate on the CPU; the ImageNet mode,
  ``--distributed`` and the perf harness's mesh sweep name what they
  wait for.

Card tests (``cuda`` marker, skipped without a card): NHWC steps equal
NCHW steps, TF32 off for cuDNN after ``resolve_device``, the perf
harness on the card.  The card's machine has no JAX: there only the card
tests run, ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_cnn_models.py``.
"""
import logging
import os

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import models as jmodels
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
    from bigdl_tpu.optim import optim_method as jom
except ImportError:  # the card's machine: only the card tests run there
    jax = None

from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.nn.dropout import keep_mask
from bigdl_tpu_torch.utils import keychain, pytree

TOL_LOGP = dict(rtol=1e-4, atol=1e-4)
TOL_STEP = dict(rtol=1e-5, atol=1e-5)

@pytest.fixture(autouse=True)
def _reference(request):
    """The CPU tests compare with the JAX package: without it (the card's
    machine) they skip, decided when each test runs."""
    if jax is None and "cuda" not in request.keywords:
        pytest.skip("needs the JAX package (the reference)")


_BUILDS = {
    "lenet5": lambda m: m.LeNet5(10),
    "vgg_cifar": lambda m: m.VggForCifar10(10),
    "vgg_cifar_nhwc": lambda m: m.VggForCifar10(10, data_format="NHWC"),
    "vgg16": lambda m: m.Vgg_16(1000),
    "vgg19": lambda m: m.Vgg_19(100),
    "resnet20_a": lambda m: m.ResNet(10, depth=20, dataset="cifar10",
                                     shortcut_type="A"),
    "resnet32_b": lambda m: m.ResNet(10, depth=32, dataset="cifar10",
                                     shortcut_type="B"),
    "resnet18_c": lambda m: m.ResNet(1000, depth=18, shortcut_type="C"),
    "resnet50": lambda m: m.ResNet(1000, depth=50),
    "resnet50_nhwc": lambda m: m.ResNet(1000, depth=50, data_format="NHWC"),
    "inception_v1": lambda m: m.Inception_v1(1000),
    "inception_v2": lambda m: m.Inception_v2(1000),
    "alexnet": lambda m: m.AlexNet(1000),
}


def _ref_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [a.detach().numpy() for a in pytree.tree_leaves(tree)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_build_is_the_references_bit_for_bit(name):
    ref = _BUILDS[name](jmodels).build(1)
    port = _BUILDS[name](tmodels).build(seed=1, device="cpu")
    for tree_r, tree_p in ((ref.params, port.params),
                           (ref.buffers, port.buffers)):
        assert jax.tree_util.tree_structure(_np_tree(tree_r)) == \
            jax.tree_util.tree_structure(
                pytree.tree_map(lambda a: a.numpy(), tree_p))
        a, b = _ref_leaves(tree_r), _port_leaves(tree_p)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and y.dtype == np.float32
            np.testing.assert_array_equal(x.view(np.uint32),
                                          y.view(np.uint32))


def test_key_chain_uniform_across_its_chunks():
    """A draw longer than one pass of the cipher (65,536 counters) is
    jax's, bit for bit: every convolution tower's weights are."""
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.uniform(key, (3, 70001), minval=-0.2,
                                         maxval=0.3))
    got = keychain.uniform(np.asarray(key), (3, 70001), -0.2, 0.3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_a_reference_tree_crosses_over():
    """A ResNet-20 the JAX package built (seed 7, one training step's
    BN statistics in its buffers) loaded into the port's architecture
    gives the reference's eval-mode log-probs."""
    ref = jmodels.ResNet(10, depth=20, dataset="cifar10").build(7)
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    _, bufs = ref.apply(ref.params, jnp.asarray(x), buffers=ref.buffers,
                        training=True)
    port = tmodels.ResNet(10, depth=20, dataset="cifar10").load_numpy_tree(
        _np_tree(ref.params), _np_tree(bufs), device="cpu")
    want = np.asarray(ref.apply(ref.params, jnp.asarray(x), buffers=bufs)[0])
    with torch.no_grad():
        got = port.apply(port.params, torch.from_numpy(x),
                         buffers=port.buffers)[0].numpy()
    np.testing.assert_allclose(got, want, **TOL_LOGP)
    with pytest.raises(ValueError, match="does not match"):
        tmodels.ResNet(10, depth=20, dataset="cifar10",
                       shortcut_type="B").load_numpy_tree(
            _np_tree(jmodels.ResNet(10, depth=20, dataset="cifar10",
                                    shortcut_type="C").build(1).params),
            device="cpu")


_FORWARD = {
    "resnet20": (lambda m: m.ResNet(10, depth=20, dataset="cifar10"),
                 (2, 3, 32, 32)),
    "resnet20_nhwc": (lambda m: m.ResNet(10, depth=20, dataset="cifar10",
                                         data_format="NHWC"),
                      (2, 32, 32, 3)),
    "resnet50": (lambda m: m.ResNet(1000, depth=50), (1, 3, 224, 224)),
    "inception_v1": (lambda m: m.Inception_v1(1000), (1, 3, 224, 224)),
    "vgg_cifar": (lambda m: m.VggForCifar10(10), (2, 3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(_FORWARD))
def test_forward_log_probs(name):
    make, shape = _FORWARD[name]
    ref, port = make(jmodels).build(1), make(tmodels).build(1, device="cpu")
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(ref.apply(ref.params, jnp.asarray(x),
                                buffers=ref.buffers)[0])
    with torch.no_grad():
        got = port.apply(port.params, torch.from_numpy(x),
                         buffers=port.buffers)[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL_LOGP)


def test_vgg_training_forward_draws_the_references_dropout_masks():
    ref = jmodels.VggForCifar10(10).build(1)
    port = tmodels.VggForCifar10(10).build(1, device="cpu")
    x = np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(9), np.uint32)
    yr, br = ref.apply(ref.params, jnp.asarray(x), buffers=ref.buffers,
                       training=True, rng=jnp.asarray(key))
    with torch.no_grad():
        yp, bp = port.apply(port.params, torch.from_numpy(x),
                            buffers=port.buffers, training=True, rng=key)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yr), **TOL_LOGP)
    for a, b in zip(_ref_leaves(br), _port_leaves(bp)):
        np.testing.assert_allclose(b, a, **TOL_LOGP)
    drops = [i for i, m in enumerate(port.modules)
             if isinstance(m, tnn.Dropout)]
    assert len(drops) == 2
    for i in drops:  # Sequential folds the key per child
        sub = np.asarray(jax.random.fold_in(jnp.asarray(key), i))
        want = np.asarray(jax.random.bernoulli(jnp.asarray(sub), 0.5,
                                               (2, 512)))
        got = keep_mask(keychain.fold_in(key, i), (2, 512), 0.5,
                        torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- #
# the training loop against the reference's                           #
# -------------------------------------------------------------------- #
class _Losses(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if str(record.msg).startswith("Epoch %d iteration %d"):
            self.losses.append(float(record.args[2]))


def _train(lib, model, samples, batch, steps, method):
    if lib == "ref":
        ds = JDataSet.array([JSample(f, l) for f, l in samples]) \
            >> JSampleToBatch(batch)
        opt = joptim.Optimizer.create(model, ds, jnn.ClassNLLCriterion())
        logger = logging.getLogger("bigdl_tpu.optim")
    else:
        ds = DataSet.array([Sample(f, l) for f, l in samples]) \
            >> SampleToBatch(batch)
        opt = toptim.Optimizer.create(model, ds, tnn.ClassNLLCriterion())
        logger = logging.getLogger("bigdl_tpu_torch.optim")
    opt.set_optim_method(method).set_end_when(
        (joptim if lib == "ref" else toptim).Trigger.max_iteration(steps))
    handler, level = _Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.losses, opt


def _sgd(lib):
    mod = jom if lib == "ref" else toptim
    schedule = mod.EpochSchedule([mod.Regime(1, 1, 1.0),
                                  mod.Regime(2, 100, 0.1)])
    return mod.SGD(learning_rate=0.01, momentum=0.9, dampening=0.0,
                   nesterov=True, weight_decay=1e-4,
                   learning_rate_schedule=schedule)


_LOOPS = {
    "lenet5": (lambda m: m.LeNet5(10), (1, 28, 28)),
    # shortcut A: the CIFAR CLIs' default (see the B test below)
    "resnet20": (lambda m: m.ResNet(10, depth=20, dataset="cifar10",
                                    shortcut_type="A"), (3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(_LOOPS))
def test_three_local_optimizer_steps_are_the_references(name):
    """8 records at batch 4: steps 1-2 in epoch 1 at rate 0.01, step 3 in
    epoch 2 at 0.001, the record order from the same MT19937 shuffle.
    (At rate 0.1 the second step raises ResNet-20's loss, and that
    unstable step magnifies float32 rounding, which both packages keep
    within 6e-6 of a float64 gradient at step 1, past 1e-5.)"""
    make, shape = _LOOPS[name]
    rng = np.random.RandomState(2)
    samples = [(rng.randn(*shape).astype(np.float32),
                np.asarray(float(i % 10 + 1), np.float32)) for i in range(8)]
    ref = make(jmodels).build(1)
    port = make(tmodels).build(1, device="cpu")
    lr_ref, _ = _train("ref", ref, samples, 4, 3, _sgd("ref"))
    lr_port, opt = _train("port", port, samples, 4, 3, _sgd("port"))
    assert len(lr_ref) == len(lr_port) == 3
    np.testing.assert_allclose(lr_port, lr_ref, **TOL_STEP)
    assert opt.state["epoch"] == 2 and opt.optim_method._state[
        "iteration"] == 3
    for tr, tp in ((ref.params, port.params), (ref.buffers, port.buffers)):
        a, b = _ref_leaves(tr), _port_leaves(tp)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, **TOL_STEP)


def test_resnet20_b_gradient_holds_to_a_float64_oracle():
    """ResNet-20 with projection shortcuts (B) on one batch of 4: the
    port's float32 gradient and the JAX package's are each held to the
    port's float64 gradient, every leaf within 1e-4 of its max |g| but
    the convolution biases ahead of a batch norm, whose gradient is zero
    in exact arithmetic.  (The three-step loop test above runs the CIFAR
    default, shortcut A.)"""
    from bigdl_tpu_torch.optim import loss_and_grads
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.tensor([5.0, 3.0, 8.0, 7.0])
    make = lambda m: m.ResNet(10, depth=20, dataset="cifar10",  # noqa: E731
                              shortcut_type="B")
    m = make(tmodels).build(1, device="cpu")
    crit = tnn.ClassNLLCriterion()
    l32, g32, _ = loss_and_grads(m, crit, m.params, x, y, buffers=m.buffers)
    f64 = lambda t: pytree.tree_map(lambda a: a.double(), t)  # noqa: E731
    l64, g64, _ = loss_and_grads(m, crit, f64(m.params), x.double(), y,
                                 buffers=f64(m.buffers))
    assert abs(float(l32) - float(l64)) <= 1e-5 * float(l64)
    ref = make(jmodels).build(1)
    jcrit = jnn.ClassNLLCriterion()

    def ref_loss(params):
        out, _ = ref.apply(params, jnp.asarray(x.numpy()),
                           buffers=ref.buffers, training=True)
        return jcrit.loss(out, jnp.asarray(y.numpy()))
    g_ref = _ref_leaves(jax.jit(jax.grad(ref_loss))(ref.params))
    cs = _chip_smoke()
    zero = cs.biases_ahead_of_bn(m)
    leaves = list(zip(_port_leaves(g32), g_ref, cs._named_leaves(g64)))
    assert len(leaves) == len(g_ref)
    for a, r, (path, b) in leaves:
        if path in zero:
            continue
        for got in (a, r):
            err = np.abs(got.astype(np.float64) - b.numpy()).max()
            assert err <= 1e-4 * np.abs(b.numpy()).max(), path


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resnet50_gradient_holds_to_float64_on_its_own_relu_decisions():
    """ResNet-50's float32 gradient lands percents of a leaf's max |g| off
    the float64 gradient: a few of its ReLU inputs lie within rounding of
    0 and fall on the other side, and each such flip moves a late weight
    gradient, summed over few positions, by a whole term.  On the float32
    run's own ReLU masks and max-pool argmaxes
    (``chip_smoke.pinned_decisions``, as the card's C3 check replays
    them), float64 holds every leaf within 1e-3 of its max |g| but the
    convolution biases ahead of a batch norm, whose gradient is zero in
    exact arithmetic; replayed in float32, the run is reproduced."""
    from bigdl_tpu_torch.optim import loss_and_grads
    cs = _chip_smoke()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 3, 224, 224).astype(np.float32))
    y = torch.tensor([5.0, 300.0])
    m = tmodels.ResNet(1000, depth=50).build(1, device="cpu")
    crit = tnn.ClassNLLCriterion()

    def grads(dt, pins):
        cast = lambda t: pytree.tree_map(lambda a: a.to(dt), t)  # noqa: E731
        with pins:
            return loss_and_grads(m, crit, cast(m.params), x.to(dt), y,
                                  buffers=cast(m.buffers))[1]
    decisions = []
    g32 = grads(torch.float32, cs.pinned_decisions(record=decisions))
    assert len(decisions) == 1 + 16 * 3 + 1  # the stem's pool, the ReLUs
    again = grads(torch.float32, cs.pinned_decisions(replay=decisions))
    g64 = grads(torch.float64, cs.pinned_decisions(replay=decisions))
    zero = cs.biases_ahead_of_bn(m)
    assert len(zero) == 53
    for (path, a), (_, b), (_, c) in zip(cs._named_leaves(g32),
                                         cs._named_leaves(again),
                                         cs._named_leaves(g64)):
        assert torch.allclose(b, a, rtol=0, atol=1e-6 * float(a.abs().max()))
        if path not in zero:
            err = (a.double() - c).abs().max() / c.abs().max()
            assert err <= 1e-3, path


def test_loop_keys_each_step_from_the_seed():
    """The loop hands the model ``rng``, split from ``prng_key(seed)``
    once a step, as the reference's loop does; a model that records its
    keys sees the reference's chain."""
    seen = []

    class Recorder(tnn.Linear):
        def apply(self, params, x, *, buffers=None, training=False,
                  rng=None):
            seen.append(np.asarray(rng))
            return super().apply(params, x, buffers=buffers,
                                 training=training, rng=rng)

    m = tnn.Sequential(Recorder(4, 3), tnn.LogSoftMax()).build(
        1, device="cpu")
    rng = np.random.RandomState(0)
    samples = [(rng.randn(4).astype(np.float32),
                np.asarray(1.0 + i % 3, np.float32)) for i in range(8)]
    ds = DataSet.array([Sample(f, l) for f, l in samples]) >> \
        SampleToBatch(4)
    opt = toptim.Optimizer.create(m, ds, tnn.ClassNLLCriterion())
    opt.set_state({"seed": 5}).set_end_when(toptim.Trigger.max_iteration(2))
    opt.optimize()
    key = jax.random.PRNGKey(5)
    for got in seen:
        key, sub = jax.random.split(key)
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.fold_in(sub, 0)))
    assert len(seen) == 2


# -------------------------------------------------------------------- #
# CLIs and the perf harness                                            #
# -------------------------------------------------------------------- #
def test_lenet_cli_trains_checkpoints_and_evaluates(tmp_path, capsys):
    from bigdl_tpu_torch.models.lenet import test as lenet_test
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    ck = str(tmp_path / "ck")
    opt = lenet_train.main(["--synthetic", "-e", "1", "-b", "256",
                            "--checkpoint", ck, "--device", "cpu"])
    (method, result), = opt.validation_results
    assert str(method) == "Top1Accuracy" and result.count == 512
    assert np.isfinite(opt.state["loss"])
    assert sorted(os.listdir(ck)) == ["model.16", "state.16"]
    results = lenet_test.main(["--synthetic", "--model", ck + "/model.16",
                               "-b", "256", "--device", "cpu"])
    assert "Top1Accuracy is Accuracy(" in capsys.readouterr().out
    assert results[0][1].correct == result.correct
    # the resumed run continues the epoch count
    opt2 = lenet_train.main(["--synthetic", "-e", "2", "-b", "256",
                             "--resume", ck, "--checkpoint", ck,
                             "--device", "cpu"])
    assert opt2.state["epoch"] == 3 and opt2.state["neval"] == 33


def test_resnet_and_vgg_clis_refuse_what_waits(monkeypatch):
    """``--distributed`` (refused before the data-parallel engine was
    ported) trains through ``DistriOptimizer`` on a world of one,
    started by the CLI and torn down here; the synthetic CIFAR records
    are cut to 64 for time."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.models.vgg import train as vgg_train
    from bigdl_tpu_torch.parallel import DistriOptimizer, shutdown_world
    real = cifar.synthetic
    monkeypatch.setattr(cifar, "synthetic",
                        lambda n, seed=0: real(64, seed=seed))
    try:
        for main, extra in ((resnet_train.main, ["--depth", "8"]),
                            (vgg_train.main, [])):
            opt = main(["--synthetic", "--distributed", "-e", "1", "-b",
                        "32", "--device", "cpu"] + extra)
            assert isinstance(opt, DistriOptimizer)
            assert np.isfinite(opt.state["loss"]) and opt.state["neval"] == 3
    finally:
        shutdown_world()


def test_resnet_cli_one_epoch(tmp_path):
    from bigdl_tpu_torch.models.resnet import test as resnet_test
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    ck = str(tmp_path / "ck")
    opt = resnet_train.main(["--synthetic", "--depth", "8", "-e", "1", "-b",
                             "512", "--checkpoint", ck, "--device", "cpu"])
    assert np.isfinite(opt.state["loss"]) and opt.state["neval"] == 5
    results = resnet_test.main(["--synthetic", "--model", ck + "/model.4",
                                "-b", "512", "--device", "cpu"])
    assert results[0][1].count == 512


def test_perf_harness_on_the_cpu(capsys):
    from bigdl_tpu_torch.models.utils import perf
    r = perf.main(["-m", "lenet5", "-b", "8", "-i", "2", "--device", "cpu"])
    assert "lenet5:" in capsys.readouterr().out
    assert r["platform"] == "cpu" and len(r["step_s"]) == 2
    assert r["throughput_rec_s"] > 0 and r["input_bytes"] == 8 * 28 * 28 * 4
    # LeNet-5's products, 221,800 MACs an image: 2 FLOPs a MAC forward,
    # twice that backward, less the first convolution's input gradient
    assert r["step_flops"] == 8 * (3 * 2 * 221_800 - 2 * 86_400)
    # one rank drives one device: a sweep past the world's ranks refuses
    # before starting a world, naming the count
    with pytest.raises(SystemExit, match="this world has 1"):
        perf.main(["-m", "lenet5", "--mesh", "1,2", "--device", "cpu"])
    with pytest.raises(ValueError, match="NCHW only"):
        perf.build_model("alexnet", "NHWC")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bigdl_tpu_torch.models.utils import perf
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf.run_perf("lenet5", 4, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.LeNet5().build(1)


# -------------------------------------------------------------------- #
# on the card                                                          #
# -------------------------------------------------------------------- #
@pytest.fixture
def card():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cudnn_tf32_is_off_on_the_card(card):
    from bigdl_tpu_torch.device import resolve_device
    torch.backends.cudnn.allow_tf32 = True
    resolve_device("cuda")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.cuda
def test_nhwc_step_equals_nchw_step_on_the_card(card):
    from bigdl_tpu_torch.optim import loss_and_grads
    x = np.random.RandomState(0).randn(4, 3, 32, 32).astype(np.float32)
    y = torch.tensor([1.0, 2.0, 3.0, 4.0], device="cuda")
    out = {}
    for df in ("NCHW", "NHWC"):
        m = tmodels.ResNet(10, depth=20, dataset="cifar10",
                           data_format=df).build(1, device="cuda")
        xin = x if df == "NCHW" else np.ascontiguousarray(
            x.transpose(0, 2, 3, 1))
        out[df] = loss_and_grads(m, tnn.ClassNLLCriterion(), m.params,
                                 torch.as_tensor(xin, device="cuda"), y,
                                 buffers=m.buffers, rng=keychain.prng_key(0))
    (la, ga, ba), (lb, gb, bb) = out["NCHW"], out["NHWC"]
    assert abs(float(la) - float(lb)) <= 1e-5 * abs(float(la))
    for a, b in zip(pytree.tree_leaves((ga, ba)), pytree.tree_leaves((gb,
                                                                      bb))):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_perf_harness_on_the_card(card):
    from bigdl_tpu_torch.models.utils import perf
    r = perf.run_perf("lenet5", 32, 3)
    assert r["platform"] == "gpu" and r["peak_bytes"] > 0
    assert np.isfinite(r["loss"]) and r["throughput_rec_s"] > 0
