"""bigdl_tpu_torch's Module core against the JAX package on the CPU:
``Module``/``Criterion``, the linear family, the containers and the
activations (mirrors the module-core parts of
``tests/test_containers_and_modules.py``: TestSequential, TestBranches
but ``test_concat_table_and_cadd``, TestGradients for linear and
activations, TestCheckpointRemat; and of
``tests/test_layers_torch_oracle.py``: TestLinear, TestActivations,
TestEmbeddingEtc, TestAttentionOracle).

Both packages build from the same seed: the trees are bitwise equal
(``LookupTable``'s normal draw within 4 ulp).  The same numpy inputs
then go through both OO shells: forward outputs within rtol 1e-5 / atol
1e-6, ``backward`` gradients (input and every parameter) within 1e-5.
The reference's forward and backward run jitted, as its shell runs
them."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import keychain, pytree
from bigdl_tpu_torch.utils.table import T as TT
from bigdl_tpu_torch.utils.table import Table as TTable

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-5, atol=1e-5)


def _both(make, seed=0):
    """(reference module, port module), each built from ``seed``."""
    return make(jnn).build(seed), make(tnn).build(seed, device="cpu")


def _ref_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [a.detach().numpy() for a in pytree.tree_leaves(tree)]


def _to_lib(x, lib_t):
    """A nested numpy input as the reference's (jnp) or the port's (a
    Table of numpy arrays both take)."""
    if isinstance(x, list):
        return lib_t(*[_to_lib(v, lib_t) for v in x])
    return x


# -------------------------------------------------------------------- #
# build parity                                                         #
# -------------------------------------------------------------------- #
_BUILDS = {
    "linear": lambda n: n.Linear(8, 4),
    "linear_nobias": lambda n: n.Linear(6, 3, with_bias=False),
    "linear_xavier": lambda n: n.Linear(5, 7, init_method=n.Xavier),
    "bilinear": lambda n: n.Bilinear(3, 4, 5),
    "cosine": lambda n: n.Cosine(6, 3),
    "euclidean": lambda n: n.Euclidean(6, 3),
    "add": lambda n: n.Add(5),
    "mul": lambda n: n.Mul(),
    "cmul": lambda n: n.CMul((3, 4)),
    "cadd": lambda n: n.CAdd((1, 4)),
    "scale": lambda n: n.Scale((2, 5)),
    "mha": lambda n: n.MultiHeadAttention(32, 4),
    "sequential": lambda n: n.Sequential(n.Linear(8, 4), n.LogSoftMax()),
    "concat_tree": lambda n: n.Concat(
        2, n.Linear(5, 3),
        n.Sequential(n.Linear(5, 2), n.Tanh(), n.Scale((2,))),
        n.Sequential(n.MultiHeadAttention(8, 2), n.Linear(8, 8))),
    "deep_sequential": lambda n: n.Sequential(
        n.Linear(12, 12), n.Sequential(n.Linear(12, 6), n.CMul((6,))),
        n.Concat(2, n.Linear(6, 2), n.Add(6)), n.PReLU(8)),
}


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_build_is_the_references_bit_for_bit(name):
    a, b = _both(_BUILDS[name])
    ja, tb = _ref_leaves(a.params), _port_leaves(b.params)
    assert len(ja) == len(tb) > 0
    for x, y in zip(ja, tb):
        assert x.shape == y.shape and y.dtype == np.float32
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    assert b.device == torch.device("cpu")


def test_lookup_table_build_within_4_ulp():
    a, b = _both(lambda n: n.LookupTable(300, 24))
    x, y = np.asarray(a.params["weight"]), b.params["weight"].numpy()
    ulp = np.abs(x.view(np.int32).astype(np.int64)
                 - y.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4


def test_build_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: build() lands on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.Linear(3, 2).build(0)


# -------------------------------------------------------------------- #
# forward parity                                                       #
# -------------------------------------------------------------------- #
_R = np.random.RandomState(0)


def _x(*shape):
    return _R.randn(*shape).astype(np.float32)


_POS = np.abs(_x(3, 5)) + 0.1
_FORWARD = {
    # name: (make, input (numpy, or a list for a Table), train mode)
    "linear": (lambda n: n.Linear(7, 5), _x(4, 7), False),
    "linear_nobias": (lambda n: n.Linear(7, 5, with_bias=False), _x(4, 7),
                      False),
    "linear_3d": (lambda n: n.Linear(7, 5), _x(2, 3, 7), False),
    "bilinear": (lambda n: n.Bilinear(4, 5, 2), [_x(3, 4), _x(3, 5)], False),
    "mm": (lambda n: n.MM(), [_x(2, 3, 4), _x(2, 4, 5)], False),
    "mm_trans": (lambda n: n.MM(True, True), [_x(4, 3), _x(5, 4)], False),
    "mv": (lambda n: n.MV(), [_x(2, 3, 4), _x(2, 4)], False),
    "mv_trans": (lambda n: n.MV(True), [_x(4, 3), _x(4)], False),
    "dot_product": (lambda n: n.DotProduct(), [_x(3, 6), _x(3, 6)], False),
    "cosine": (lambda n: n.Cosine(6, 3), _x(4, 6), False),
    "euclidean": (lambda n: n.Euclidean(6, 3), _x(4, 6), False),
    "pairwise_l2": (lambda n: n.PairwiseDistance(2), [_x(3, 6), _x(3, 6)],
                    False),
    "pairwise_l1": (lambda n: n.PairwiseDistance(1), [_x(3, 6), _x(3, 6)],
                    False),
    "cosine_distance": (lambda n: n.CosineDistance(), [_x(3, 6), _x(3, 6)],
                        False),
    "lookup_table": (lambda n: n.LookupTable(10, 4),
                     np.array([[1, 3, 5], [2, 4, 10]], np.float32), False),
    "lookup_max_norm": (lambda n: n.LookupTable(10, 4, max_norm=1.0),
                        np.array([[1, 3, 5], [2, 4, 10]], np.float32), False),
    "add": (lambda n: n.Add(5), _x(3, 5), False),
    "add_constant": (lambda n: n.AddConstant(1.5), _x(3, 5), False),
    "mul": (lambda n: n.Mul(), _x(3, 5), False),
    "mul_constant": (lambda n: n.MulConstant(-2.0), _x(3, 5), False),
    "cmul": (lambda n: n.CMul((1, 5)), _x(3, 5), False),
    "cadd": (lambda n: n.CAdd((1, 5)), _x(3, 5), False),
    "scale": (lambda n: n.Scale((1, 5)), _x(3, 5), False),
    # activations
    "relu": (lambda n: n.ReLU(), _x(3, 5), False),
    "relu6": (lambda n: n.ReLU6(), 4 * _x(3, 5), False),
    "gelu_tanh": (lambda n: n.GELU(), _x(3, 5), False),
    "gelu_erf": (lambda n: n.GELU(approximate=False), _x(3, 5), False),
    "tanh": (lambda n: n.Tanh(), _x(3, 5), False),
    "sigmoid": (lambda n: n.Sigmoid(), _x(3, 5), False),
    "softmax": (lambda n: n.SoftMax(), _x(4, 7), False),
    "softmin": (lambda n: n.SoftMin(), _x(4, 7), False),
    "log_softmax": (lambda n: n.LogSoftMax(), _x(4, 7), False),
    "log_sigmoid": (lambda n: n.LogSigmoid(), _x(3, 5), False),
    "softplus": (lambda n: n.SoftPlus(), _x(3, 5), False),
    "softplus_beta": (lambda n: n.SoftPlus(2.0), _x(3, 5), False),
    "softsign": (lambda n: n.SoftSign(), _x(3, 5), False),
    "leaky_relu": (lambda n: n.LeakyReLU(0.02), _x(3, 5), False),
    "elu": (lambda n: n.ELU(0.7), _x(3, 5), False),
    "prelu_shared": (lambda n: n.PReLU(), _x(3, 5), False),
    "prelu_channels": (lambda n: n.PReLU(3), _x(2, 3, 4), False),
    "rrelu_eval": (lambda n: n.RReLU(), _x(3, 5), False),
    "rrelu_train": (lambda n: n.RReLU(), _x(3, 5), True),
    "hard_tanh": (lambda n: n.HardTanh(), 2 * _x(3, 5), False),
    "hard_shrink": (lambda n: n.HardShrink(0.4), _x(3, 5), False),
    "soft_shrink": (lambda n: n.SoftShrink(0.4), _x(3, 5), False),
    "tanh_shrink": (lambda n: n.TanhShrink(), _x(3, 5), False),
    "threshold": (lambda n: n.Threshold(0.1, -3.0), _x(3, 5), False),
    "clamp": (lambda n: n.Clamp(-0.5, 0.5), _x(3, 5), False),
    "power": (lambda n: n.Power(2.0, 0.5, 1.0), _x(3, 5), False),
    "square": (lambda n: n.Square(), _x(3, 5), False),
    "sqrt": (lambda n: n.Sqrt(), _POS, False),
    "log": (lambda n: n.Log(), _POS, False),
    "exp": (lambda n: n.Exp(), _x(3, 5), False),
    "abs": (lambda n: n.Abs(), _x(3, 5), False),
    # containers
    "sequential": (lambda n: n.Sequential(n.Linear(4, 8), n.ReLU(),
                                          n.Linear(8, 3), n.LogSoftMax()),
                   _x(2, 4), False),
    "concat": (lambda n: n.Concat(2, n.Linear(4, 3), n.Linear(4, 5)),
               _x(2, 4), False),
    "depth_concat": (lambda n: n.DepthConcat(n.MulConstant(2.0),
                                             n.AddConstant(1.0)),
                     _x(2, 3, 4, 4), False),
    "concat_table": (lambda n: n.ConcatTable(n.Linear(4, 2), n.Tanh()),
                     _x(2, 4), False),
    "parallel_table": (lambda n: n.ParallelTable(n.Linear(4, 2),
                                                 n.Linear(3, 2)),
                       [_x(2, 4), _x(2, 3)], False),
    "map_table": (lambda n: n.MapTable(n.Linear(4, 2)),
                  [_x(2, 4), _x(2, 4), _x(2, 4)], False),
    "bottle": (lambda n: n.Bottle(n.Linear(4, 2), 2, 2), _x(3, 5, 4), False),
    "flatten_table": (lambda n: n.FlattenTable(),
                      [_x(2), [_x(3), _x(1)]], False),
    "split_join": (lambda n: n.Sequential(n.SplitTable(2), n.JoinTable(1, 2)),
                   _x(2, 3, 4), False),
    "split_nid": (lambda n: n.SplitTable(1, 2), _x(2, 3, 4), False),
    "join_table": (lambda n: n.JoinTable(2), [_x(2, 3), _x(2, 4)], False),
    "mixture_table": (lambda n: n.MixtureTable(),
                      [np.asarray([[0.3, 0.7], [0.5, 0.5]], np.float32),
                       [_x(2, 4), _x(2, 4)]], False),
    "narrow_table": (lambda n: n.NarrowTable(2, 2),
                     [_x(2), _x(2), _x(2)], False),
    "narrow_table_neg": (lambda n: n.NarrowTable(2, -1),
                         [_x(2), _x(2), _x(2), _x(2)], False),
    "select_table": (lambda n: n.SelectTable(2), [_x(2), _x(3)], False),
    "select_table_neg": (lambda n: n.SelectTable(-1), [_x(2), _x(3)], False),
    # attention (the plain core on the CPU, as the reference's "auto")
    "mha_self": (lambda n: n.MultiHeadAttention(32, 4), _x(2, 6, 32), False),
    "mha_causal": (lambda n: n.MultiHeadAttention(32, 4, causal=True),
                   _x(2, 6, 32), False),
    "mha_table": (lambda n: n.MultiHeadAttention(16, 2),
                  [_x(2, 5, 16), _x(2, 7, 16), _x(2, 7, 16)], False),
    "mha_nobias": (lambda n: n.MultiHeadAttention(16, 2, with_bias=False),
                   _x(2, 5, 16), False),
}


def _forward_pair(name, seed=0):
    make, x, train = _FORWARD[name]
    a, b = _both(make, seed)
    if not train:
        a.evaluate()
        b.evaluate()
    ya = a.forward(_to_lib(x, JT))
    yb = b.forward(_to_lib(x, TT))
    return a, b, ya, yb


@pytest.mark.parametrize("name", sorted(_FORWARD))
def test_forward_matches_the_reference(name):
    _, _, ya, yb = _forward_pair(name)
    assert isinstance(ya, JTable) == isinstance(yb, TTable)
    la, lb = _ref_leaves(ya), _port_leaves(yb)
    assert len(la) == len(lb) > 0
    for u, v in zip(la, lb):
        assert u.shape == v.shape
        np.testing.assert_allclose(v, u, **FWD)


# -------------------------------------------------------------------- #
# backward parity                                                      #
# -------------------------------------------------------------------- #
_BACKWARD = sorted(
    n for n in _FORWARD
    if n not in ("lookup_table", "lookup_max_norm", "flatten_table",
                 "narrow_table", "narrow_table_neg", "select_table",
                 "select_table_neg", "split_nid", "rrelu_train"))


@pytest.mark.parametrize("name", _BACKWARD)
def test_backward_matches_the_reference(name):
    """``backward`` (gradInput and the accumulated parameter gradients)
    against the reference's ``jax.vjp`` pullback, with a seeded
    ``grad_output``."""
    a, b, ya, yb = _forward_pair(name)
    rng = np.random.RandomState(1)
    g = jax.tree_util.tree_map(
        lambda t: rng.randn(*np.shape(t)).astype(np.float32), ya)
    g_port = (TT(*[g[i + 1] for i in range(g.length())])
              if isinstance(g, JTable) else g)
    x = _FORWARD[name][1]
    gia = a.backward(_to_lib(x, JT), g)
    gib = b.backward(_to_lib(x, TT), g_port)
    for u, v in zip(_ref_leaves(gia), _port_leaves(gib)):
        np.testing.assert_allclose(v, u, **BWD)
    pa, pb = _ref_leaves(a.grad_params), _port_leaves(b.grad_params)
    assert len(pa) == len(pb)
    for u, v in zip(pa, pb):
        np.testing.assert_allclose(v, u, **BWD)


def test_update_grad_input_and_acc_grad_parameters_split_backward():
    a, b = _both(lambda n: n.Sequential(n.Linear(6, 5), n.Tanh(),
                                        n.Linear(5, 2)))
    x, g = _x(3, 6), _x(3, 2)
    gi = b.update_grad_input(x, g)
    np.testing.assert_allclose(gi.numpy(),
                               np.asarray(a.update_grad_input(x, g)), **BWD)
    b.acc_grad_parameters(x, g)
    b.acc_grad_parameters(x, g)   # accumulates
    a.acc_grad_parameters(x, g)
    a.acc_grad_parameters(x, g)
    for u, v in zip(_ref_leaves(a.grad_params), _port_leaves(b.grad_params)):
        np.testing.assert_allclose(v, u, **BWD)
    b.zero_grad_parameters()
    assert all(not v.any() for v in _port_leaves(b.grad_params))


# -------------------------------------------------------------------- #
# the OO shell                                                         #
# -------------------------------------------------------------------- #
def test_oo_shell_parameters_and_flatten():
    a, b = _both(lambda n: n.Sequential(n.Linear(4, 8), n.Tanh(),
                                        n.Linear(8, 3)), seed=1)
    x = np.ones((2, 4), np.float32)
    y = b.forward(x)
    assert tuple(y.shape) == (2, 3)
    g = b.backward(x, torch.ones_like(y))
    assert tuple(g.shape) == x.shape
    w, grads = b.parameters()
    assert len(w) == len(grads) == 4
    a.forward(x)
    a.backward(x, jnp.ones((2, 3)))
    fa, ga, _ = a.get_parameters()
    fb, gb, unravel = b.get_parameters()
    assert tuple(fb.shape) == (4 * 8 + 8 + 8 * 3 + 3,)
    np.testing.assert_array_equal(fb.numpy(), np.asarray(fa))
    np.testing.assert_allclose(gb.numpy(), np.asarray(ga), **BWD)
    for u, v in zip(pytree.tree_leaves(unravel(fb)),
                    pytree.tree_leaves(b.params)):
        assert torch.equal(u, v)


def test_parameters_table_names_each_layer():
    _, b = _both(lambda n: n.Sequential(n.Linear(4, 3), n.ReLU(),
                                        n.Linear(3, 2).set_name("head")))
    table = b.get_parameters_table()
    assert set(table.keys()) == {"Linear@0", "head"}
    assert set(table["head"].keys()) == {"weight", "bias", "gradWeight",
                                         "gradBias"}


def test_modes_times_clone_and_name():
    _, b = _both(lambda n: n.Sequential(n.Linear(4, 3), n.Tanh()))
    assert b.is_training() and b.modules[0].is_training()
    b.evaluate()
    assert not b.is_training() and not b.modules[1].is_training()
    b.forward(_x(2, 4))
    assert b.get_times()[0][1] > 0 and len(b.get_times()) == 3
    b.reset_times()
    assert b.get_times()[0][1] == 0.0
    c = b.clone_module()
    c.params["0"]["weight"].add_(1.0)
    assert not torch.equal(c.params["0"]["weight"], b.params["0"]["weight"])
    assert b.get_name() == "Sequential" and \
        b.set_name("net").get_name() == "net"
    assert b.has_params() and not tnn.Tanh().has_params()


def test_register_batch_buckets_pads_eval_forward_only():
    seen = []

    class Recording(tnn.Module):
        def f(self, params, x, *, training=False, rng=None):
            seen.append(int(x.shape[0]))
            return x * 2.0

    m = Recording().build(device="cpu").evaluate() \
        .register_batch_buckets([8, 16])
    for n in (3, 5, 8, 2, 7, 12, 99):
        y = m.forward(np.ones((n, 4), np.float32))
        assert tuple(y.shape) == (n, 4)
        np.testing.assert_allclose(y.numpy(), 2.0)
    assert seen == [8, 8, 8, 8, 8, 16, 99]
    seen.clear()
    m.training()
    for n in (3, 5):
        m.forward(np.ones((n, 2), np.float32))
    assert seen == [3, 5]   # training never pads


def test_remat_grads_identical():
    x = _x(4, 8)

    def grads(remat):
        m = tnn.Sequential(tnn.Linear(8, 16), tnn.Tanh(), tnn.Linear(16, 8))
        if remat:
            m.checkpoint()
        m.build(1, device="cpu")
        leaves, tdef = pytree.tree_flatten(m.params)
        req = [t.detach().requires_grad_(True) for t in leaves]
        y, _ = m.apply(pytree.tree_unflatten(tdef, req), torch.from_numpy(x),
                       training=True)
        return torch.autograd.grad((y ** 2).sum(), req)

    for u, v in zip(grads(True), grads(False)):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-7)


def test_criterion_shell_matches_the_reference():
    out = np.log(np.random.RandomState(2).dirichlet(
        np.ones(5), size=4)).astype(np.float32)
    target = np.array([1, 5, 3, 2], np.float32)
    for kw in ({}, {"size_average": False}):
        jc, tc = jnn.ClassNLLCriterion(**kw), tnn.ClassNLLCriterion(**kw)
        np.testing.assert_allclose(float(tc.forward(out, target)),
                                   float(jc.forward(out, target)), **FWD)
        np.testing.assert_allclose(tc.backward(out, target).numpy(),
                                   np.asarray(jc.backward(out, target)),
                                   **BWD)
    assert isinstance(tnn.TimeDistributedCriterion(tc), tnn.Criterion)


def test_format1_both_ways(tmp_path):
    """A Sequential saved by each package loads in the other: by class
    name in the port, into a template in the reference."""
    def make(n):
        return n.Sequential(n.Linear(8, 4, init_method=n.Xavier), n.Tanh(),
                            n.Scale((4,)), n.LogSoftMax())

    a, b = _both(make, seed=3)
    x = _x(2, 8)
    a.save(str(tmp_path / "ref.bigdl"))
    b.save(str(tmp_path / "port.bigdl"))
    ref_in_port = tnn.Module.load(str(tmp_path / "ref.bigdl"), device="cpu")
    assert [type(m).__name__ for m in ref_in_port.modules] == [
        "Linear", "Tanh", "Scale", "LogSoftMax"]
    assert ref_in_port.modules[0].init_method is tnn.Xavier
    port_in_ref = jnn.Module.load(str(tmp_path / "port.bigdl"),
                                  template=make(jnn))
    port_in_port = tnn.Module.load(str(tmp_path / "port.bigdl"),
                                   device="cpu")
    want = np.asarray(a.evaluate().forward(x))
    for m in (ref_in_port, port_in_port):
        np.testing.assert_array_equal(m.evaluate().forward(x).numpy(),
                                      b.evaluate().forward(x).numpy())
    np.testing.assert_allclose(b.forward(x).numpy(), want, **FWD)
    np.testing.assert_allclose(np.asarray(port_in_ref.evaluate().forward(x)),
                               want, **FWD)


@pytest.mark.parametrize("compute", ["dequant", "int8"])
def test_quantized_linear_is_the_references(compute):
    """``Module.quantize()`` gives a Linear its native per-output-channel
    scale, bitwise the reference's; the clone serves within the
    products' float32 tolerance of the reference's clone."""
    a, b = _both(lambda n: n.Sequential(n.Linear(8, 32), n.LogSoftMax()))
    qa, qb = a.quantize(compute=compute), b.quantize(compute=compute)
    wa, wb = qa.params["0"]["weight"], qb.params["0"]["weight"]
    assert wa.native and wb.native and wb.compute == compute
    assert tuple(wb.scale.shape) == (32, 1)
    np.testing.assert_array_equal(wb.q.numpy(), np.asarray(wa.q))
    np.testing.assert_array_equal(wb.scale.numpy(), np.asarray(wa.scale))
    assert qb.quant_report["payload_ratio"] == \
        qa.quant_report["payload_ratio"]
    assert not qb.is_training()
    x = _x(5, 8)
    np.testing.assert_allclose(qb.forward(x).numpy(),
                               np.asarray(qa.forward(x)), rtol=1e-5,
                               atol=1e-5)
    # the embedding owner is never quantized
    qe = tnn.Sequential(tnn.LookupTable(64, 8)).build(0, device="cpu") \
        .quantize()
    assert isinstance(qe.params["0"]["weight"], torch.Tensor)


def test_remaining_item12_refusals_name_their_item():
    """The loaders are ported; the quantized convolution weight, the
    CLIs' --distributed and distributed datasets still refuse, naming
    their item of ROADMAP Queue 1."""
    from types import SimpleNamespace

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.utils import refuse_distributed
    from bigdl_tpu_torch.quant import quantize_array
    conv = tnn.SpatialConvolution(2, 4, 3, 3).build(0, device="cpu")
    qparams = dict(conv.params,
                   weight=quantize_array(conv.params["weight"], (1, 2, 3)))
    with pytest.raises(NotImplementedError, match="item 12"):
        conv.apply(qparams, torch.from_numpy(_x(1, 2, 6, 6)))
    with pytest.raises(SystemExit, match="item 12"):
        refuse_distributed(SimpleNamespace(distributed=True))
    with pytest.raises(NotImplementedError, match="12-DIST"):
        DataSet.array([1, 2], distributed=True)


def test_transformer_lm_is_a_module_and_takes_the_reference_rng():
    from bigdl_tpu_torch.models.transformer import TransformerLM
    lm = TransformerLM(vocab_size=17, hidden_size=16, n_head=2, n_layers=1,
                       max_len=8, dropout=0.1, device="cpu").build(0)
    assert isinstance(lm, tnn.Module)
    ids = torch.randint(1, 18, (2, 8))
    key = keychain.prng_key(5)
    y1, _ = lm.apply(lm.params, ids, training=True, rng=key)
    y2, _ = lm.apply(lm.params, ids, training=True, rng=key)
    assert torch.equal(y1, y2)
    y0, _ = lm.apply(lm.params, ids, rng=key)
    torch.testing.assert_close(y0, lm.f(lm.params, ids))
    assert not os.path.exists("x.t7")


def test_depth_concat_pads_smaller_branches_like_the_reference():
    """Branches of different spatial sizes: the smaller maps are
    zero-padded around the centre (the odd extra row and column after),
    then joined on the channel dim."""
    def crop(lib):
        class Crop(lib.Module):
            def f(self, params, x, **kw):
                return x[..., 1:, :-2]
        return Crop()

    a, b = _both(lambda n: n.DepthConcat(n.MulConstant(2.0), crop(n)))
    x = _x(2, 3, 6, 7)
    ya = np.asarray(a.evaluate().forward(x))
    yb = b.evaluate().forward(x).numpy()
    assert yb.shape == ya.shape == (2, 6, 6, 7)
    np.testing.assert_array_equal(yb, ya)
