"""The recurrent stack of bigdl_tpu_torch against the JAX package on the
CPU (``bigdl_tpu_torch/nn/recurrent.py`` against
``bigdl_tpu/nn/recurrent.py``).

Both packages build each module from seed 1: the trees are bitwise
equal.  The same numpy input then goes through the reference's
``apply`` under ``jax.vjp`` and the port's under ``torch.autograd`` with
the same output cotangent: the output within 1e-5, the input gradient
and every parameter gradient within 1e-5 of that leaf's max |g|.  Each
cell runs alone (one step from the zero state) and under ``Recurrent``
at T <= 12.  Gate dropout's masks are the reference's bit for bit.  A
bf16-compute ``Recurrent`` keeps its state in the weights' dtype.
``BiRecurrent`` and ``TimeDistributed`` survive a save and load, in
each package's file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import Module as JModule

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.dropout import keep_masks
from bigdl_tpu_torch.utils import keychain, pytree

TOL = 1e-5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(make, seed=1):
    return make(jnn).build(seed), make(tnn).build(seed, device="cpu")


def _assert_bitwise(ref, port):
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref.params)]
    b = [x.numpy() for x in pytree.tree_leaves(port.params)]
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def _close_rel(got, want, what):
    """Each array within TOL of its own max |value|."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g) - w).max()) / scale
        assert err <= TOL, f"{what}: {err:.3e} of max |g| {scale:.3e}"


def _vjp_check(make, x, *, training=False, key=None, seed=1):
    """Builds bitwise, output within TOL, input and parameter gradients
    within TOL of their max |g|; returns the port's output."""
    ref, port = _both(make, seed)
    _assert_bitwise(ref, port)
    jkey = None if key is None else jnp.asarray(key)

    def fn(params, xin):
        return ref.apply(params, xin, training=training, rng=jkey)[0]

    yr, pull = jax.vjp(fn, ref.params, jnp.asarray(x))
    g = _x(*yr.shape, seed=7)
    gpr, gxr = pull(jnp.asarray(g))
    leaves, tdef = pytree.tree_flatten(port.params)
    req = [a.detach().requires_grad_(True) for a in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.enable_grad():
        yp, _ = port.apply(pytree.tree_unflatten(tdef, req), xt,
                           training=training, rng=key)
        grads = torch.autograd.grad(yp, req + [xt], torch.from_numpy(g))
    np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yr),
                               rtol=TOL, atol=TOL)
    _close_rel([gr.numpy() for gr in grads[:-1]],
               jax.tree_util.tree_leaves(gpr), "param grads")
    _close_rel([grads[-1].numpy()], [gxr], "input grad")
    return yp


CELLS = {
    "rnn_tanh": lambda n: n.RnnCell(5, 7),
    "rnn_relu": lambda n: n.RnnCell(5, 7, n.ReLU()),
    "lstm": lambda n: n.LSTM(5, 7),
    "gru": lambda n: n.GRU(5, 7),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_alone_matches_the_reference(name):
    """One step from the zero state (a cell used alone)."""
    y = _vjp_check(CELLS[name], _x(4, 5))
    assert tuple(y.shape) == (4, 7)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("steps", [1, 12])
def test_cell_under_recurrent_matches_the_reference(name, steps):
    y = _vjp_check(lambda n: n.Recurrent(CELLS[name](n)), _x(3, steps, 5))
    assert tuple(y.shape) == (3, steps, 7)


def test_recurrent_add_sets_the_cell():
    r = tnn.Recurrent().add(tnn.GRU(3, 4))
    assert r.modules == [r.cell] and r.cell.hidden_size == 4
    y = r.build(0, device="cpu").forward(_x(2, 5, 3))
    assert tuple(y.shape) == (2, 5, 4)


@pytest.mark.parametrize("merge", ["default", "join"])
def test_birecurrent_matches_the_reference(merge):
    def make(n):
        return n.BiRecurrent(n.LSTM(5, 6), merge=None if merge == "default"
                             else n.JoinTable(3))
    y = _vjp_check(make, _x(2, 8, 5))
    assert tuple(y.shape) == (2, 8, 6 if merge == "default" else 12)


def test_birecurrent_passes_no_training_or_key_to_its_directions():
    """The reference's quirk, kept: gate dropout never runs inside a
    BiRecurrent, in training or not."""
    m = tnn.BiRecurrent(tnn.GRU(4, 5, p=0.5)).build(2, device="cpu")
    x = torch.from_numpy(_x(2, 6, 4))
    a = m.apply(m.params, x)[0]
    b = m.apply(m.params, x, training=True, rng=keychain.prng_key(1))[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("inner", ["linear", "linear_logsoftmax"])
def test_time_distributed_matches_the_reference(inner):
    def make(n):
        lin = n.Linear(5, 4)
        return n.TimeDistributed(lin if inner == "linear" else
                                 n.Sequential(lin, n.LogSoftMax()))
    y = _vjp_check(make, _x(3, 7, 5))
    assert tuple(y.shape) == (3, 7, 4)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_gate_dropout_masks_are_the_reference_s(cell):
    """p = 0.3 under Recurrent: the masks from ``split(rng, T)`` equal
    ``jax.random.bernoulli``'s bit for bit, and the outputs and
    gradients match."""
    B, T, H, k = 3, 6, 7, (4 if cell == "lstm" else 3)
    key = np.asarray(jax.random.PRNGKey(5))
    keys = jax.random.split(jnp.asarray(key), T)
    want = np.stack([np.asarray(jax.random.bernoulli(kt, 0.7, (B, k * H)))
                     for kt in keys])
    got = keep_masks(keychain.split(key, T), (B, k * H), 0.7, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1

    def make(n):
        return n.Recurrent((n.LSTM if cell == "lstm" else n.GRU)(5, H, p=0.3))
    ref, port = _both(make)
    x = _x(B, T, 5)
    yr = ref.apply(ref.params, jnp.asarray(x), training=True,
                   rng=jnp.asarray(key))[0]
    yp = port.apply(port.params, torch.from_numpy(x), training=True,
                    rng=key)[0]
    np.testing.assert_allclose(yp.numpy(), np.asarray(yr), rtol=1e-6,
                               atol=1e-6)
    # dropout changes the output, and evaluation draws no mask
    y_eval = port.apply(port.params, torch.from_numpy(x))[0]
    assert not torch.allclose(y_eval, yp)
    _vjp_check(make, x, training=True, key=key)


def test_gate_dropout_of_a_cell_alone_uses_its_key():
    key = np.asarray(jax.random.PRNGKey(9))
    ref, port = _both(lambda n: n.LSTM(5, 6, p=0.3))
    x = _x(4, 5)
    yr = ref.apply(ref.params, jnp.asarray(x), training=True,
                   rng=jnp.asarray(key))[0]
    yp = port.apply(port.params, torch.from_numpy(x), training=True,
                    rng=key)[0]
    np.testing.assert_allclose(yp.numpy(), np.asarray(yr), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_bf16_compute_state_follows_the_weights(cell):
    """Under a bf16 parameter tree the state starts in bf16, so every
    step stays in bf16, as the reference's scan carry must."""
    def make(n):
        c = {"rnn": n.RnnCell, "lstm": n.LSTM, "gru": n.GRU}[cell](5, 6)
        return n.Recurrent(c)
    ref, port = _both(make)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref.params)
    tp = pytree.tree_map(lambda a: a.to(torch.bfloat16), port.params)
    x = _x(2, 5, 5)
    yr = ref.apply(jp, jnp.asarray(x))[0]
    yp = port.apply(tp, torch.from_numpy(x))[0]
    assert yr.dtype == jnp.bfloat16 and yp.dtype == torch.bfloat16
    np.testing.assert_allclose(yp.float().numpy(),
                               np.asarray(yr.astype(jnp.float32)),
                               rtol=0, atol=3e-2)


def _same_outputs(a, b, x):
    ya = a.apply(a.params, torch.from_numpy(x))[0]
    yb = b.apply(b.params, torch.from_numpy(x))[0]
    assert torch.equal(ya, yb)


@pytest.mark.parametrize("which", ["birecurrent_lstm", "time_distributed"])
def test_save_load_round_trip(which, tmp_path):
    """The port's file rebuilds the module by class name; the
    reference's file of the same module loads into the port too, and the
    reference reads the port's file into a template."""
    def make(n):
        if which == "birecurrent_lstm":
            return n.BiRecurrent(n.LSTM(4, 5), merge=n.JoinTable(3))
        return n.TimeDistributed(n.Sequential(n.Linear(4, 3),
                                              n.LogSoftMax()))
    ref, port = _both(make)
    x = _x(2, 6, 4)
    port.save(str(tmp_path / "port.bin"))
    back = tnn.Module.load(str(tmp_path / "port.bin"), device="cpu")
    assert type(back) is type(port)
    _same_outputs(port, back, x)
    ref.save(str(tmp_path / "ref.bin"))
    crossed = tnn.Module.load(str(tmp_path / "ref.bin"), device="cpu")
    _same_outputs(port, crossed, x)
    # and the reference reads the port's file into a template
    jback = JModule.load(str(tmp_path / "port.bin"), template=make(jnn))
    np.testing.assert_allclose(
        np.asarray(jback.apply(jback.params, jnp.asarray(x))[0]),
        port.apply(port.params, torch.from_numpy(x))[0].numpy(),
        rtol=1e-6, atol=1e-6)
