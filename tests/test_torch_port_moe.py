"""bigdl_tpu_torch's switch MoE against the JAX package on the CPU:
``switch_mlp`` in both dispatch modes (outputs, balance loss and
gradients), an MoE ``TransformerLM`` (log-probs, ``aux_loss``, a 3-step
Adam run, greedy generation with dense routing), MoE serving and the
int8 clone of an MoE model.  The JAX parameters cross over with
``params_from_numpy``; the inputs are the same numpy arrays on both
sides, with batch rows >= 2 and a capacity factor of 0.5 so that tokens
really drop (the capacity count runs over the flattened batch)."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import generate as jgen
from bigdl_tpu.parallel import expert as jexpert

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.transformer import generate as tgen
from bigdl_tpu_torch.parallel import init_moe_params, switch_mlp
from bigdl_tpu_torch.serving import LMServingEngine
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import params_from_numpy, params_to_numpy

KW = dict(vocab_size=11, hidden_size=16, n_head=2, n_layers=2, max_len=12,
          moe_experts=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(impl="xla", seed=1, **over):
    kw = dict(KW, **over)
    jm = JaxLM(attention_impl=impl, block_size=8 if impl == "flash" else None,
               **kw).build(seed=seed)
    tm = TransformerLM(attention_impl=impl, device="cpu", **kw)
    tm.params = params_from_numpy(_np_tree(jm.params), "cpu")
    return jm, tm


def _ids(rng, b, t, vocab):
    return rng.randint(1, vocab + 1, size=(b, t)).astype(np.float32)


def _jit_switch(p, x, capacity_factor=None):
    """The reference's switch_mlp, jitted (one compile instead of an
    eager dispatch of every op)."""
    return jax.jit(lambda p, x: jexpert.switch_mlp(
        p, x, capacity_factor=capacity_factor))(p, x)


# --------------------------------------------------------------------------- #
# switch_mlp                                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("capacity_factor", [None, 0.5, 1.25])
def test_switch_mlp_matches_jax(capacity_factor):
    """y within 1e-5, aux within 1e-6, and the gradients of sum(y) + aux
    in gate, w1, w2 and x within 1e-5, at B = 3 rows of 10 tokens."""
    p = jexpert.init_moe_params(jax.random.PRNGKey(0), 4, 16, 32)
    pn = _np_tree(p)
    x = np.random.RandomState(0).randn(3, 10, 16).astype(np.float32)

    def jf(p, x):
        y, a = jexpert.switch_mlp(p, x, capacity_factor=capacity_factor)
        return jnp.sum(y) + a

    want_y, want_aux = _jit_switch(p, jnp.asarray(x), capacity_factor)
    want_gp, want_gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        p, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in pn.items()}
    tx = torch.tensor(x, requires_grad=True)
    drops = []
    y, aux = switch_mlp(tp, tx, capacity_factor=capacity_factor, drops=drops)
    (y.sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-5)
    assert float(aux.detach()) == pytest.approx(float(want_aux), abs=1e-6)
    for k in pn:
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   np.asarray(want_gp[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx),
                               atol=1e-5)
    if capacity_factor is None:
        assert drops == []
    else:
        # the dropped tokens are exactly the reference's zero rows; at 0.5
        # (30 tokens, C = ceil(0.5 * 30 / 4) = 4 slots an expert) at
        # least 14 drop
        zero = np.all(np.asarray(want_y).reshape(30, 16) == 0, axis=-1)
        assert int(drops[0]) == int(zero.sum())
        assert capacity_factor != 0.5 or int(drops[0]) >= 14


def test_capacity_positions_couple_batch_rows():
    """The capacity count runs over the tokens flattened row-major, so a
    row's drops depend on the rows before it: row 1 alone keeps tokens
    that row 1 behind row 0 drops, on both sides alike."""
    p = jexpert.init_moe_params(jax.random.PRNGKey(3), 4, 16, 32)
    pn = params_from_numpy(_np_tree(p), "cpu")
    x = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    both, _ = switch_mlp(pn, torch.from_numpy(x), capacity_factor=0.5)
    alone, _ = switch_mlp(pn, torch.from_numpy(x[1:]), capacity_factor=0.5)
    jboth, _ = _jit_switch(p, jnp.asarray(x), 0.5)
    jalone, _ = _jit_switch(p, jnp.asarray(x[1:]), 0.5)
    np.testing.assert_allclose(both.numpy(), np.asarray(jboth), atol=1e-5)
    np.testing.assert_allclose(alone.numpy(), np.asarray(jalone), atol=1e-5)
    assert not np.allclose(both.numpy()[1], alone.numpy()[0])


def test_argmax_ties_take_the_first_expert():
    """Two gate columns equal: every token's probabilities tie between
    experts 1 and 2, and both packages route to expert 1 (the first
    maximum), so expert 2's weights get no gradient."""
    p = {k: np.array(v) for k, v in _np_tree(
        jexpert.init_moe_params(jax.random.PRNGKey(4), 4, 8, 16)).items()}
    p["gate"][:, 2] = p["gate"][:, 1]
    p["gate"][:, [0, 3]] = -5.0 * np.abs(p["gate"][:, [0, 3]]) - 1.0
    x = np.abs(np.random.RandomState(2).randn(6, 8)).astype(np.float32)
    jy, _ = _jit_switch(jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y, _ = switch_mlp(tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-6)
    y.sum().backward()
    assert tp["w1"].grad[1].abs().sum() > 0
    assert float(tp["w1"].grad[2].abs().sum()) == 0.0


def test_switch_mlp_capacity_matches_dense_when_ample():
    """Mirror of tests/test_transformer.py TestMoELM: a capacity no token
    exceeds gives dense dispatch's outputs and balance loss."""
    p = params_from_numpy(init_moe_params(keychain.prng_key(0), 4, 8, 16),
                          "cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(32, 8)
                         .astype(np.float32))
    y_dense, aux_d = switch_mlp(p, x, capacity_factor=None)
    y_cap, aux_c = switch_mlp(p, x, capacity_factor=4.0)
    np.testing.assert_allclose(y_cap.numpy(), y_dense.numpy(), atol=1e-5)
    assert float(aux_c) == pytest.approx(float(aux_d), rel=1e-6)


# --------------------------------------------------------------------------- #
# the MoE TransformerLM                                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl,capacity_factor",
                         [("xla", 1.25), ("xla", 0.5), ("xla", None),
                          ("flash", 0.5)])
def test_apply_logp_and_aux_match_jax(impl, capacity_factor):
    """Log-probs and the aux_loss buffer within 1e-5 at B = 3; the flash
    case runs the JAX Pallas kernels in interpret mode."""
    jm, tm = _pair(impl, moe_capacity_factor=capacity_factor)
    x = _ids(np.random.RandomState(0), 3, 9, 11)
    want, jbuf = jax.jit(lambda p, x, b: jm.apply(p, x, buffers=b))(
        jm.params, jnp.asarray(x), jm.buffers)
    got, tbuf = tm.apply(tm.params, torch.from_numpy(x), buffers=tm.buffers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(tbuf["aux_loss"]) == pytest.approx(
        float(jbuf["aux_loss"]), abs=1e-6, rel=1e-5)


def test_forward_and_aux_buffer():
    """Mirror of TestMoELM.test_forward_and_aux_buffer: the aux buffer
    is finite and positive; a dense model grows no key."""
    _, tm = _pair()
    x = torch.from_numpy(_ids(np.random.RandomState(0), 2, 8, 11))
    y, nb = tm.apply(tm.params, x)
    assert tuple(y.shape) == (2, 8, 11)
    assert np.isfinite(float(nb["aux_loss"])) and float(nb["aux_loss"]) > 0
    assert set(tm.init_buffers()) == {"aux_loss"}
    dense = TransformerLM(vocab_size=11, hidden_size=16, n_head=2,
                          n_layers=1, max_len=12, device="cpu").build(0)
    _, nb2 = dense.apply(dense.params, x)
    assert "aux_loss" not in nb2 and dense.buffers == {}


def test_remat_matches_stored_blocks():
    _, tm = _pair(moe_capacity_factor=0.5)
    tr = TransformerLM(device="cpu", remat=True, moe_capacity_factor=0.5,
                       **KW)
    x = torch.from_numpy(_ids(np.random.RandomState(3), 2, 9, 11))
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True)
    a = optim.loss_and_grads(tm, crit, tm.params, x, x)
    b = optim.loss_and_grads(tr, crit, tm.params, x, x)
    assert float(a[0]) == pytest.approx(float(b[0]), rel=1e-6)
    for ga, gb in zip(optim.optimizer.tree_leaves(a[1]),
                      optim.optimizer.tree_leaves(b[1])):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=1e-6)


def _moe_datasets(rng_seed=0, vocab=7, batch=4):
    rng = np.random.RandomState(rng_seed)
    seqs = rng.randint(1, vocab + 1, size=(8, 9))
    feats = [(s[:-1].astype(np.float32), s[1:].astype(np.float32))
             for s in seqs]
    jds = JDataSet.array([JSample(f, l) for f, l in feats]) >> \
        JSampleToBatch(batch, drop_last=True)
    tds = DataSet.array([Sample(f, l) for f, l in feats]) >> \
        SampleToBatch(batch, drop_last=True)
    return jds, tds


class _IterationLosses(logging.Handler):
    """Each iteration's loss from the optimizers' per-iteration log
    record (both packages log "Epoch %d iteration %d: loss ..." with the
    float loss as its third argument)."""

    def __init__(self, logger):
        super().__init__(logging.INFO)
        self.logger, self.losses = logging.getLogger(logger), []

    def emit(self, record):
        if record.msg.startswith("Epoch %d iteration %d"):
            self.losses.append(float(record.args[2]))

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def test_local_optimizer_adam_matches_jax():
    """3 LocalOptimizer steps with Adam on an MoE model (capacity 0.5,
    tokens dropping), the aux_loss inside the differentiated loss on
    both sides: every step's loss within 1e-5 relative, and the gate,
    trained through the gate values and the balance loss, moved."""
    jm, tm = _pair(vocab_size=7, hidden_size=32, max_len=8,
                   moe_capacity_factor=0.5)
    gate0 = tm.params["blocks"]["moe"]["gate"].clone()
    jds, tds = _moe_datasets()
    losses = []
    for lib, crit, model, ds, logger in (
            (joptim, jnn, jm, jds, "bigdl_tpu.optim"),
            (optim, tnn, tm, tds, "bigdl_tpu_torch.optim")):
        opt = lib.LocalOptimizer(model, ds, crit.TimeDistributedCriterion(
            crit.ClassNLLCriterion(), True))
        opt.set_optim_method(lib.Adam(learning_rate=1e-3))
        opt.set_end_when(lib.Trigger.max_iteration(3))
        with _IterationLosses(logger) as record:
            opt.optimize()
        losses.append(record.losses)
    assert len(losses[0]) == len(losses[1]) == 3
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert not torch.equal(tm.params["blocks"]["moe"]["gate"], gate0)
    assert np.isfinite(float(tm.buffers["aux_loss"]))


def test_trains_with_aux_through_optimizer():
    """Mirror of TestMoELM.test_trains_with_aux_through_optimizer, at
    fewer steps: the loss falls and the gate received gradient."""
    _, tds = _moe_datasets(batch=8)
    m = TransformerLM(device="cpu", **dict(KW, vocab_size=7, hidden_size=32,
                                           max_len=8)).build(1)
    fresh = m.params["blocks"]["moe"]["gate"].clone()
    opt = optim.LocalOptimizer(m, tds, tnn.TimeDistributedCriterion(
        tnn.ClassNLLCriterion(), True))
    opt.set_optim_method(optim.Adam(learning_rate=0.01)) \
       .set_end_when(optim.Trigger.max_iteration(12))
    first = []
    opt.set_end_when(optim.Trigger.max_iteration(1))
    opt.optimize()
    first.append(opt.state["loss"])
    opt.set_end_when(optim.Trigger.max_iteration(12))
    opt.optimize()
    assert np.isfinite(opt.state["loss"]) and opt.state["loss"] < first[0]
    assert not torch.allclose(m.params["blocks"]["moe"]["gate"], fresh)


def test_generate_greedy_exact_vs_jax():
    """Greedy generation of a capacity-trained model: dense routing on
    every cached path, token for token the reference's."""
    jm, tm = _pair(seed=3, max_len=16)
    ids = np.random.RandomState(4).randint(1, 12, size=(3, 5)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(jm, jm.params, jnp.asarray(ids), 8))
    out = tgen.generate(tm, tm.params, ids, 8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generation_matches_full_recompute():
    """Mirror of TestMoELM.test_generation_matches_full_recompute: with
    dense dispatch the cached decode equals re-running the whole
    sequence through ``apply`` each step."""
    _, tm = _pair(moe_capacity_factor=None)
    prompt = _ids(np.random.RandomState(4), 2, 4, 11).astype(np.int64)
    out = tgen.generate(tm, tm.params, prompt, 5, device="cpu").numpy()
    ids = prompt
    for _ in range(5):
        logp, _ = tm.apply(tm.params, torch.from_numpy(ids))
        nxt = logp[:, -1].argmax(-1).numpy() + 1
        ids = np.concatenate([ids, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(out, ids)


def test_decode_batch_independent():
    """Mirror of TestMoELM.test_decode_batch_independent: a capacity
    model decodes a sequence alike alone or among 8."""
    _, tm = _pair()
    prompts = _ids(np.random.RandomState(6), 8, 4, 11).astype(np.int64)
    solo = tgen.generate(tm, tm.params, prompts[:1], 5, device="cpu")
    batch = tgen.generate(tm, tm.params, prompts, 5, device="cpu")
    np.testing.assert_array_equal(batch[0].numpy(), solo[0].numpy())


def test_engine_serves_moe_model():
    """LMServingEngine on an MoE model: every stream equal to offline
    generate at batch 1 (dense routing in prefill, decode and the
    suffix prefill of a radix hit)."""
    _, tm = _pair(seed=5, max_len=64)
    rng = np.random.RandomState(7)
    head = list(rng.randint(1, 12, size=16))
    prompts = [head + list(rng.randint(1, 12, size=n)) for n in (3, 9)] + \
        [list(rng.randint(1, 12, size=n)) for n in (5, 20)]
    eng = LMServingEngine(tm, slots=2, cache_len=64, block_len=8,
                          max_new_tokens=6, device="cpu")
    try:
        streams = [eng.submit(p) for p in prompts]
        got = [s.result(timeout=60) for s in streams]
    finally:
        eng.close()
    for p, g in zip(prompts, got):
        want = tgen.generate(tm, tm.params, np.asarray([p]), 6,
                             device="cpu")[0].numpy()
        np.testing.assert_array_equal(np.asarray(g), want)


def test_quantize_moe_mirrors_reference():
    """int8 (dequant compute): the same leaves quantized as the
    reference's report (the gate and both expert weights among them),
    and the clone generates as the reference's clone does.  int8
    compute: the reference's policy marks the expert weights int8 with
    no consumer and its serving fails; the port's refuses with a
    TypeError saying so."""
    jm, tm = _pair(seed=2, hidden_size=32)
    jq = jm.quantize("int8")
    tq = tm.quantize("int8")
    for key in ("quantized_leaves", "skipped_leaves", "bytes_orig",
                "bytes_quant"):
        assert tq.quant_report[key] == jq.quant_report[key], key
    assert sorted(tq.quant_report["per_layer_max_abs_err"]) == \
        sorted(jq.quant_report["per_layer_max_abs_err"])
    ids = np.random.RandomState(1).randint(1, 12, size=(2, 4)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(jq, jq.params, jnp.asarray(ids), 5))
    np.testing.assert_array_equal(
        tgen.generate(tq, tq.params, ids, 5, device="cpu").numpy(), ref)
    ti8 = tm.quantize("int8", compute="int8")
    with pytest.raises(TypeError, match="MoE"):
        tgen.generate(ti8, ti8.params, ids, 2, device="cpu")


def test_params_roundtrip_layout():
    """The moe leaves keep the reference's stacked layout: gate (L, D,
    E), w1 (L, E, D, F), w2 (L, E, F, D)."""
    tm = TransformerLM(device="cpu", **KW).build(0)
    moe = params_to_numpy(tm.params)["blocks"]["moe"]
    assert moe["gate"].shape == (2, 16, 4)
    assert moe["w1"].shape == (2, 4, 16, 64)
    assert moe["w2"].shape == (2, 4, 64, 16)
    assert "w1" not in tm.params["blocks"]
