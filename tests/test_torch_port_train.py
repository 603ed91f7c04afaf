"""bigdl_tpu_torch's training path against the JAX package on the CPU:
``TransformerLM.apply`` gradients, the criteria, the optimization
methods, gradient clipping, a 3-step ``LocalOptimizer`` run, and the
train CLI.  Same weights (the JAX init carried over with
``params_from_numpy``) and the same numpy inputs on both sides; the JAX
flash path runs its Pallas kernels in interpret mode with pinned
blocks, as the JAX package's own tests do."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.utils import lm_corpus as jax_lm_corpus
from bigdl_tpu.models.utils import lm_dataset as jax_lm_dataset

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.utils import SYNTH_CORPUS, lm_corpus, lm_dataset
from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
from bigdl_tpu_torch.utils.params import (params_from_numpy, params_to_numpy,
                                          tree_leaves)

CONFIGS = {
    "learned": dict(pos_encoding="learned"),
    "rope": dict(pos_encoding="rope"),
    "doc_start": dict(pos_encoding="learned", doc_start_id=3),
    "untied": dict(pos_encoding="rope", tie_embeddings=False),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, impl, layers=2, **over):
    kw = dict(vocab_size=29, hidden_size=32, n_head=2, n_layers=layers,
              max_len=24)
    kw.update(CONFIGS[name])
    kw.update(over)
    jm = JaxLM(attention_impl=impl, block_size=8 if impl == "flash" else None,
               **kw).build(seed=0)
    tm = TransformerLM(attention_impl=impl, device="cpu", **kw)
    tm.params = params_from_numpy(_np_tree(jm.params), "cpu")
    return jm, tm


def _assert_trees_close(got, want, atol, rtol):
    """Leaf by leaf, matched by key path."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(np.asarray(node), np.asarray(leaf),
                                   atol=atol, rtol=rtol, err_msg=str(path))


# --------------------------------------------------------------------------- #
# TransformerLM.apply gradients                                               #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_grads_match_jax(name, impl):
    """Loss and every gradient leaf of TimeDistributed(ClassNLL) over
    ``apply``, 1e-4: float32 on both sides, only summation order
    differs (the JAX flash backward in interpret mode against the port's
    plain backward inside its autograd Function)."""
    jm, tm = _pair(name, impl)
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 30, size=(2, 19)).astype(np.float32)
    ids[:, [0, 7, 12]] = 3                          # document starts
    labels = rng.randint(1, 30, size=(2, 19)).astype(np.float32)
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True)

    def jloss(p):
        out, _ = jm.apply(p, jnp.asarray(ids), training=True,
                          rng=jax.random.PRNGKey(0))
        return jcrit.loss(out, jnp.asarray(labels))

    want_loss, want = jax.value_and_grad(jloss)(jm.params)
    loss, grads, _ = optim.loss_and_grads(
        tm, TimeDistributedCriterion(ClassNLLCriterion(), True), tm.params,
        torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_trees_close(params_to_numpy(grads), _np_tree(want), 1e-4, 1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_matches_plain(dropout):
    """Recomputed blocks give the same loss and gradients as stored
    ones, dropout included: each block rebuilds its generator from the
    seed drawn for its layer, so the replay draws the same masks."""
    _, tm = _pair("rope", "flash", dropout=dropout)
    tr = TransformerLM(attention_impl="flash", device="cpu", remat=True,
                       vocab_size=29, hidden_size=32, n_head=2, n_layers=2,
                       max_len=24, dropout=dropout, **CONFIGS["rope"])
    rng = np.random.RandomState(6)
    ids = torch.from_numpy(rng.randint(1, 30, size=(2, 16)))
    labels = torch.from_numpy(rng.randint(1, 30, size=(2, 16)))
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    out = []
    for m in (tm, tr):
        gen = torch.Generator().manual_seed(11)
        out.append(optim.loss_and_grads(m, crit, tm.params, ids, labels,
                                        generator=gen))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    if dropout:
        # a different generator draws other masks
        other = optim.loss_and_grads(tm, crit, tm.params, ids, labels,
                                     generator=torch.Generator().manual_seed(12))
        assert float(other[0]) != float(out[0][0])
        with pytest.raises(ValueError, match="generator"):
            tm.apply(tm.params, ids, training=True)


# --------------------------------------------------------------------------- #
# criteria                                                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size_average", [False, True])
def test_criteria_match_jax(weighted, size_average):
    """ClassNLL on (N, C) and TimeDistributed(ClassNLL) on (B, T, C),
    1e-6: the same float32 gathers and sums (a weighted size-average
    inner loss takes the per-timestep path on both sides)."""
    rng = np.random.RandomState(3)
    logp = np.log(rng.dirichlet(np.ones(7), size=(3, 5))).astype(np.float32)
    target = rng.randint(1, 8, size=(3, 5)).astype(np.float32)
    w = rng.rand(7).astype(np.float32) if weighted else None
    jc = jnn.ClassNLLCriterion(w, size_average)
    tc = ClassNLLCriterion(w, size_average)
    np.testing.assert_allclose(
        float(tc.loss(torch.from_numpy(logp[0]), torch.from_numpy(target[0]))),
        float(jc.loss(jnp.asarray(logp[0]), jnp.asarray(target[0]))),
        rtol=1e-6)
    for inner_avg in (False, True):
        jt = jnn.TimeDistributedCriterion(
            jnn.ClassNLLCriterion(w, inner_avg), size_average)
        tt = TimeDistributedCriterion(ClassNLLCriterion(w, inner_avg),
                                      size_average)
        np.testing.assert_allclose(
            float(tt.loss(torch.from_numpy(logp), torch.from_numpy(target))),
            float(jt.loss(jnp.asarray(logp), jnp.asarray(target))),
            rtol=1e-6)


# --------------------------------------------------------------------------- #
# optimization methods and clipping                                           #
# --------------------------------------------------------------------------- #

def _tree(rng):
    return {"a": rng.randn(4, 3).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float32),
                  "d": rng.randn(2, 2, 2).astype(np.float32)}}


METHODS = {
    "sgd_plain": lambda m: m.SGD(learning_rate=0.1),
    "sgd_momentum": lambda m: m.SGD(learning_rate=0.1, momentum=0.9),
    "sgd_nesterov_wd": lambda m: m.SGD(learning_rate=0.05, momentum=0.8,
                                       nesterov=True, weight_decay=1e-2),
    "sgd_dampening_decay": lambda m: m.SGD(learning_rate=0.1, momentum=0.5,
                                           dampening=0.2,
                                           learning_rate_decay=0.3,
                                           weight_decay=1e-3),
    "adam": lambda m: m.Adam(learning_rate=1e-2, weight_decay=1e-2),
    "adamw": lambda m: m.AdamW(learning_rate=1e-2, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_optim_methods_match_jax(name):
    """Three updates from the same parameter and gradient trees: 1e-6
    (float32 elementwise arithmetic in the same order)."""
    rng = np.random.RandomState(len(name))
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jm, tm = METHODS[name](joptim), METHODS[name](optim)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jm.init_state(jp)
    tp = params_from_numpy(p0, "cpu")
    ts = tm.init_state(tp)
    for g in grads:
        jp, js = jm.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        out, ts = tm.update(params_from_numpy(g, "cpu"), ts, tp)
        assert out is tp                           # updated in place
    assert ts["iteration"] == int(js["iteration"]) == 3
    _assert_trees_close(params_to_numpy(tp), _np_tree(jp), 1e-6, 1e-6)


@pytest.mark.parametrize("clip", ["const", "l2_active", "l2_inactive",
                                  "both"])
def test_gradient_clipping_matches_jax(clip):
    rng = np.random.RandomState(4)
    g = _tree(rng)
    jopt = joptim.LocalOptimizer.__new__(joptim.LocalOptimizer)
    topt = optim.LocalOptimizer(None, None, None)
    if clip in ("const", "both"):
        jopt.set_constant_gradient_clipping(-0.5, 0.7)
        topt.set_constant_gradient_clipping(-0.5, 0.7)
    if clip != "const":
        norm = 1.0 if clip != "l2_inactive" else 100.0
        jopt.set_gradient_clipping_by_l2_norm(norm)
        topt.set_gradient_clipping_by_l2_norm(norm)
    want = jopt._clip_gradients(jax.tree_util.tree_map(jnp.asarray, g))
    got = topt._clip_gradients(params_from_numpy(g, "cpu"))
    _assert_trees_close(params_to_numpy(got), _np_tree(want), 1e-6, 1e-6)


# --------------------------------------------------------------------------- #
# the slice as a whole: LocalOptimizer against the JAX package's              #
# --------------------------------------------------------------------------- #

def _train_both(method_name, steps=3):
    """The same synthetic corpus, batches and weights through both
    LocalOptimizers; returns (jax losses, port losses, jax model, port
    model)."""
    tok, dic = jax_lm_corpus(SYNTH_CORPUS, 100)
    ttok, tdic = lm_corpus(SYNTH_CORPUS, 100)
    vocab = dic.vocab_size()
    kw = dict(vocab_size=vocab, hidden_size=32, n_head=2, n_layers=2,
              max_len=16)
    jm = JaxLM(attention_impl="flash", block_size=8, **kw).build(seed=2)
    tm = TransformerLM(attention_impl="flash", device="cpu", **kw)
    tm.params = params_from_numpy(_np_tree(jm.params), "cpu")
    make = {"sgd": lambda m: m.SGD(learning_rate=0.1, momentum=0.9),
            "adam": lambda m: m.Adam(learning_rate=3e-3)}[method_name]
    losses = []
    for lib, crit, model, ds in (
            (joptim, jnn, jm, jax_lm_dataset(tok, dic, 16, 4, packed=True)),
            (optim, tnn, tm, lm_dataset(ttok, tdic, 16, 4, packed=True))):
        criterion = crit.TimeDistributedCriterion(crit.ClassNLLCriterion(),
                                                  True)
        opt = lib.LocalOptimizer(model, ds, criterion)
        opt.set_optim_method(make(lib))
        run = []
        for n in range(1, steps + 1):
            opt.set_end_when(lib.Trigger.max_iteration(n))
            opt.optimize()
            run.append(opt.state["loss"])
        losses.append(run)
    return losses[0], losses[1], jm, tm


def test_local_optimizer_sgd_matches_jax():
    """SGD with momentum, 3 steps: every step's loss within 1e-5
    relative, and every parameter within 1e-5 after them."""
    jl, tl, jm, tm = _train_both("sgd")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _assert_trees_close(params_to_numpy(tm.params), _np_tree(jm.params),
                        1e-5, 1e-5)


def test_local_optimizer_adam_matches_jax():
    """Adam, 3 steps: losses within 1e-4.  Parameters are not compared:
    for a gradient near zero Adam's step is about +-lr whatever its size,
    so a sign flip in a ~1e-10 gradient moves a weight by 2 lr."""
    jl, tl, _, _ = _train_both("adam")
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_train_cli_runs_on_cpu(caplog):
    from bigdl_tpu_torch.models.transformer import train
    with caplog.at_level(logging.INFO, logger="bigdl_tpu_torch.optim"):
        opt = train.main(["--synthetic", "--device", "cpu", "-e", "1",
                          "-b", "16", "--seqLength", "16", "--packed",
                          "--docIsolate"])
    assert np.isfinite(opt.state["loss"]) and opt.state["epoch"] == 2
    (method, result), = opt.validation_results
    assert str(method) == "Loss" and np.isfinite(result.result()[0])
    assert any(r.getMessage().startswith("Loss is Loss(")
               for r in caplog.records)
    # --moeExperts, --checkpoint, --model, --state and --resume are
    # ported (tests/test_torch_port_ckpt.py); --distributed is not
    with pytest.raises(SystemExit, match="not ported"):
        train.main(["--synthetic", "--device", "cpu", "--distributed"])


# --------------------------------------------------------------------------- #
# gradient accumulation (mirrors tests/test_grad_accum.py)                    #
# --------------------------------------------------------------------------- #

def _accum_data(n=32, t=8, vocab=13, seed=5):
    rng = np.random.RandomState(seed)
    seqs = rng.randint(1, vocab + 1, size=(n, t + 1))
    return seqs[:, :-1].astype(np.float32), seqs[:, 1:].astype(np.float32)


def _accum_train(accum, epochs=2, batch=16):
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    x, y = _accum_data()
    ds = DataSet.array([Sample(a, b) for a, b in zip(x, y)], seed=11) >> \
        SampleToBatch(batch)
    model = TransformerLM(vocab_size=13, hidden_size=16, n_head=2,
                          n_layers=1, max_len=8, device="cpu").build(2)
    opt = optim.LocalOptimizer(model, ds, TimeDistributedCriterion(
        ClassNLLCriterion(), True))
    opt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_gradient_accumulation(accum)
    opt.set_end_when(optim.Trigger.max_epoch(epochs))
    opt.optimize()
    return model.params, opt.state["loss"]


def test_accumulated_matches_full_batch():
    """Mean-reduced criterion: the mean of 4 micro-batch gradients is the
    full batch's, so two epochs' trajectories agree."""
    p1, loss1 = _accum_train(1)
    p4, loss4 = _accum_train(4)
    assert abs(loss1 - loss4) < 1e-5
    for a, b in zip(tree_leaves(p4), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("moe", [0, 2])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_jax(accum, moe):
    """One accumulated step against the JAX package's
    ``accumulated_value_and_grad`` (a scan over micro-batches): the loss
    within 1e-5 relative and every gradient leaf within 1e-5.  The MoE
    case threads its aux_loss buffer through the micro-batches and adds
    it to each micro-batch's loss."""
    from bigdl_tpu.optim.optimizer import accumulated_value_and_grad
    kw = dict(vocab_size=13, hidden_size=16, n_head=2, n_layers=2,
              max_len=8, moe_experts=moe, moe_capacity_factor=0.5)
    jm = JaxLM(attention_impl="xla", **kw).build(seed=3)
    tm = TransformerLM(attention_impl="xla", device="cpu", **kw)
    tm.params = params_from_numpy(_np_tree(jm.params), "cpu")
    x, y = _accum_data(n=8)
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True)

    def loss_fn(params, buffers, data, labels, rng):
        out, nb = jm.apply(params, data, buffers=buffers, training=True,
                           rng=rng)
        loss = jcrit.loss(out, labels)
        if "aux_loss" in nb:
            loss = loss + nb["aux_loss"]
        return loss, nb

    (want_loss, want_buf), want = jax.jit(
        lambda *a: accumulated_value_and_grad(loss_fn, accum, *a))(
        jm.params, jm.buffers, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    loss, grads, buf = optim.accumulated_loss_and_grads(
        tm, TimeDistributedCriterion(ClassNLLCriterion(), True), tm.params,
        torch.from_numpy(x), torch.from_numpy(y), accum, buffers=tm.buffers)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    _assert_trees_close(params_to_numpy(grads), _np_tree(want), 1e-5, 1e-5)
    if moe:
        assert float(buf["aux_loss"]) == pytest.approx(
            float(want_buf["aux_loss"]), rel=1e-5)


def test_indivisible_batch_raises():
    with pytest.raises(ValueError, match="divisible"):
        _accum_train(5)  # 16 % 5 != 0


def test_ragged_tail_falls_back_unaccumulated(caplog):
    """An indivisible batch (an epoch's ragged tail) runs as one
    unaccumulated step, bitwise that step, with one warning a shape."""
    tm = TransformerLM(vocab_size=13, hidden_size=16, n_head=2, n_layers=1,
                       max_len=8, device="cpu").build(9)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    x, y = (torch.from_numpy(a) for a in _accum_data(n=10))
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch.optim"):
        tail = optim.accumulated_loss_and_grads(tm, crit, tm.params, x, y, 4,
                                                batch_desc="ragged test")
        optim.accumulated_loss_and_grads(tm, crit, tm.params, x, y, 4,
                                         batch_desc="ragged test")
    ref = optim.accumulated_loss_and_grads(tm, crit, tm.params, x, y, 1)
    assert float(tail[0]) == float(ref[0])
    for a, b in zip(tree_leaves(tail[1]), tree_leaves(ref[1])):
        assert torch.equal(a, b)
    warned = [r for r in caplog.records if "not divisible" in r.getMessage()]
    assert len(warned) == 1


def test_setter_rejects_nonpositive():
    with pytest.raises(ValueError):
        optim.LocalOptimizer(None, None, None).set_gradient_accumulation(0)
