"""The 24 criterions and NMS of bigdl_tpu_torch against the JAX package on
the CPU (``bigdl_tpu_torch/nn/criterions.py`` and ``nn/detection.py``
against ``bigdl_tpu/nn/criterions.py`` and ``nn/detection.py``).

One parametrised test holds every criterion: the same seeded numpy
output and target go through the reference's ``jax.value_and_grad`` of
``loss`` and the port's ``loss`` under ``torch.autograd``; the loss and
the gradient of every input (each table slot for the table criterions)
within 1e-6, with ``size_average`` both ways where the class takes it.
NMS gives the reference's indices and count exactly, on float boxes, on
integer boxes with tied scores, and on no boxes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.criterions import build_simplex

TOL = dict(rtol=1e-6, atol=1e-6)
B, C = 4, 5


def _r(seed):
    return np.random.RandomState(seed)


def _f(*shape, seed=0):
    return _r(seed).randn(*shape).astype(np.float32)


def _logp(seed=0):
    x = _f(B, C, seed=seed)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _labels(seed=1, n=B, c=C):
    return (_r(seed).randint(0, c, n) + 1).astype(np.float32)


def _sign(*shape, seed=2):
    return np.where(_r(seed).rand(*shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


def _probs(seed=3):
    p = _r(seed).rand(B, C).astype(np.float32)
    p[0, 1] = 0.0  # a zero target term
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(np.float32)


_W = np.asarray([0.5, 1.0, 2.0, 1.5, 0.25], np.float32)
_MULTILABEL = np.asarray([[3, 1, 0, 0, 0], [2, 0, 5, 0, 0],
                          [5, 4, 3, 2, 1], [0, 2, 0, 0, 0]], np.float32)

# name -> (factory(lib, size_average), output, target, takes size_average)
CASES = {
    "ClassNLL": (lambda n, sa: n.ClassNLLCriterion(size_average=sa),
                 lambda: _logp(), lambda: _labels(), True),
    "ClassNLL_weighted": (
        lambda n, sa: n.ClassNLLCriterion(_W, size_average=sa),
        lambda: _logp(), lambda: _labels(), True),
    "CrossEntropy": (lambda n, sa: n.CrossEntropyCriterion(size_average=sa),
                     lambda: _f(B, C), lambda: _labels(), True),
    "MSE": (lambda n, sa: n.MSECriterion(sa), lambda: _f(B, C),
            lambda: _f(B, C, seed=4), True),
    "Abs": (lambda n, sa: n.AbsCriterion(sa), lambda: _f(B, C),
            lambda: _f(B, C, seed=4), True),
    "BCE": (lambda n, sa: n.BCECriterion(_W, size_average=sa),
            lambda: _sigmoid(_f(B, C)),
            lambda: (_r(5).rand(B, C) < 0.5).astype(np.float32), True),
    "DistKLDiv": (lambda n, sa: n.DistKLDivCriterion(sa), lambda: _logp(),
                  lambda: _probs(), True),
    "SmoothL1": (lambda n, sa: n.SmoothL1Criterion(sa),
                 lambda: 2 * _f(B, C), lambda: _f(B, C, seed=4), True),
    "SmoothL1WithWeights": (
        lambda n, sa: n.SmoothL1CriterionWithWeights(sigma=2.0, num=4),
        lambda: _f(B, C),
        lambda: [_f(B, C, seed=4), _r(6).rand(B, C).astype(np.float32),
                 _r(7).rand(B, C).astype(np.float32)], False),
    "Margin": (lambda n, sa: n.MarginCriterion(0.8, sa), lambda: _f(B, C),
               lambda: _sign(B, C), True),
    "MarginRanking": (lambda n, sa: n.MarginRankingCriterion(0.5, sa),
                      lambda: [_f(B), _f(B, seed=4)], lambda: _sign(B),
                      True),
    "MultiMargin_p1": (
        lambda n, sa: n.MultiMarginCriterion(1, _W, 0.9, sa),
        lambda: _f(B, C), lambda: _labels(), True),
    "MultiMargin_p2": (lambda n, sa: n.MultiMarginCriterion(2,
                                                            size_average=sa),
                       lambda: _f(B, C), lambda: _labels(), True),
    "MultiLabelMargin": (lambda n, sa: n.MultiLabelMarginCriterion(sa),
                         lambda: _f(B, C), lambda: _MULTILABEL, True),
    "MultiLabelSoftMargin": (
        lambda n, sa: n.MultiLabelSoftMarginCriterion(_W, sa),
        lambda: _f(B, C),
        lambda: (_r(5).rand(B, C) < 0.5).astype(np.float32), True),
    "SoftMargin": (lambda n, sa: n.SoftMarginCriterion(sa), lambda: _f(B, C),
                   lambda: _sign(B, C), True),
    "HingeEmbedding": (lambda n, sa: n.HingeEmbeddingCriterion(0.7, sa),
                       lambda: _f(B, C), lambda: _sign(B, C), True),
    "L1HingeEmbedding_similar": (
        lambda n, sa: n.L1HingeEmbeddingCriterion(2.0),
        lambda: [_f(C), _f(C, seed=4)], lambda: np.float32(1.0), False),
    "L1HingeEmbedding_dissimilar": (
        lambda n, sa: n.L1HingeEmbeddingCriterion(9.0),
        lambda: [_f(C), _f(C, seed=4)], lambda: np.float32(-1.0), False),
    "CosineEmbedding": (lambda n, sa: n.CosineEmbeddingCriterion(0.2, sa),
                        lambda: [_f(B, C), _f(B, C, seed=4)],
                        lambda: _sign(B), True),
    "ClassSimplex": (lambda n, sa: n.ClassSimplexCriterion(C),
                     lambda: _f(B, C), lambda: _labels(), False),
    "L1Cost": (lambda n, sa: n.L1Cost(), lambda: _f(B, C),
               lambda: _f(B, C, seed=4), False),
    "SoftmaxWith_valid_ignore": (
        lambda n, sa: n.SoftmaxWithCriterion(ignore_label=2),
        lambda: _f(B, C, 3), lambda: _labels(n=B * 3).reshape(B, 3), False),
    "SoftmaxWith_batch_size": (
        lambda n, sa: n.SoftmaxWithCriterion(normalize_mode="BATCH_SIZE"),
        lambda: _f(B, C, 3), lambda: _labels(n=B * 3).reshape(B, 3), False),
    "SoftmaxWith_full": (
        lambda n, sa: n.SoftmaxWithCriterion(normalize_mode="FULL"),
        lambda: _f(B, C), lambda: _labels(), False),
    "SoftmaxWith_none": (
        lambda n, sa: n.SoftmaxWithCriterion(3, normalize_mode="NONE"),
        lambda: _f(B, C), lambda: _labels(), False),
    "Parallel": (
        lambda n, sa: n.ParallelCriterion().add(n.MSECriterion(), 0.5).add(
            n.ClassNLLCriterion(), 2.0),
        lambda: [_f(B, C), _logp(seed=8)],
        lambda: [_f(B, C, seed=4), _labels()], False),
    "Parallel_repeat_target": (
        lambda n, sa: n.ParallelCriterion(True).add(n.MSECriterion()).add(
            n.AbsCriterion(), 0.3),
        lambda: [_f(B, C), _f(B, C, seed=8)], lambda: _f(B, C, seed=4),
        False),
    "Multi": (lambda n, sa: n.MultiCriterion().add(n.MSECriterion(), 0.3).add(
        n.SmoothL1Criterion(), 0.7), lambda: _f(B, C),
        lambda: _f(B, C, seed=4), False),
    "CriterionTable": (lambda n, sa: n.CriterionTable(n.AbsCriterion()),
                       lambda: [_f(B, C), _f(B, C, seed=4)], lambda: None,
                       False),
    "TimeDistributed": (
        lambda n, sa: n.TimeDistributedCriterion(n.ClassNLLCriterion(), sa),
        lambda: np.stack([_logp(s) for s in range(3)], 1),
        lambda: np.stack([_labels(s) for s in range(3)], 1), True),
    "TimeDistributed_weighted": (
        lambda n, sa: n.TimeDistributedCriterion(
            n.ClassNLLCriterion(_W), sa),
        lambda: np.stack([_logp(s) for s in range(3)], 1),
        lambda: np.stack([_labels(s) for s in range(3)], 1), True),
}

PARAMS = [(name, sa) for name, case in sorted(CASES.items())
          for sa in ((True, False) if case[3] else (True,))]


def test_every_criterion_of_the_reference_is_covered():
    names = {"ClassNLLCriterion", "CrossEntropyCriterion", "MSECriterion",
             "AbsCriterion", "BCECriterion", "DistKLDivCriterion",
             "SmoothL1Criterion", "SmoothL1CriterionWithWeights",
             "MarginCriterion", "MarginRankingCriterion",
             "MultiMarginCriterion", "MultiLabelMarginCriterion",
             "MultiLabelSoftMarginCriterion", "SoftMarginCriterion",
             "HingeEmbeddingCriterion", "L1HingeEmbeddingCriterion",
             "CosineEmbeddingCriterion", "ClassSimplexCriterion", "L1Cost",
             "SoftmaxWithCriterion", "ParallelCriterion", "MultiCriterion",
             "TimeDistributedCriterion", "CriterionTable"}
    assert len(names) == 24
    covered = {type(case[0](tnn, True)).__name__ for case in CASES.values()}
    assert covered == names
    for name in names:
        assert issubclass(getattr(tnn, name), tnn.Criterion)


def _jax_target(t):
    if t is None:
        return None
    if isinstance(t, list):
        return [jnp.asarray(a) for a in t]
    return jnp.asarray(t)


def _torch_target(t):
    if t is None:
        return None
    if isinstance(t, list):
        return [torch.from_numpy(np.asarray(a)) for a in t]
    return torch.from_numpy(np.asarray(t))


@pytest.mark.parametrize("name,size_average", PARAMS)
def test_criterion_loss_and_gradient_match_the_reference(name, size_average):
    make, out_fn, tgt_fn, _ = CASES[name]
    out, tgt = out_fn(), tgt_fn()
    ref, port = make(jnn, size_average), make(tnn, size_average)
    table = isinstance(out, list)
    jout = [jnp.asarray(a) for a in out] if table else jnp.asarray(out)
    want, jgrad = jax.value_and_grad(
        lambda o: ref.loss(o, _jax_target(tgt)))(jout)
    touts = [torch.from_numpy(np.asarray(a)).requires_grad_(True)
             for a in (out if table else [out])]
    with torch.enable_grad():
        got = port.loss(touts if table else touts[0], _torch_target(tgt))
        grads = torch.autograd.grad(got, touts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip(grads, jgrad if table else [jgrad]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the Torch-style shell's forward and backward agree with loss
    assert float(port.forward(touts if table else touts[0],
                              _torch_target(tgt))) == pytest.approx(
        float(got.detach()), rel=1e-6)
    back = port.backward([t.detach() for t in touts] if table
                         else touts[0].detach(), _torch_target(tgt))
    for g, b in zip(grads, back if table else [back]):
        np.testing.assert_allclose(b.numpy(), g.numpy(), **TOL)


def test_class_simplex_is_the_reference_s():
    from bigdl_tpu.nn.criterions import ClassSimplexCriterion as J
    for n in (2, 5, 10):
        np.testing.assert_array_equal(build_simplex(n), J._build_simplex(n))
        s = build_simplex(n).astype(np.float64)
        gram = s @ s.T
        np.testing.assert_allclose(np.diag(gram), 1.0, atol=1e-6)
        np.testing.assert_allclose(gram[~np.eye(n, dtype=bool)], -1.0 / n,
                                   atol=1e-6)


def test_numpy_float64_targets_read_as_float32():
    out = torch.from_numpy(_f(B, C))
    t64 = _f(B, C, seed=4).astype(np.float64)
    loss = tnn.MSECriterion().loss(out, t64)
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(
        float(jnn.MSECriterion().loss(jnp.asarray(out.numpy()),
                                      jnp.asarray(t64))), rel=1e-6)


# ---------------------------------------------------------------------- #
# NMS
# ---------------------------------------------------------------------- #
def _boxes(n, seed, integer=False):
    r = _r(seed)
    xy = r.rand(n, 2) * 100
    wh = r.rand(n, 2) * 40 + 5
    b = np.concatenate([xy, xy + wh], 1)
    return (np.floor(b) if integer else b).astype(np.float32)


@pytest.mark.parametrize("case", ["float", "integer_ties"])
@pytest.mark.parametrize("iou,max_out", [(0.5, 100), (0.3, 7), (0.7, 40)])
def test_nms_equals_the_reference(case, iou, max_out):
    from bigdl_tpu.nn.detection import nms as jnms
    boxes = _boxes(120, seed=11, integer=case != "float")
    if case == "float":
        scores = _r(12).rand(120).astype(np.float32)
    else:
        # a few distinct scores: ties everywhere, broken by the lowest
        # index as jnp.argmax breaks them
        scores = (_r(12).randint(0, 6, 120) / 6.0).astype(np.float32)
    keep_j, count_j = jnms(boxes, scores, iou, max_out)
    keep, count = tnn.nms(torch.from_numpy(boxes), scores, iou, max_out)
    assert keep.dtype == torch.int32 and tuple(keep.shape) == (max_out,)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert int(count) == int(count_j) > 0
    assert (keep.numpy()[int(count):] == 0).all()
    np.testing.assert_array_equal(
        tnn.Nms(iou, max_out)(boxes, scores),
        jnn.Nms(iou, max_out)(boxes, scores))


def test_nms_of_no_boxes():
    keep, count = tnn.nms(np.zeros((0, 4), np.float32),
                          np.zeros((0,), np.float32), 0.5, 5)
    assert int(count) == 0 and keep.tolist() == [0] * 5
