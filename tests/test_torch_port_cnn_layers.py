"""The image-classification layer zoo of bigdl_tpu_torch against the JAX
package on the CPU: convolution, pooling, normalization, dropout, the
shape layers and the table ops (``bigdl_tpu_torch/nn/{conv,pooling,
normalization,dropout,shape,table_ops}.py``).

Both packages build each layer from seed 1: the trees are bitwise
equal.  The same numpy input then goes through the reference's
``apply`` under ``jax.vjp`` and the port's under ``torch.autograd``
with the same output cotangent: the outputs, the new buffers, the input
gradient and every parameter gradient within atol 1e-5 and rtol 1e-5
(float32).  Cases cover NCHW and NHWC, floor and ceil pools with
overhanging windows (3x3 stride 2 on 56 and on 112, as Inception v1's
pools meet them), ``count_include_pad`` both ways, groups, dilation, an
even LRN size and 3-D (unbatched) input.  Dropout's mask from a key is
the reference's, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.dropout import keep_mask
from bigdl_tpu_torch.utils import pytree
from bigdl_tpu_torch.utils.table import T as TT

TOL = dict(rtol=1e-5, atol=1e-5)
_R = np.random.RandomState(0)


def _x(*shape):
    return _R.randn(*shape).astype(np.float32)


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _both(make, seed=1):
    return make(jnn).build(seed), make(tnn).build(seed, device="cpu")


def _leaves_np(tree, ref):
    if ref:
        return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    return [a.detach().numpy() for a in pytree.tree_leaves(tree)]


def _ref_run(m, x, g, training, key):
    """Reference output, buffers and (param, input) gradients."""
    table = isinstance(x, list)

    def fn(params, xin):
        y, b = m.apply(params, JT(*xin) if table else xin,
                       buffers=m.buffers, training=training,
                       rng=None if key is None else jnp.asarray(key))
        return y, b

    xin = [jnp.asarray(a) for a in x] if table else jnp.asarray(x)
    y, pull, b = jax.vjp(fn, m.params, xin, has_aux=True)
    gp, gx = pull(jnp.asarray(g))
    return y, b, gp, gx


def _port_run(m, x, g, training, key):
    table = isinstance(x, list)
    p_leaves, p_def = pytree.tree_flatten(m.params)
    p_req = [a.detach().requires_grad_(True) for a in p_leaves]
    xs = [torch.from_numpy(a).requires_grad_(True)
          for a in (x if table else [x])]
    with torch.enable_grad():
        y, b = m.apply(pytree.tree_unflatten(p_def, p_req),
                       TT(*xs) if table else xs[0], buffers=m.buffers,
                       training=training, rng=key)
        grads = torch.autograd.grad(y, p_req + xs, torch.from_numpy(g),
                                    allow_unused=True)
    gp = [torch.zeros_like(p) if gr is None else gr
          for gr, p in zip(grads[:len(p_req)], p_req)]
    gx = [torch.zeros_like(a) if gr is None else gr
          for gr, a in zip(grads[len(p_req):], xs)]
    return y, b, gp, gx


def _check(make, x, training=False, key=None, grads=True):
    ref, port = _both(make)
    for a, b in zip(_leaves_np((ref.params, ref.buffers), True),
                    _leaves_np((port.params, port.buffers), False)):
        np.testing.assert_array_equal(a, b)
    if not grads:
        yr, _ = ref.apply(ref.params, jnp.asarray(x) if not isinstance(
            x, list) else JT(*[jnp.asarray(a) for a in x]),
            buffers=ref.buffers, training=training, rng=key)
        with torch.no_grad():
            yp, _ = port.apply(port.params, torch.from_numpy(x)
                               if not isinstance(x, list)
                               else TT(*[torch.from_numpy(a) for a in x]),
                               buffers=port.buffers, training=training,
                               rng=key)
        np.testing.assert_allclose(yp.numpy(), np.asarray(yr), **TOL)
        return yp
    yr = ref.apply(ref.params, jnp.asarray(x) if not isinstance(x, list)
                   else JT(*[jnp.asarray(a) for a in x]),
                   buffers=ref.buffers, training=training,
                   rng=None if key is None else jnp.asarray(key))[0]
    g = _R.randn(*np.shape(yr)).astype(np.float32)
    yr, br, gpr, gxr = _ref_run(ref, x, g, training, key)
    yp, bp, gpp, gxp = _port_run(port, x, g, training, key)
    np.testing.assert_allclose(yp.detach().numpy(), np.asarray(yr), **TOL)
    for a, b in zip(_leaves_np(br, True), _leaves_np(bp, False)):
        np.testing.assert_allclose(b, a, **TOL)
    gxr = gxr if isinstance(x, list) else [gxr]
    for a, b in zip(gxr, gxp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    ref_gp = _leaves_np(gpr, True)
    assert len(ref_gp) == len(gpp)
    for a, b in zip(ref_gp, gpp):
        np.testing.assert_allclose(b.numpy(), a, **TOL)
    return yp


# -------------------------------------------------------------------- #
# convolution                                                          #
# -------------------------------------------------------------------- #
_CONV = {
    "basic": (lambda n, df: n.SpatialConvolution(
        3, 4, 3, 2, 2, 1, 1, 1, data_format=df), (2, 3, 9, 11)),
    "groups": (lambda n, df: n.SpatialConvolution(
        4, 6, 3, 3, 1, 1, 1, 1, n_group=2, data_format=df), (2, 4, 7, 7)),
    "no_bias_xavier": (lambda n, df: n.SpatialConvolution(
        3, 5, 1, 1, 2, 2, with_bias=False, init_method=n.Xavier,
        data_format=df), (2, 3, 6, 6)),
    "share": (lambda n, df: n.SpatialShareConvolution(
        3, 4, 5, 5, 1, 1, 2, 2, data_format=df), (1, 3, 8, 8)),
    "dilated": (lambda n, df: n.SpatialDilatedConvolution(
        3, 4, 3, 3, 1, 1, 2, 2, 2, 2, data_format=df), (2, 3, 9, 9)),
    "dilated_strided": (lambda n, df: n.SpatialDilatedConvolution(
        2, 3, 3, 2, 2, 1, 1, 0, 3, 2, data_format=df), (1, 2, 11, 10)),
    "full": (lambda n, df: n.SpatialFullConvolution(
        3, 4, 3, 3, 2, 2, 1, 1, 1, 1, data_format=df), (2, 3, 5, 6)),
    "full_groups": (lambda n, df: n.SpatialFullConvolution(
        4, 6, 4, 3, 2, 1, 1, 0, n_group=2, data_format=df), (1, 4, 5, 5)),
    "full_no_bias": (lambda n, df: n.SpatialFullConvolution(
        2, 3, 2, 2, 2, 2, no_bias=True, data_format=df), (2, 2, 4, 4)),
}


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(_CONV))
def test_convolution(name, df):
    make, shape = _CONV[name]
    x = _x(*shape)
    _check(lambda n: make(n, df), _nhwc(x) if df == "NHWC" else x)


def test_convolution_nhwc_is_the_nchw_layer():
    """The same weights in either layout give the same numbers, and the
    NHWC output is a channels-last view, not a copy."""
    x = _x(2, 3, 9, 9)
    a = tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1).build(1, device="cpu")
    b = tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                               data_format="NHWC").build(1, device="cpu")
    ya = a.forward(x)
    yb = b.forward(_nhwc(x))
    np.testing.assert_allclose(yb.permute(0, 3, 1, 2).numpy(), ya.numpy(),
                               **TOL)
    assert yb.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


def test_convolution_3d_input():
    _check(lambda n: n.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
           _x(3, 7, 6))


@pytest.mark.parametrize("table", ["random", "one_to_one"])
def test_convolution_map(table):
    def make(n):
        cls = n.SpatialConvolutionMap
        ct = cls.random(4, 3, 2, seed=2) if table == "random" \
            else cls.one_to_one(4)
        return cls(ct, 3, 3, 1, 1, 1, 1)
    _check(make, _x(2, 4, 6, 6))


def test_quantized_convolution_weight_names_its_item():
    """A quantized weight goes through ``qconv`` (it was refused before
    the quantized convolution was ported): with unit scales and integer
    weights, exactly the float convolution of bf16-rounded inputs."""
    from bigdl_tpu_torch.quant.qtensor import QTensor
    m = tnn.SpatialConvolution(2, 2, 1, 1).build(1, device="cpu")
    w = torch.tensor([[1, -2], [3, 0]], dtype=torch.int8).reshape(2, 2, 1, 1)
    q = QTensor(w, torch.ones(2, 1, 1, 1), "float32", True, "dequant", None)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 2, 2, 2).astype(
        np.float32)).to(torch.bfloat16).float()
    y, _ = m.apply({"weight": q, "bias": m.params["bias"]}, x)
    want = torch.nn.functional.conv2d(x, w.float(), m.params["bias"])
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)


# -------------------------------------------------------------------- #
# pooling                                                              #
# -------------------------------------------------------------------- #
_POOL_GEOMETRY = {
    # name: (kernel, stride, pad, input (C, H, W))
    "k2s2": (2, 2, 0, (2, 8, 9)),
    "k3s2": (3, 2, 0, (2, 9, 10)),
    "k3s2p1": (3, 2, 1, (2, 9, 10)),
    "k3s1p1": (3, 1, 1, (2, 7, 7)),
    "k3s2_56": (3, 2, 0, (2, 56, 56)),
    "k3s2_112": (3, 2, 0, (1, 112, 112)),
    "k3s3p2_wide_pad": (3, 3, 2, (2, 8, 8)),
    "k1s2": (1, 2, 0, (2, 7, 8)),
}


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("ceil", [False, True], ids=["floor", "ceil"])
@pytest.mark.parametrize("geo", sorted(_POOL_GEOMETRY))
def test_max_pooling(geo, ceil, df):
    k, s, p, chw = _POOL_GEOMETRY[geo]
    x = _x(2, *chw)

    def make(n):
        m = n.SpatialMaxPooling(k, k, s, s, p, p, data_format=df)
        return m.ceil() if ceil else m.floor()
    _check(make, _nhwc(x) if df == "NHWC" else x)


@pytest.mark.parametrize("cip", [True, False], ids=["cip", "no_cip"])
@pytest.mark.parametrize("ceil", [False, True], ids=["floor", "ceil"])
@pytest.mark.parametrize("geo", sorted(_POOL_GEOMETRY))
def test_average_pooling(geo, ceil, cip):
    k, s, p, chw = _POOL_GEOMETRY[geo]
    _check(lambda n: n.SpatialAveragePooling(
        k, k, s, s, p, p, ceil_mode=ceil, count_include_pad=cip), _x(2, *chw))


@pytest.mark.parametrize("cip", [True, False], ids=["cip", "no_cip"])
def test_average_pooling_nhwc_ceil_overhang(cip):
    x = _nhwc(_x(2, 3, 56, 56))
    _check(lambda n: n.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=cip,
        data_format="NHWC"), x)


def test_average_pooling_overhang_divides_by_the_whole_window():
    """The ceil-mode window past the input divides by kernel_h*kernel_w
    (the reference), not by the elements it covers (PyTorch's default)."""
    x = np.ones((1, 1, 5, 5), np.float32)
    m = tnn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True).build(
        1, device="cpu")
    y = m.forward(x).numpy()[0, 0]
    assert y[0, 0] == 1.0 and y[-1, -1] == 0.25 and y[0, -1] == 0.5


def test_average_pooling_sum_and_3d_input():
    _check(lambda n: n.SpatialAveragePooling(3, 3, 2, 2, 1, 1, divide=False),
           _x(2, 9, 9))


def test_roi_pooling():
    feats = _x(2, 3, 12, 10)
    rois = np.array([[0, 1, 1, 6, 7], [1, 0, 2, 9, 11], [0, 3, 3, 3, 3],
                     [1, 4.4, 0.6, 8.2, 5.1]], np.float32)
    ref, port = _both(lambda n: n.RoiPooling(3, 2, 0.5))
    yr = np.asarray(ref.apply({}, JT(jnp.asarray(feats),
                                     jnp.asarray(rois)))[0])
    yp = port.forward(TT(feats, rois)).numpy()
    np.testing.assert_allclose(yp, yr, **TOL)


# -------------------------------------------------------------------- #
# normalization                                                        #
# -------------------------------------------------------------------- #
_NORM = {
    "bn_2d": (lambda n: n.BatchNormalization(5), (6, 5)),
    "bn_2d_momentum": (lambda n: n.BatchNormalization(5, 1e-3, 0.3),
                       (4, 5)),
    "bn_no_affine": (lambda n: n.BatchNormalization(4, affine=False),
                     (5, 4)),
    "spatial_bn": (lambda n: n.SpatialBatchNormalization(3), (2, 3, 5, 4)),
    "spatial_bn_nhwc": (lambda n: n.SpatialBatchNormalization(
        3, data_format="NHWC"), (2, 5, 4, 3)),
    "bn_3d_input": (lambda n: n.BatchNormalization(3), (2, 3, 6)),
    "layer_norm": (lambda n: n.LayerNorm(6), (3, 6)),
    "layer_norm_plain": (lambda n: n.LayerNorm(6, affine=False), (2, 3, 6)),
    "normalize_l2": (lambda n: n.Normalize(2.0), (3, 6)),
    "normalize_l1": (lambda n: n.Normalize(1.0), (3, 6)),
    "normalize_inf": (lambda n: n.Normalize(float("inf")), (3, 6)),
    "lrn_odd": (lambda n: n.SpatialCrossMapLRN(5, 0.01, 0.75), (2, 7, 4, 4)),
    "lrn_even": (lambda n: n.SpatialCrossMapLRN(4, 0.02, 0.6, 2.0),
                 (2, 7, 4, 4)),
    "lrn_even_nhwc": (lambda n: n.SpatialCrossMapLRN(
        2, 0.05, 0.75, data_format="NHWC"), (2, 4, 4, 6)),
    "lrn_odd_nhwc": (lambda n: n.SpatialCrossMapLRN(
        3, 0.05, 0.75, data_format="NHWC"), (2, 4, 4, 6)),
    "subtractive": (lambda n: n.SpatialSubtractiveNormalization(3),
                    (2, 3, 9, 10)),
    "subtractive_small_kernel": (
        lambda n: n.SpatialSubtractiveNormalization(
            2, np.ones((3, 4), np.float32)), (2, 2, 6, 7)),
    "divisive": (lambda n: n.SpatialDivisiveNormalization(3), (2, 3, 9, 10)),
    "contrastive": (lambda n: n.SpatialContrastiveNormalization(2),
                    (2, 2, 9, 9)),
    "subtractive_3d": (lambda n: n.SpatialSubtractiveNormalization(2),
                       (2, 8, 8)),
}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(_NORM))
def test_normalization(name, training):
    make, shape = _NORM[name]
    _check(make, _x(*shape), training=training)


def test_batch_norm_leaves_its_buffers_alone():
    m = tnn.SpatialBatchNormalization(3).build(1, device="cpu")
    before = {k: v.clone() for k, v in m.buffers.items()}
    _, new = m.apply(m.params, torch.from_numpy(_x(2, 3, 4, 4)),
                     buffers=m.buffers, training=True)
    for k in before:
        assert torch.equal(m.buffers[k], before[k])
        assert not torch.equal(new[k], before[k])


# -------------------------------------------------------------------- #
# dropout and the gradient shapers                                     #
# -------------------------------------------------------------------- #
@pytest.mark.parametrize("p", [0.5, 0.3, 0.9])
@pytest.mark.parametrize("shape", [(4, 33), (2, 3, 5, 7), (70001,)])
def test_dropout_mask_is_the_references(shape, p):
    key = np.asarray(jax.random.PRNGKey(11), np.uint32)
    want = np.asarray(jax.random.bernoulli(jnp.asarray(key), 1.0 - p, shape))
    got = keep_mask(key, shape, 1.0 - p, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_dropout(training, scale):
    key = np.asarray(jax.random.PRNGKey(3), np.uint32)
    y = _check(lambda n: n.Dropout(0.4, scale=scale), _x(5, 12),
               training=training, key=key)
    if training:
        want = np.asarray(jax.random.bernoulli(jnp.asarray(key), 0.6,
                                               (5, 12)))
        np.testing.assert_array_equal(y.detach().numpy() != 0, want)


def test_dropout_needs_a_key_in_training():
    m = tnn.Dropout(0.5).build(1, device="cpu")
    with pytest.raises(ValueError, match="rng"):
        m.apply({}, torch.ones(2, 3), training=True)


@pytest.mark.parametrize("size_average", [False, True])
def test_l1_penalty(size_average):
    _check(lambda n: n.L1Penalty(0.3, size_average), _x(3, 4))


def test_gradient_reversal():
    _check(lambda n: n.GradientReversal(0.7), _x(3, 4))


# -------------------------------------------------------------------- #
# shape layers and table ops                                           #
# -------------------------------------------------------------------- #
_SHAPE = {
    "identity": (lambda n: n.Identity(), _x(2, 3)),
    "contiguous": (lambda n: n.Contiguous(), _x(2, 3)),
    "copy": (lambda n: n.Copy(), _x(2, 3)),
    "reshape_batch": (lambda n: n.Reshape((3, 4)), _x(2, 12)),
    "reshape_unbatched": (lambda n: n.Reshape((3, 4)), _x(12)),
    "reshape_single": (lambda n: n.Reshape((3, 4)), _x(1, 12)),
    "reshape_no_batch_mode": (lambda n: n.Reshape((6, 4), batch_mode=False),
                              _x(2, 12)),
    "infer_reshape": (lambda n: n.InferReshape((0, -1, 2)), _x(3, 4, 2)),
    "infer_reshape_batch": (lambda n: n.InferReshape((-1, 0), True),
                            _x(2, 6, 4)),
    "view": (lambda n: n.View(6), _x(4, 2, 3)),
    "view_single": (lambda n: n.View(2, 3), _x(1, 6)),
    "squeeze_all": (lambda n: n.Squeeze(), _x(2, 1, 3, 1)),
    "squeeze_dim": (lambda n: n.Squeeze(2), _x(2, 1, 3)),
    "squeeze_batch_dims": (lambda n: n.Squeeze(1, 2), _x(4, 1, 3)),
    "unsqueeze": (lambda n: n.Unsqueeze(2), _x(2, 3)),
    "unsqueeze_nid": (lambda n: n.Unsqueeze(1, 1), _x(2, 3)),
    "transpose": (lambda n: n.Transpose([(1, 3), (2, 3)]), _x(2, 3, 4)),
    "transpose_nhwc_to_nchw": (lambda n: n.Transpose([(2, 4), (3, 4)]),
                               _x(2, 3, 4, 5)),
    "replicate": (lambda n: n.Replicate(3, 2), _x(2, 4)),
    "replicate_ndim": (lambda n: n.Replicate(2, 1, 1), _x(3, 4)),
    "padding_after": (lambda n: n.Padding(2, 2, value=1.5), _x(2, 3)),
    "padding_before": (lambda n: n.Padding(1, -1), _x(2, 3)),
    "padding_nid": (lambda n: n.Padding(1, 2, 2), _x(3, 2, 4)),
    "spatial_zero_padding": (lambda n: n.SpatialZeroPadding(1, 2, 0, 1),
                             _x(2, 3, 4, 5)),
    "narrow": (lambda n: n.Narrow(2, 2, 3), _x(2, 5)),
    "narrow_negative": (lambda n: n.Narrow(2, -3, 2), _x(2, 5)),
    "narrow_to_end": (lambda n: n.Narrow(1, 2, -1), _x(4, 3)),
    "select": (lambda n: n.Select(2, 3), _x(2, 4, 3)),
    "select_last": (lambda n: n.Select(3, -1), _x(2, 4, 3)),
    "reverse": (lambda n: n.Reverse(2), _x(2, 4)),
    "cadd_table": (lambda n: n.CAddTable(), [_x(2, 3), _x(2, 3), _x(2, 3)]),
    "csub_table": (lambda n: n.CSubTable(), [_x(2, 3), _x(2, 3)]),
    "cmul_table": (lambda n: n.CMulTable(), [_x(2, 3), _x(2, 3), _x(2, 3)]),
    "cdiv_table": (lambda n: n.CDivTable(), [_x(2, 3), np.abs(_x(2, 3)) + 1]),
    "cmax_table": (lambda n: n.CMaxTable(), [_x(2, 3), _x(2, 3), _x(2, 3)]),
    "cmin_table": (lambda n: n.CMinTable(), [_x(2, 3), _x(2, 3)]),
    "sum": (lambda n: n.Sum(2), _x(3, 4, 2)),
    "sum_average_keep": (lambda n: n.Sum(1, 2, True, False), _x(3, 4, 2)),
    "mean": (lambda n: n.Mean(3), _x(3, 4, 2)),
    "mean_keep": (lambda n: n.Mean(1, squeeze=False), _x(3, 4)),
    "max": (lambda n: n.Max(2), _x(3, 5)),
    "max_nid": (lambda n: n.Max(1, 1), _x(3, 5)),
    "min": (lambda n: n.Min(1), _x(3, 5)),
}


@pytest.mark.parametrize("name", sorted(_SHAPE))
def test_shape_and_table_layer(name):
    make, x = _SHAPE[name]
    _check(make, x)


def test_index_and_masked_select():
    t = _x(3, 5)
    idx = np.array([[2, 1], [5, 5]], np.float32)
    ref, port = _both(lambda n: n.Index(2))
    yr = np.asarray(ref.apply({}, JT(jnp.asarray(t), jnp.asarray(idx)))[0])
    np.testing.assert_array_equal(port.forward(TT(t, idx)).numpy(), yr)
    mask = (t > 0).astype(np.float32)
    ref, port = _both(lambda n: n.MaskedSelect())
    yr = np.asarray(ref.apply({}, JT(jnp.asarray(t), jnp.asarray(mask)))[0])
    np.testing.assert_array_equal(port.forward(TT(t, mask)).numpy(), yr)


def test_echo_prints_the_shape(capsys):
    y = tnn.Echo().build(device="cpu").forward(_x(2, 3))
    assert y.shape == (2, 3)
    assert "Echo: shape (2, 3)" in capsys.readouterr().out
