"""bigdl_tpu_torch's Torch7 .t7 reader and writer against the JAX
package on the CPU (mirrors ``tests/test_torch_file.py``).

Format compliance is pinned as the reference pins it: byte-level golden
vectors, round trips, and real Torch7 files when the reference checkout
holds them.  Beside that, both packages' ``save_model`` of the same
tree (each built from the same seed, bitwise equal) must give
byte-identical files, each package must read the other's, and a
loaded model's forward must match the reference's forward of the source
model on the same numpy input: rtol 1e-5 / atol 1e-5, loaded parameters
bitwise.
"""
import glob
import struct

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils import torch_file as jt7

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import pytree
from bigdl_tpu_torch.utils import torch_file as t7
from bigdl_tpu_torch.utils.table import T
from bigdl_tpu_torch.utils.torch_file import (TorchObject, load, load_model,
                                              save, save_model)

_REF_T7 = sorted(glob.glob(
    "/root/reference/spark/dl/src/test/resources/torch/*.t7"))
FWD = dict(rtol=1e-5, atol=1e-5)


def rt(obj, tmp_path, name="x.t7"):
    p = str(tmp_path / name)
    save(obj, p)
    return load(p)


def _both(make, seed=0):
    """(reference module, port module on the CPU) from one seed."""
    return make(jnn).build(seed), make(tnn).build(seed, device="cpu")


def _port_out(y):
    if isinstance(y, torch.Tensor):
        return [y.numpy()]
    return [a.numpy() for a in pytree.tree_leaves(y)]


def _ref_out(y):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(y)]


def _same_forward(ref, port, x, **tol):
    for a, b in zip(_ref_out(ref.forward(x)), _port_out(port.forward(x))):
        np.testing.assert_allclose(b, a, **(tol or FWD))


def _assert_params_equal(ref_tree, port_tree):
    ref = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_tree)]
    port = [a.numpy() for a in pytree.tree_leaves(port_tree)]
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)


def _roundtrip(ref, port, tmp_path, name):
    """Save both models, assert the files are byte-identical, and return
    (the port's reload of its file, the reference's reload of the
    port's file)."""
    pp, pr = str(tmp_path / ("port_" + name)), str(tmp_path / ("ref_" + name))
    save_model(port, pp)
    jt7.save_model(ref, pr)
    assert open(pp, "rb").read() == open(pr, "rb").read()
    return load_model(pp, device="cpu"), jt7.load_model(pp)


# --------------------------------------------------------------------- #
# wire format                                                           #
# --------------------------------------------------------------------- #
def test_golden_number_bytes(tmp_path):
    p = str(tmp_path / "n.t7")
    save(4.5, p)
    raw = open(p, "rb").read()
    assert raw == struct.pack("<i", 1) + struct.pack("<d", 4.5)


def test_golden_string_bytes(tmp_path):
    p = str(tmp_path / "s.t7")
    save("abc", p)
    assert open(p, "rb").read() == (struct.pack("<i", 2) + struct.pack("<i", 3)
                                    + b"abc")


def test_golden_float_tensor_bytes(tmp_path):
    """A numpy array and the same values as a torch tensor both write the
    reference's golden bytes."""
    exp = struct.pack("<i", 4) + struct.pack("<i", 1)
    exp += struct.pack("<i", 3) + b"V 1"
    exp += struct.pack("<i", 17) + b"torch.FloatTensor"
    exp += struct.pack("<i", 2) + struct.pack("<qq", 2, 3) + struct.pack("<qq", 3, 1)
    exp += struct.pack("<q", 1)
    exp += struct.pack("<i", 4) + struct.pack("<i", 2)
    exp += struct.pack("<i", 3) + b"V 1"
    exp += struct.pack("<i", 18) + b"torch.FloatStorage"
    exp += struct.pack("<q", 6) + np.arange(1, 7, dtype=np.float32).tobytes()
    a = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    for i, obj in enumerate((a, torch.from_numpy(a))):
        p = str(tmp_path / f"t{i}.t7")
        save(obj, p)
        assert open(p, "rb").read() == exp


def test_scalar_roundtrip(tmp_path):
    assert rt(3.25, tmp_path) == 3.25
    assert rt(7.0, tmp_path) == 7 and isinstance(rt(7.0, tmp_path), int)
    assert rt(True, tmp_path) is True
    assert rt(None, tmp_path) is None
    assert rt("héllo", tmp_path) == "héllo"


def test_table_roundtrip(tmp_path):
    table = {"a": 1, "b": {"nested": 2.5}, 1: "one"}
    got = rt(table, tmp_path)
    assert got["a"] == 1 and got["b"]["nested"] == 2.5 and got[1] == "one"
    # the reference reads the port's file and writes the same bytes
    p, q = str(tmp_path / "p.t7"), str(tmp_path / "q.t7")
    save(table, p)
    jt7.save(table, q)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert jt7.load(p) == load(q)


def test_tensor_roundtrip(tmp_path):
    for dt in (np.float32, np.float64):
        x = np.random.RandomState(0).randn(3, 4, 5).astype(dt)
        got = rt(x, tmp_path)
        assert got.dtype == dt and np.array_equal(got, x)
        assert np.array_equal(jt7.load(str(tmp_path / "x.t7")), x)


def test_shared_reference_preserved(tmp_path):
    x = np.ones((2, 2), np.float32)
    table = {"w1": x, "w2": x}
    got = rt(table, tmp_path)
    assert got["w1"] is got["w2"]  # heap index memoization


def test_strided_tensor_read(tmp_path):
    """A transposed (non-contiguous) tensor written with explicit strides
    comes back element-correct, as the reference reads it."""
    p = str(tmp_path / "st.t7")
    data = np.arange(6, dtype=np.float64)
    with open(p, "wb") as f:
        f.write(struct.pack("<i", 4) + struct.pack("<i", 1))
        f.write(struct.pack("<i", 3) + b"V 1")
        f.write(struct.pack("<i", 18) + b"torch.DoubleTensor")
        f.write(struct.pack("<i", 2) + struct.pack("<qq", 3, 2)
                + struct.pack("<qq", 1, 3))  # transposed strides
        f.write(struct.pack("<q", 1))
        f.write(struct.pack("<i", 4) + struct.pack("<i", 2))
        f.write(struct.pack("<i", 3) + b"V 1")
        f.write(struct.pack("<i", 19) + b"torch.DoubleStorage")
        f.write(struct.pack("<q", 6) + data.tobytes())
    got = load(p)
    assert np.array_equal(got, data.reshape(2, 3).T)
    assert np.array_equal(got, jt7.load(p))


def test_legacy_no_version_string(tmp_path):
    """Pre-'V 1' files carry the class name where the version goes."""
    p = str(tmp_path / "legacy.t7")
    with open(p, "wb") as f:
        f.write(struct.pack("<i", 4) + struct.pack("<i", 1))
        f.write(struct.pack("<i", 18) + b"torch.FloatStorage")
        f.write(struct.pack("<q", 2) + np.array([1, 2], np.float32).tobytes())
    assert np.array_equal(load(p), np.array([1, 2], np.float32))


def test_unknown_module_kept_as_torch_object(tmp_path):
    obj = TorchObject("nn.FancyCustom", {"gain": 2.0})
    got = rt(obj, tmp_path)
    assert isinstance(got, TorchObject)
    assert got.class_name == "nn.FancyCustom" and got["gain"] == 2.0


# --------------------------------------------------------------------- #
# models                                                                #
# --------------------------------------------------------------------- #
def _lenet_like(n):
    return n.Sequential(
        n.SpatialConvolution(1, 6, 5, 5), n.Tanh(),
        n.SpatialMaxPooling(2, 2, 2, 2),
        n.Reshape((6 * 12 * 12,)), n.Linear(6 * 12 * 12, 10),
        n.LogSoftMax())


def test_model_roundtrip_forward_equal(tmp_path):
    """Byte-identical files; the port reads its own and the reference's
    file to the source's parameters bitwise, the reference reads the
    port's; forwards within 1e-5 of the reference's source model."""
    ref, port = _both(_lenet_like, seed=3)
    got, ref_got = _roundtrip(ref, port, tmp_path, "m.t7")
    _assert_params_equal(ref.params, got.params)
    _assert_params_equal(ref.params, load_model(
        str(tmp_path / "ref_m.t7"), device="cpu").params)
    x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
    _same_forward(ref, got, x)
    _same_forward(ref_got, got, x)


def test_model_roundtrip_batchnorm_buffers(tmp_path):
    ref, port = _both(lambda n: n.SpatialBatchNormalization(4), seed=1)
    mean = np.arange(4, dtype=np.float32)
    var = 1.0 + np.arange(4, dtype=np.float32)
    ref.buffers = {"running_mean": mean, "running_var": var}
    port.buffers = {"running_mean": torch.from_numpy(mean.copy()),
                    "running_var": torch.from_numpy(var.copy())}
    got, ref_got = _roundtrip(ref, port, tmp_path, "bn.t7")
    assert isinstance(got, tnn.SpatialBatchNormalization)
    for name, want in (("running_mean", mean), ("running_var", var)):
        np.testing.assert_array_equal(got.buffers[name].numpy(), want)
        np.testing.assert_array_equal(np.asarray(ref_got.buffers[name]), want)
    _assert_params_equal(ref.params, got.params)


def test_conv_mm_2d_weight_import(tmp_path):
    """SpatialConvolutionMM's (out, in*kh*kw) weight becomes the 4-D
    layout, as the reference reshapes it."""
    w2 = np.random.RandomState(1).randn(8, 3 * 5 * 5).astype(np.float32)
    b = np.zeros(8, np.float32)
    obj = TorchObject("nn.SpatialConvolutionMM", {
        "nInputPlane": 3.0, "nOutputPlane": 8.0, "kW": 5.0, "kH": 5.0,
        "dW": 1.0, "dH": 1.0, "padW": 0.0, "padH": 0.0,
        "weight": w2, "bias": b})
    m = t7.module_from_torch(obj, device="cpu")
    ref = jt7.module_from_torch(jt7.TorchObject(obj.class_name, obj.elements))
    assert isinstance(m, tnn.SpatialConvolution)
    assert tuple(m.params["weight"].shape) == (8, 3, 5, 5)
    np.testing.assert_array_equal(m.params["weight"].numpy().reshape(8, -1), w2)
    _assert_params_equal(ref.params, m.params)


@pytest.mark.skipif(not _REF_T7, reason="reference .t7 fixtures not present")
def test_reads_real_torch7_files():
    """Read-only oracle: .t7 files produced by Torch7 itself, read by
    both packages to the same arrays."""
    for path in _REF_T7[:6]:
        obj, ref = load(path), jt7.load(path)

        def collect(o, out):
            if isinstance(o, np.ndarray):
                out.append(o)
            elif isinstance(o, dict):
                for v in o.values():
                    collect(v, out)
            elif isinstance(o, (TorchObject, jt7.TorchObject)):
                for v in o.elements.values():
                    collect(v, out)
            return out
        got, want = collect(obj, []), collect(ref, [])
        assert got and len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_grouped_conv_roundtrip(tmp_path):
    """A grouped conv exports as the Concat{Narrow, conv} decomposition;
    the re-import is forward-equivalent."""
    ref, port = _both(lambda n: n.SpatialConvolution(4, 6, 3, 3, n_group=2),
                      seed=3)
    got, _ = _roundtrip(ref, port, tmp_path, "gconv.t7")
    assert isinstance(got, tnn.Concat) and len(got.modules) == 2
    x = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
    _same_forward(ref, got, x)


def test_grouped_conv_import_with_ngroup_field(tmp_path):
    ref, _ = _both(lambda n: n.SpatialConvolution(4, 6, 3, 3, n_group=2),
                   seed=3)
    obj = TorchObject("nn.SpatialConvolutionMM", {
        "nInputPlane": 4.0, "nOutputPlane": 6.0, "kW": 3.0, "kH": 3.0,
        "dW": 1.0, "dH": 1.0, "padW": 0.0, "padH": 0.0, "nGroup": 2.0,
        "weight": np.asarray(ref.params["weight"], np.float32).reshape(6, -1),
        "bias": np.asarray(ref.params["bias"], np.float32)})
    got = t7.module_from_torch(obj, device="cpu")
    assert isinstance(got, tnn.SpatialConvolution) and got.n_group == 2
    x = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
    _same_forward(ref, got, x)


def test_depth_concat_roundtrip(tmp_path):
    def make(n):
        return n.DepthConcat(n.SpatialConvolution(3, 2, 1, 1),
                             n.SpatialConvolution(3, 2, 3, 3))
    ref, port = _both(make, seed=2)
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    got, ref_got = _roundtrip(ref, port, tmp_path, "dc.t7")
    assert isinstance(got, tnn.DepthConcat)
    out = got.forward(x).numpy()
    assert out.shape == (2, 4, 8, 8)
    np.testing.assert_array_equal(out[:, 2:, 0, :], 0.0)
    _same_forward(ref, got, x)
    _same_forward(ref_got, got, x)


def test_conv_map_roundtrip(tmp_path):
    conn = jnn.SpatialConvolutionMap.random(4, 3, 2, seed=7)
    ref, port = _both(lambda n: n.SpatialConvolutionMap(conn, 3, 3), seed=5)
    got, _ = _roundtrip(ref, port, tmp_path, "convmap.t7")
    assert isinstance(got, tnn.SpatialConvolutionMap)
    x = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
    _same_forward(ref, got, x)


@pytest.mark.parametrize("name,make", [
    ("full", lambda n: n.SpatialFullConvolution(4, 2, 3, 3, 2, 2, 1, 1)),
    ("dilated", lambda n: n.SpatialDilatedConvolution(
        4, 2, 3, 3, dilation_w=2, dilation_h=2)),
])
def test_full_and_dilated_conv_roundtrip(tmp_path, name, make):
    ref, port = _both(make, seed=2)
    got, _ = _roundtrip(ref, port, tmp_path, f"{name}.t7")
    assert type(got) is type(port)
    x = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
    _same_forward(ref, got, x)


_VEC = np.random.RandomState(0).randn(2, 6).astype(np.float32)


@pytest.mark.parametrize("name,make,x", [
    ("lookup", lambda n: n.LookupTable(10, 4),
     np.array([[1, 3], [9, 2]], np.float32)),
    ("prelu", lambda n: n.PReLU(6), _VEC),
    ("mul", lambda n: n.Mul(), _VEC),
    ("add", lambda n: n.Add(6), _VEC),
    ("cmul", lambda n: n.CMul((1, 6)), _VEC),
    ("cadd", lambda n: n.CAdd((1, 6)), _VEC),
    ("euclidean", lambda n: n.Euclidean(6, 3), _VEC),
])
def test_parameterized_layer_roundtrips(tmp_path, name, make, x):
    ref, port = _both(make, seed=1)
    got, _ = _roundtrip(ref, port, tmp_path, f"{name}.t7")
    assert type(got) is type(port)
    _assert_params_equal(ref.params, got.params)
    _same_forward(ref, got, x)


_PARAMLESS = {
    "tanh": lambda n: n.Tanh(), "sigmoid": lambda n: n.Sigmoid(),
    "softmax": lambda n: n.SoftMax(), "softmin": lambda n: n.SoftMin(),
    "logsoftmax": lambda n: n.LogSoftMax(),
    "logsigmoid": lambda n: n.LogSigmoid(), "softsign": lambda n: n.SoftSign(),
    "abs": lambda n: n.Abs(), "exp": lambda n: n.Exp(),
    "square": lambda n: n.Square(), "tanhshrink": lambda n: n.TanhShrink(),
    "identity": lambda n: n.Identity(), "leakyrelu": lambda n: n.LeakyReLU(0.2),
    "elu": lambda n: n.ELU(0.7), "softplus": lambda n: n.SoftPlus(2.0),
    "hardtanh": lambda n: n.HardTanh(-0.5, 0.5),
    "clamp": lambda n: n.Clamp(-0.3, 0.3),
    "power": lambda n: n.Power(2.0, 1.5, 0.5),
    "mulconstant": lambda n: n.MulConstant(3.0),
    "addconstant": lambda n: n.AddConstant(1.0), "mean": lambda n: n.Mean(2),
    "sum": lambda n: n.Sum(2), "max": lambda n: n.Max(2),
    "min": lambda n: n.Min(2), "select": lambda n: n.Select(2, 3),
    "narrow": lambda n: n.Narrow(2, 2, 3), "replicate": lambda n: n.Replicate(3),
    "squeeze": lambda n: n.Squeeze(), "unsqueeze": lambda n: n.Unsqueeze(2),
    "normalize": lambda n: n.Normalize(2.0),
    "transpose": lambda n: n.Transpose([(1, 2)]),
}


def test_parameterless_layer_roundtrips(tmp_path):
    """The reflection-fallback set: every parameter-free layer the
    reference loads by class name (TorchFile.scala:163-177); Clamp comes
    back as its torch identity, nn.HardTanh.  Files byte-identical."""
    vec = 0.25 * _VEC
    for name, make in _PARAMLESS.items():
        ref, port = _both(make)
        got, _ = _roundtrip(ref, port, tmp_path, f"{name}.t7")
        assert isinstance(port, type(got)), name
        _same_forward(ref, got, vec, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,make", [
    ("caddtable", lambda n: n.CAddTable()), ("csubtable", lambda n: n.CSubTable()),
    ("cmultable", lambda n: n.CMulTable()), ("cdivtable", lambda n: n.CDivTable()),
    ("cmaxtable", lambda n: n.CMaxTable()), ("cmintable", lambda n: n.CMinTable()),
    ("jointable", lambda n: n.JoinTable(2)),
    ("flattentable", lambda n: n.FlattenTable()),
])
def test_table_layer_roundtrips(tmp_path, name, make):
    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    b = np.random.RandomState(1).randn(2, 3).astype(np.float32) + 3.0
    ref, port = _both(make)
    got, _ = _roundtrip(ref, port, tmp_path, f"{name}.t7")
    assert type(got) is type(port)
    want = _ref_out(ref.forward([a, b]))
    have = _port_out(got.forward(T(a, b)))
    for x, y in zip(want, have):
        np.testing.assert_allclose(y, x, rtol=1e-6)


def test_container_roundtrips(tmp_path):
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)

    def seq(n):
        m = n.Sequential()
        m.add(n.ConcatTable().add(n.Linear(4, 3)).add(n.Linear(4, 3)))
        return m.add(n.CAddTable())
    ref, port = _both(seq, seed=9)
    got, _ = _roundtrip(ref, port, tmp_path, "ct.t7")
    _assert_params_equal(ref.params, got.params)
    _same_forward(ref, got, x)

    ref, port = _both(lambda n: n.ParallelTable(n.Linear(4, 2), n.Tanh()),
                      seed=4)
    got, _ = _roundtrip(ref, port, tmp_path, "pt.t7")
    want = _ref_out(ref.forward([x, x]))
    have = _port_out(got.forward(T(x, x)))
    for a, b in zip(want, have):
        np.testing.assert_allclose(b, a, **FWD)


@pytest.mark.parametrize("name,make", [
    ("lrn", lambda n: n.SpatialCrossMapLRN(3, 0.5, 0.7, 1.2)),
    ("avgpool", lambda n: n.SpatialAveragePooling(2, 2, 2, 2)),
    ("zeropad", lambda n: n.SpatialZeroPadding(1, 2, 1, 0)),
])
def test_lrn_and_avgpool_roundtrip(tmp_path, name, make):
    x = np.abs(np.random.RandomState(0).randn(2, 4, 6, 6)).astype(np.float32)
    ref, port = _both(make)
    got, _ = _roundtrip(ref, port, tmp_path, f"{name}.t7")
    assert type(got) is type(port)
    _same_forward(ref, got, x)


def test_reader_rejects_corrupt_bytes(tmp_path):
    """Truncated or corrupted .t7 streams raise, never hang or return
    garbage silently; the port refuses exactly the variants the
    reference refuses."""
    from tests.conftest import corrupt_variants

    errors = (ValueError, NotImplementedError, KeyError, EOFError,
              MemoryError, OverflowError, TypeError, AttributeError,
              IndexError, RuntimeError, struct.error)
    base = str(tmp_path / "good.t7")
    save_model(tnn.Linear(4, 3).build(seed=1, device="cpu"), base)
    good = open(base, "rb").read()
    failures = 0
    for trial, data in corrupt_variants(good, 40):
        p = str(tmp_path / f"bad{trial}.t7")
        open(p, "wb").write(data)
        outcomes = []
        for read in (lambda: load_model(p, device="cpu"),
                     lambda: jt7.load_model(p)):
            try:
                read()
                outcomes.append(True)
            except errors:
                outcomes.append(False)
        assert outcomes[0] == outcomes[1], trial
        failures += not outcomes[0]
    assert failures >= 10


def test_module_save_torch_and_load_torch(tmp_path):
    """``Module.save_torch`` / ``Module.load_torch(path, device=)`` are
    the entry points; the file is the reference's ``save_torch``'s."""
    ref, port = _both(_lenet_like, seed=5)
    p, q = str(tmp_path / "p.t7"), str(tmp_path / "q.t7")
    assert port.save_torch(p) is port
    ref.save_torch(q)
    assert open(p, "rb").read() == open(q, "rb").read()
    with pytest.raises(FileExistsError):
        port.save_torch(p)
    got = tnn.Module.load_torch(p, device="cpu")
    assert got.device == torch.device("cpu")
    _assert_params_equal(ref.params, got.params)
