"""bigdl_tpu_torch's PyTorch state-dict import/export and Caffe loader
against the JAX package on the CPU (mirrors
``tests/test_model_import_oracle.py`` and ``tests/test_caffe_loader.py``).

Torch twins of the model factories are built layer for layer from a
torch seed; their state dict goes through the port's loaders and the
reference's.  Tolerances:

- imported parameters and buffers: bitwise equal to the reference's
  import of the same file (and to the source values);
- whole-net log-probs: rtol/atol 1e-3 against the torch twin (the
  reference's own whole-net tolerance), top-1 equal; against the
  reference's import of the same weights, rtol/atol 1e-4;
- exported state dicts: the reference's keys, in the reference's order,
  values bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.alexnet import AlexNet as JAlexNet
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.utils import caffe_loader as jcaffe
from bigdl_tpu.utils import torch_import as jti

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import AlexNet, ResNet
from bigdl_tpu_torch.utils import pytree
from bigdl_tpu_torch.utils.caffe_loader import (load, parse_caffemodel,
                                                parse_prototxt)
from bigdl_tpu_torch.utils.torch_import import (chunked_device_array,
                                                export_torch_state_dict,
                                                group_state_dict,
                                                load_torch_state_dict)
from test_caffe_loader import _blob, _layer_v1, _layer_v2, _len_field
from test_model_import_oracle import (_torch_alexnet, _torch_inception_v1,
                                      _torch_resnet)

TOL = dict(rtol=1e-3, atol=1e-3)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
_REF_DIR = "/root/reference/spark/dl/src/test/resources/caffe"


def _predict(model, x_np):
    with torch.no_grad():
        y, _ = model.apply(model.params, torch.from_numpy(x_np),
                           buffers=model.buffers, training=False)
    return y.numpy()


def _predict_ref(model, x_np):
    y, _ = model.apply(model.params, jnp.asarray(x_np),
                       buffers=model.buffers, training=False)
    return np.asarray(y)


def _assert_trees_equal(ref_tree, port_tree):
    ref = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_tree)]
    port = [a.detach().numpy() for a in pytree.tree_leaves(port_tree)]
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)


def _parity(port, ref, x, want, x_ref=None):
    """The port's and the reference's imports agree bitwise in params and
    buffers; both predict the twin's log-probs."""
    _assert_trees_equal(ref.params, port.params)
    _assert_trees_equal(ref.buffers, port.buffers)
    ours = _predict(port, x)
    np.testing.assert_allclose(ours, want, **TOL)
    assert (ours.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(
        ours, _predict_ref(ref, x if x_ref is None else x_ref), **REF_TOL)


# --------------------------------------------------------------------- #
# AlexNet (the two-group Caffe variant)                                 #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def alexnet_pair():
    torch.manual_seed(7)
    twin = _torch_alexnet(10).eval()
    x = np.random.RandomState(3).randn(2, 3, 227, 227).astype(np.float32) * 0.1
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    ref = JAlexNet(10).build(0)
    jti.load_torch_state_dict(ref, twin.state_dict())
    return twin, x, want, ref


def test_alexnet_state_dict_import_parity(alexnet_pair):
    twin, x, want, ref = alexnet_pair
    port = AlexNet(10).build(0, device="cpu")
    assert load_torch_state_dict(port, twin.state_dict()) is port
    _parity(port, ref, x, want)


def test_alexnet_checkpoint_file_import(alexnet_pair, tmp_path):
    twin, x, want, ref = alexnet_pair
    path = tmp_path / "alexnet.pth"
    torch.save({"state_dict": twin.state_dict()}, path)
    port = AlexNet(10).build(1, device="cpu")
    port.load_pytorch(str(path))
    _parity(port, ref, x, want)


def _alexnet_caffemodel(twin, tmp_path):
    sd = twin.state_dict()
    layers = b""
    names = ["conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"]
    prefixes = ["0", "4", "8", "10", "12", "16", "19", "22"]
    for name, pre in zip(names, prefixes):
        w = sd[f"{pre}.weight"].numpy()
        b = sd[f"{pre}.bias"].numpy()
        kind = "InnerProduct" if name.startswith("fc") else "Convolution"
        layers += _layer_v2(name, kind, [_blob(w.shape, w.ravel()),
                                         _blob(b.shape, b.ravel())])
    model_path = tmp_path / "alexnet.caffemodel"
    model_path.write_bytes(layers)
    def_path = tmp_path / "deploy.prototxt"
    def_path.write_text('name: "alexnet"\n')
    return str(def_path), str(model_path)


def test_alexnet_caffe_import_parity(alexnet_pair, tmp_path):
    """A caffemodel carrying the twin's weights loads through both
    packages' CaffeLoader to the same tensors and predictions."""
    twin, x, want, _ = alexnet_pair
    dp, mp = _alexnet_caffemodel(twin, tmp_path)
    port = AlexNet(10).build(2, device="cpu")
    port.load_caffe(dp, mp, match_all=False)
    ref = JAlexNet(10).build(2)
    ref.load_caffe(dp, mp, match_all=False)
    _parity(port, ref, x, want)


# --------------------------------------------------------------------- #
# ResNet                                                                #
# --------------------------------------------------------------------- #
def _resnet_parity(depth, data_format="NCHW"):
    torch.manual_seed(depth)
    twin = _torch_resnet(depth, 10)
    twin.train()  # warm the BN statistics: the buffer import is load-bearing
    with torch.no_grad():
        for i in range(2):
            twin(torch.from_numpy(np.random.RandomState(20 + i).randn(
                4, 3, 224, 224).astype(np.float32)))
    twin.eval()
    kw = dict(class_num=10, depth=depth, shortcut_type="B",
              dataset="imagenet", data_format=data_format)
    port = ResNet(**kw).build(0, device="cpu")
    load_torch_state_dict(port, twin.state_dict())
    ref = JResNet(**kw).build(0)
    jti.load_torch_state_dict(ref, twin.state_dict())
    x = np.random.RandomState(9).randn(2, 3, 224, 224).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    xin = x if data_format == "NCHW" else x.transpose(0, 2, 3, 1)
    _parity(port, ref, xin, want)


def test_resnet18_state_dict_import_parity():
    _resnet_parity(18)


@pytest.mark.slow
def test_resnet50_state_dict_import_parity():
    _resnet_parity(50)


def test_resnet18_nhwc_import_same_checkpoint():
    """The NHWC variant keeps the same tree: the same checkpoint imports
    into it and predicts the twin's log-probs from NHWC input."""
    _resnet_parity(18, "NHWC")


@pytest.mark.slow
def test_inception_v1_state_dict_import_parity():
    from bigdl_tpu.models.inception import Inception_v1 as JInception
    from bigdl_tpu_torch.models import Inception_v1
    torch.manual_seed(15)
    twin = _torch_inception_v1(10).eval()
    port = Inception_v1(10).build(0, device="cpu")
    load_torch_state_dict(port, twin.state_dict())
    ref = JInception(10).build(0)
    jti.load_torch_state_dict(ref, twin.state_dict())
    x = np.random.RandomState(4).randn(2, 3, 224, 224).astype(np.float32) * 0.1
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    _parity(port, ref, x, want)


def test_lenet5_state_dict_import_parity():
    from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
    from bigdl_tpu_torch.models import LeNet5
    torch.manual_seed(22)
    twin = torch.nn.Sequential(
        torch.nn.Conv2d(1, 6, 5), torch.nn.Tanh(), torch.nn.MaxPool2d(2, 2),
        torch.nn.Conv2d(6, 12, 5), torch.nn.Tanh(), torch.nn.MaxPool2d(2, 2),
        torch.nn.Flatten(), torch.nn.Linear(12 * 4 * 4, 100), torch.nn.Tanh(),
        torch.nn.Linear(100, 10), torch.nn.LogSoftmax(dim=-1)).eval()
    port = LeNet5(10).build(0, device="cpu")
    load_torch_state_dict(port, twin.state_dict())
    ref = JLeNet5(10).build(0)
    jti.load_torch_state_dict(ref, twin.state_dict())
    x = np.random.RandomState(1).randn(4, 1, 28, 28).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    _parity(port, ref, x.reshape(4, -1), want)


def test_vgg_cifar_state_dict_import_parity():
    from bigdl_tpu.models.vgg import VggForCifar10 as JVgg
    from bigdl_tpu_torch.models import VggForCifar10
    torch.manual_seed(23)
    cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
           (128, 256), (256, 256), (256, 256), "M",
           (256, 512), (512, 512), (512, 512), "M",
           (512, 512), (512, 512), (512, 512), "M"]
    mods = []
    for item in cfg:
        if item == "M":
            mods.append(torch.nn.MaxPool2d(2, 2, ceil_mode=True))
        else:
            mods += [torch.nn.Conv2d(*item, 3, padding=1),
                     torch.nn.BatchNorm2d(item[1], eps=1e-3), torch.nn.ReLU()]
    mods += [torch.nn.Flatten(), torch.nn.Dropout(0.5),
             torch.nn.Linear(512, 512), torch.nn.BatchNorm1d(512),
             torch.nn.ReLU(), torch.nn.Dropout(0.5),
             torch.nn.Linear(512, 10), torch.nn.LogSoftmax(dim=-1)]
    twin = torch.nn.Sequential(*mods)
    twin.train()
    with torch.no_grad():
        for i in range(2):
            twin(torch.from_numpy(np.random.RandomState(30 + i).randn(
                8, 3, 32, 32).astype(np.float32)))
    twin.eval()
    port = VggForCifar10(10).build(0, device="cpu")
    load_torch_state_dict(port, twin.state_dict())
    ref = JVgg(10).build(0)
    jti.load_torch_state_dict(ref, twin.state_dict())
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    _parity(port, ref, x, want)


# --------------------------------------------------------------------- #
# importer contract                                                     #
# --------------------------------------------------------------------- #
def test_group_state_dict_orders_and_groups():
    sd = {"a.weight": np.ones(2), "a.bias": np.zeros(2),
          "b.bn.running_mean": np.zeros(3), "b.bn.weight": np.ones(3),
          "b.bn.num_batches_tracked": np.array(5),
          "c.weight": torch.ones(2, dtype=torch.bfloat16)}
    groups = group_state_dict(sd)
    ref = jti.group_state_dict(sd)
    assert [g[0] for g in groups] == [g[0] for g in ref] == ["a", "b.bn", "c"]
    for (_, a), (_, b) in zip(groups, ref):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert groups[2][1]["weight"].dtype == np.float32  # bf16 widened


def test_count_mismatch_raises():
    model = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2)).build(
        0, device="cpu")
    sd = {"0.weight": np.zeros((4, 3), np.float32)}
    with pytest.raises(ValueError, match="count mismatch"):
        load_torch_state_dict(model, sd)


def test_shape_mismatch_raises_and_writes_nothing():
    model = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2)).build(
        0, device="cpu")
    before = [a.clone() for a in pytree.tree_leaves(model.params)]
    sd = {"a.weight": np.ones((4, 3), np.float32),
          "a.bias": np.ones(4, np.float32),
          "b.weight": np.zeros((5, 4), np.float32),
          "b.bias": np.zeros(5, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_torch_state_dict(model, sd)
    for a, b in zip(before, pytree.tree_leaves(model.params)):
        assert torch.equal(a, b)


def _small_net(n):
    return n.Sequential(
        n.SpatialConvolution(1, 4, 3, 3), n.ReLU(),
        n.SpatialBatchNormalization(4), n.View(4 * 6 * 6),
        n.Linear(4 * 6 * 6, 5), n.LogSoftMax())


def test_export_state_dict_roundtrip_to_torch():
    """Export equals the reference's in keys, order and values, and
    loads into the torch twin, which reproduces the port's predictions
    (1e-4 / 1e-5, the reference's tolerance)."""
    port = _small_net(nn).build(3, device="cpu")
    ref = _small_net(jnn).build(3)
    sd = export_torch_state_dict(port)
    ref_sd = jti.export_torch_state_dict(ref)
    assert list(sd) == list(ref_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(ref_sd[k]))
    twin = torch.nn.Sequential(
        torch.nn.Conv2d(1, 4, 3), torch.nn.ReLU(), torch.nn.BatchNorm2d(4),
        torch.nn.Flatten(), torch.nn.Linear(4 * 6 * 6, 5),
        torch.nn.LogSoftmax(dim=-1))
    twin_keys = [k for k in twin.state_dict() if "num_batches" not in k]
    assert len(twin_keys) == len(sd)
    twin.load_state_dict({tk: torch.from_numpy(v.copy())
                          for tk, v in zip(twin_keys, sd.values())},
                         strict=False)
    twin.eval()
    x = np.random.RandomState(2).randn(3, 1, 8, 8).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_predict(port, x), want, rtol=1e-4, atol=1e-5)


def test_export_roundtrip_nested_leaf_params():
    """Scale's nested {cmul, cadd} groups: export and the positional
    loader agree on the grouping; the reference loads the port's
    export bitwise."""
    m1 = nn.Sequential(nn.Linear(3, 4), nn.Scale((4,))).build(
        0, device="cpu")
    sd = export_torch_state_dict(m1)
    assert "1.cmul.weight" in sd and "1.cadd.bias" in sd
    m2 = nn.Sequential(nn.Linear(3, 4), nn.Scale((4,))).build(
        9, device="cpu")
    load_torch_state_dict(m2, sd)
    ref = jnn.Sequential(jnn.Linear(3, 4), jnn.Scale((4,))).build(9)
    jti.load_torch_state_dict(ref, sd)
    _assert_trees_equal(ref.params, m2.params)
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    np.testing.assert_array_equal(_predict(m1, x), _predict(m2, x))


def test_export_key_order_survives_tree_map():
    """A tree walk rebuilds dicts with sorted keys (bias before weight);
    export emits definition order regardless."""
    model = nn.Sequential(nn.Linear(3, 4)).build(0, device="cpu")
    model.params = pytree.tree_map(lambda w: w * 1.0, model.params)
    assert list(model.params["0"]) == ["bias", "weight"]  # the hazard
    assert list(export_torch_state_dict(model)) == ["0.weight", "0.bias"]


def test_export_unbuilt_model_raises():
    with pytest.raises(ValueError, match="no params to export"):
        export_torch_state_dict(nn.Sequential(nn.Linear(3, 4)))


def test_non_strict_partial_import():
    model = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2)).build(
        0, device="cpu")
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    sd = {"fc1.weight": w, "fc1.bias": np.zeros(4, np.float32)}
    load_torch_state_dict(model, sd, strict=False)
    np.testing.assert_array_equal(model.params["0"]["weight"].numpy(), w)


def _random_tail(n, r, dim, depth):
    mods = []
    for _ in range(r.randint(1, 4)):
        kind = r.randint(0, 4)
        if kind == 0:
            out = int(r.randint(2, 7))
            mods.append(n.Linear(dim, out))
            dim = out
        elif kind == 1:
            mods.append(n.Tanh())
        elif kind == 2:
            mods.append(n.BatchNormalization(dim))
        elif kind == 3 and depth > 0:
            branch1, d1 = _random_tail(n, r, dim, depth - 1)
            mods.append(n.Sequential(
                n.ConcatTable(n.Sequential(*branch1), n.Linear(dim, d1)),
                n.JoinTable(2)))
            dim = 2 * d1
    return mods, dim


@pytest.mark.parametrize("seed", range(6))
def test_export_import_roundtrip_random_compositions(seed):
    """Randomly nested containers round-trip export -> load with
    bit-exact predictions, and the export is the reference's (keys,
    order, values)."""
    def make(n, build_seed, **kw):
        mods, _ = _random_tail(n, np.random.RandomState(100 + seed), 5, 2)
        return n.Sequential(*mods).build(build_seed, **kw)
    model = make(nn, seed, device="cpu")
    sd = export_torch_state_dict(model)
    ref_sd = jti.export_torch_state_dict(make(jnn, seed))
    assert list(sd) == list(ref_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(ref_sd[k]))
    clone = make(nn, seed + 999, device="cpu")
    load_torch_state_dict(clone, sd)
    x = np.random.RandomState(7).randn(3, 5).astype(np.float32)
    np.testing.assert_array_equal(_predict(model, x), _predict(clone, x))


def test_chunked_device_array_slicing():
    """The <=limit leading-axis slicing fills one preallocated tensor
    exactly (``force`` takes the chunk path on the CPU); ``out=`` writes
    into an existing tensor in its dtype."""
    a = np.arange(7 * 5, dtype=np.float32).reshape(7, 5)
    out = chunked_device_array(a, limit_bytes=2 * 5 * 4, force=True,
                               device="cpu")
    np.testing.assert_array_equal(out.numpy(), a)
    np.testing.assert_array_equal(
        chunked_device_array(a, device="cpu").numpy(), a)
    assert float(chunked_device_array(np.float32(3.0), device="cpu")) == 3.0
    into = torch.zeros((7, 5), dtype=torch.bfloat16)
    got = chunked_device_array(a, limit_bytes=40, force=True, out=into)
    assert got is into
    assert torch.equal(into, torch.from_numpy(a).to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        chunked_device_array(a, out=torch.zeros(5, 7))


# --------------------------------------------------------------------- #
# recurrent import                                                      #
# --------------------------------------------------------------------- #
def test_recurrent_lstm_import_parity():
    torch.manual_seed(31)

    class Twin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = torch.nn.LSTM(5, 7, batch_first=True)
            self.fc = torch.nn.Linear(7, 3)

        def forward(self, x):
            y, _ = self.lstm(x)
            return torch.log_softmax(self.fc(y[:, -1]), dim=-1)

    twin = Twin().eval()

    def make(n):
        return n.Sequential(n.Recurrent(n.LSTM(5, 7)), n.Select(2, -1),
                            n.Linear(7, 3), n.LogSoftMax())
    port = make(nn).build(0, device="cpu")
    load_torch_state_dict(port, twin.state_dict())
    ref = make(jnn).build(0)
    jti.load_torch_state_dict(ref, twin.state_dict())
    x = np.random.RandomState(3).randn(4, 6, 5).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    _parity(port, ref, x, want)


def test_recurrent_gru_import_parity_and_nonzero_bias_hh_rejected():
    torch.manual_seed(32)
    layer = torch.nn.GRU(4, 6, batch_first=True)
    with torch.no_grad():
        layer.bias_hh_l0[2 * 6:].zero_()  # representable case
    model = nn.Sequential(nn.Recurrent(nn.GRU(4, 6))).build(0, device="cpu")
    load_torch_state_dict(model, dict(layer.state_dict()))
    x = np.random.RandomState(5).randn(2, 5, 4).astype(np.float32)
    with torch.no_grad():
        want, _ = layer(torch.from_numpy(x))
    np.testing.assert_allclose(_predict(model, x), want.numpy(),
                               rtol=1e-4, atol=1e-5)
    torch.manual_seed(33)
    bad = torch.nn.GRU(4, 6, batch_first=True)
    m2 = nn.Sequential(nn.Recurrent(nn.GRU(4, 6))).build(0, device="cpu")
    with pytest.raises(ValueError, match="reset"):
        load_torch_state_dict(m2, dict(bad.state_dict()))


def test_recurrent_lstm_biasfree_import():
    """bias=False checkpoints map to an exact ZERO fused bias."""
    torch.manual_seed(34)
    layer = torch.nn.LSTM(5, 7, batch_first=True, bias=False)
    model = nn.Sequential(nn.Recurrent(nn.LSTM(5, 7))).build(0, device="cpu")
    load_torch_state_dict(model, dict(layer.state_dict()))
    assert not model.params["0"]["cell"]["bias"].any()
    x = np.random.RandomState(6).randn(2, 5, 5).astype(np.float32)
    with torch.no_grad():
        want, _ = layer(torch.from_numpy(x))
    np.testing.assert_allclose(_predict(model, x), want.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_recurrent_multilayer_clear_error():
    torch.manual_seed(35)
    layer = torch.nn.GRU(4, 6, num_layers=2, batch_first=True)
    model = nn.Sequential(nn.Recurrent(nn.GRU(4, 6))).build(0, device="cpu")
    with pytest.raises(ValueError, match="layer-by-layer"):
        load_torch_state_dict(model, dict(layer.state_dict()), strict=False)


def test_save_pytorch_roundtrip(tmp_path):
    """``save_pytorch`` writes a torch.load-able state dict holding the
    reference's tensors (its ``save_pytorch`` of the same tree), which
    round-trips through ``load_pytorch``, and which the reference
    loads."""
    def make(n):
        return n.Sequential(n.Linear(4, 6), n.Tanh(), n.Linear(6, 2))
    port = make(nn).build(5, device="cpu")
    p, q = tmp_path / "port.pth", tmp_path / "ref.pth"
    assert port.save_pytorch(str(p)) is port
    make(jnn).build(5).save_pytorch(str(q))
    sd, ref_sd = (torch.load(str(f), weights_only=True) for f in (p, q))
    assert list(sd) == list(ref_sd) == ["0.weight", "0.bias", "2.weight",
                                        "2.bias"]
    for k in sd:
        assert torch.equal(sd[k], ref_sd[k])
    clone = make(nn).build(8, device="cpu")
    clone.load_pytorch(p)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(_predict(port, x), _predict(clone, x))
    ref = make(jnn).build(8)
    ref.load_pytorch(str(p))
    _assert_trees_equal(ref.params, clone.params)


# --------------------------------------------------------------------- #
# Caffe (mirrors tests/test_caffe_loader.py)                            #
# --------------------------------------------------------------------- #
def test_parse_prototxt():
    text = """
      name: "net"  # comment
      input_dim: 1
      input_dim: 3
      layer { name: "conv" type: "Convolution"
              convolution_param { num_output: 4 pad: 0 } }
      layer { name: "ip" type: "InnerProduct" }
    """
    msg = parse_prototxt(text)
    assert msg == jcaffe.parse_prototxt(text)
    assert msg["input_dim"] == [1, 3]
    assert msg["layer"][0]["convolution_param"]["num_output"] == 4


def _same_net(raw):
    net, ref = parse_caffemodel(raw), jcaffe.parse_caffemodel(raw)
    assert net.name == ref.name
    for mine, theirs in ((net.layers_v1, ref.layers_v1),
                         (net.layers_v2, ref.layers_v2)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert (a.name, a.type, a.bottom, a.top) == \
                (b.name, b.type, b.bottom, b.top)
            for x, y in zip(a.blobs, b.blobs):
                assert x.shape == y.shape
                np.testing.assert_array_equal(x.data, y.data)
    return net


def test_parse_synthetic_caffemodel():
    w = np.arange(8, dtype=np.float32)
    raw = (_len_field(1, b"net")
           + _layer_v2("fc", "InnerProduct", [_blob([2, 4], w),
                                              _blob([2], [0.5, -0.5])]))
    layer = _same_net(raw).by_name()["fc"]
    assert layer.type == "InnerProduct" and layer.blobs[0].shape == [2, 4]
    np.testing.assert_array_equal(layer.blobs[0].data, w)


def test_parse_v1_layer_with_legacy_blob_dims():
    w = np.ones(6, np.float32)
    raw = _layer_v1("old", 14, [_blob([1, 1, 2, 3], w, legacy=True)])
    layer = _same_net(raw).by_name()["old"]
    assert layer.type == 14 and layer.blobs[0].shape == [1, 1, 2, 3]


def _write_fixture(tmp_path, raw, proto_text='name: "n"\n'):
    mp, dp = str(tmp_path / "m.caffemodel"), str(tmp_path / "d.prototxt")
    open(mp, "wb").write(raw)
    open(dp, "w").write(proto_text)
    return dp, mp


def test_load_copies_weights(tmp_path):
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    b = np.random.RandomState(1).randn(3).astype(np.float32)
    raw = _layer_v2("fc1", "InnerProduct", [_blob([3, 4], w), _blob([3], b)])
    dp, mp = _write_fixture(tmp_path, raw)
    model = nn.Sequential(nn.Linear(4, 3).set_name("fc1")).build(
        seed=9, device="cpu")
    weight = model.params["0"]["weight"]
    load(model, dp, mp)
    assert model.params["0"]["weight"] is weight  # written in place
    np.testing.assert_array_equal(weight.numpy(), w)
    np.testing.assert_array_equal(model.params["0"]["bias"].numpy(), b)


def test_match_all_raises_on_unmapped(tmp_path):
    dp, mp = _write_fixture(tmp_path, _len_field(1, b"net"))
    model = nn.Sequential(nn.Linear(4, 3).set_name("nope")).build(
        seed=0, device="cpu")
    with pytest.raises(ValueError, match="cannot map"):
        load(model, dp, mp, match_all=True)
    before = model.params["0"]["weight"].clone()
    load(model, dp, mp, match_all=False)
    assert torch.equal(model.params["0"]["weight"], before)


def test_element_count_mismatch_raises(tmp_path):
    raw = _layer_v2("fc1", "InnerProduct",
                    [_blob([2, 2], np.ones(4, np.float32))])
    dp, mp = _write_fixture(tmp_path, raw)
    model = nn.Sequential(nn.Linear(4, 3).set_name("fc1")).build(
        seed=0, device="cpu")
    with pytest.raises(ValueError, match="element number"):
        load(model, dp, mp)


def test_module_load_caffe_method(tmp_path):
    w = np.random.RandomState(2).randn(4, 3, 2, 2).astype(np.float32)
    raw = _layer_v2("conv", "Convolution",
                    [_blob([4, 3, 2, 2], w.ravel()), _blob([4], np.zeros(4))])
    dp, mp = _write_fixture(tmp_path, raw)
    model = nn.Sequential(
        nn.SpatialConvolution(3, 4, 2, 2).set_name("conv")).build(
        seed=5, device="cpu")
    assert model.load_caffe(dp, mp) is model
    np.testing.assert_array_equal(model.params["0"]["weight"].numpy(), w)


@pytest.mark.skipif(not os.path.isdir(_REF_DIR),
                    reason="reference caffe fixtures not present")
def test_reads_real_caffemodel_fixture():
    dp = os.path.join(_REF_DIR, "test.prototxt")
    mp = os.path.join(_REF_DIR, "test.caffemodel")

    def make(n):
        return n.Sequential(
            n.SpatialConvolution(3, 4, 2, 2).set_name("conv"),
            n.SpatialConvolution(4, 3, 2, 2).set_name("conv2"),
            n.Reshape((27,)),
            n.Linear(27, 2, with_bias=False).set_name("ip"))
    model = make(nn).build(seed=1, device="cpu")
    load(model, dp, mp)
    ref = make(jnn).build(seed=1)
    jcaffe.load(ref, dp, mp)
    _assert_trees_equal(ref.params, model.params)
    assert _predict(model, np.ones((1, 3, 5, 5), np.float32)).shape == (1, 2)
