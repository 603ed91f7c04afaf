"""bigdl_tpu_torch's ``ml`` predictors, ``DataSet.image_folder`` and the
two example CLIs against the JAX package on the CPU (mirrors
``tests/test_ml.py`` and ``tests/test_examples.py``).

The same weights (built from one seed in both packages, bitwise equal,
or one file both read) and the same numpy rows go through both
packages: raw outputs within rtol/atol 1e-5, 1-based classes equal; the
CLIs print the reference's Top1/Top5 results exactly and the same
per-image classes.
"""
import os
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ml import DLClassifier as JDLClassifier

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.ml import DLClassifier, DLModel, ModelBroadcast

FWD = dict(rtol=1e-5, atol=1e-5)


def _weights():
    w = np.zeros((3, 4), np.float32)
    w[0, 0] = w[1, 1] = w[2, 2] = 5.0
    return w, np.zeros(3, np.float32)


@pytest.fixture(scope="module")
def trained_linear():
    """A 4->3 classifier whose argmax is feature-block determined."""
    model = nn.Sequential(nn.Linear(4, 3), nn.LogSoftMax()).build(
        seed=1, device="cpu")
    w, b = _weights()
    model.params["0"]["weight"] = torch.from_numpy(w)
    model.params["0"]["bias"] = torch.from_numpy(b)
    return model


@pytest.fixture(scope="module")
def ref_linear():
    model = jnn.Sequential(jnn.Linear(4, 3), jnn.LogSoftMax()).build(seed=1)
    w, b = _weights()
    model.params["0"]["weight"] = w
    model.params["0"]["bias"] = b
    return model


def _feature(cls: int) -> np.ndarray:
    x = np.zeros(4, np.float32)
    x[cls] = 1.0
    return x


class _Frame:
    """The part of a pandas DataFrame ``transform`` reads and writes
    (pandas is not installed here)."""

    def __init__(self, cols):
        self.cols = dict(cols)

    @property
    def columns(self):
        return list(self.cols)

    def __getitem__(self, k):
        return self.cols[k]

    def __setitem__(self, k, v):
        self.cols[k] = v

    def copy(self):
        return _Frame(self.cols)


class TestDLModel:
    def test_predict_shapes(self, trained_linear, ref_linear):
        feats = np.stack([_feature(0), _feature(1), _feature(2)])
        out = DLModel(trained_linear, (2, 4)).predict(feats)
        assert out.shape == (3, 3)
        np.testing.assert_allclose(
            out, JDLClassifier(ref_linear, (2, 4)).predict(feats), **FWD)

    def test_predict_class_one_based(self, trained_linear):
        pred = DLClassifier(trained_linear, (2, 4)).predict_class(
            np.stack([_feature(0), _feature(1), _feature(2)]))
        assert pred.tolist() == [1, 2, 3]

    def test_tail_batch_padding(self, trained_linear, ref_linear):
        feats = np.stack([_feature(i % 3) for i in range(7)])  # 7 % 4 != 0
        m = DLClassifier(trained_linear, (4, 4))
        calls = []
        fwd = m._forward_batch
        m._forward_batch = lambda b: calls.append(b.shape) or fwd(b)
        pred = m.predict_class(feats)
        assert pred.tolist() == [1, 2, 3, 1, 2, 3, 1]
        assert calls == [(4, 4), (4, 4)]  # the tail padded to one shape
        assert pred.tolist() == JDLClassifier(ref_linear, (4, 4)) \
            .predict_class(feats).tolist()

    def test_empty_input(self, trained_linear):
        m = DLClassifier(trained_linear, (2, 4))
        assert m.predict(np.empty((0, 4), np.float32)).shape[0] == 0
        assert m.predict_class(np.empty((0, 4), np.float32)).shape == (0,)

    def test_samples_input(self, trained_linear):
        from bigdl_tpu_torch.dataset.types import Sample
        m = DLClassifier(trained_linear, (2, 4))
        assert m.predict_class([Sample(_feature(2), np.float32(3.0))]) \
            .tolist() == [3]

    def test_reshape_flat_rows(self, trained_linear):
        m = DLClassifier(trained_linear, (2, 4))
        assert m.predict_class([_feature(1).tolist()]).tolist() == [2]


class TestTransform:
    def test_dataframe_transform(self, trained_linear):
        """``transform`` duck-types a DataFrame (pandas is on neither
        machine); the reference's pandas test skips without it."""
        df = _Frame({"features": [_feature(0), _feature(2)]})
        out = DLClassifier(trained_linear, (2, 4)).transform(df)
        assert out["prediction"].tolist() == [1.0, 3.0]
        assert "features" in out.columns and "prediction" not in df.columns


class TestModelBroadcast:
    def test_broadcast_value_predicts(self, trained_linear):
        rebuilt = ModelBroadcast(trained_linear).value()
        m = DLClassifier(rebuilt, (2, 4))
        assert m.predict_class(np.stack([_feature(1)])).tolist() == [2]

    def test_original_model_untouched(self, trained_linear):
        bc = ModelBroadcast(trained_linear)
        assert trained_linear.params is not None
        assert trained_linear.grad_params is not None
        out1 = DLClassifier(trained_linear, (2, 4)).predict(
            np.stack([_feature(0)]))
        out2 = DLClassifier(bc.value(), (2, 4)).predict(np.stack([_feature(0)]))
        np.testing.assert_array_equal(out1, out2)

    def test_structure_shared_weights_not_copied_twice(self, trained_linear):
        bc = ModelBroadcast(trained_linear)
        v1, v2 = bc.value(), bc.value()
        assert v1.params["0"]["weight"] is v2.params["0"]["weight"]
        assert v1.params["0"]["weight"] is trained_linear.params["0"]["weight"]


# --------------------------------------------------------------------- #
# DataSet.image_folder                                                  #
# --------------------------------------------------------------------- #
def test_image_folder_labels_sorted_one_based(tmp_path):
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu_torch.dataset import DataSet
    for cls, names in (("zebra", ["b.png", "a.png"]), ("ant", ["c.png"])):
        (tmp_path / cls).mkdir()
        for n in names:
            (tmp_path / cls / n).write_bytes(b"x")
    (tmp_path / "notes.txt").write_text("not a class")
    ds = DataSet.image_folder(str(tmp_path))
    got = list(ds.data(train=False))
    assert got == list(JDataSet.image_folder(str(tmp_path)).data(train=False))
    assert [(os.path.relpath(p, tmp_path), y) for p, y in got] == [
        ("ant/c.png", 1.0), ("zebra/a.png", 2.0), ("zebra/b.png", 2.0)]
    assert ds.size() == 3
    with pytest.raises(NotImplementedError, match="12-DIST"):
        DataSet.image_folder(str(tmp_path), distributed=True)


# --------------------------------------------------------------------- #
# the example CLIs                                                      #
# --------------------------------------------------------------------- #
def _write_mnist_idx(folder, n=32):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 50, size=(n, 28, 28)).astype(np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    for i in range(n):
        images[i, labels[i] * 2:labels[i] * 2 + 3, :] += 150
    with open(os.path.join(folder, "t10k-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(images.tobytes())
    with open(os.path.join(folder, "t10k-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())


@pytest.fixture(scope="module")
def lenet_file(tmp_path_factory):
    """A LeNet-5 saved by the reference (format 1, read by both)."""
    from bigdl_tpu.models.lenet import LeNet5
    path = str(tmp_path_factory.mktemp("models") / "lenet.bin")
    LeNet5(10).build(seed=1).save(path, overwrite=True)
    return path


def _results(out):
    return sorted(line for line in out.splitlines() if " is " in line)


def _load_model_both(argv, capsys):
    from bigdl_tpu.example.load_model import main as jmain
    from bigdl_tpu_torch.example.load_model import main
    results = main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    jmain(argv)
    ref_out = capsys.readouterr().out
    assert _results(port_out) == _results(ref_out)
    assert "Top1Accuracy" in port_out and "Top5Accuracy" in port_out
    return results


class TestLoadModelExample:
    def test_bigdl_model_on_mnist(self, lenet_file, tmp_path, capsys):
        _write_mnist_idx(str(tmp_path))
        _load_model_both(["--modelType", "bigdl", "--model", lenet_file,
                          "-f", str(tmp_path), "--dataset", "mnist",
                          "-b", "16"], capsys)

    def test_torch_model_roundtrip(self, tmp_path, capsys):
        model = nn.Sequential(nn.Reshape((784,)), nn.Linear(784, 10),
                              nn.LogSoftMax()).build(seed=3, device="cpu")
        t7 = str(tmp_path / "model.t7")
        model.save_torch(t7, overwrite=True)
        _write_mnist_idx(str(tmp_path))
        _load_model_both(["--modelType", "torch", "--model", t7,
                          "-f", str(tmp_path), "--dataset", "mnist",
                          "-b", "16"], capsys)

    def test_caffe_lenet_factory(self, tmp_path, capsys):
        """--modelType caffe copies a caffemodel into the lenet skeleton,
        the reference's result exactly."""
        from test_caffe_loader import _blob, _layer_v2
        from bigdl_tpu.models.lenet import LeNet5
        src = LeNet5(10).build(seed=4)
        raw = b""
        for name, leaf in _named_leaves(src):
            w, b = (np.asarray(leaf["weight"]), np.asarray(leaf["bias"]))
            raw += _layer_v2(name, "Convolution", [_blob(w.shape, w.ravel()),
                                                   _blob(b.shape, b.ravel())])
        mp, dp = tmp_path / "lenet.caffemodel", tmp_path / "deploy.prototxt"
        mp.write_bytes(raw)
        dp.write_text('name: "lenet"\n')
        _write_mnist_idx(str(tmp_path))
        _load_model_both(["--modelType", "caffe", "--model", str(mp),
                          "--caffeDefPath", str(dp), "--modelFactory",
                          "lenet", "-f", str(tmp_path), "-b", "16"], capsys)

    def test_caffe_requires_factory(self, lenet_file, tmp_path):
        from bigdl_tpu_torch.example.load_model import main
        with pytest.raises(SystemExit):
            main(["--modelType", "caffe", "--model", lenet_file,
                  "-f", str(tmp_path), "--device", "cpu"])

    def test_imagenet_names_its_item(self, lenet_file, tmp_path):
        from bigdl_tpu_torch.example.load_model import main
        with pytest.raises(NotImplementedError, match="12-DATA"):
            main(["--modelType", "bigdl", "--model", lenet_file,
                  "-f", str(tmp_path), "--dataset", "imagenet",
                  "--device", "cpu"])


def _named_leaves(model):
    """(caffe name, params) of each parameterized leaf, the names the
    skeleton's modules carry (``get_name``)."""
    out = []

    def walk(m, p):
        if getattr(m, "modules", None):
            for i, c in enumerate(m.modules):
                walk(c, p[str(i)])
        elif p and "weight" in p:
            out.append((m.get_name(), p))
    walk(model, model.params)
    return out


class TestImageClassificationExample:
    @pytest.fixture
    def image_folder(self, tmp_path):
        pytest.importorskip("PIL")
        from PIL import Image
        rng = np.random.RandomState(1)
        for cls in ["cat", "dog"]:
            d = tmp_path / cls
            d.mkdir()
            for i in range(2):
                arr = rng.randint(0, 255, size=(40, 40, 3)).astype(np.uint8)
                Image.fromarray(arr).save(str(d / f"{cls}{i}.png"))
        return str(tmp_path)

    def test_predict_folder_lenet(self, lenet_file, image_folder, capsys):
        from bigdl_tpu.example.image_classification import main as jmain
        from bigdl_tpu_torch.example.image_classification import main
        argv = ["--model", lenet_file, "-f", image_folder,
                "--modelType", "lenet", "-b", "4", "--topN", "2"]
        lines = main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out.strip().splitlines()
        jmain(argv)
        assert out == capsys.readouterr().out.strip().splitlines()
        assert len(out) == len(lines) == 4
        for _, classes in lines:
            assert len(classes) == 2 and all(1 <= c <= 10 for c in classes)

    def test_grey_from_bgr(self):
        from bigdl_tpu_torch.dataset.image import GreyFromBGR
        from bigdl_tpu_torch.dataset.types import LabeledImage
        img = LabeledImage(np.ones((3, 4, 4), np.float32) * 100, 1.0)
        grey = GreyFromBGR().transform_one(img)
        assert grey.data.shape == (1, 4, 4)
        np.testing.assert_allclose(grey.data, 100.0, rtol=1e-5)
