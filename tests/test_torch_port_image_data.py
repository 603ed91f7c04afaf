"""The image data path of bigdl_tpu_torch against the JAX package on the
CPU (``bigdl_tpu_torch/dataset/{types,transformer,image,mnist,cifar}.py``).

The synthetic MNIST and CIFAR-10 records from a seed are the
reference's byte for byte; ``load`` reads the published IDX and pickle
files as the reference does; and every pipeline the CLIs build (and the
random transformers: flips, crops, colour jitter, lighting) yields,
from the same seed, batches bitwise equal to the reference's."""
import gzip
import pickle
import struct

import numpy as np
import pytest

from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.dataset import types as jtypes
from bigdl_tpu.dataset.transformer import FuncTransformer as JFunc
from bigdl_tpu.utils.rng import RandomGenerator as JRandomGenerator

from bigdl_tpu_torch.dataset import (ByteRecord, DataSet, FuncTransformer,
                                     LabeledImage, Prefetcher, cifar, image,
                                     mnist)
from bigdl_tpu_torch.utils.rng import RandomGenerator


def _batches(ds, train=False, n=None):
    out = []
    for i, b in enumerate(ds.data(train=train)):
        if n is not None and i >= n:
            break
        out.append(b)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.data.dtype == w.data.dtype and g.data.shape == w.data.shape
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(g.labels, w.labels)


@pytest.mark.parametrize("jitter", [0, 3])
def test_mnist_synthetic_is_the_references(jitter):
    a = mnist.synthetic(300, seed=4, jitter=jitter)
    b = jmnist.synthetic(300, seed=4, jitter=jitter)
    assert [(r.data, r.label) for r in a] == [(r.data, r.label) for r in b]
    assert mnist.TRAIN_MEAN == jmnist.TRAIN_MEAN
    assert mnist.TEST_STD == jmnist.TEST_STD


def test_cifar_synthetic_is_the_references():
    a, b = cifar.synthetic(100, seed=3), jcifar.synthetic(100, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.data, y.data)
        assert x.label == y.label
    assert cifar.TRAIN_MEAN == jcifar.TRAIN_MEAN
    assert cifar.TRAIN_STD == jcifar.TRAIN_STD


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_load_reads_the_idx_files(tmp_path, gz):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, size=(7, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, size=7).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(tmp_path / f"t10k-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + images.tobytes())
    with opener(tmp_path / f"t10k-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, 7) + labels.tobytes())
    got = mnist.load(str(tmp_path), train=False)
    want = jmnist.load(str(tmp_path), train=False)
    assert [(r.data, r.label) for r in got] == [(r.data, r.label)
                                                for r in want]
    assert got[0].label == float(labels[0]) + 1.0
    with pytest.raises(FileNotFoundError):
        mnist.load(str(tmp_path), train=True)


def test_cifar_load_reads_the_pickle_batches(tmp_path):
    rng = np.random.RandomState(1)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    data = rng.randint(0, 256, size=(5, 3072)).astype(np.uint8)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({b"data": data, b"labels": [3, 0, 9, 1, 2]}, f)
    got = cifar.load(str(tmp_path), train=False)
    want = jcifar.load(str(tmp_path), train=False)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.data, y.data)
        assert x.label == y.label
    # BGR: the first channel is the file's blue plane
    np.testing.assert_array_equal(got[0].data[0],
                                  data[0, 2048:].reshape(32, 32))


def test_random_generator_uniform_is_the_references():
    a, b = RandomGenerator(17), JRandomGenerator(17)
    got = [a.uniform(-0.3, 0.7) for _ in range(1000)]
    want = [b.uniform(-0.3, 0.7) for _ in range(1000)]
    assert got == want


def _lenet_pipe(mod, batch):
    return (mod.BytesToGreyImg(28, 28) >> mod.GreyImgNormalizer(60.0, 80.0)
            >> mod.GreyImgToBatch(batch))


def test_lenet_pipeline_batches():
    recs = mnist.synthetic(100, seed=2)
    jrecs = jmnist.synthetic(100, seed=2)
    got = _batches(DataSet.array(recs) >> _lenet_pipe(image, 32))
    want = _batches(JDataSet.array(jrecs) >> _lenet_pipe(jimage, 32))
    _assert_batches_equal(got, want)
    assert got[0].data.shape == (32, 1, 28, 28) and got[-1].size() == 4


def _cifar_train_pipe(mod, batch):
    return (mod.HFlip(0.5, seed=3) >> mod.BGRImgNormalizer(
        jcifar.TRAIN_MEAN, jcifar.TRAIN_STD) >> mod.BGRImgToBatch(batch))


def test_cifar_training_pipeline_batches_over_two_epochs():
    """Shuffled, flipped and normalized: the first two epochs' batches
    (the dataset reshuffles between them) are the reference's."""
    ds = DataSet.array(cifar.synthetic(48, seed=5)) >> \
        _cifar_train_pipe(image, 16)
    jds = JDataSet.array(jcifar.synthetic(48, seed=5)) >> \
        _cifar_train_pipe(jimage, 16)
    got, want = [], []
    for d, out in ((ds, got), (jds, want)):
        d.shuffle()
        it = d.data(train=True)
        out.extend(next(it) for _ in range(3))
        d.shuffle()
        out.extend(next(it) for _ in range(3))
    _assert_batches_equal(got, want)


def _augment(mod):
    return (mod.BGRImgRdmCropper(24, 20, seed=7) >> mod.HFlip(0.3, seed=8)
            >> mod.ColorJitter(0.4, seed=9) >> mod.Lighting(0.1, seed=10)
            >> mod.BGRImgPixelNormalizer(np.full((3, 20, 24), 5.0,
                                                 np.float32))
            >> mod.BGRImgToBatch(8))


def test_random_augmentation_batches():
    imgs = cifar.synthetic(20, seed=6)
    got = _batches(DataSet.array(imgs) >> _augment(image))
    want = _batches(JDataSet.array(jcifar.synthetic(20, seed=6))
                    >> _augment(jimage))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_threaded_batcher_center_crops_to_size(data_format):
    rng = np.random.RandomState(4)
    imgs = [LabeledImage(rng.rand(3, 40, 36).astype(np.float32) * 255,
                         float(i % 5 + 1)) for i in range(10)]
    jimgs = [jtypes.LabeledImage(x.data, x.label) for x in imgs]

    def pipe(mod, cls):
        return mod.MTLabeledBGRImgToBatch(
            32, 32, 4, mod.BGRImgCropper(34, 34) >> mod.BGRImgNormalizer(
                (100.0, 110.0, 120.0), (60.0, 61.0, 62.0)),
            depth=2, data_format=data_format)

    got = _batches(DataSet.array(imgs) >> pipe(image, LabeledImage))
    want = _batches(JDataSet.array(jimgs) >> pipe(jimage, None))
    _assert_batches_equal(got, want)
    assert got[0].data.shape == ((4, 3, 32, 32) if data_format == "NCHW"
                                 else (4, 32, 32, 3))


def test_grey_normalizer_fit_and_grey_from_bgr():
    imgs = cifar.synthetic(12, seed=8)
    jimgs = jcifar.synthetic(12, seed=8)
    to_grey = DataSet.array(imgs) >> image.GreyFromBGR()
    jto_grey = JDataSet.array(jimgs) >> jimage.GreyFromBGR()
    a = image.GreyImgNormalizer.fit(to_grey)
    b = jimage.GreyImgNormalizer.fit(jto_grey)
    assert (a.mean, a.std) == (b.mean, b.std)
    pipe = image.GreyImgCropper(30, 28) >> a >> image.GreyImgToBatch(5)
    jpipe = jimage.GreyImgCropper(30, 28) >> b >> jimage.GreyImgToBatch(5)
    _assert_batches_equal(_batches(to_grey >> pipe),
                          _batches(jto_grey >> jpipe))


def test_batch_to_nhwc_and_func_transformer():
    imgs = cifar.synthetic(8, seed=1)
    scale = FuncTransformer(lambda im: LabeledImage(im.data * 0.5, im.label))
    jscale = JFunc(lambda im: jtypes.LabeledImage(im.data * 0.5, im.label))
    got = _batches(DataSet.array(imgs) >> (scale >> image.BGRImgToBatch(4)
                                           >> image.BatchToNHWC()))
    want = _batches(JDataSet.array(jcifar.synthetic(8, seed=1)) >> (
        jscale >> jimage.BGRImgToBatch(4) >> jimage.BatchToNHWC()))
    _assert_batches_equal(got, want)
    assert got[0].data.shape == (4, 32, 32, 3)


def test_prefetcher_passes_items_and_errors():
    assert list(Prefetcher(2)(iter(range(10)))) == list(range(10))

    def boom():
        yield 1
        raise KeyError("upstream")
    it = Prefetcher(1)(boom())
    assert next(it) == 1
    with pytest.raises(KeyError, match="upstream"):
        next(it)


def test_record_types():
    r = ByteRecord(b"\x01\x02", 3.0)
    assert r.data == b"\x01\x02" and r.label == 3.0
    im = LabeledImage(np.zeros((3, 5, 7), np.float32), 2.0)
    assert (im.channels, im.height, im.width) == (3, 5, 7)


def test_decoding_names_pil_when_it_is_missing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="PIL"):
        image.BytesToBGRImg().transform_one(ByteRecord(b"\x89PNG", 1.0))
