"""The record-shard ImageNet path of the port against the JAX package:
record shards (``dataset/seqfile.py``), Hadoop SequenceFiles
(``dataset/hadoop_seqfile.py``), ``DataSet.record_files``, the ImageNet
pipelines of ``models/utils``, ``seqfile_generator``, ``pipeline_bench``
and the ImageNet CLIs.

Mirrors the shard tests of ``tests/test_dataset.py``, the record tests
of ``tests/test_cli_parity.py`` and ``tests/test_seqfile_generator.py``.
Files, records, batches and host arrays are held bitwise (``==`` on
bytes, ``assert_array_equal``); losses of the slice's training loop
within 1e-5 (float32, the same model, data and updates); one SGD
update within 1e-6.
"""
import io
import logging
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import hadoop_seqfile as jhs
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu.dataset.types import ByteRecord as JByteRecord
from bigdl_tpu.dataset.types import LabeledImage as JLabeledImage
from bigdl_tpu.models import utils as jmutils
from bigdl_tpu.models.utils import pipeline_bench as jpb
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, image
from bigdl_tpu_torch.dataset import hadoop_seqfile as hs
from bigdl_tpu_torch.dataset import seqfile
from bigdl_tpu_torch.dataset.seqfile import (read_shard, write_shard,
                                             write_sharded)
from bigdl_tpu_torch.dataset.types import ByteRecord, LabeledImage
from bigdl_tpu_torch.models import utils as mutils
from bigdl_tpu_torch.models.utils import pipeline_bench as pb
from tests.conftest import corrupt_variants

TOL_LOSS = dict(rtol=1e-5, atol=1e-5)   # float32 loop, the same steps
TOL_SGD = dict(rtol=1e-6, atol=1e-6)    # one float32 update


def _pairs(records):
    return [(r.data, float(r.label)) for r in records]


def _png(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


# --------------------------------------------------------------------- #
# record shards (tests/test_dataset.py TestSeqFile)                     #
# --------------------------------------------------------------------- #
class TestShards:
    def test_roundtrip(self, tmp_path):
        recs = [ByteRecord(bytes([i] * 10), float(i)) for i in range(20)]
        p = str(tmp_path / "shard-0")
        assert write_shard(p, recs) == 20
        back = list(read_shard(p))
        assert len(back) == 20
        assert back[3].data == bytes([3] * 10) and back[3].label == 3.0

    def test_sharded(self, tmp_path):
        recs = [ByteRecord(b"x" * 5, float(i)) for i in range(10)]
        paths = write_sharded(str(tmp_path / "part"), recs, 3)
        assert [os.path.basename(p) for p in paths] == \
            ["part-00000", "part-00001", "part-00002"]
        assert sum(len(list(read_shard(p))) for p in paths) == 10

    @pytest.mark.parametrize("native_path", [True, False])
    def test_bad_magic(self, tmp_path, monkeypatch, native_path):
        if not native_path:
            monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
        p = tmp_path / "bad"
        p.write_bytes(b"NOTAMAGIC")
        with pytest.raises(ValueError, match="bad"):
            list(read_shard(str(p)))

    def test_index_cache_reuse_and_invalidation(self, tmp_path,
                                                monkeypatch):
        recs = [ByteRecord(bytes([i] * 10), float(i)) for i in range(5)]
        p = str(tmp_path / "shard-c")
        write_shard(p, recs)
        first = list(read_shard(p))
        calls = []
        real = seqfile.native.lib.shard_index
        monkeypatch.setattr(seqfile.native.lib, "shard_index",
                            lambda b: calls.append(1) or real(b))
        second = list(read_shard(p))  # a hit: no second index
        assert _pairs(first) == _pairs(second) and calls == []
        # a rewrite of another size is indexed anew
        write_shard(p, [ByteRecord(bytes([9 - i] * 24), float(i))
                        for i in range(7)])
        third = list(read_shard(p))
        assert len(third) == 7 and third[0].data == bytes([9] * 24)
        # a rewrite of the same size: the content windows catch it
        write_shard(p, [ByteRecord(bytes([i + 40] * 24), float(i + 1))
                        for i in range(7)])
        fourth = list(read_shard(p))
        assert fourth[0].data == bytes([40] * 24) and fourth[0].label == 1.0
        # a corrupted payload of a cached path: checked again, refused
        raw = bytearray(open(p, "rb").read())
        raw[-1] ^= 0xFF
        with open(p, "wb") as f:
            f.write(raw + b"\x00")
        with pytest.raises(ValueError):
            list(read_shard(p))
        assert len(calls) == 3

    def test_cache_off_checks_every_read(self, tmp_path, monkeypatch):
        p = str(tmp_path / "shard-d")
        write_shard(p, [ByteRecord(b"abc", 1.0)])
        monkeypatch.setenv("BIGDL_TPU_SHARD_INDEX_CACHE", "0")
        calls = []
        real = seqfile.native.lib.shard_index
        monkeypatch.setattr(seqfile.native.lib, "shard_index",
                            lambda b: calls.append(1) or real(b))
        list(read_shard(p))
        list(read_shard(p))
        assert len(calls) == 2

    def test_shards_are_the_references_bytes_and_read_across(self,
                                                             tmp_path):
        rng = np.random.RandomState(3)
        data = [(rng.bytes(int(rng.randint(0, 300))), float(i % 7) + 0.5)
                for i in range(23)]
        port = write_sharded(str(tmp_path / "p"), [ByteRecord(*d)
                                                   for d in data], 4)
        ref = jseq.write_sharded(str(tmp_path / "r"),
                                 [JByteRecord(*d) for d in data], 4)
        for a, b in zip(port, ref):
            assert open(a, "rb").read() == open(b, "rb").read()
            assert _pairs(read_shard(b)) == _pairs(jseq.read_shard(a))

    @pytest.mark.parametrize("native_path", [True, False])
    def test_fuzz_raises_value_errors(self, tmp_path, monkeypatch,
                                      native_path):
        if not native_path:
            monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
        p = str(tmp_path / "good")
        write_shard(p, [ByteRecord(bytes([i]) * 40, float(i))
                        for i in range(8)])
        good = open(p, "rb").read()
        detected = 0
        for trial, data in corrupt_variants(good, 30, seed=1):
            q = str(tmp_path / f"bad-{trial}")
            with open(q, "wb") as f:
                f.write(data)
            try:
                list(read_shard(q))
            except ValueError:
                detected += 1
        assert detected >= 20


# --------------------------------------------------------------------- #
# Hadoop SequenceFiles (tests/test_cli_parity.py)                       #
# --------------------------------------------------------------------- #
def _hand_encoded_seqfile(records, sync=b"0123456789abcdef",
                          codec=None):
    """A byte-level SequenceFile encoder written apart from the
    package's writer (both must agree with Hadoop's format)."""
    def vint(n):
        assert 0 <= n <= 127
        return struct.pack("b", n)

    out = io.BytesIO()
    out.write(b"SEQ\x06")
    for cls in (b"org.apache.hadoop.io.Text",) * 2:
        out.write(vint(len(cls)) + cls)
    if codec is None:
        out.write(b"\x00\x00")
    else:
        out.write(b"\x01\x00" + vint(len(codec)) + codec)
    out.write(struct.pack(">i", 0))
    out.write(sync)
    for i, (key, value) in enumerate(records):
        if i == 2 and codec is None:  # the sync-escape path
            out.write(struct.pack(">i", -1) + sync)
        kser = vint(len(key)) + key
        vser = vint(len(value)) + value
        if codec is not None:
            vser = zlib.compress(vser)
        out.write(struct.pack(">i", len(kser) + len(vser)))
        out.write(struct.pack(">i", len(kser)))
        out.write(kser + vser)
    return out.getvalue()


def _bgr_value(w, h, seed):
    rng = np.random.RandomState(seed)
    pixels = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
    return struct.pack(">ii", w, h) + pixels.tobytes(), pixels


class TestSequenceFiles:
    def test_reads_hand_encoded_fixture(self, tmp_path):
        vals = [_bgr_value(4, 3, i) for i in range(4)]
        records = [(str(i % 2 + 1).encode(), v[0])
                   for i, v in enumerate(vals)]
        p = tmp_path / "fixture_0.seq"
        p.write_bytes(_hand_encoded_seqfile(records))
        got = list(hs.read_sequence_file(str(p)))
        assert len(got) == 4
        for (key, value), (_, want_px), i in zip(got, vals, range(4)):
            name, label = hs.parse_key(key)
            assert name is None and label == float(i % 2 + 1)
            img = hs.decode_bgr_value(value)
            assert img.shape == (3, 3, 4)
            np.testing.assert_array_equal(
                img.transpose(1, 2, 0).astype(np.uint8), want_px)

    def test_name_label_key(self):
        assert hs.parse_key(b"42") == (None, 42.0)
        assert hs.parse_key(b"n01440764_10026.JPEG\n7") == \
            ("n01440764_10026.JPEG", 7.0)

    def test_writer_reader_roundtrip_with_sync(self, tmp_path):
        records = [(f"{i}".encode(), bytes([i]) * (i + 1))
                   for i in range(10)]
        p = str(tmp_path / "rt_0.seq")
        hs.write_sequence_file(p, records, sync_interval=3)
        assert list(hs.read_sequence_file(p)) == records

    @pytest.mark.parametrize("compression", [None, "record", "block"])
    def test_files_are_the_references_bytes_and_read_across(
            self, tmp_path, compression):
        records = [(f"name{i}.JPEG\n{i % 5 + 1}".encode(),
                    np.random.RandomState(i).bytes(40 + 13 * i))
                   for i in range(11)]
        a, b = str(tmp_path / "port.seq"), str(tmp_path / "ref.seq")
        hs.write_sequence_file(a, records, sync_interval=4,
                               compression=compression)
        jhs.write_sequence_file(b, records, sync_interval=4,
                                compression=compression)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert list(hs.read_sequence_file(b)) == \
            list(jhs.read_sequence_file(a)) == records
        assert _pairs(hs.file_records(b)) == _pairs(jhs.file_records(a))

    def test_write_bgr_images_matches_reference_layout(self, tmp_path):
        rng = np.random.RandomState(0)
        imgs = [rng.randint(0, 255, size=(3, 5, 7)).astype(np.float32)
                for _ in range(5)]
        paths = hs.SeqFileFolder.write_bgr_images(
            [LabeledImage(x, float(i + 1)) for i, x in enumerate(imgs)],
            str(tmp_path / "im"), block_size=2)
        ref = jhs.SeqFileFolder.write_bgr_images(
            [JLabeledImage(x, float(i + 1)) for i, x in enumerate(imgs)],
            str(tmp_path / "jm"), block_size=2)
        assert len(paths) == 3  # 2 + 2 + 1
        for a, b in zip(paths, ref):
            assert open(a, "rb").read() == open(b, "rb").read()
        seen = []
        for p in paths:
            for key, value in hs.read_sequence_file(p):
                seen.append((hs.parse_key(key)[1],
                             hs.decode_bgr_value(value)))
        assert [s[0] for s in seen] == [1.0, 2.0, 3.0, 4.0, 5.0]
        np.testing.assert_array_equal(seen[0][1], imgs[0])

    def test_write_bgr_images_with_names(self, tmp_path):
        img = np.full((3, 2, 2), 7.0, np.float32)
        (p,) = hs.SeqFileFolder.write_bgr_images(
            [(LabeledImage(img, 3.0), "a.JPEG")], str(tmp_path / "n"),
            has_name=True)
        ((key, _),) = list(hs.read_sequence_file(p))
        assert hs.parse_key(key) == ("a.JPEG", 3.0)

    def test_folder_records_to_training_pipeline(self, tmp_path):
        records = [(str(i % 2 + 1).encode(), _bgr_value(8, 8, i)[0])
                   for i in range(16)]
        hs.write_sequence_file(str(tmp_path / "imagenet_0.seq"), records[:8])
        hs.write_sequence_file(str(tmp_path / "imagenet_1.seq"), records[8:])
        recs = hs.SeqFileFolder.records(str(tmp_path))
        assert len(recs) == 16
        assert hs.SeqFileFolder.paths(str(tmp_path))[0].endswith(
            "imagenet_0.seq")
        ds = DataSet.array(recs) >> (
            hs.SeqBytesToBGRImg()
            >> image.BGRImgNormalizer((128.0,) * 3, (64.0,) * 3)
            >> image.BGRImgToBatch(8))
        m = nn.Sequential(nn.Reshape((8 * 8 * 3,)), nn.Linear(8 * 8 * 3, 2),
                          nn.LogSoftMax()).build(1, device="cpu")
        opt = optim.LocalOptimizer(m, ds, nn.ClassNLLCriterion())
        opt.set_optim_method(optim.SGD(learning_rate=0.01)) \
           .set_end_when(optim.Trigger.max_iteration(2))
        opt.optimize()
        assert np.isfinite(opt.state["loss"])

    def test_empty_folder_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no .seq files"):
            hs.SeqFileFolder.paths(str(tmp_path))

    def test_reads_hand_encoded_record_compressed(self, tmp_path):
        records = [(f"{i}".encode(), bytes([65 + i]) * (20 + i))
                   for i in range(5)]
        p = tmp_path / "rc_0.seq"
        p.write_bytes(_hand_encoded_seqfile(
            records, sync=b"fedcba9876543210",
            codec=b"org.apache.hadoop.io.compress.DefaultCodec"))
        assert list(hs.read_sequence_file(str(p))) == records

    @pytest.mark.parametrize("compression", ["record", "block"])
    def test_compressed_roundtrip(self, tmp_path, compression):
        records = [(f"key-{i}".encode(), np.random.RandomState(i).bytes(150))
                   for i in range(11)]
        p = str(tmp_path / "c_0.seq")
        hs.write_sequence_file(p, records, sync_interval=4,
                               compression=compression)
        assert list(hs.read_sequence_file(p)) == records

    def test_unknown_codec_fails_loudly(self, tmp_path):
        p = tmp_path / "bad_0.seq"
        p.write_bytes(_hand_encoded_seqfile(
            [], codec=b"com.example.SnappyCodec"))
        with pytest.raises(ValueError, match="SnappyCodec"):
            list(hs.read_sequence_file(str(p)))

    def test_folder_records_handles_compressed(self, tmp_path):
        rng = np.random.RandomState(0)
        records = [(str(i + 1).encode(), hs.encode_bgr_image(
            rng.rand(3, 4, 4).astype(np.float32) * 255)) for i in range(4)]
        hs.write_sequence_file(str(tmp_path / "part_0.seq"), records,
                               compression="record")
        got = hs.SeqFileFolder.records(str(tmp_path))
        assert [r.label for r in got] == [1.0, 2.0, 3.0, 4.0]

    @pytest.mark.parametrize("compression", [None, "record", "block"])
    def test_reader_rejects_corrupt_bytes(self, tmp_path, compression):
        """The reference's mutation schedule: every detected corruption
        is a ValueError naming the file (the reference lets struct,
        index and zlib errors through), and nothing hangs."""
        records = [(f"{i}".encode(), bytes([i]) * 50) for i in range(8)]
        p = str(tmp_path / "good.seq")
        hs.write_sequence_file(p, records, sync_interval=3,
                               compression=compression)
        good = open(p, "rb").read()
        detected = 0
        for _, data in corrupt_variants(good, 30, seed=1):
            try:
                list(hs.read_sequence_file("<fuzz>", data=data))
            except ValueError as e:
                assert "<fuzz>" in str(e)
                detected += 1
        assert detected >= 8

    def test_is_seq_value_and_any_bytes(self):
        value, px = _bgr_value(10, 10, 0)
        png = _png(px)
        assert hs.is_seq_value(value) and not hs.is_seq_value(png)
        dec = hs.AnyBytesToBGRImg()
        jdec = jhs.AnyBytesToBGRImg()
        for data in (value, png):
            got = dec.transform_one(ByteRecord(data, 2.0))
            want = jdec.transform_one(JByteRecord(data, 2.0))
            np.testing.assert_array_equal(got.data, want.data)
            assert got.label == want.label == 2.0


# --------------------------------------------------------------------- #
# DataSet.record_files and Transformer.chain/clone                      #
# --------------------------------------------------------------------- #
def _mixed_folder(tmp_path, size=10, n=3):
    """A PNG record shard beside a framed-raw .seq file."""
    rng = np.random.RandomState(0)
    write_shard(str(tmp_path / "train_a.shard"), [
        ByteRecord(_png(rng.randint(0, 256, size=(size, size, 3),
                                    dtype=np.uint8)), float(i + 1))
        for i in range(n)])
    hs.write_sequence_file(str(tmp_path / "train_b.seq"), [
        (b"1", hs.encode_bgr_image(rng.rand(3, size, size).astype(
            np.float32) * 255)) for _ in range(n)])
    return [str(tmp_path / "train_a.shard"), str(tmp_path / "train_b.seq")]


def test_record_files_mixes_shards_and_seq_files(tmp_path, monkeypatch):
    paths = _mixed_folder(tmp_path)
    ds = DataSet.record_files(paths)
    pipe = hs.AnyBytesToBGRImg() >> image.BGRImgCropper(8, 8)
    imgs = list(pipe(ds.data(train=False)))
    assert len(imgs) == 6
    assert all(im.data.shape == (3, 8, 8) and np.isfinite(im.data).all()
               for im in imgs)
    want = _pairs(JDataSet.record_files(paths).data(train=False))
    assert _pairs(ds.data(train=False)) == want
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    assert _pairs(DataSet.record_files(paths).data(train=False)) == want


def test_record_files_refuses_distributed(tmp_path):
    """distributed=True (refused before the data-parallel engine was
    ported): this rank's shard of the records, the reference's."""
    from bigdl_tpu_torch.dataset import DistributedDataSet
    paths = _mixed_folder(tmp_path)
    ds = DataSet.record_files(paths, distributed=True)
    assert isinstance(ds, DistributedDataSet)
    jd = JDataSet.record_files(paths, distributed=True)
    assert ds.size() == jd.size()
    assert _pairs(ds.data(train=False)) == _pairs(jd.data(train=False))


def test_chain_and_clone():
    flip = image.HFlip(0.5)
    norm = image.BGRImgNormalizer((1.0,) * 3, (2.0,) * 3)
    chained = flip.chain(norm)
    assert chained.first is flip and chained.second is norm
    imgs = [LabeledImage(np.random.RandomState(i).rand(3, 4, 4)
                         .astype(np.float32), 1.0) for i in range(6)]
    list(flip(iter(imgs[:3])))  # advance the generator
    twin = flip.clone()
    assert twin is not flip and twin._rng._native != flip._rng._native
    a = [x.data for x in flip(iter(imgs))]
    b = [x.data for x in twin(iter(imgs))]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the reference's generator after the same draws (its own clone
    # shares one native handle between the copies, which frees it twice)
    jflip = jimage.HFlip(0.5)
    list(jflip(iter([JLabeledImage(x.data, 1.0) for x in imgs[:3]])))
    c = [x.data for x in jflip(
        iter([JLabeledImage(x.data, 1.0) for x in imgs]))]
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------- #
# the ImageNet helpers                                                  #
# --------------------------------------------------------------------- #
def test_imagenet_constants():
    assert mutils.IMAGENET_BGR_MEAN == jmutils.IMAGENET_BGR_MEAN
    assert mutils.IMAGENET_BGR_STD == jmutils.IMAGENET_BGR_STD


@pytest.mark.parametrize("names", [
    ("train-00000", "train-00001", "val-00000"),
    ("part-0", "part-1", "part-2")])
@pytest.mark.parametrize("fallback", ["first", "all"])
def test_imagenet_shards_discovery(tmp_path, names, fallback):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = mutils.imagenet_shards(str(tmp_path), val_fallback=fallback)
    assert got == jmutils.imagenet_shards(str(tmp_path),
                                          val_fallback=fallback)
    if names[0].startswith("part"):
        assert got[1] == (got[0][:1] if fallback == "first" else got[0])
    with pytest.raises(ValueError, match="val_fallback"):
        mutils.imagenet_shards(str(tmp_path), val_fallback="some")


def _imagenet_folder(tmp_path, n_train=8, n_val=4, size=240):
    """train: a PNG record shard and a framed-raw .seq file; val: .seq."""
    rng = np.random.RandomState(5)

    def px():
        return rng.randint(0, 256, size=(size, size, 3), dtype=np.uint8)

    half = n_train // 2
    write_shard(str(tmp_path / "train-00000"), [
        ByteRecord(_png(px()), float(i % 4 + 1)) for i in range(half)])
    hs.write_sequence_file(str(tmp_path / "train_1.seq"), [
        (str(i % 4 + 1).encode(), hs.encode_bgr_image(
            px().transpose(2, 0, 1).astype(np.float32)))
        for i in range(n_train - half)])
    hs.write_sequence_file(str(tmp_path / "val_0.seq"), [
        (str(i % 4 + 1).encode(), hs.encode_bgr_image(
            px().transpose(2, 0, 1).astype(np.float32)))
        for i in range(n_val)])
    return str(tmp_path)


def _first(ds, train):
    it = ds.data(train=train)
    b = next(it)
    it.close()
    return b


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_imagenet_seq_datasets_first_batches_are_the_references(
        tmp_path, data_format):
    folder = _imagenet_folder(tmp_path)
    train, val = mutils.imagenet_seq_datasets(folder, 4,
                                              data_format=data_format)
    jtrain, jval = jmutils.imagenet_seq_datasets(folder, 4,
                                                 data_format=data_format)
    for ds, jds, is_train in ((train, jtrain, True), (val, jval, False)):
        got, want = _first(ds, is_train), _first(jds, is_train)
        shape = (4, 3, 224, 224) if data_format == "NCHW" else \
            (4, 224, 224, 3)
        assert got.data.shape == shape
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.labels, want.labels)


def test_imagenet_val_pipe_is_the_references(tmp_path):
    folder = _imagenet_folder(tmp_path, n_train=2, n_val=6)
    files = mutils.imagenet_shards(folder, val_fallback="all")[1]
    got = list((DataSet.record_files(files)
                >> mutils.imagenet_val_pipe(4)).data(train=False))
    want = list((JDataSet.record_files(files)
                 >> jmutils.imagenet_val_pipe(4)).data(train=False))
    assert [b.size() for b in got] == [4, 2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.labels, b.labels)


# --------------------------------------------------------------------- #
# the slice as a whole                                                  #
# --------------------------------------------------------------------- #
class _Losses(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if str(record.msg).startswith("Epoch %d iteration %d"):
            self.losses.append(float(record.args[2]))


def _seq_folder_training(pkg, path):
    """The reference's ``test_inception_style_training_from_seq_folder``
    in one package: .seq file -> record_files -> SeqBytesToBGRImg ->
    crop/normalize -> 3 LocalOptimizer iterations of a tiny stand-in."""
    if pkg == "ref":
        from bigdl_tpu.dataset import DataSet as DS
        nn_, optim_, img, seq = jnn, joptim, jimage, jhs
        build = dict()
        logger = logging.getLogger("bigdl_tpu.optim")
    else:
        DS, nn_, optim_, img, seq = DataSet, nn, optim, image, hs
        build = dict(device="cpu")
        logger = logging.getLogger("bigdl_tpu_torch.optim")
    ds = DS.record_files([path])
    pipe = (seq.SeqBytesToBGRImg() >> img.BGRImgCropper(8, 8)
            >> img.BGRImgNormalizer((104.0, 117.0, 123.0), (1.0, 1.0, 1.0))
            >> img.BGRImgToBatch(8))
    model = nn_.Sequential(nn_.Reshape((3 * 8 * 8,)),
                           nn_.Linear(3 * 8 * 8, 2),
                           nn_.LogSoftMax()).build(seed=1, **build)
    opt = optim_.LocalOptimizer(model, ds >> pipe, nn_.ClassNLLCriterion())
    opt.set_optim_method(optim_.SGD(learning_rate=0.01)) \
       .set_end_when(optim_.Trigger.max_iteration(3))
    handler, level = _Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.losses, opt


def test_inception_style_training_from_seq_folder_is_the_references(
        tmp_path):
    rng = np.random.RandomState(0)
    records = []
    for i in range(16):
        img = rng.rand(3, 10, 10).astype(np.float32) * 255
        records.append((str(i % 2 + 1).encode(), hs.encode_bgr_image(img)))
    path = str(tmp_path / "train_0.seq")
    hs.write_sequence_file(path, records, compression="record")
    ref_losses, _ = _seq_folder_training("ref", path)
    losses, opt = _seq_folder_training("port", path)
    assert len(losses) == len(ref_losses) == 3
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, **TOL_LOSS)
    assert opt.state["epoch"] == 2


# --------------------------------------------------------------------- #
# seqfile_generator (tests/test_seqfile_generator.py)                   #
# --------------------------------------------------------------------- #
@pytest.fixture
def image_tree(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    for split, n_per_class in (("train", 3), ("val", 2)):
        for cls in ["apple", "banana"]:
            d = tmp_path / "tree" / split / cls
            d.mkdir(parents=True)
            for i in range(n_per_class):
                arr = rng.randint(0, 255, size=(8, 8, 3)).astype(np.uint8)
                Image.fromarray(arr).save(str(d / f"{i}.png"))
    return str(tmp_path / "tree")


def test_generate_and_roundtrip(image_tree, tmp_path):
    from bigdl_tpu.models.utils.seqfile_generator import generate as jgen
    from bigdl_tpu_torch.models.utils.seqfile_generator import generate
    out, jout = str(tmp_path / "shards"), str(tmp_path / "jshards")
    counts = generate(image_tree, out, parallel=2, splits=["train", "val"],
                      validate=True)
    assert counts == {"train": 6, "val": 4}
    shards = sorted(os.listdir(out))
    assert shards == ["train-00000", "train-00001", "val-00000",
                      "val-00001"]
    jgen(image_tree, jout, parallel=2, splits=["train", "val"])
    for s in shards:  # the JAX package's generator writes the same bytes
        assert open(os.path.join(out, s), "rb").read() == \
            open(os.path.join(jout, s), "rb").read()
    ds = DataSet.record_files([os.path.join(out, s) for s in shards
                               if s.startswith("train")])
    batches = list((ds >> (image.BytesToBGRImg()
                           >> image.BGRImgToBatch(3))).data(train=False))
    assert sum(b.size() for b in batches) == 6
    assert sorted(float(v) for b in batches for v in b.labels) == \
        [1.0, 1.0, 1.0, 2.0, 2.0, 2.0]


def test_generator_cli_main(image_tree, tmp_path, capsys):
    from bigdl_tpu_torch.models.utils.seqfile_generator import main
    out = str(tmp_path / "shards2")
    main(["-f", image_tree, "-o", out, "-p", "1", "--splits", "val",
          "--validate"])
    assert "val: 4 records -> 1 shards" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="missing split"):
        main(["-f", image_tree, "-o", out, "--splits", "test"])


# --------------------------------------------------------------------- #
# pipeline_bench                                                        #
# --------------------------------------------------------------------- #
@pytest.fixture
def small_crop(monkeypatch):
    """The bench at CROP, STORED = 16, 24 in both packages."""
    for mod in (pb, jpb):
        monkeypatch.setattr(mod, "CROP", 16)
        monkeypatch.setattr(mod, "STORED", 24)


def test_pipeline_bench_stream_shapes(tmp_path, small_crop):
    paths = pb.generate_shards(str(tmp_path), 32, n_shards=2)
    stream = pb.batch_stream(paths, 8)
    try:
        x, y = next(stream)
        assert x.shape == (8, 16, 16, 3) and x.dtype == np.uint8
        assert y.shape == (8,) and y.min() >= 1.0
        for _ in range(8):  # crosses an epoch boundary (32 records / 8)
            x, y = next(stream)
        assert x.shape == (8, 16, 16, 3)
    finally:
        stream.close()


@pytest.mark.parametrize("native_path", [True, False])
def test_batch_stream_is_the_references(tmp_path, monkeypatch, small_crop,
                                        native_path):
    """The shards are the reference's bytes, and so are six batches (an
    epoch and a half, a reshuffle between): the library's batcher, and
    the Python thread pool under ``BIGDL_TPU_NO_NATIVE=1`` against the
    reference's own Python path."""
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    paths = pb.generate_shards(str(tmp_path / "p"), 32, n_shards=4)
    jpaths = jpb.generate_shards(str(tmp_path / "r"), 32, n_shards=4)
    for a, b in zip(paths, jpaths):
        assert open(a, "rb").read() == open(b, "rb").read()
    if not native_path:
        monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
        from bigdl_tpu import native as jnative
        monkeypatch.setattr(jnative.lib, "_dll", None)
        monkeypatch.setattr(jnative.lib, "_tried", True)
    got_stream, want_stream = pb.batch_stream(paths, 12), \
        jpb.batch_stream(jpaths, 12)
    try:
        for _ in range(6):
            (x, y), (jx, jy) = next(got_stream), next(want_stream)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    finally:
        got_stream.close()
        want_stream.close()


def test_pipeline_bench_host_only_mode(tmp_path, small_crop):
    r = pb.run_host_only(batch=8, iters=6, warmup=2, workdir=str(tmp_path),
                         n_records=32)
    assert r["value"] > 0
    assert r["metric"] == "input_pipeline_host_delivery_images_per_sec"
    assert r["native_batcher"] is True
    assert r["card_rate"] is None and r["headroom_vs_card_rate"] is None
    assert "chip_consumption_rate_r1" not in r
    (tmp_path / "b").mkdir()
    r = pb.run_host_only(batch=8, iters=2, warmup=1,
                         workdir=str(tmp_path / "b"), n_records=32,
                         card_rate=1000.0)
    assert r["headroom_vs_card_rate"] == r["value"] / 1000.0


def test_train_pieces_normalize_cast_and_update():
    """The step's pieces against the reference's: the normalize of the
    uint8 batch and the bf16 cast of the masters bitwise, one
    SGD(0.1, momentum 0.9, dampening 0) update from equal gradients
    within 1e-6."""
    from bigdl_tpu.nn._util import cast_f32_leaves as jcast
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu_torch.nn._util import cast_f32_leaves
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, size=(2, 5, 5, 3), dtype=np.uint8)
    got = pb.device_normalize(
        torch.from_numpy(x), torch.tensor(pb.MEAN, dtype=torch.bfloat16),
        torch.tensor(pb.STD, dtype=torch.bfloat16))
    want = (jnp.asarray(x).astype(jnp.bfloat16)
            - jnp.asarray(jpb.MEAN, jnp.bfloat16)) / jnp.asarray(
                jpb.STD, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    tree = {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32),
            "n": np.arange(3, dtype=np.int32)}
    got = cast_f32_leaves({k: torch.from_numpy(v) for k, v in tree.items()},
                          torch.bfloat16)
    want = jcast({k: jnp.asarray(v) for k, v in tree.items()}, jnp.bfloat16)
    for k in tree:
        np.testing.assert_array_equal(
            got[k].float().numpy(), np.asarray(want[k]).astype(np.float32))
    assert got["n"].dtype == torch.int32
    params = {k: tree[k] for k in ("w", "b")}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    method = optim.SGD(learning_rate=0.1, momentum=0.9, dampening=0.0)
    jmethod = JSGD(learning_rate=0.1, momentum=0.9, dampening=0.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = method.init_state(tp), jmethod.init_state(jp)
    for g in grads:  # the second step reads the momentum
        tp, state = method.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, state, tp)
        jp, jstate = jmethod.update({k: jnp.asarray(v)
                                     for k, v in g.items()}, jstate, jp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   **TOL_SGD)


def test_pipeline_bench_runs_on_the_cpu(tmp_path):
    """The whole bench at batch 2 on the CPU (ResNet-50 at ImageNet
    width): both rates, finite losses, the copy and the stamp."""
    r = pb.main(["--batch", "2", "--iters", "1", "--warmup", "1",
                 "--records", "8", "--workdir", str(tmp_path),
                 "--device", "cpu", "--json", str(tmp_path / "r.json")])
    assert r["synthetic_img_s"] > 0 and r["pipeline_img_s"] > 0
    assert r["ratio"] == r["pipeline_img_s"] / r["synthetic_img_s"]
    assert np.isfinite(list(r["last_loss"].values())).all()
    assert r["input_bytes"] == 2 * 224 * 224 * 3
    assert r["native_batcher"] is True and r["platform"] == "cpu"
    assert r["peak_bytes"] is None
    assert os.path.exists(tmp_path / "r.json")


def test_pipeline_bench_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.run(2, 1, 1, str(tmp_path), 8)


# --------------------------------------------------------------------- #
# the ImageNet CLIs (the port's only; the reference's ResNet one is     #
# marked slow there)                                                    #
# --------------------------------------------------------------------- #
def _raw_seq_folder(tmp_path, n_train=4, n_val=2):
    rng = np.random.RandomState(0)
    records = [(str(i % 4 + 1).encode(), hs.encode_bgr_image(
        (rng.rand(3, 256, 256) * 255).astype(np.float32)))
        for i in range(max(n_train, n_val))]
    folder = tmp_path / "seq"
    folder.mkdir()
    hs.write_sequence_file(str(folder / "train_0.seq"), records[:n_train])
    hs.write_sequence_file(str(folder / "val_0.seq"), records[:n_val])
    return str(folder)


def test_resnet_cli_imagenet_one_epoch(tmp_path):
    from bigdl_tpu_torch.models.resnet import train as cli
    opt = cli.main(["--dataset", "imagenet", "-f", _raw_seq_folder(tmp_path),
                    "--depth", "18", "--classNumber", "4", "-b", "2",
                    "-e", "1", "--dataFormat", "NHWC", "--device", "cpu"])
    assert np.isfinite(opt.state["loss"]) and opt.state["epoch"] == 2
    with pytest.raises(SystemExit, match="cifar-mode only"):
        cli.main(["--dataset", "imagenet", "--synthetic", "--device", "cpu"])


def test_inception_clis_train_then_test(tmp_path, capsys):
    from bigdl_tpu_torch.models.inception import test as inc_test
    from bigdl_tpu_torch.models.inception import train as inc_train
    folder = _raw_seq_folder(tmp_path)
    opt = inc_train.main(["-f", folder, "--modelName", "inception_v1",
                          "-b", "2", "-i", "2", "--classNumber", "4",
                          "--device", "cpu"])
    assert np.isfinite(opt.state["loss"]) and opt.state["neval"] == 3
    path = str(tmp_path / "inception.bin")
    opt.model.save(path)
    results = inc_test.main(["-f", folder, "--model", path, "-b", "2",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Top1Accuracy is" in out and "Top5Accuracy is" in out
    assert results[0][1].count == 2


def test_inception_synthetic_records_are_the_references():
    from bigdl_tpu.models.inception.train import _synthetic_records as jsyn
    from bigdl_tpu_torch.models.inception.train import _synthetic_records
    assert _pairs(_synthetic_records(3)) == _pairs(jsyn(3))


def test_load_model_imagenet(tmp_path, capsys):
    from bigdl_tpu_torch.example.load_model import main
    from bigdl_tpu_torch.models import ResNet
    folder = _raw_seq_folder(tmp_path, n_val=3)
    path = str(tmp_path / "resnet.bin")
    ResNet(4, depth=18, dataset="imagenet").build(1, device="cpu").save(path)
    results = main(["--modelType", "bigdl", "--model", path, "-f", folder,
                    "--dataset", "imagenet", "-b", "2", "--device", "cpu"])
    assert [r.count for _, r in results] == [3, 3]
    assert "Top5Accuracy is" in capsys.readouterr().out
