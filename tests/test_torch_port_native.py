"""The port's host library (``bigdl_tpu_torch/native`` over
``bigdl_tpu_torch/csrc/host_native.cpp``) against the JAX package's
native library and against the Python paths beside each call.

Mirrors ``tests/test_native.py`` and the native indexer cases of
``tests/test_cli_parity.py``.  Every comparison is exact (bitwise): the
library computes integer CRCs, the standard MT19937, byte offsets and
byte copies, and the same double arithmetic as the Python paths.
"""
import copy
import pickle
import re
import threading
import zlib

import numpy as np
import pytest

from bigdl_tpu import native as jnative
from bigdl_tpu.utils.rng import RandomGenerator as JRandomGenerator
from bigdl_tpu.visualization import crc as jcrc
from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.types import ByteRecord
from bigdl_tpu_torch.utils.rng import RandomGenerator
from bigdl_tpu_torch.visualization import crc


@pytest.fixture
def no_native(monkeypatch):
    """The Python paths: the reference's switch, ``BIGDL_TPU_NO_NATIVE``."""
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")


def _ref_lib():
    lib = jnative.get()
    if lib is None:
        pytest.skip("the JAX package's native library did not build")
    return lib


def _ref_python_generator(seed: int) -> JRandomGenerator:
    """The reference's generator on its pure-Python path."""
    g = JRandomGenerator.__new__(JRandomGenerator)
    g._mt = np.zeros(624, dtype=np.uint64)
    g._mti = 625
    g._normal_cached = None
    g._native = None
    g.set_seed(seed)
    return g


def test_library_builds_into_the_port_build_dir():
    lib = native.get()
    assert lib is not None and lib.dll is not None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "bigdl_tpu_torch"
    assert native.SOURCE.name == "host_native.cpp"


# --------------------------------------------------------------------- #
# crc                                                                   #
# --------------------------------------------------------------------- #
def test_crc32c_vectors():
    lib = native.get()
    # RFC 3720: 32 zero bytes -> 0x8A9136AA; "123456789" -> 0xE3069283
    assert lib.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert lib.crc32c(b"123456789") == 0xE3069283
    assert crc.crc32c(b"123456789") == 0xE3069283


def test_crc32c_matches_the_python_path_and_the_reference():
    lib, ref = native.get(), _ref_lib()
    rng = np.random.RandomState(0)
    for n in [0, 1, 7, 8, 9, 63, 64, 1000]:
        data = rng.bytes(n)
        want = crc.crc32c_py(data)
        assert lib.crc32c(data) == want == ref.crc32c(data)
        assert lib.crc32c(data, 0x1234) == crc.crc32c_py(data, 0x1234)


def test_masked_crc_matches_the_reference(no_native):
    data = b"tfevents payload"
    python_path = crc.masked_crc32c(data)
    c = jcrc.crc32c_py(data)
    want = (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    assert python_path == want == jcrc.masked_crc32c(data)


def test_masked_crc_native_path():
    data = b"tfevents payload"
    assert crc.masked_crc32c(data) == jcrc.masked_crc32c(data)


def test_zlib_crc_matches():
    data = b"hello shard"
    assert native.get().dll.bt_crc32(data, len(data), 0) == \
        zlib.crc32(data) & 0xFFFFFFFF


# --------------------------------------------------------------------- #
# MT19937                                                               #
# --------------------------------------------------------------------- #
def test_generator_runs_on_the_library():
    g = RandomGenerator(42)
    assert g._native is not None


def test_random_sequence_matches_the_reference(no_native):
    py = RandomGenerator(42)
    assert py._native is None
    ref_py = _ref_python_generator(42)
    got_py = [py.random() for _ in range(100)]
    assert got_py == [ref_py.random() for _ in range(100)]


def test_random_sequence_native_matches_python_and_reference():
    nat = RandomGenerator(42)
    ref = JRandomGenerator(42)
    # beyond the 624-word block, where a wrong block update shows
    got = [nat.random() for _ in range(700)]
    assert got == [ref.random() for _ in range(700)]
    lib = native.get()
    h = lib.mt_new(42)
    try:
        assert [lib.mt_random(h) for _ in range(700)] == got
    finally:
        lib.mt_free(h)


def test_python_path_equals_the_library_past_the_block(monkeypatch):
    """The port's Python path keeps the standard sequence past the
    455th draw, where the reference's own Python fallback parts from
    it: 1300 draws span two block updates."""
    g = RandomGenerator(7)
    want = [g.random_int() for _ in range(1300)]
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    py = RandomGenerator(7)
    assert py._native is None
    assert [py.random_int() for _ in range(1300)] == want


def test_uniform_normal_arrays_match_the_reference():
    lib, ref = native.get(), JRandomGenerator(7)
    if ref._native is None:
        pytest.skip("the reference's native generator is not active")
    h = lib.mt_new(7)
    try:
        np.testing.assert_array_equal(lib.mt_uniform(h, 64, -1, 1),
                                      ref.uniform_array(64, -1, 1))
        np.testing.assert_array_equal(lib.mt_normal(h, 65, 2.0, 3.0),
                                      ref.normal_array(65, 2.0, 3.0))
        np.testing.assert_array_equal(lib.mt_bernoulli(h, 33, 0.3),
                                      ref.bernoulli_array(33, 0.3))
    finally:
        lib.mt_free(h)


def test_normal_cache_interleave():
    """Scalar normals consume the polar method's cached second value as
    the reference's generator does, and the stream stays aligned."""
    lib, ref = native.get(), _ref_python_generator(5)
    h = lib.mt_new(5)
    try:
        for _ in range(11):  # odd: ends on a cached value
            assert float(lib.mt_normal(h, 1, 0.0, 1.0)[0]) == ref.normal()
        assert lib.mt_random(h) == ref.random()
    finally:
        lib.mt_free(h)


def test_randperm_parity(monkeypatch):
    nat = RandomGenerator(13).randperm(50)
    np.testing.assert_array_equal(nat, JRandomGenerator(13).randperm(50))
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    np.testing.assert_array_equal(RandomGenerator(13).randperm(50), nat)
    assert sorted(nat) == list(range(1, 51))


def test_random_int_parity():
    nat, ref = RandomGenerator(99), _ref_python_generator(99)
    for _ in range(10):
        assert nat.random_int() == ref.random_int()
    nat.set_seed(3)
    assert nat.random_int() == JRandomGenerator(3).random_int()


def test_state_roundtrip():
    lib = native.get()
    h1, h2 = lib.mt_new(3), lib.mt_new(999)
    try:
        lib.mt_normal(h1, 1, 0.0, 1.0)  # fill the cache
        state = lib.mt_get_state(h1)
        expect = [lib.mt_random(h1) for _ in range(5)]
        lib.mt_set_state(h2, *state)
        assert [lib.mt_random(h2) for _ in range(5)] == expect
        ref = _ref_lib()
        hr = ref.mt_new(1)
        ref.mt_set_state(hr, *state)
        assert [ref.mt_random(hr) for _ in range(5)] == expect
        ref.mt_free(hr)
    finally:
        lib.mt_free(h1)
        lib.mt_free(h2)


@pytest.mark.parametrize("how", ["deepcopy", "pickle"])
def test_copy_carries_the_state_and_owns_its_handle(how):
    g = RandomGenerator(11)
    [g.random() for _ in range(700)]
    c = (copy.deepcopy(g) if how == "deepcopy"
         else pickle.loads(pickle.dumps(g)))
    assert c._native is not None and c._native != g._native
    assert [c.random() for _ in range(5)] == [g.random() for _ in range(5)]
    del g  # frees its own handle only
    assert c.random_int() >= 0


def test_pickled_state_resumes_on_the_python_path(monkeypatch):
    g = RandomGenerator(11)
    [g.random() for _ in range(700)]
    blob = pickle.dumps(g)
    want = [g.random_int() for _ in range(700)]
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    c = pickle.loads(blob)
    assert c._native is None
    assert [c.random_int() for _ in range(700)] == want


# --------------------------------------------------------------------- #
# record-shard index                                                    #
# --------------------------------------------------------------------- #
def test_shard_roundtrip_through_the_index(tmp_path):
    from bigdl_tpu.dataset.seqfile import read_shard as jread_shard
    from bigdl_tpu_torch.dataset.seqfile import read_shard, write_shard
    rng = np.random.RandomState(1)
    records = [ByteRecord(rng.bytes(int(rng.randint(1, 200))), float(i))
               for i in range(20)]
    path = str(tmp_path / "shard-0")
    assert write_shard(path, records) == 20
    back = list(read_shard(path))
    assert [(r.data, r.label) for r in back] == \
        [(r.data, r.label) for r in records] == \
        [(r.data, r.label) for r in jread_shard(path)]


def test_empty_payload_records_not_dropped(tmp_path):
    from bigdl_tpu_torch.dataset.seqfile import read_shard, write_shard
    path = str(tmp_path / "shard-empty")
    write_shard(path, [ByteRecord(b"", float(i)) for i in range(13)])
    back = list(read_shard(path))
    assert [r.label for r in back] == [float(i) for i in range(13)]
    assert all(r.data == b"" for r in back)


def test_crc_detection(tmp_path):
    from bigdl_tpu_torch.dataset.seqfile import read_shard, write_shard
    path = str(tmp_path / "shard-bad")
    write_shard(path, [ByteRecord(b"x" * 50, 1.0)])
    raw = bytearray(open(path, "rb").read())
    raw[-10] ^= 0xFF  # corrupt the payload
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        list(read_shard(path))


def test_native_index_direct(tmp_path):
    from bigdl_tpu_torch.dataset.seqfile import write_shard
    path = str(tmp_path / "shard-1")
    write_shard(path, [ByteRecord(b"abc", 2.0), ByteRecord(b"defg", 3.0)])
    buf = open(path, "rb").read()
    offsets, lengths, labels = native.get().shard_index(buf)
    assert list(lengths) == [3, 4] and list(labels) == [2.0, 3.0]
    assert buf[offsets[0]:offsets[0] + 3] == b"abc"
    ref = _ref_lib().shard_index(buf)
    for a, b in zip((offsets, lengths, labels), ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("buf", [b"", b"BTRS", b"XXXX\x01", b"BTRS\x01abc",
                                 b"BTRS\x01" + b"\x10\x00\x00\x00" + b"\x00" * 8
                                 + b"short"])
def test_shard_index_rejects_malformed(buf):
    with pytest.raises(ValueError, match="malformed"):
        native.get().shard_index(buf)


# --------------------------------------------------------------------- #
# Hadoop SequenceFile index                                             #
# --------------------------------------------------------------------- #
def test_hadoop_index_matches_the_python_reader(tmp_path):
    from bigdl_tpu_torch.dataset.hadoop_seqfile import (parse_key,
                                                        read_sequence_file,
                                                        write_sequence_file)
    records = [(b"3", b"abc"), (b"name.JPEG\n7", b"0123456789" * 50),
               (b"1", b""), (b"2", bytes(range(100)))]
    p = str(tmp_path / "n_0.seq")
    write_sequence_file(p, records, sync_interval=2)
    buf = open(p, "rb").read()
    offsets, lengths, labels = native.get().hadoop_seq_index(buf)
    got = [(buf[o:o + n], float(lab))
           for o, n, lab in zip(offsets, lengths, labels)]
    want = [(v, parse_key(k)[1]) for k, v in read_sequence_file(p)]
    assert got == want
    assert [lab for _, lab in got] == [3.0, 7.0, 1.0, 2.0]
    ref = _ref_lib().hadoop_seq_index(buf)
    for a, b in zip((offsets, lengths, labels), ref):
        np.testing.assert_array_equal(a, b)


def test_hadoop_index_rejects_malformed():
    lib = native.get()
    with pytest.raises(ValueError):
        lib.hadoop_seq_index(b"NOTASEQFILE")
    with pytest.raises(NotImplementedError):
        lib.hadoop_seq_index(b"SEQ\x05" + b"\x00" * 64)  # version 5


def test_hadoop_index_rejects_non_numeric_label(tmp_path):
    from bigdl_tpu_torch.dataset.hadoop_seqfile import write_sequence_file
    p = str(tmp_path / "bad_0.seq")
    write_sequence_file(p, [(b"not-a-number", b"payload")])
    with pytest.raises(ValueError, match="non-numeric label"):
        native.get().hadoop_seq_index(open(p, "rb").read())


def test_hadoop_index_fuzz_raises_value_errors(tmp_path):
    """The reference's mutation schedule (``tests/conftest.py``
    ``corrupt_variants``) over an uncompressed file: the index raises
    ValueError or NotImplementedError, or returns in-bounds records."""
    from bigdl_tpu_torch.dataset.hadoop_seqfile import write_sequence_file
    from tests.conftest import corrupt_variants
    p = str(tmp_path / "good.seq")
    write_sequence_file(p, [(f"{i}".encode(), bytes([i]) * 50)
                            for i in range(8)], sync_interval=3)
    good = open(p, "rb").read()
    detected = 0
    for _, data in corrupt_variants(good, 30, seed=1):
        try:
            offsets, lengths, _ = native.get().hadoop_seq_index(data)
        except (ValueError, NotImplementedError):
            detected += 1
            continue
        assert ((offsets + lengths) <= len(data)).all()
    assert detected >= 8


def test_folder_records_same_either_path(tmp_path, monkeypatch):
    from bigdl_tpu_torch.dataset import hadoop_seqfile as hs
    records = [(str(i % 3 + 1).encode(), bytes([i]) * 8) for i in range(9)]
    hs.write_sequence_file(str(tmp_path / "x_0.seq"), records)
    fast = hs.SeqFileFolder.records(str(tmp_path))
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    slow = hs.SeqFileFolder.records(str(tmp_path))
    assert [(r.data, r.label) for r in fast] == \
        [(r.data, r.label) for r in slow]


# --------------------------------------------------------------------- #
# tokenizer                                                             #
# --------------------------------------------------------------------- #
TOKEN_CASES = [
    "Hello, world!",
    "it's 42 degrees... really?!",
    "a+b=c; x_y [z] {w} 'quoted' don't",
    "tabs\tand\nnewlines  multiple   spaces",
    "unicode: café naïve — dash µm",
    "",
    "'''",
    "ALLCAPS lower 0123456789",
    "a\xa0b nbsp",
    "em space en space thin space",
    "line sep para sep nel\x85done",
    "fs\x1cgs\x1drs\x1eus\x1fend",
    "ideographic　space ogham mark",
    "narrow nbsp math space zero​widthish",
]


def test_tokenizer_matches_the_regex_and_the_reference():
    from bigdl_tpu_torch.dataset.text import SentenceTokenizer
    pat = SentenceTokenizer._pat
    assert pat.pattern == re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9]").pattern
    lib, ref = native.get(), _ref_lib()
    for s in TOKEN_CASES:
        low = s.lower()
        assert lib.tokenize(low) == pat.findall(low) == ref.tokenize(low), s


def test_tokenizer_transformer_takes_the_library(monkeypatch):
    from bigdl_tpu_torch.dataset.text import SentenceTokenizer
    calls = []
    real = native.lib.tokenize
    monkeypatch.setattr(native.lib, "tokenize",
                        lambda s: calls.append(s) or real(s))
    toks = SentenceTokenizer().transform_one("The quick (brown) fox!")
    assert toks == ["the", "quick", "(", "brown", ")", "fox", "!"]
    assert calls == ["the quick (brown) fox!"]


# --------------------------------------------------------------------- #
# image batcher                                                         #
# --------------------------------------------------------------------- #
def test_crop_flip_pack_matches_python_and_the_reference():
    rng = np.random.RandomState(0)
    stored, crop, batch = 12, 8, 24
    records = [rng.randint(0, 256, size=(stored, stored, 3), dtype=np.uint8)
               for _ in range(batch)]
    cys = rng.randint(0, stored - crop + 1, size=batch)
    cxs = rng.randint(0, stored - crop + 1, size=batch)
    flips = rng.randint(0, 2, size=batch).astype(np.uint8)
    raw = [r.tobytes() for r in records]
    got = native.get().crop_flip_pack(raw, stored, stored, crop, cys, cxs,
                                      flips, n_threads=3)
    assert got.shape == (batch, crop, crop, 3) and got.dtype == np.uint8
    for b in range(batch):
        want = records[b][cys[b]:cys[b] + crop, cxs[b]:cxs[b] + crop]
        np.testing.assert_array_equal(got[b],
                                      want[:, ::-1] if flips[b] else want)
    np.testing.assert_array_equal(
        got, _ref_lib().crop_flip_pack(raw, stored, stored, crop, cys, cxs,
                                       flips, n_threads=3))
    one = native.get().crop_flip_pack(raw, stored, stored, crop, cys, cxs,
                                      flips, n_threads=1)
    np.testing.assert_array_equal(one, got)


def test_crop_flip_pack_guards_its_pointers():
    lib = native.get()
    good = bytes(12 * 12 * 3)
    with pytest.raises(ValueError, match="expected"):
        lib.crop_flip_pack([good, good[:-1]], 12, 12, 8, [0, 0], [0, 0],
                           [0, 0])
    with pytest.raises(ValueError, match="out of bounds"):
        lib.crop_flip_pack([good], 12, 12, 8, [5], [0], [0])
    with pytest.raises(ValueError, match="out of bounds"):
        lib.crop_flip_pack([good], 12, 12, 8, [-1], [0], [0])


def test_crop_flip_pack_releases_the_interpreter_lock():
    """A Python thread keeps running while a batch packs: ctypes drops
    the lock around the call."""
    stored, crop, batch = 512, 448, 64
    rec = bytes(np.random.RandomState(0).randint(
        0, 256, size=stored * stored * 3, dtype=np.uint8))
    ticks, stop = [0], threading.Event()

    def spin():
        while not stop.is_set():
            ticks[0] += 1

    t = threading.Thread(target=spin)
    t.start()
    try:
        before = ticks[0]
        for _ in range(5):
            native.get().crop_flip_pack([rec] * batch, stored, stored, crop,
                                        [0] * batch, [0] * batch,
                                        [1] * batch, n_threads=1)
        during = ticks[0] - before
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and during > 0


# --------------------------------------------------------------------- #
# build and switch                                                      #
# --------------------------------------------------------------------- #
def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.load(src)
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*"))


def test_concurrent_builds_all_load(tmp_path, monkeypatch):
    """Builders racing for one library each write their own file and
    rename it into place; every one loads a whole library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    results, errors = [], []

    def one():
        try:
            results.append(native.load().bt_crc32c(b"123456789", 9, 0))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and results == [0xE3069283] * 3
    assert [p.suffix for p in (tmp_path / "_build").iterdir()] == [".so"]


def test_no_native_takes_the_python_paths(tmp_path, monkeypatch):
    from bigdl_tpu_torch.dataset import seqfile, text
    from bigdl_tpu_torch.dataset.hadoop_seqfile import (file_records,
                                                        write_sequence_file)

    def refuse(*a, **k):
        raise AssertionError("the library was called")

    for name in ("crc32c", "mt_new", "tokenize", "shard_index",
                 "hadoop_seq_index", "crop_flip_pack"):
        monkeypatch.setattr(native.lib, name, refuse)
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    assert native.get() is None
    assert RandomGenerator(1)._native is None
    assert crc.crc32c(b"123456789") == 0xE3069283
    assert text.SentenceTokenizer().transform_one("A b.") == ["a", "b", "."]
    p = str(tmp_path / "s-0")
    seqfile.write_shard(p, [ByteRecord(b"abc", 1.0)])
    assert [r.data for r in seqfile.read_shard(p)] == [b"abc"]
    write_sequence_file(str(tmp_path / "a.seq"), [(b"2", b"xy")])
    assert [(r.data, r.label) for r in file_records(
        str(tmp_path / "a.seq"))] == [(b"xy", 2.0)]
