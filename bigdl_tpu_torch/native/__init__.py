"""ctypes bindings for the port's host library (``csrc/host_native.cpp``;
port of ``bigdl_tpu/native/__init__.py``).

The library runs the data pipeline's host loops in C++: CRC32C framing,
the Torch-compatible MT19937, record-shard and Hadoop SequenceFile
indexing, the word tokenizer and the crop/flip/pack image batcher.  It
runs on the CPU, never on the card.

It builds at first use with

    g++ -O3 -fPIC -shared -std=c++17 -pthread -o <lib> csrc/host_native.cpp

into ``bigdl_tpu_torch/_build/host_native-<hash>.so`` (listed in
``.gitignore``); the hash covers the source and the flags, so an edited
source builds anew.  Each build writes a file of its own process and
renames it into place, so processes that build at once never load half
a file.

Unlike the JAX package, a failed build or load raises (with the
compiler's output) rather than handing every caller its Python path.
Only ``BIGDL_TPU_NO_NATIVE=1`` selects the Python paths, which stay in
each calling module beside the native call as the tests' oracle.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_native.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()


def library_path(source: Path = SOURCE) -> Path:
    """The built library's path, named by a hash of the source and the
    flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library is built; returns the
    library's path.  Raises ``RuntimeError`` with the compiler's output
    when ``g++`` fails."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees half a file
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


def _set_prototypes(dll: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    # c_char_p: C never writes through these, so bytes pass zero-copy
    dll.bt_crc32c.restype = ctypes.c_uint32
    dll.bt_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
    dll.bt_crc32.restype = ctypes.c_uint32
    dll.bt_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
    dll.bt_mt_new.restype = ctypes.c_void_p
    dll.bt_mt_new.argtypes = [ctypes.c_uint64]
    dll.bt_mt_free.restype = None
    dll.bt_mt_free.argtypes = [ctypes.c_void_p]
    dll.bt_mt_set_seed.restype = None
    dll.bt_mt_set_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    dll.bt_mt_random.restype = ctypes.c_double
    dll.bt_mt_random.argtypes = [ctypes.c_void_p]
    dll.bt_mt_random_int.restype = ctypes.c_uint32
    dll.bt_mt_random_int.argtypes = [ctypes.c_void_p]
    for name in ("bt_mt_uniform", "bt_mt_normal"):
        fn = getattr(dll, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64,
                       ctypes.c_double, ctypes.c_double]
    dll.bt_mt_bernoulli.restype = None
    dll.bt_mt_bernoulli.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64,
                                    ctypes.c_double]
    dll.bt_mt_randperm.restype = None
    dll.bt_mt_randperm.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
    dll.bt_mt_get_state.restype = None
    dll.bt_mt_get_state.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint32), i32p,
                                    f64p, i32p]
    dll.bt_mt_set_state.restype = None
    dll.bt_mt_set_state.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.c_int32, ctypes.c_double,
                                    ctypes.c_int32]
    dll.bt_shard_index.restype = ctypes.c_int64
    dll.bt_shard_index.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p,
                                   i64p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, ctypes.c_int32]
    dll.bt_hadoop_seq_index.restype = ctypes.c_int64
    dll.bt_hadoop_seq_index.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        i64p, i64p,
                                        ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_int64]
    dll.bt_crop_flip_pack.restype = None
    dll.bt_crop_flip_pack.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
        u8p, u8p, ctypes.c_int32]
    dll.bt_tokenize.restype = ctypes.c_int64
    dll.bt_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p,
                                ctypes.c_int64]
    dll.bt_tokenize_join.restype = ctypes.c_int64
    dll.bt_tokenize_join.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int64]
    return dll


def load(source: Path = SOURCE) -> ctypes.CDLL:
    """Build (if needed) and load the library with every prototype set.
    ``ctypes.CDLL`` releases the interpreter lock around each call, so
    a long native call (the batcher) never stalls other Python threads."""
    path = build(source)
    try:
        return _set_prototypes(ctypes.CDLL(str(path)))
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"cannot load the host library {path}: {e}") \
            from e


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class _Lib:
    """The loaded library behind typed Python methods; the library is
    built and loaded at the first use of ``dll``."""

    def __init__(self):
        self._dll = None

    @property
    def dll(self) -> ctypes.CDLL:
        if self._dll is None:
            with _lock:
                if self._dll is None:
                    self._dll = load()
        return self._dll

    # -- crc ------------------------------------------------------------ #
    def crc32c(self, data: bytes, crc: int = 0) -> int:
        return int(self.dll.bt_crc32c(bytes(data), len(data), crc))

    # -- rng ------------------------------------------------------------ #
    def mt_new(self, seed: int) -> int:
        return self.dll.bt_mt_new(seed & 0xFFFFFFFFFFFFFFFF)

    def mt_free(self, handle) -> None:
        self.dll.bt_mt_free(handle)

    def mt_set_seed(self, handle, seed: int) -> None:
        self.dll.bt_mt_set_seed(handle, seed & 0xFFFFFFFFFFFFFFFF)

    def mt_random(self, handle) -> float:
        return float(self.dll.bt_mt_random(handle))

    def mt_random_int(self, handle) -> int:
        return int(self.dll.bt_mt_random_int(handle))

    def mt_uniform(self, handle, n: int, a: float, b: float) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self.dll.bt_mt_uniform(handle, _ptr(out, ctypes.c_double), n, a, b)
        return out

    def mt_normal(self, handle, n: int, mean: float,
                  stdv: float) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self.dll.bt_mt_normal(handle, _ptr(out, ctypes.c_double), n, mean,
                              stdv)
        return out

    def mt_bernoulli(self, handle, n: int, p: float) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self.dll.bt_mt_bernoulli(handle, _ptr(out, ctypes.c_double), n, p)
        return out

    def mt_randperm(self, handle, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        self.dll.bt_mt_randperm(handle, _ptr(out, ctypes.c_int64), n)
        return out

    def mt_get_state(self, handle):
        """(624 state words, index, cached normal, has-cached flag)."""
        mt = (ctypes.c_uint32 * 624)()
        mti = ctypes.c_int32()
        cached = ctypes.c_double()
        has = ctypes.c_int32()
        self.dll.bt_mt_get_state(handle, mt, ctypes.byref(mti),
                                 ctypes.byref(cached), ctypes.byref(has))
        return list(mt), mti.value, cached.value, has.value

    def mt_set_state(self, handle, mt, mti, cached, has) -> None:
        arr = (ctypes.c_uint32 * 624)(*[int(x) & 0xFFFFFFFF for x in mt])
        self.dll.bt_mt_set_state(handle, arr, mti, cached, has)

    # -- image batcher --------------------------------------------------- #
    def crop_flip_pack(self, records, stored_h: int, stored_w: int,
                       crop: int, cys, cxs, flips,
                       n_threads: int = 0) -> np.ndarray:
        """Crop/flip/pack HWC uint8 image records into one (B, crop,
        crop, 3) uint8 NHWC batch on native threads (ref
        MTLabeledBGRImgToBatch.scala:52-80).  ``records``: bytes of
        ``stored_h * stored_w * 3`` each, kept alive by this frame's
        ``recs`` array for the whole call."""
        batch = len(records)
        want = stored_h * stored_w * 3
        for i, r in enumerate(records):
            if len(r) != want:
                raise ValueError(
                    f"record {i} has {len(r)} bytes, expected {stored_h}x"
                    f"{stored_w}x3 = {want} (a short record would be read "
                    f"out of bounds)")
        out = np.empty((batch, crop, crop, 3), dtype=np.uint8)
        records = [bytes(r) for r in records]
        recs = (ctypes.c_char_p * batch)(*records)
        cy = np.ascontiguousarray(cys, dtype=np.int32)
        cx = np.ascontiguousarray(cxs, dtype=np.int32)
        fl = np.ascontiguousarray(flips, dtype=np.uint8)
        if not (len(cy) == len(cx) == len(fl) == batch):
            raise ValueError("one crop origin and flip a record")
        if (cy.min(initial=0) < 0 or cx.min(initial=0) < 0
                or cy.max(initial=0) + crop > stored_h
                or cx.max(initial=0) + crop > stored_w):
            raise ValueError("crop window out of bounds")
        if n_threads <= 0:
            n_threads = max(1, (os.cpu_count() or 8) // 2)
        # tiny batches don't amortize the pool's wake-up
        n_threads = min(n_threads, max(1, batch // 8))
        self.dll.bt_crop_flip_pack(
            recs, batch, stored_h, stored_w, crop,
            _ptr(cy, ctypes.c_int32), _ptr(cx, ctypes.c_int32),
            _ptr(fl, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), n_threads)
        return out

    # -- indexing -------------------------------------------------------- #
    def shard_index(self, buf, validate: bool = True):
        """(offsets, lengths, labels) of a whole record shard's bytes;
        raises ``ValueError`` on malformed input or a CRC mismatch."""
        data = bytes(buf)
        # a record is >= 12 header bytes (its payload may be empty)
        max_n = max((len(data) - 5) // 12, 1)
        offsets = np.empty(max_n, dtype=np.int64)
        lengths = np.empty(max_n, dtype=np.int64)
        labels = np.empty(max_n, dtype=np.float32)
        n = self.dll.bt_shard_index(
            data, len(data), _ptr(offsets, ctypes.c_int64),
            _ptr(lengths, ctypes.c_int64), _ptr(labels, ctypes.c_float),
            max_n, 1 if validate else 0)
        if n == -1:
            raise ValueError("malformed record shard")
        if n == -2:
            raise ValueError("record shard crc mismatch")
        if n == -3:  # cannot happen with the sizing above
            raise ValueError("record shard index overflow")
        return offsets[:n], lengths[:n], labels[:n]

    def hadoop_seq_index(self, buf):
        """(value offsets, value lengths, labels) of a whole Text/Text
        SequenceFile's bytes.  Raises ``ValueError`` on malformed input
        and ``NotImplementedError`` on a flavor the indexer does not
        read (compression, other classes, version < 6), which the
        Python reader then takes."""
        data = bytes(buf)
        # a record is >= 10 bytes (reclen + keylen + 1-byte key + 1-byte
        # value vints)
        max_n = max(len(data) // 10, 1)
        offsets = np.empty(max_n, dtype=np.int64)
        lengths = np.empty(max_n, dtype=np.int64)
        labels = np.empty(max_n, dtype=np.float32)
        n = self.dll.bt_hadoop_seq_index(
            data, len(data), _ptr(offsets, ctypes.c_int64),
            _ptr(lengths, ctypes.c_int64), _ptr(labels, ctypes.c_float),
            max_n)
        if n == -1:
            raise ValueError("malformed SequenceFile")
        if n == -3:
            raise ValueError("SequenceFile index overflow")
        if n == -4:
            raise NotImplementedError("unsupported SequenceFile flavor")
        if n == -5:
            raise ValueError("SequenceFile key has a non-numeric label")
        return offsets[:n], lengths[:n], labels[:n]

    # -- tokenizer ------------------------------------------------------- #
    def tokenize(self, text: str) -> list:
        """Word tokens of an (already lower-cased) string, the C twin of
        ``dataset/text.py`` ``SentenceTokenizer``'s regex: runs of word
        characters as one token, any other single code point as one.
        The tokens come back newline-joined in one buffer."""
        data = text.encode("utf-8")
        if not data:
            return []
        cap = 2 * len(data)
        out = ctypes.create_string_buffer(cap)
        n = self.dll.bt_tokenize_join(data, len(data), out, cap)
        if n < 0:  # cannot happen with cap = 2x the byte count
            raise ValueError("tokenizer overflow")
        if n == 0:
            return []
        return out.raw[:n].decode("utf-8", "replace").split("\n")


lib = _Lib()


def get() -> _Lib | None:
    """The single gate every caller uses: the loaded library, or None
    when ``BIGDL_TPU_NO_NATIVE=1`` selects the Python paths.  The first
    call builds and loads the library and raises if that fails."""
    if os.environ.get("BIGDL_TPU_NO_NATIVE") in ("1", "true"):
        return None
    lib.dll
    return lib
