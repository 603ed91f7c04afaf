"""Hadoop SequenceFile reader and writer for the reference's ImageNet
layout (port of ``bigdl_tpu/dataset/hadoop_seqfile.py``).

The reference stores preprocessed ImageNet as Hadoop SequenceFiles of
(Text key, Text value): key = "<label>" or "<name>\\n<label>"
(dataset/image/BGRImgToLocalSeqFile.scala:46-78, readLabel/readName in
dataset/DataSet.scala:397-417), value = 4-byte big-endian width + height
followed by H*W*3 BGR uint8 pixels.  This module reads (and writes) that
exact on-disk format with no Hadoop dependency; the files are byte for
byte the JAX package's.  ``dataset/seqfile.py`` is the repo's own shard
format.

Format notes (uncompressed SequenceFile version 6):
  header:  b"SEQ" + version byte; key/value class names as vint-length
           UTF-8 strings; bool compressed; bool block-compressed;
           int32 metadata-pair count + pairs; 16-byte sync marker.
  records: int32 record-length (key+value serialized bytes),
           int32 key-length, key bytes, value bytes.  A record-length of
           -1 is a sync escape followed by the 16-byte sync marker.
  Text serialization = vint byte-length + raw bytes (Hadoop
  WritableUtils vint: one byte for -112..127, else a length prefix).

A malformed file raises ``ValueError`` naming it, from either reader.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.dataset.types import ByteRecord, LabeledImage
from bigdl_tpu_torch.utils import fs

MAGIC = b"SEQ"
TEXT_CLASS = "org.apache.hadoop.io.Text"
DEFAULT_CODEC = "org.apache.hadoop.io.compress.DefaultCodec"


def _zlib_decompress(data: bytes) -> bytes:
    return zlib.decompress(data)


def _gzip_decompress(data: bytes) -> bytes:
    import gzip
    return gzip.decompress(data)


def _bz2_decompress(data: bytes) -> bytes:
    import bz2
    return bz2.decompress(data)


#: codec class -> decompressor; DefaultCodec is zlib-framed deflate
_CODECS = {
    DEFAULT_CODEC: _zlib_decompress,
    "org.apache.hadoop.io.compress.GzipCodec": _gzip_decompress,
    "org.apache.hadoop.io.compress.BZip2Codec": _bz2_decompress,
}


# --------------------------------------------------------------------- #
# Hadoop vint / Text codecs                                             #
# --------------------------------------------------------------------- #
def _read_vint(f) -> int:
    b = struct.unpack("b", f.read(1))[0]
    if -112 <= b <= 127:
        return b
    neg = b < -120
    n = -(b + 120) if neg else -(b + 112)
    val = 0
    for _ in range(n):
        val = (val << 8) | f.read(1)[0]
    return ~val if neg else val


def _write_vint(f, value: int) -> None:
    if -112 <= value <= 127:
        f.write(struct.pack("b", value))
        return
    neg = value < 0
    if neg:
        value = ~value
    length = (value.bit_length() + 7) // 8
    f.write(struct.pack("b", (-120 if neg else -112) - length))
    f.write(value.to_bytes(length, "big"))


def _read_text(f) -> bytes:
    return f.read(_read_vint(f))


def _write_text(f, data: bytes) -> None:
    _write_vint(f, len(data))
    f.write(data)


# --------------------------------------------------------------------- #
# SequenceFile container                                                #
# --------------------------------------------------------------------- #
def read_sequence_file(path: str, data: Optional[bytes] = None
                       ) -> Iterator[tuple[bytes, bytes]]:
    """Yield raw (key, value) byte pairs from a Text/Text SequenceFile
    (uncompressed, record- or block-compressed with a standard codec).
    ``data`` supplies already-read file bytes so callers that loaded the
    file for other reasons don't pay the I/O twice."""
    if data is None:
        with fs.open_file(path, "rb") as fh:
            data = fh.read()
    try:
        yield from _read_records(path, data)
    except (struct.error, IndexError, EOFError, OSError,
            UnicodeDecodeError, zlib.error) as e:
        raise ValueError(f"{path}: malformed SequenceFile ({e!r})") from None


def _read_records(path: str, data: bytes) -> Iterator[tuple[bytes, bytes]]:
    f = io.BytesIO(data)
    if f.read(3) != MAGIC:
        raise ValueError(f"{path}: not a SequenceFile (bad magic)")
    version = f.read(1)[0]
    if version < 6:
        raise ValueError(f"{path}: SequenceFile version {version} < 6 "
                         f"is not supported")
    key_cls = _read_text(f).decode()
    val_cls = _read_text(f).decode()
    if key_cls != TEXT_CLASS or val_cls != TEXT_CLASS:
        raise ValueError(f"{path}: expected Text/Text records, got "
                         f"{key_cls}/{val_cls}")
    compressed = f.read(1)[0] != 0
    block_compressed = f.read(1)[0] != 0
    decomp = None
    if compressed or block_compressed:
        # the reference only ever writes uncompressed files
        # (BGRImgToLocalSeqFile.scala), but real-world Hadoop ImageNet
        # dumps are often record/block compressed with the default codec —
        # support the standard codecs so those migrate too.
        codec_cls = _read_text(f).decode()
        decomp = _CODECS.get(codec_cls)
        if decomp is None:
            raise ValueError(f"{path}: unsupported compression codec "
                             f"{codec_cls} (supported: {sorted(_CODECS)})")
    (n_meta,) = struct.unpack(">i", f.read(4))
    for _ in range(n_meta):
        _read_text(f)
        _read_text(f)
    sync = f.read(16)

    if block_compressed:
        yield from _read_block_compressed(f, sync, decomp, path)
        return

    while True:
        head = f.read(4)
        if not head:
            return
        (rec_len,) = struct.unpack(">i", head)
        if rec_len == -1:  # sync escape
            marker = f.read(16)
            if marker != sync:
                raise ValueError(f"{path}: corrupt sync marker")
            continue
        (key_len,) = struct.unpack(">i", f.read(4))
        payload = f.read(rec_len)
        if rec_len < 0 or len(payload) != rec_len or not \
                0 <= key_len <= rec_len:
            raise ValueError(f"{path}: truncated or corrupt record")
        kf = io.BytesIO(payload[:key_len])
        yield _read_text(kf), _read_text(
            io.BytesIO(decomp(payload[key_len:]) if decomp
                       else payload[key_len:]))


def _read_block_compressed(f, sync: bytes, decomp, path: str
                           ) -> Iterator[tuple[bytes, bytes]]:
    """Block-compressed record stream: each block is a sync escape followed
    by a record count and four length-prefixed compressed buffers
    (key-lengths, keys, value-lengths, values); the length buffers hold
    vints of each record's *serialized* key/value size."""

    def split(lengths_buf: bytes, data_buf: bytes, n: int) -> list[bytes]:
        lf, df, out = io.BytesIO(lengths_buf), io.BytesIO(data_buf), []
        for _ in range(n):
            out.append(df.read(_read_vint(lf)))
        return out

    while True:
        head = f.read(4)
        if not head:
            return
        (escape,) = struct.unpack(">i", head)
        if escape != -1 or f.read(16) != sync:
            raise ValueError(f"{path}: corrupt block sync")
        probe = f.read(1)
        if not probe:
            return
        f.seek(-1, io.SEEK_CUR)
        n_records = _read_vint(f)
        bufs = [decomp(f.read(_read_vint(f))) for _ in range(4)]
        keys = split(bufs[0], bufs[1], n_records)
        values = split(bufs[2], bufs[3], n_records)
        for k_ser, v_ser in zip(keys, values):
            yield (_read_text(io.BytesIO(k_ser)),
                   _read_text(io.BytesIO(v_ser)))


def write_sequence_file(path: str, records: Sequence[tuple[bytes, bytes]],
                        sync_interval: int = 64,
                        compression: Optional[str] = None) -> None:
    """Write raw (key, value) byte pairs as a Text/Text SequenceFile
    readable by Hadoop and by ``read_sequence_file``.  ``compression`` is
    None (the reference's own flavor), "record", or "block" — compressed
    flavors use the default codec (zlib deflate)."""
    if compression not in (None, "record", "block"):
        raise ValueError(f"compression must be None/'record'/'block', "
                         f"got {compression!r}")
    sync = np.random.RandomState(len(records)).bytes(16)
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(bytes([6]))
    _write_text(out, TEXT_CLASS.encode())
    _write_text(out, TEXT_CLASS.encode())
    out.write(bytes([1 if compression else 0,
                     1 if compression == "block" else 0]))
    if compression:
        _write_text(out, DEFAULT_CODEC.encode())
    out.write(struct.pack(">i", 0))  # no metadata
    out.write(sync)

    if compression == "block":
        for start in range(0, len(records), sync_interval):
            chunk = records[start:start + sync_interval]
            klen, kdat, vlen, vdat = (io.BytesIO() for _ in range(4))
            for key, value in chunk:
                kb, vb = io.BytesIO(), io.BytesIO()
                _write_text(kb, key)
                _write_text(vb, value)
                _write_vint(klen, len(kb.getvalue()))
                kdat.write(kb.getvalue())
                _write_vint(vlen, len(vb.getvalue()))
                vdat.write(vb.getvalue())
            out.write(struct.pack(">i", -1))
            out.write(sync)
            _write_vint(out, len(chunk))
            for buf in (klen, kdat, vlen, vdat):
                blob = zlib.compress(buf.getvalue())
                _write_vint(out, len(blob))
                out.write(blob)
        fs.atomic_write(path, out.getvalue())
        return

    for i, (key, value) in enumerate(records):
        if i and i % sync_interval == 0:
            out.write(struct.pack(">i", -1))
            out.write(sync)
        kb, vb = io.BytesIO(), io.BytesIO()
        _write_text(kb, key)
        _write_text(vb, value)
        kser, vser = kb.getvalue(), vb.getvalue()
        if compression == "record":
            vser = zlib.compress(vser)
        out.write(struct.pack(">i", len(kser) + len(vser)))
        out.write(struct.pack(">i", len(kser)))
        out.write(kser)
        out.write(vser)
    fs.atomic_write(path, out.getvalue())


# --------------------------------------------------------------------- #
# the reference's ImageNet record layout                                #
# --------------------------------------------------------------------- #
def parse_key(key: bytes) -> tuple[Optional[str], float]:
    """(name, label) from a record key: "<label>" or "<name>\\n<label>"
    (ref SeqFileFolder.readLabel/readName, DataSet.scala:397-417)."""
    parts = key.decode().split("\n")
    if len(parts) == 1:
        return None, float(parts[0])
    return parts[0], float(parts[1])


def encode_bgr_image(img: np.ndarray) -> bytes:
    """(3, H, W) BGR float [0,255] -> width+height header + HWC bytes
    (ref BGRImgToLocalSeqFile: putInt(width) putInt(height) +
    convertToByte)."""
    _, h, w = img.shape
    hwc = np.clip(img.transpose(1, 2, 0), 0, 255).astype(np.uint8)
    return struct.pack(">ii", w, h) + hwc.tobytes()


def decode_bgr_value(value: bytes) -> np.ndarray:
    """width+height header + HWC BGR bytes -> (3, H, W) float32."""
    w, h = struct.unpack(">ii", value[:8])
    pixels = np.frombuffer(value, dtype=np.uint8, offset=8,
                           count=h * w * 3).reshape(h, w, 3)
    return np.ascontiguousarray(
        pixels.transpose(2, 0, 1)).astype(np.float32)


def file_records(path: str) -> list[ByteRecord]:
    """One file's (value bytes, label) records: the host library's
    one-pass index of the uncompressed flavor, the Python reader for
    the compressed ones and under ``BIGDL_TPU_NO_NATIVE=1``."""
    lib = native.get()
    buf = None
    if lib is not None:
        with fs.open_file(path, "rb") as f:
            buf = f.read()
        try:
            offsets, lengths, labels = lib.hadoop_seq_index(buf)
        except NotImplementedError:
            # the native indexer reads only the uncompressed flavor; the
            # Python reader (below, reusing the bytes) knows the codecs
            pass
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        else:
            return [ByteRecord(buf[o:o + n], float(lab))
                    for o, n, lab in zip(offsets, lengths, labels)]
    return [ByteRecord(v, parse_key(k)[1])
            for k, v in read_sequence_file(path, data=buf)]


class SeqBytesToBGRImg(Transformer):
    """ByteRecord holding a SequenceFile value -> LabeledImage (3,H,W)
    BGR float (the decode stage the reference runs after reading seq
    files)."""

    def transform_one(self, r: ByteRecord) -> LabeledImage:
        return LabeledImage(decode_bgr_value(r.data), r.label)


def is_seq_value(data: bytes) -> bool:
    """True when the bytes carry the reference's SequenceFile value
    framing: a big-endian (width, height) header followed by exactly
    H*W*3 raw pixels.  Encoded images (PNG \\x89PNG, JPEG \\xff\\xd8...)
    can't satisfy the exact-length equation, so the sniff is reliable."""
    if len(data) < 8:
        return False
    w, h = struct.unpack(">ii", data[:8])
    return 0 < w <= 65536 and 0 < h <= 65536 and len(data) == 8 + w * h * 3


class AnyBytesToBGRImg(Transformer):
    """Per-RECORD image decoder: reference SequenceFile values (w/h-framed
    raw BGR) and encoded images (PNG/JPEG) both decode, so datasets that
    mix the repo's shard flavor with reference-generated .seq shards
    train through one pipeline (DataSet.record_files dispatches the
    container format per file; this dispatches the payload format per
    record)."""

    def __init__(self):
        from bigdl_tpu_torch.dataset.image import BytesToBGRImg
        self._fallback = BytesToBGRImg()

    def transform_one(self, r: ByteRecord) -> LabeledImage:
        if is_seq_value(r.data):
            return LabeledImage(decode_bgr_value(r.data), r.label)
        return self._fallback.transform_one(r)


class SeqFileFolder:
    """Factories mirroring the reference's SeqFileFolder object
    (dataset/DataSet.scala:380-433)."""

    @staticmethod
    def paths(folder: str) -> list[str]:
        out = [os.path.join(folder, f) for f in sorted(os.listdir(folder))
               if f.endswith(".seq")]
        if not out:
            raise ValueError(f"no .seq files under {folder}")
        return out

    @staticmethod
    def records(folder: str) -> list[ByteRecord]:
        """All (value bytes, label) records across the folder's files."""
        out = []
        for p in SeqFileFolder.paths(folder):
            out.extend(file_records(p))
        return out

    @staticmethod
    def write_bgr_images(images, base_path: str,
                         block_size: int = 1024,
                         has_name: bool = False) -> list[str]:
        """LabeledImage stream (or (LabeledImage, name) pairs when
        ``has_name``) -> `<base>_<i>.seq` files, byte-compatible with the
        reference's BGRImgToLocalSeqFile."""
        paths, block = [], []

        def flush():
            if block:
                p = f"{base_path}_{len(paths)}.seq"
                write_sequence_file(p, block)
                paths.append(p)
                block.clear()

        for item in images:
            img, name = item if isinstance(item, tuple) else (item, "")
            key = (f"{name}\n{int(img.label)}" if has_name
                   else f"{int(img.label)}").encode()
            block.append((key, encode_bgr_image(img.data)))
            if len(block) >= block_size:
                flush()
        flush()
        return paths
