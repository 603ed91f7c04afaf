"""Packed record shards (port of ``bigdl_tpu/dataset/seqfile.py``; ref
dataset/DataSet.scala SeqFileFolder :380-433 and the writer
dataset/image/BGRImgToLocalSeqFile.scala; the generator CLI is
``models/utils/seqfile_generator.py``).

Format (little-endian), one record:
    u32 payload_len | u32 crc32(payload) | f32 label | payload bytes

after the 5-byte magic ``BTRS\\x01``.  The files are byte for byte the
JAX package's, and each package reads the other's.  Shards are
independent files, so sharding a dataset is splitting its file list.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Iterator, Sequence

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.types import ByteRecord

_HEADER = struct.Struct("<IIf")
MAGIC = b"BTRS\x01"  # record shard v1


def write_shard(path: str, records: Iterable[ByteRecord]) -> int:
    """Write records to one shard file; returns the record count."""
    n = 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        for r in records:
            payload = r.data
            f.write(_HEADER.pack(len(payload),
                                 zlib.crc32(payload) & 0xFFFFFFFF,
                                 float(r.label)))
            f.write(payload)
            n += 1
    os.replace(tmp, path)
    return n


# The epoch-persistent index cache.  A multi-epoch loop reads every
# shard again each epoch, and checking every payload's CRC again would
# dominate the host pipeline.  The first read of a file checks it all;
# a read again reuses the index while the file's signature holds:
# (mtime_ns, size) and the CRC32 of three 4 KB windows (head, middle,
# tail), so a rewrite of the same size on a filesystem with coarse
# mtimes is caught.  A flipped byte outside the windows, between the
# first read and a rewrite, is not.  BIGDL_TPU_SHARD_INDEX_CACHE=0
# checks every payload on every read.
_INDEX_CACHE: dict = {}
_INDEX_CACHE_MAX = 4096  # ~1000 ImageNet shards; a few MB of arrays


def _shard_signature(path: str, buf: bytes) -> tuple:
    st = os.stat(path)
    k = 4096
    mid = max(0, len(buf) // 2 - k // 2)
    return (st.st_mtime_ns, st.st_size,
            zlib.crc32(buf[:k]), zlib.crc32(buf[mid:mid + k]),
            zlib.crc32(buf[-k:]))


def read_shard(path: str) -> Iterator[ByteRecord]:
    """Yield a shard's records; ``ValueError`` names the file when it is
    not a shard, is truncated or fails a CRC.  The host library indexes
    the file in one pass; the Python reader below is the path under
    ``BIGDL_TPU_NO_NATIVE=1``."""
    lib = native.get()
    if lib is not None:
        with open(path, "rb") as f:
            buf = f.read()
        use_cache = os.environ.get(
            "BIGDL_TPU_SHARD_INDEX_CACHE", "1") not in ("0", "false")
        sig = _shard_signature(path, buf) if use_cache else None
        cached = _INDEX_CACHE.get(path) if use_cache else None
        if cached is not None and cached[0] == sig:
            offsets, lengths, labels = cached[1]
        else:
            try:
                offsets, lengths, labels = lib.shard_index(buf)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None
            if use_cache:
                if len(_INDEX_CACHE) >= _INDEX_CACHE_MAX:
                    _INDEX_CACHE.clear()  # crude but bounded
                _INDEX_CACHE[path] = (sig, (offsets, lengths, labels))
        for off, length, label in zip(offsets, lengths, labels):
            yield ByteRecord(buf[off:off + length], float(label))
        return
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a record shard (bad magic "
                             f"{magic!r})")
        while True:
            head = f.read(_HEADER.size)
            if not head:
                return
            if len(head) != _HEADER.size:
                raise ValueError(f"{path}: truncated record header")
            length, crc, label = _HEADER.unpack(head)
            payload = f.read(length)
            if len(payload) != length:
                raise ValueError(f"{path}: truncated record")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise ValueError(f"{path}: crc mismatch")
            yield ByteRecord(payload, label)


def write_sharded(prefix: str, records: Sequence[ByteRecord],
                  n_shards: int) -> list[str]:
    """Split records round-robin into n_shards files <prefix>-NNNNN."""
    paths = [f"{prefix}-{i:05d}" for i in range(n_shards)]
    for i, p in enumerate(paths):
        write_shard(p, records[i::n_shards])
    return paths
