"""TFRecord-style framing for tfevents files (port of
``bigdl_tpu/visualization/record.py``).

Rebuild of ``visualization/tensorboard/RecordWriter.scala:29-55``: each
record is ``uint64le(len) | uint32le(masked_crc(len_bytes)) | payload |
uint32le(masked_crc(payload))``.
"""
from __future__ import annotations

import struct
from typing import Iterator, Optional

from .crc import masked_crc32c


class RecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "ab")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_records(path: str, *, validate: bool = True) -> Iterator[bytes]:
    """Yield payloads; stops cleanly at a truncated tail (a live writer may
    be mid-record — same tolerance as the reference FileReader)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            hcrc = f.read(4)
            if len(hcrc) < 4:
                return
            if validate and struct.unpack("<I", hcrc)[0] != masked_crc32c(header):
                return  # corrupt/truncated: stop like tf's reader
            (length,) = struct.unpack("<Q", header)
            payload = f.read(length)
            if len(payload) < length:
                return
            pcrc = f.read(4)
            if len(pcrc) < 4:
                return
            if validate and struct.unpack("<I", pcrc)[0] != masked_crc32c(payload):
                return
            yield payload
