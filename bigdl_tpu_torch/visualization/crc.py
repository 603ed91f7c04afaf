"""CRC32C (Castagnoli) + TensorFlow's masked CRC (port of
``bigdl_tpu/visualization/crc.py``).

tfevents records are framed as ``len + masked_crc(len) + payload +
masked_crc(payload)`` where ``masked = ((crc >> 15 | crc << 17) +
0xa282ead8) & 0xffffffff``.  The port has no native library yet, so the
table-driven pure-Python path is the only one: the reference takes the
same path when its native library is not built.
"""
from __future__ import annotations

_POLY = 0x82F63B78  # reflected Castagnoli polynomial

def _make_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table

_TABLE = _make_table()


def crc32c_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    return crc32c_py(data, crc)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
