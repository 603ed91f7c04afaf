"""Hand-rolled protobuf wire codec for the TensorBoard ``Event`` schema (port of
``bigdl_tpu/visualization/proto.py``).

The reference vendors 17,999 LoC of *generated* Java protos
(``spark/visualization/src/main/java/org/tensorflow/...``); only a tiny
subset is actually used (Event{wall_time, step, file_version, summary},
Summary{value: [tag, simple_value | histo]}, HistogramProto).  Rather than
a codegen step, this module encodes/decodes exactly that subset directly in
the protobuf wire format — ~150 lines instead of 18k.

Field numbers follow tensorflow's event.proto / summary.proto:
  Event: wall_time=1(double) step=2(int64) file_version=3(string) summary=5(msg)
  Summary: value=1(repeated msg); Value: tag=1(string) simple_value=2(float)
  histo=5(msg); HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (double)
  bucket_limit=6(packed double) bucket=7(packed double)
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional


# ------------------------------- encoding ------------------------------- #

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_num: int, wire_type: int) -> bytes:
    return _varint((field_num << 3) | wire_type)


def _f64(field_num: int, v: float) -> bytes:
    return _tag(field_num, 1) + struct.pack("<d", v)


def _f32(field_num: int, v: float) -> bytes:
    return _tag(field_num, 5) + struct.pack("<f", v)


def _int(field_num: int, v: int) -> bytes:
    return _tag(field_num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field_num: int, v: bytes) -> bytes:
    return _tag(field_num, 2) + _varint(len(v)) + v


def _packed_f64(field_num: int, vs) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in vs)
    return _bytes(field_num, payload)


@dataclass
class HistogramProto:
    min: float = 0.0
    max: float = 0.0
    num: float = 0.0
    sum: float = 0.0
    sum_squares: float = 0.0
    bucket_limit: List[float] = field(default_factory=list)
    bucket: List[float] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        out += _f64(1, self.min) + _f64(2, self.max) + _f64(3, self.num)
        out += _f64(4, self.sum) + _f64(5, self.sum_squares)
        if self.bucket_limit:
            out += _packed_f64(6, self.bucket_limit)
        if self.bucket:
            out += _packed_f64(7, self.bucket)
        return out


@dataclass
class SummaryValue:
    tag: str = ""
    simple_value: Optional[float] = None
    histo: Optional[HistogramProto] = None

    def encode(self) -> bytes:
        out = _bytes(1, self.tag.encode("utf-8"))
        if self.simple_value is not None:
            out += _f32(2, self.simple_value)
        if self.histo is not None:
            out += _bytes(5, self.histo.encode())
        return out


@dataclass
class Event:
    wall_time: float = 0.0
    step: int = 0
    file_version: Optional[str] = None
    values: List[SummaryValue] = field(default_factory=list)

    def encode(self) -> bytes:
        out = _f64(1, self.wall_time)
        if self.step:
            out += _int(2, self.step)
        if self.file_version is not None:
            out += _bytes(3, self.file_version.encode("utf-8"))
        if self.values:
            summary = b"".join(_bytes(1, v.encode()) for v in self.values)
            out += _bytes(5, summary)
        return out


# ------------------------------- decoding ------------------------------- #

def _read_varint(buf: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_num, wire_type, value_bytes_or_int) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos:pos + 4]
            pos += 4
        else:  # groups unsupported / unused
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, v


def decode_event(buf: bytes) -> Event:
    ev = Event()
    for fnum, wt, v in _iter_fields(buf):
        if fnum == 1 and wt == 1:
            ev.wall_time = struct.unpack("<d", v)[0]
        elif fnum == 2 and wt == 0:
            ev.step = v
        elif fnum == 3 and wt == 2:
            ev.file_version = v.decode("utf-8", "replace")
        elif fnum == 5 and wt == 2:
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:
                    ev.values.append(_decode_value(v2))
    return ev


def _decode_value(buf: bytes) -> SummaryValue:
    val = SummaryValue()
    for fnum, wt, v in _iter_fields(buf):
        if fnum == 1 and wt == 2:
            val.tag = v.decode("utf-8", "replace")
        elif fnum == 2 and wt == 5:
            val.simple_value = struct.unpack("<f", v)[0]
        elif fnum == 5 and wt == 2:
            val.histo = _decode_histo(v)
    return val


def _decode_histo(buf: bytes) -> HistogramProto:
    h = HistogramProto()
    for fnum, wt, v in _iter_fields(buf):
        if wt == 1:
            d = struct.unpack("<d", v)[0]
            if fnum == 1:
                h.min = d
            elif fnum == 2:
                h.max = d
            elif fnum == 3:
                h.num = d
            elif fnum == 4:
                h.sum = d
            elif fnum == 5:
                h.sum_squares = d
        elif wt == 2 and fnum in (6, 7):
            vals = [struct.unpack("<d", v[i:i + 8])[0] for i in range(0, len(v), 8)]
            if fnum == 6:
                h.bucket_limit = vals
            else:
                h.bucket = vals
    return h
