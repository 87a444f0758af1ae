"""Protobuf-compatible wire codec for OpenDLV messages: a copy of
`tpuslam.io.proto`.

Re-implements libcluon's ToProtoVisitor/FromProtoVisitor wire format
(reference src/cluon-complete-build.hpp:5543-5840, impl :9850+):
- signed ints -> zigzag + varint; unsigned ints -> plain varint
- float -> 4-byte LE (wire type 5); double -> 8-byte LE (wire type 1)
- string/bytes/nested message -> length-delimited (wire type 2)
- key = (field_id << 3) | wire_type, varint-encoded

Interoperates byte-for-byte with real `.rec` logs and live OD4 sessions.
A native C++ fast path (`tpuslam_torch.native`) handles bulk decode; this
module is the reference implementation and fallback.
"""
from __future__ import annotations

import struct

from tpuslam_torch.io import messages as M

WT_VARINT = 0
WT_EIGHT_BYTES = 1
WT_LENGTH_DELIMITED = 2
WT_FOUR_BYTES = 5

_WIRE_TYPE = {
    M.VARINT_SIGNED: WT_VARINT,
    M.VARINT_UNSIGNED: WT_VARINT,
    M.FLOAT: WT_FOUR_BYTES,
    M.DOUBLE: WT_EIGHT_BYTES,
    M.STRING: WT_LENGTH_DELIMITED,
    M.MESSAGE: WT_LENGTH_DELIMITED,
}


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def write_varint(out: bytearray, v: int):
    v &= (1 << 64) - 1
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def encode(msg) -> bytes:
    """Encode a message dataclass (with FIELDS spec) to proto wire bytes."""
    out = bytearray()
    for fid, kind, name, nested in msg.FIELDS:
        v = getattr(msg, name)
        write_varint(out, (fid << 3) | _WIRE_TYPE[kind])
        if kind == M.VARINT_SIGNED:
            write_varint(out, zigzag_encode(int(v)))
        elif kind == M.VARINT_UNSIGNED:
            write_varint(out, int(v))
        elif kind == M.FLOAT:
            out += struct.pack("<f", float(v))
        elif kind == M.DOUBLE:
            out += struct.pack("<d", float(v))
        elif kind == M.STRING:
            data = v.encode() if isinstance(v, str) else bytes(v)
            write_varint(out, len(data))
            out += data
        elif kind == M.MESSAGE:
            data = encode(v)
            write_varint(out, len(data))
            out += data
    return bytes(out)


def _skip(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == WT_VARINT:
        _, pos = read_varint(buf, pos)
    elif wire_type == WT_EIGHT_BYTES:
        pos += 8
    elif wire_type == WT_FOUR_BYTES:
        pos += 4
    elif wire_type == WT_LENGTH_DELIMITED:
        ln, pos = read_varint(buf, pos)
        pos += ln
    else:
        raise ValueError(f"unknown wire type {wire_type}")
    return pos


def decode(cls, buf: bytes):
    """Decode wire bytes into a message dataclass; unknown fields skipped."""
    msg = cls()
    by_id = {fid: (kind, name, nested) for fid, kind, name, nested in cls.FIELDS}
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        fid, wt = key >> 3, key & 0x7
        if fid not in by_id:
            pos = _skip(buf, pos, wt)
            continue
        kind, name, nested = by_id[fid]
        if kind == M.VARINT_SIGNED:
            raw, pos = read_varint(buf, pos)
            setattr(msg, name, zigzag_decode(raw))
        elif kind == M.VARINT_UNSIGNED:
            raw, pos = read_varint(buf, pos)
            setattr(msg, name, raw)
        elif kind == M.FLOAT:
            setattr(msg, name, struct.unpack_from("<f", buf, pos)[0])
            pos += 4
        elif kind == M.DOUBLE:
            setattr(msg, name, struct.unpack_from("<d", buf, pos)[0])
            pos += 8
        elif kind == M.STRING:
            ln, pos = read_varint(buf, pos)
            setattr(msg, name, bytes(buf[pos:pos + ln]))
            pos += ln
        elif kind == M.MESSAGE:
            ln, pos = read_varint(buf, pos)
            setattr(msg, name, decode(nested, buf[pos:pos + ln]))
            pos += ln
    return msg
