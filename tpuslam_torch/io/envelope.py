"""OD4 envelope framing + pack/unpack helpers: a copy of
`tpuslam.io.envelope`.

Wire frame (reference src/cluon-complete-build.hpp:6868-6957, magic at
:6904-6906): `0x0D 0xA4 LEN0 LEN1 LEN2` — little-endian 24-bit length of the
proto-encoded cluon::data::Envelope that follows. Identical framing keeps us
interoperable with real `.rec` recordings and live OD4 buses.
"""
from __future__ import annotations

import time
from typing import Iterator, Optional

from tpuslam_torch.io import messages as M
from tpuslam_torch.io import proto

MAGIC0 = 0x0D
MAGIC1 = 0xA4
HEADER_LEN = 5

__all__ = ["serialize_envelope", "extract_envelope", "iterate_envelopes",
           "pack_message", "unpack_message", "now_us", "HEADER_LEN"]


def now_us() -> int:
    return time.time_ns() // 1000


def serialize_envelope(env: M.Envelope) -> bytes:
    payload = proto.encode(env)
    n = len(payload)
    if n >= 1 << 24:
        raise ValueError("envelope too large for 24-bit frame length")
    return bytes([MAGIC0, MAGIC1, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF]) \
        + payload


def extract_envelope(buf: bytes, pos: int = 0) -> tuple[Optional[M.Envelope], int]:
    """Parse one envelope at/after `pos`; returns (envelope|None, new_pos).

    Resynchronizes on the magic bytes like the reference decoder
    (cluon src/cluon-complete-build.hpp:6911-6957).
    """
    end = len(buf)
    while pos + HEADER_LEN <= end:
        if buf[pos] == MAGIC0 and buf[pos + 1] == MAGIC1:
            n = buf[pos + 2] | (buf[pos + 3] << 8) | (buf[pos + 4] << 16)
            if pos + HEADER_LEN + n > end:
                return None, pos  # incomplete; caller buffers more
            payload = buf[pos + HEADER_LEN: pos + HEADER_LEN + n]
            return proto.decode(M.Envelope, payload), pos + HEADER_LEN + n
        pos += 1
    return None, pos


def iterate_envelopes(buf: bytes) -> Iterator[M.Envelope]:
    pos = 0
    while True:
        env, pos = extract_envelope(buf, pos)
        if env is None:
            return
        yield env


def pack_message(msg, sample_us: Optional[int] = None, sender_stamp: int = 0,
                 sent_us: Optional[int] = None) -> M.Envelope:
    """Message -> Envelope, stamping times like OD4Session::send
    (reference src/cluon-complete-build.hpp:7808-7826)."""
    sent = now_us() if sent_us is None else sent_us
    return M.Envelope(
        dataType=msg.ID,
        serializedData=proto.encode(msg),
        sent=M.TimeStamp.from_micros(sent),
        sampleTimeStamp=M.TimeStamp.from_micros(
            sent if sample_us is None else sample_us),
        senderStamp=sender_stamp,
    )


def unpack_message(env: M.Envelope):
    """Envelope -> typed message (GenericMessage for unknown dataTypes)."""
    cls = M.MESSAGE_REGISTRY.get(env.dataType)
    data = env.serializedData
    if isinstance(data, str):
        data = data.encode("latin-1")
    if cls is None or cls in (M.Envelope,):
        return M.GenericMessage(dataType=env.dataType, values={"raw": data})
    return proto.decode(cls, data)
