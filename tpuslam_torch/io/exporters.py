"""Offline analysis exporters + JSON codec: .rec -> CSV / JSON-lines and back.

A copy of `tpuslam.io.exporters` (pure Python), so that the port imports nothing of
the JAX package.

Equivalents of the embedded cluon tools `cluon-rec2csv`
(reference src/cluon-complete-build.hpp:16272-16464), the
`ToJSONVisitor`/`FromJSONVisitor` pair (:6315, :6171), and both directions
of `EnvelopeConverter` (:7011 — Envelope->JSON and JSON->proto-encoded
Envelope). Exposed via `slamctl export`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional, TextIO

from tpuslam_torch.io import messages as M
from tpuslam_torch.io import envelope as E

__all__ = ["envelope_to_dict", "rec_to_jsonl", "rec_to_csv",
           "message_to_json", "message_from_json", "envelope_from_dict"]


def envelope_to_dict(env: M.Envelope) -> dict:
    msg = E.unpack_message(env)
    if isinstance(msg, M.GenericMessage):
        payload = {"raw_bytes": len(msg.values.get("raw", b""))}
        name = f"unknown_{env.dataType}"
    else:
        payload = dataclasses.asdict(msg)
        payload = {k: (v.decode("latin-1") if isinstance(v, bytes) else v)
                   for k, v in payload.items()}
        name = type(msg).__name__
    return {
        "dataType": env.dataType,
        "message": name,
        "senderStamp": env.senderStamp,
        "sampleTimeStamp_us": env.sampleTimeStamp.micros,
        "sent_us": env.sent.micros,
        "payload": payload,
    }


def message_to_json(msg) -> str:
    """ToJSONVisitor equivalent: one message -> JSON object keyed by field
    name (bytes fields base64'd like the reference, cluon :6315+)."""
    import base64
    d = {}
    for _fid, kind, name, _nested in msg.FIELDS:
        v = getattr(msg, name)
        if kind == M.MESSAGE:
            d[name] = json.loads(message_to_json(v))
        elif isinstance(v, bytes):
            d[name] = base64.b64encode(v).decode()
        else:
            d[name] = v
    return json.dumps(d)


def message_from_json(cls, text: str):
    """FromJSONVisitor equivalent (reference :6171): populate a message
    dataclass from a JSON object; unknown keys ignored, missing keep
    defaults; bytes fields base64-decoded."""
    import base64
    d = json.loads(text) if isinstance(text, str) else dict(text)
    msg = cls()
    for _fid, kind, name, nested in cls.FIELDS:
        if name not in d:
            continue
        v = d[name]
        if kind == M.MESSAGE:
            setattr(msg, name, message_from_json(nested, json.dumps(v)))
        elif kind == M.STRING:
            setattr(msg, name, base64.b64decode(v) if isinstance(v, str)
                    else bytes(v))
        else:
            setattr(msg, name, v)
    return msg


def envelope_from_dict(d: dict) -> M.Envelope:
    """EnvelopeConverter's JSON->Envelope direction (reference :7011): build
    a wire-ready Envelope from the dict layout `envelope_to_dict` emits,
    re-encoding the payload through the proto codec."""
    from tpuslam_torch.io import proto
    cls = M.MESSAGE_REGISTRY.get(d["dataType"])
    if cls is None:
        raise KeyError(f"unknown dataType {d['dataType']}")
    payload = d.get("payload", {})
    msg = cls()
    for _fid, kind, name, _nested in cls.FIELDS:
        if name in payload:
            v = payload[name]
            if kind == M.STRING and isinstance(v, str):
                v = v.encode("latin-1")
            setattr(msg, name, v)
    return M.Envelope(
        dataType=d["dataType"],
        serializedData=proto.encode(msg),
        sent=M.TimeStamp.from_micros(d.get("sent_us", 0)),
        sampleTimeStamp=M.TimeStamp.from_micros(d.get("sampleTimeStamp_us", 0)),
        senderStamp=d.get("senderStamp", 0),
    )


def rec_to_jsonl(envelopes: Iterable[M.Envelope], out: TextIO,
                 data_type: Optional[int] = None) -> int:
    n = 0
    for env in envelopes:
        if data_type is not None and env.dataType != data_type:
            continue
        out.write(json.dumps(envelope_to_dict(env)) + "\n")
        n += 1
    return n


def rec_to_csv(envelopes: Iterable[M.Envelope], out: TextIO,
               data_type: int) -> int:
    """One CSV per message type (matches cluon-rec2csv's per-type split)."""
    n = 0
    header_written = False
    for env in envelopes:
        if env.dataType != data_type:
            continue
        d = envelope_to_dict(env)
        cols = ["sampleTimeStamp_us", "senderStamp"] + list(d["payload"].keys())
        if not header_written:
            out.write(";".join(cols) + "\n")
            header_written = True
        vals = [str(d["sampleTimeStamp_us"]), str(d["senderStamp"])] + \
            [str(v) for v in d["payload"].values()]
        out.write(";".join(vals) + "\n")
        n += 1
    return n
