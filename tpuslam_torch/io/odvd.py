"""Minimal .odvd message-specification parser.

A copy of `tpuslam.io.odvd` (pure Python), so that the port imports nothing of
the JAX package.

The reference embeds a full PEG parser + mustache codegen (`cluon-msc`,
reference src/cluon-complete-build.hpp:4716-5011, 14067-15825) to turn the
ODVD DSL into C++ classes at build time. We keep `.odvd` as the schema source
of truth but parse it directly at runtime into field-spec tables compatible
with tpuslam_torch.io.proto — no codegen step.

Grammar subset (all the standard message set uses):
    message <dotted.name> [id = N] {
        <type> <fieldName> [id = M];
        ...
    }
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, make_dataclass
from typing import ClassVar

from tpuslam_torch.io import messages as M

_TYPE_MAP = {
    "bool": (M.VARINT_UNSIGNED, False),
    "char": (M.VARINT_SIGNED, 0),
    "int8": (M.VARINT_SIGNED, 0), "uint8": (M.VARINT_UNSIGNED, 0),
    "int16": (M.VARINT_SIGNED, 0), "uint16": (M.VARINT_UNSIGNED, 0),
    "int32": (M.VARINT_SIGNED, 0), "uint32": (M.VARINT_UNSIGNED, 0),
    "int64": (M.VARINT_SIGNED, 0), "uint64": (M.VARINT_UNSIGNED, 0),
    "float": (M.FLOAT, 0.0), "double": (M.DOUBLE, 0.0),
    "string": (M.STRING, b""), "bytes": (M.STRING, b""),
}

_MSG_RE = re.compile(
    r"message\s+([\w.]+)\s*\[\s*id\s*=\s*(\d+)\s*[^\]]*\]\s*\{([^}]*)\}",
    re.MULTILINE)
_FIELD_RE = re.compile(
    r"(\w+)\s+(\w+)\s*\[\s*(?:default\s*=\s*[^,\]]+\s*,\s*)?id\s*=\s*(\d+)\s*[^\]]*\]\s*;")


@dataclass
class MessageSpec:
    name: str
    ident: int
    fields: list  # (field_id, wire_kind, field_name, None)
    odvd_types: dict = field(default_factory=dict)  # field_name -> declared type


def parse_odvd(text: str) -> list[MessageSpec]:
    text = re.sub(r"//[^\n]*", "", text)  # strip comments
    specs = []
    for m in _MSG_RE.finditer(text):
        name, ident, body = m.group(1), int(m.group(2)), m.group(3)
        fields = []
        types = {}
        for f in _FIELD_RE.finditer(body):
            ftype, fname, fid = f.group(1), f.group(2), int(f.group(3))
            if ftype not in _TYPE_MAP:
                continue  # nested message types unsupported in the subset
            kind, _default = _TYPE_MAP[ftype]
            fields.append((fid, kind, fname, None))
            types[fname] = ftype
        specs.append(MessageSpec(name=name, ident=ident, fields=fields,
                                 odvd_types=types))
    return specs


def build_message_classes(specs: list[MessageSpec], register: bool = False):
    """Materialize proto-codable dataclasses from parsed specs."""
    out = {}
    for s in specs:
        cls_fields = []
        for fid, kind, fname, _ in s.fields:
            default = {M.FLOAT: 0.0, M.DOUBLE: 0.0, M.STRING: b""}.get(kind, 0)
            cls_fields.append((fname, object, field(default=default)))
        cls = make_dataclass(s.name.split(".")[-1], cls_fields,
                             namespace={"ID": s.ident, "FIELDS": s.fields,
                                        "LONG_NAME": s.name,
                                        "ODVD_TYPES": s.odvd_types})
        out[s.name] = cls
        if register:
            M.MESSAGE_REGISTRY.setdefault(s.ident, cls)
    return out


def load_standard_message_set(path: str, register: bool = True):
    with open(path) as f:
        return build_message_classes(parse_odvd(f.read()), register=register)


# ---------------------------------------------------------------------------
# ODVD emitter (ToODVDVisitor equivalent,
# reference src/cluon-complete-build.hpp:6675, impl :12901-13075):
# regenerate the .odvd specification text from a message class. Output
# round-trips through parse_odvd.
# ---------------------------------------------------------------------------

_ODVD_DEFAULT = {"bool": "false", "char": "'0'", "float": "0.0",
                 "double": "0.0", "string": '""', "bytes": '""'}

_KIND_FALLBACK = M.WIRE_KIND_TO_ODVD


def message_to_odvd(cls) -> str:
    """Emit the ODVD message specification for a FIELDS-spec dataclass.
    Nested message types are emitted as forward declarations first, exactly
    like the reference visitor (:12901-12906)."""
    forward = []
    lines = [f"message {getattr(cls, 'LONG_NAME', cls.__name__)} "
             f"[ id = {cls.ID} ] {{"]
    odvd_types = getattr(cls, "ODVD_TYPES", {})
    for fid, kind, name, nested in cls.FIELDS:
        if kind == M.MESSAGE:
            forward.append(message_to_odvd(nested))
            tname = getattr(nested, "LONG_NAME", nested.__name__)
            lines.append(f"    {tname} {name} [ id = {fid} ];")
            continue
        t = odvd_types.get(name, _KIND_FALLBACK[kind])
        d = _ODVD_DEFAULT.get(t, "0")
        lines.append(f"    {t} {name} [ default = {d}, id = {fid} ];")
    lines.append("}")
    return "".join(forward) + "\n".join(lines) + "\n"
