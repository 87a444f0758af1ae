"""ODVD -> Python source generator (the cluon-msc equivalent).

A copy of `tpuslam.io.msc` (pure Python), so that the port imports nothing of
the JAX package.

The reference's `cluon-msc` (embedded in the single header, reference
src/cluon-complete-build.hpp:14067-15825) turns the ODVD DSL into C++ message
classes at build time via mustache templates (CMakeLists.txt:57-70). This
framework's native message target is Python dataclasses driven by the generic
proto codec (tpuslam_torch.io.proto), so the generator emits an importable,
self-contained Python module instead: one dataclass per `message` declaration,
carrying the same ID / LONG_NAME / ODVD_TYPES / FIELDS contract as the
hand-written classes in tpuslam_torch.io.messages — byte-identical on the wire.

The runtime parser (tpuslam_torch.io.odvd.parse_odvd) stays the no-build-step path;
this module is the build-time path for users who want static, greppable,
importable message classes (what cluon-msc gives C++ users).

Generated module surface:
    <ShortName> classes         one dataclass per message
    MESSAGES                    {long dotted name: class}
    BY_ID                       {numeric id: class} (first declaration wins)
    register_all(registry=None) install into tpuslam's MESSAGE_REGISTRY
    <namespace tree>            gen.opendlv.proxy.GeodeticWgs84Reading
"""
from __future__ import annotations

import keyword

from tpuslam_torch.io import messages as M
from tpuslam_torch.io.odvd import MessageSpec, parse_odvd

_KIND_CONST = {
    M.VARINT_SIGNED: "_M.VARINT_SIGNED",
    M.VARINT_UNSIGNED: "_M.VARINT_UNSIGNED",
    M.FLOAT: "_M.FLOAT",
    M.DOUBLE: "_M.DOUBLE",
    M.STRING: "_M.STRING",
}

# declared ODVD type -> (python annotation, default literal)
_PY_TYPE = {
    "bool": ("int", "0"),
    "char": ("int", "0"),
    "int8": ("int", "0"), "uint8": ("int", "0"),
    "int16": ("int", "0"), "uint16": ("int", "0"),
    "int32": ("int", "0"), "uint32": ("int", "0"),
    "int64": ("int", "0"), "uint64": ("int", "0"),
    "float": ("float", "0.0"), "double": ("float", "0.0"),
    "string": ("bytes", 'b""'), "bytes": ("bytes", 'b""'),
}


def _safe(name: str) -> str:
    return name + "_" if keyword.iskeyword(name) else name


def _class_names(specs: list[MessageSpec]) -> dict[str, str]:
    """Unique Python class name per long message name. Short names are used
    when unambiguous (the standard set has no collisions); dotted-path
    underscore names otherwise."""
    counts: dict[str, int] = {}
    for s in specs:
        short = s.name.split(".")[-1]
        counts[short] = counts.get(short, 0) + 1
    out = {}
    for s in specs:
        short = s.name.split(".")[-1]
        out[s.name] = _safe(short) if counts[short] == 1 \
            else _safe(s.name.replace(".", "_"))
    return out


def generate_python_source(odvd_text: str, source_name: str = "<odvd>") -> str:
    """Emit a standalone Python module for every message in `odvd_text`."""
    specs = parse_odvd(odvd_text)
    names = _class_names(specs)
    out = [
        f'"""Generated by slamctl msc from {source_name}. Do not edit.\n',
        "cluon-msc equivalent output (reference",
        "src/cluon-complete-build.hpp:14067-15825): one proto-codable",
        'dataclass per ODVD message declaration."""',
        "# no `from __future__ import annotations`: string annotations would",
        "# make @dataclass resolve ClassVar via sys.modules[__module__],",
        "# which breaks when the generated file is exec'd standalone",
        "from dataclasses import dataclass",
        "from types import SimpleNamespace as _NS",
        "from typing import ClassVar",
        "",
        "from tpuslam_torch.io import messages as _M",
        "",
    ]
    for s in specs:
        cname = names[s.name]
        out += ["", "@dataclass", f"class {cname}:"]
        out.append(f"    ID: ClassVar[int] = {s.ident}")
        out.append(f"    LONG_NAME: ClassVar[str] = {s.name!r}")
        types_lit = "{" + ", ".join(
            f"{_safe(n)!r}: {t!r}" for n, t in s.odvd_types.items()) + "}"
        out.append(f"    ODVD_TYPES: ClassVar = {types_lit}")
        if s.fields:
            out.append("    FIELDS: ClassVar = [")
            for fid, kind, fname, _ in s.fields:
                out.append(
                    f"        ({fid}, {_KIND_CONST[kind]}, {_safe(fname)!r}, None),")
            out.append("    ]")
        else:
            out.append("    FIELDS: ClassVar = []")
        for fid, kind, fname, _ in s.fields:
            ann, default = _PY_TYPE[s.odvd_types[fname]]
            out.append(f"    {_safe(fname)}: {ann} = {default}")
        out.append("")
    out += ["", "MESSAGES = {"]
    for s in specs:
        out.append(f"    {s.name!r}: {names[s.name]},")
    out += ["}", "", "BY_ID = {}",
            "for _cls in MESSAGES.values():",
            "    BY_ID.setdefault(_cls.ID, _cls)",
            "", "",
            "def register_all(registry=None):",
            '    """Install every generated class into the live message',
            '    registry (non-destructive: hand-written classes win)."""',
            "    reg = _M.MESSAGE_REGISTRY if registry is None else registry",
            "    for _c in MESSAGES.values():",
            "        reg.setdefault(_c.ID, _c)",
            "    return reg",
            "", "",
            "def _tree():",
            "    root = {}",
            "    for _name, _c in MESSAGES.items():",
            "        parts = _name.split('.')",
            "        node = root",
            "        for p in parts[:-1]:",
            "            node = node.setdefault(p, {})",
            "        node[parts[-1]] = _c",
            "    def build(d):",
            "        return _NS(**{k: build(v) if isinstance(v, dict) else v",
            "                      for k, v in d.items()})",
            "    return {k: build(v) if isinstance(v, dict) else v",
            "            for k, v in root.items()}",
            "",
            "globals().update(_tree())",
            ""]
    return "\n".join(out)


def generate_python_module(odvd_path: str, out_path: str) -> int:
    """CLI entry: read `odvd_path`, write the generated module. Returns the
    number of message classes generated."""
    with open(odvd_path) as f:
        text = f.read()
    src = generate_python_source(text, source_name=odvd_path)
    with open(out_path, "w") as f:
        f.write(src)
    return len(parse_odvd(text))
