"""OpenDaVINCI `configuration` file parsing (the reference deployment's
second config layer, SURVEY.md §5.6(b)).

A copy of `tpuslam.runtime.odconfig` (pure Python), so that the port imports
nothing of the JAX package.

The usecase session distributes per-module settings through odsupercomponent
from one key-value file (reference usecase/configuration:1-16):

    global.key = value            # applies to every module
    section.key = value           # applies to all modules of type `section`
    section:ID.key = value        # applies only to module ID of that type

`#` starts a comment; stray non-assignment lines (e.g. `%RANSAC`,
reference usecase/configuration:110) are ignored. This module parses the
format and resolves a module view with OpenDaVINCI precedence
(global < section < section:ID), and maps the reference's
`logic-cfsd18-sensation-attention.*` keys (usecase/configuration:101-115)
onto our integrated lidar front-end's AttentionConfig.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

__all__ = ["parse_od_configuration", "module_view", "attention_from_od_config"]

_LINE = re.compile(r"^\s*([A-Za-z0-9_.:\-]+)\s*=\s*(.*)$")


def parse_od_configuration(text: str) -> dict[str, str]:
    """Flat `section[:id].key -> value` mapping, comments stripped."""
    out: dict[str, str] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = _LINE.match(line)
        if not m or "." not in m.group(1):
            continue  # stray markers like `%RANSAC`
        out[m.group(1)] = m.group(2).strip()
    return out


def module_view(cfg: dict[str, str], section: str,
                ident: Optional[int] = None) -> dict[str, str]:
    """Resolve the keys one module sees: global < section < section:ID."""
    out: dict[str, str] = {}
    for full, v in cfg.items():
        head, key = full.split(".", 1)
        if head == "global":
            out.setdefault(key, v)
    for full, v in cfg.items():
        head, key = full.split(".", 1)
        if head == section:
            out[key] = v
    if ident is not None:
        want = f"{section}:{ident}"
        for full, v in cfg.items():
            head, key = full.split(".", 1)
            if head == want:
                out[key] = v
    return out


# reference attention keys (usecase/configuration:101-115) -> AttentionConfig
_ATTENTION_KEYS = {
    "connectDistanceThreshold": ("connect_distance_threshold", float),
    "minNumOfPointsForCone": ("min_points", int),
    "maxNumOfPointsForCone": ("max_points", int),
    "farConeRadiusThreshold": ("far_cone_radius", float),
    "nearConeRadiusThreshold": ("near_cone_radius", float),
    "zRangeThreshold": ("z_range_threshold", float),
    "inlierRangeTreshold": ("inlier_range_threshold", float),  # sic
    "dotThreshold": ("dot_threshold", float),
    "inlierFoundTreshold": ("inlier_found_threshold", int),    # sic
    "numberOfIterations": ("ransac_iterations", int),
}


def attention_from_od_config(text: str, ident: Optional[int] = None,
                             base=None):
    """Build an AttentionConfig from an OpenDaVINCI configuration file's
    `logic-cfsd18-sensation-attention` section (returns (config,
    sender_stamp|None))."""
    from tpuslam_torch.perception.attention import AttentionConfig

    view = module_view(parse_od_configuration(text),
                       "logic-cfsd18-sensation-attention", ident)
    fields = {}
    for od_key, (attr, conv) in _ATTENTION_KEYS.items():
        if od_key in view:
            fields[attr] = conv(float(view[od_key]) if conv is int
                                else view[od_key])
    cfg = dataclasses.replace(base or AttentionConfig(), **fields)
    stamp = int(view["senderStamp"]) if "senderStamp" in view else None
    return cfg, stamp
