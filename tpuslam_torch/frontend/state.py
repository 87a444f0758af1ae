"""Top-level SLAM engine state (counterpart of `tpuslam.frontend.state`),
plus converters to and from numpy so a state carries across packages.

The system has no weights: what carries over between the JAX package and
this port is the graph and the frontend flags. `state_to_numpy` gives a
dict of numpy arrays keyed by field name (the graph as a nested dict), the
layout `np.asarray(getattr(x, f.name))` over `dataclasses.fields` gives for
the JAX pytree; `state_from_numpy` reads it back. Dtypes round-trip
exactly: f32 stays f32, i32 stays i32, bool stays bool.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.backend.graph import FactorGraph, GraphCapacity, empty_graph


@dataclasses.dataclass
class SlamState:
    graph: FactorGraph
    current_cone_index: torch.Tensor   # i32 — where on the track we are
    loop_closing: torch.Tensor         # bool — closure detected this session
    loop_closure_complete: torch.Tensor  # bool — map frozen, localization mode
    keyframe_count: torch.Tensor       # i32
    send_cone_data: torch.Tensor       # bool — currentConeIndex changed
    lm_info_xy: torch.Tensor           # [L,3] packed per-landmark 2x2 information


def initial_state(cap: GraphCapacity, device) -> SlamState:
    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)
    return SlamState(
        graph=empty_graph(cap, device),
        current_cone_index=scalar(0, torch.int32),
        loop_closing=scalar(False, torch.bool),
        loop_closure_complete=scalar(False, torch.bool),
        keyframe_count=scalar(0, torch.int32),
        send_cone_data=scalar(False, torch.bool),
        lm_info_xy=torch.zeros((cap.max_landmarks, 3), dtype=torch.float32, device=device),
    )


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def graph_from_numpy(d: dict, device) -> FactorGraph:
    """`FactorGraph` from a dict of numpy arrays keyed by field name."""
    return FactorGraph(**{f.name: _tensor(d[f.name], device)
                          for f in dataclasses.fields(FactorGraph)})


def state_from_numpy(d: dict, device) -> SlamState:
    """`SlamState` from a dict of numpy arrays keyed by field name, with the
    graph under "graph" as a nested dict."""
    kw = {f.name: _tensor(d[f.name], device)
          for f in dataclasses.fields(SlamState) if f.name != "graph"}
    return SlamState(graph=graph_from_numpy(d["graph"], device), **kw)


def graph_to_numpy(g: FactorGraph) -> dict:
    return {f.name: getattr(g, f.name).cpu().numpy() for f in dataclasses.fields(g)}


def state_to_numpy(s: SlamState) -> dict:
    """The inverse of `state_from_numpy`."""
    out = {f.name: getattr(s, f.name).cpu().numpy()
           for f in dataclasses.fields(s) if f.name != "graph"}
    out["graph"] = graph_to_numpy(s.graph)
    return out
