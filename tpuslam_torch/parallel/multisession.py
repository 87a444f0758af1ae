"""Stacked multi-session graphs (counterpart of
`tpuslam.parallel.multisession`, its `stack_graphs`).

A stacked graph is a `FactorGraph` whose fields carry a leading session
axis [S]; the batched GN (`backend.gauss_newton.optimize`) and the fusion
(`parallel.fusion`) take it. The JAX package's mesh-sharded
`multisession_optimize` is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend.graph import FactorGraph

__all__ = ["stack_graphs"]


def stack_graphs(graphs) -> FactorGraph:
    """Stack per-session graphs into one graph with a leading session axis."""
    return FactorGraph(**{f.name: torch.stack([getattr(g, f.name) for g in graphs])
                          for f in dataclasses.fields(FactorGraph)})
