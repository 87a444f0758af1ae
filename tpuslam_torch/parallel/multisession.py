"""Multi-session mapping over a ('sessions', 'edges') mesh (counterpart of
`tpuslam.parallel.multisession`).

A stacked graph is a `FactorGraph` whose fields carry a leading session
axis [S]; the batched GN (`backend.gauss_newton.optimize`) and the fusion
(`parallel.fusion`) take it. `multisession_optimize` runs S independent
sessions' GNs over a mesh: each rank takes its chunk of the sessions by its
'sessions' coordinate and its slice of their edge lists by its 'edges'
coordinate, one `psum` over 'edges' per iteration reduces the partial
landmark blocks, the odometry is assembled once after it, and each local
session's dense reduced system is solved (one batched `cholesky_ex`, as the
JAX package's solve takes the library). The sessions' results are
gathered over 'sessions' once, at the end: every rank returns the whole
stacked graph.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.parallel.collectives import all_gather, shard
from tpuslam_torch.parallel.distributed import sharded_blocks

__all__ = ["stack_graphs", "multisession_optimize"]


def stack_graphs(graphs) -> FactorGraph:
    """Stack per-session graphs into one graph with a leading session axis."""
    return FactorGraph(**{f.name: torch.stack([getattr(g, f.name) for g in graphs])
                          for f in dataclasses.fields(FactorGraph)})


def multisession_optimize(stacked: FactorGraph, cfg: gn.GNConfig, mesh,
                          iterations: int | None = None) -> FactorGraph:
    """GN on S stacked sessions over `mesh`: `iterations` (default
    `cfg.iterations`) steps of every session, no early exit. S must divide
    by the 'sessions' axis and the edge capacity by the 'edges' axis."""
    i, n = shard(mesh, "sessions")
    S = stacked.poses.shape[0]
    if S % n:
        raise ValueError(f"{S} sessions do not divide over {n} 'sessions' shards")
    k = S // n
    g = FactorGraph(**{f.name: getattr(stacked, f.name)[i * k:(i + 1) * k]
                       for f in dataclasses.fields(FactorGraph)})
    # the JAX package's multi-session solve takes the library's Cholesky
    cfg = dataclasses.replace(cfg, use_cholesky_kernel=False)
    with gn.precision(cfg, g.poses):
        for _ in range(cfg.iterations if iterations is None else iterations):
            g = gn.solve_blocks(g, cfg, sharded_blocks(g, cfg, mesh))
    return dataclasses.replace(stacked, poses=all_gather(g.poses, mesh, "sessions"),
                               lm_xy=all_gather(g.lm_xy, mesh, "sessions"))
