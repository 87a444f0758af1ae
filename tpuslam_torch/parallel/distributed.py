"""Distributed Gauss-Newton: edge-sharded assembly and a summed Schur
reduction (counterpart of `tpuslam.parallel.distributed`).

Every rank holds the replicated pose and landmark estimates and takes its
slice of the observation-edge list by its coordinate on the mesh's 'edges'
axis; it assembles the partial landmark-edge blocks of its slice
(`gauss_newton.landmark_edge_blocks`), and one `psum` over 'edges' per
iteration reduces them to the full graph's. The odometry chain and priors
are assembled after the reduction; the blocks are gauged and the dense
reduced pose system [3P, 3P] (no pose buckets, as the JAX package's
distributed path) is solved identically on every rank
(`gauss_newton.solve_blocks`), through the Cholesky kernel when
`cfg.use_cholesky_kernel` (n = 3P, up to the kernel's 1536). A rank outside
the mesh holds no shard and raises.
"""
from __future__ import annotations

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.parallel.collectives import psum, shard

__all__ = ["distributed_gn_step", "distributed_optimize"]


def edge_slice(n_edges: int, mesh, axis: str = "edges") -> slice:
    """This rank's slice of an edge axis of `n_edges` rows, which must
    divide by the axis size (as a JAX shard_map's sharded axis must)."""
    i, n = shard(mesh, axis)
    if n_edges % n:
        raise ValueError(f"{n_edges} edges do not divide over {n} '{axis}' shards")
    k = n_edges // n
    return slice(i * k, (i + 1) * k)


def sharded_blocks(g: FactorGraph, cfg: gn.GNConfig, mesh):
    """The full graph's normal-equation blocks (h_diag, h_off, w [P,3,L,2],
    hll, gp [P,3], gl), with the landmark edges of `g` (one graph or a
    stacked batch [S]) sharded over the mesh's 'edges' axis: one `psum` of
    every rank's partial blocks, then the odometry and priors."""
    e = edge_slice(g.obs_pose.shape[-1], mesh)
    w_l = cfg.lm_info * g.obs_valid.to(g.poses.dtype)
    parts = gn.landmark_edge_blocks(g.poses, g.lm_xy, g.obs_pose[..., e], g.obs_lm[..., e],
                                    g.obs_xy[..., e, :], w_l[..., e])
    h_diag_lm, w, hll, gp_lm, gl = psum(list(parts), mesh, "edges")
    h_diag_o, h_off, gp_o = gn.assemble_odometry(g, cfg)
    return h_diag_o + h_diag_lm, h_off, w, hll, gp_o + gp_lm, gl


def distributed_gn_step(g: FactorGraph, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """One GN iteration with the landmark-edge work sharded over `mesh`:
    `gauss_newton.gn_step`'s update up to the order of the sums."""
    with gn.precision(cfg, g.poses):
        return gn.solve_blocks(g, cfg, sharded_blocks(g, cfg, mesh))


def distributed_optimize(g: FactorGraph, cfg: gn.GNConfig, mesh) -> FactorGraph:
    """`cfg.iterations` distributed GN iterations (no early exit, as the
    JAX package's). Every rank of the mesh calls it with the same graph and
    gets the same result."""
    for _ in range(cfg.iterations):
        g = distributed_gn_step(g, cfg, mesh)
    return g
