"""Resident-sharded map state: landmark blocks live on their owning rank
(counterpart of `tpuslam.parallel.resident`).

The DD plan's owner classification (`chain.partition_chain`: a landmark is
local to pose block d when every observing pose lies in block d, else
shared) becomes a physical layout (`partition_chain_resident`, on the host,
once per solve): block d's local landmarks are packed into [lb] rows that
only rank d holds, and only the shared landmarks (the block-boundary
interface) are replicated. Edge landmark indices are remapped to the
rank's table [lb resident | shared_cap shared]: an edge's landmark is local
to its own block or shared, by construction.

The solve (`chain_gn_step_dd_resident`) is the DD solve's linear algebra on
that table: the resident rows need no reduction (only the owner's edges
touch them), only the shared rows are summed. Comm per iteration: the
ring shifts, one [m, m] interface psum and [shared_cap]-sized psums, with
m = 3·D + 3 + 2·shared_cap; nothing of size L, and no rank holds the whole
map. Results equal `chain_gn_step_dd`'s up to the order of the sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.parallel.chain import (
    AXIS, _back_substitute, _classify, _eliminate, _gauge, _interface_activity, _masked,
    _pose_rows, _shard_of, _shared_layout, _solve_spd, partition_edges_by_pose_block,
)
from tpuslam_torch.parallel.collectives import all_gather, psum, shard

__all__ = ["ResidentChainPlan", "partition_chain_resident",
           "chain_gn_step_dd_resident", "chain_optimize_resident",
           "resident_comm_bytes_per_iteration"]


@dataclasses.dataclass(frozen=True, eq=False)
class ResidentChainPlan:
    """Host-side layout for the resident DD solve (static per graph layout).

    lm_local_gid[d, j] is the global landmark id in rank d's slot j (L =
    padding). `graph`'s obs_lm holds rank-local slots: [0, lb) the block's
    resident landmarks, [lb, lb + shared_cap) the shared interface."""
    graph: FactorGraph          # edges reordered per block, landmarks remapped
    edge_counts: torch.Tensor   # [D]
    lm_local_gid: torch.Tensor  # [D, lb] global id per resident slot (L = pad)
    shared_idx: torch.Tensor    # [shared_cap] global ids (L = pad)
    n_dev: int
    lb: int                     # resident landmark slots per rank
    shared_cap: int
    n_shared: int


def partition_chain_resident(g: FactorGraph, n_shards: int, lb: int | None = None,
                             shared_cap: int | None = None) -> ResidentChainPlan:
    """Classify the landmarks (owner / shared, as `partition_chain`), pack
    each block's local ones into its resident rows, and remap the edges'
    landmark indices to rank-local slots. Raises `ValueError` for fewer than
    3 poses per block or a capacity too small."""
    cap = g.capacity
    d = n_shards
    if cap.max_poses // d < 3:
        raise ValueError("resident DD solve needs >= 3 poses per block")
    g2, counts = partition_edges_by_pose_block(g, d)
    min_o, max_o, valid = _classify(g, d)
    L = cap.max_landmarks
    shared = valid & (max_o >= 0) & (max_o != min_o)
    local = valid & (max_o >= 0) & (max_o == min_o)
    shared_idx, n_shared, shared_cap = _shared_layout(shared, L, shared_cap)
    shared_rank = np.full(L, -1, np.int64)
    shared_rank[shared_idx[:n_shared]] = np.arange(n_shared)

    per_block = [np.flatnonzero(local & (min_o == dev)) for dev in range(d)]
    need = max((len(p) for p in per_block), default=1)
    if lb is None:
        lb = max(8, -(-max(need, 1) // 8) * 8)
    if need > lb:
        raise ValueError(f"a block owns {need} landmarks > resident cap {lb}")
    lm_local_gid = np.full((d, lb), L, np.int32)
    local_slot = np.full(L, -1, np.int64)
    for dev, ids in enumerate(per_block):
        lm_local_gid[dev, :len(ids)] = ids
        local_slot[ids] = np.arange(len(ids))

    # the edges of block dev fill [dev*eb, dev*eb + count)
    eb = cap.max_obs // d
    new_ol = np.zeros(cap.max_obs, np.int32)
    ol2 = g2.obs_lm.cpu().numpy()
    counts_h = counts.cpu().numpy()
    for dev in range(d):
        sl = slice(dev * eb, dev * eb + int(counts_h[dev]))
        gl_ = ol2[sl]
        is_sh = shared_rank[gl_] >= 0
        # every non-shared edge landmark is local to ITS OWN block
        assert np.all(is_sh | ((local_slot[gl_] >= 0) & (min_o[gl_] == dev)))
        new_ol[sl] = np.where(is_sh, lb + shared_rank[gl_], local_slot[gl_]).astype(np.int32)
    dv = g.poses.device
    g2 = dataclasses.replace(g2, obs_lm=torch.from_numpy(new_ol).to(dv))
    return ResidentChainPlan(
        graph=g2, edge_counts=counts, lm_local_gid=torch.from_numpy(lm_local_gid).to(dv),
        shared_idx=torch.from_numpy(shared_idx).to(dv), n_dev=d, lb=int(lb),
        shared_cap=shared_cap, n_shared=n_shared)


@dataclasses.dataclass
class _Rows:
    """A rank's gauged rows on its resident table, ready to eliminate."""
    blocks: tuple             # (h_diag_l, h_off_l, gp_l, w0, w1, hll, gl)
    locf: torch.Tensor        # [lb + lsh] 1 for the free resident landmarks
    w_sh: torch.Tensor        # [3b, 2·lsh] coupling to the shared landmarks
    sh_ok: torch.Tensor       # [lsh] 1 for the real shared landmarks


def _resident_rows(poses_l, lm_loc_l, lm_sh, plan: ResidentChainPlan, sh, cfg, mesh) -> _Rows:
    """This rank's rows against its table [lb resident | lsh shared]: the
    shared rows of Hll and gl summed over the axis (the resident ones see
    only this block's edges), then gauged by global landmark id."""
    lb, lsh = plan.lb, plan.shared_cap
    dtype = poses_l.dtype
    h_diag_l, h_off_l, gp_l, w0, w1, hll, gl = _pose_rows(
        poses_l, torch.cat([lm_loc_l, lm_sh]), sh, cfg, mesh, split=True)
    hll_sh, gl_sh = psum([hll[lb:], gl[lb:]], mesh, AXIS)
    hll, gl = torch.cat([hll[:lb], hll_sh]), torch.cat([gl[:lb], gl_sh])
    gid_dev = torch.cat([plan.lm_local_gid[sh.d], plan.shared_idx])
    free_lm = (gid_dev >= cfg.fix_first_landmarks) & (gid_dev < sh.n_landmarks)
    blocks = _gauge(h_diag_l, h_off_l, gp_l, w0, w1, hll, gl, free_lm, sh, cfg, mesh)
    w0, w1 = blocks[3], blocks[4]
    ldev = lb + lsh
    locf = (torch.arange(ldev, device=poses_l.device) < lb).to(dtype) * free_lm.to(dtype)
    w_sh = torch.stack([w0[:, lb:], w1[:, lb:]], dim=-1).reshape(-1, 2 * lsh)
    sh_ok = (plan.shared_idx < plan.graph.capacity.max_landmarks).to(dtype)
    return _Rows(blocks=blocks, locf=locf, w_sh=w_sh, sh_ok=sh_ok)


def _eliminate_rows(r: _Rows, plan: ResidentChainPlan, sh, add):
    """`chain._eliminate` of a rank's resident rows, the shared landmarks'
    own Hll and gl added with weight `add`."""
    m = 3 * plan.n_dev + 3 + 2 * plan.shared_cap
    hll, gl = r.blocks[5], r.blocks[6]
    return _eliminate(*r.blocks, r.locf, r.w_sh, hll[plan.lb:], gl[plan.lb:], add, sh, m)


def _resident_iteration(poses_l, lm_loc_l, lm_sh, plan: ResidentChainPlan, sh, cfg, mesh):
    """One resident DD iteration on this rank: (new block poses, new
    resident rows, new shared rows)."""
    r = _resident_rows(poses_l, lm_loc_l, lm_sh, plan, sh, cfg, mesh)
    # the reduced system in FP32, whatever the assembly's precision
    with gn._fp32():
        e = _eliminate_rows(r, plan, sh, 1.0 if sh.d == 0 else None)
        # THE reduction: O(m^2), nothing of size L
        s_if, g_hat = psum([e.s_if, e.g_if], mesh, AXIS)
        s_if, g_hat = _masked(s_if, g_hat, _interface_activity(r.sh_ok, sh, mesh))
        dx_if = _solve_spd(s_if, -g_hat)
        new_local, dl = _back_substitute(e, dx_if, poses_l, sh)
        lo = 3 * plan.n_dev + 3
        return (new_local, lm_loc_l + dl[:plan.lb],
                lm_sh + dx_if[lo:].reshape(plan.shared_cap, 2) * r.sh_ok[:, None])


def _resident_tables(g: FactorGraph, rp: ResidentChainPlan) -> tuple:
    """(every rank's resident rows [D·lb, 2], the shared rows [lsh, 2]) of
    `g`'s landmarks in `rp`'s layout."""
    L = g.capacity.max_landmarks
    gid = rp.lm_local_gid.reshape(-1)
    lm_loc = g.lm_xy[torch.clamp(gid, 0, L - 1).long()] * (gid < L)[:, None]
    sh = rp.shared_idx
    return lm_loc, g.lm_xy[torch.clamp(sh, 0, L - 1).long()] * (sh < L)[:, None]


def _scatter_tables(g: FactorGraph, rp: ResidentChainPlan, lm_loc, lm_shared):
    """`g`'s landmarks with the resident and shared rows written back to
    their global ids (the padding dropped)."""
    L = g.capacity.max_landmarks
    buf = torch.cat([g.lm_xy, g.lm_xy.new_zeros(1, 2)])
    gid = rp.lm_local_gid.reshape(-1).long()
    buf = buf.index_put((torch.where(gid < L, gid, L),), lm_loc)
    sh = rp.shared_idx.long()
    buf = buf.index_put((torch.where(sh < L, sh, L),), lm_shared)
    return buf[:L]


def _run_resident(plan, iteration, g: FactorGraph, cfg: gn.GNConfig, mesh,
                 iterations: int) -> FactorGraph:
    """`iterations` of `iteration(poses_l, lm_loc_l, lm_sh, plan, shard,
    cfg, mesh)` on this rank's block of `plan`'s graph (its poses, `g`'s
    landmarks), then the blocks gathered and the landmarks scattered back:
    the loop of every resident-layout solver."""
    rp = getattr(plan, "rplan", plan)
    g2 = rp.graph
    with gn.precision(cfg, g2.poses):
        sh = _shard_of(g2, rp.edge_counts, cfg, mesh, rp.n_dev)
        lm_loc, lm_shared = _resident_tables(g, rp)
        poses_l = g2.poses[sh.base:sh.base + sh.b]
        lm_loc_l = lm_loc[sh.d * rp.lb:(sh.d + 1) * rp.lb]
        for _ in range(iterations):
            poses_l, lm_loc_l, lm_shared = iteration(poses_l, lm_loc_l, lm_shared, plan, sh,
                                                     cfg, mesh)
        poses, lm_loc = all_gather(poses_l, mesh, AXIS), all_gather(lm_loc_l, mesh, AXIS)
    return dataclasses.replace(g, poses=poses, lm_xy=_scatter_tables(g, rp, lm_loc, lm_shared))


def chain_gn_step_dd_resident(g: FactorGraph, plan: ResidentChainPlan, cfg: gn.GNConfig,
                              mesh) -> FactorGraph:
    """One resident GN iteration of `g` in `plan`'s layout (the poses of
    `plan.graph`), as `chain_optimize_resident` with one iteration."""
    return _run_resident(plan, _resident_iteration, g, cfg, mesh, 1)


def chain_optimize_resident(g: FactorGraph, cfg: gn.GNConfig, mesh,
                            plan: ResidentChainPlan | None = None) -> FactorGraph:
    """Resident DD GN: partition once (or reuse `plan`), `cfg.iterations`
    iterations with the map sharded by owner, the shards gathered back into
    the graph at the end."""
    if plan is None:
        plan = partition_chain_resident(g, shard(mesh, AXIS)[1])
    return _run_resident(plan, _resident_iteration, g, cfg, mesh, cfg.iterations)


def resident_comm_bytes_per_iteration(plan: ResidentChainPlan) -> dict:
    """Analytic per-iteration communication volume (bytes, f32) of the
    resident DD solve."""
    m = 3 * plan.n_dev + 3 + 2 * plan.shared_cap
    b = plan.graph.capacity.max_poses // plan.n_dev
    return {
        "pose_halo_ppermute": 2 * (3 + 9 + 3) * 4,    # pose row + a_ii + g_i
        "interface_psum": (m * m + m) * 4,
        "shared_hll_gl_psum": (plan.shared_cap * 4 + plan.shared_cap * 2) * 4,
        "sep_valid_all_gather": plan.n_dev * 4,
        "total": (2 * 18 + m * m + m + plan.shared_cap * 6 + plan.n_dev) * 4,
        "replicated_path_total_for_comparison": (
            # chain_gn_step: W all_gather + Hpp/gp gathers + O(L) psums
            (3 * b * 2 * plan.graph.capacity.max_landmarks
             + 2 * 9 * b + 3 * b
             + plan.graph.capacity.max_landmarks * 6) * 4 * plan.n_dev),
        "note": "m = 3*n_dev + 3 + 2*shared_cap; nothing scales with L",
    }
