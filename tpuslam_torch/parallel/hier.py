"""Hierarchical (two-level) interface elimination for the resident DD solve
(counterpart of `tpuslam.parallel.hier`).

The flat resident solve sums one [m, m] interface with m = 3·D + 3 +
2·shared_cap, which grows with D. One level of nested dissection groups
the D pose blocks into T trays of G ranks: each tray eliminates its
interior separators and its tray-local shared landmarks after a sum within
the tray (a grouped `psum`), and only the tray-boundary system, m2 = 3·T +
3 + 2·cross_cap, is summed across trays:

    level 1 (within a tray):  [wt + mk] per tray
    level 2 (across trays):   [mk, mk]

A tray-interior separator's whole Hessian row lives in the within-tray sum,
and a tray-local shared landmark's edges all lie in the tray, so the tray
Schur complement is exact; summing the tray complements completes the
boundary rows. Results equal the flat DD and the single-device solve up to
the order of the sums.

Layout (static, from the host-side plan): the flat interface [3D
separators | 3 scratch | 2·lsh shared] is permuted to [tray 0 W | ... |
tray T-1 W | K], W a tray's G-1 interior separators and tray-local shared
landmarks (padded to one width), K the T tray-boundary separators, the
scratch slot and the cross-tray shared landmarks. Each rank projects its
flat part onto [its tray's W | K] (a gather on the rank, no comm).

`_nested_iteration` holds the levels generically; `parallel/hier3.py`
runs it with a third level.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.parallel.chain import (
    AXIS, _back_substitute, _interface_activity, _masked, _solve_spd,
)
from tpuslam_torch.parallel.collectives import psum, shard
from tpuslam_torch.parallel.resident import (
    ResidentChainPlan, _eliminate_rows, _resident_rows, _run_resident, partition_chain_resident,
)

__all__ = ["HierChainPlan", "partition_chain_hier", "chain_gn_step_dd_hier",
           "chain_optimize_hier", "hier_comm_bytes_per_iteration"]


@dataclasses.dataclass(frozen=True, eq=False)
class HierChainPlan:
    """Resident plan + the two-level interface permutation (host-side)."""
    rplan: ResidentChainPlan
    tray: int                  # G: ranks per tray
    n_tray: int                # T
    wt: int                    # per-tray W width = 3*(G-1) + 2*lsh_t_cap
    mk: int                    # K width = 3*T + 3 + 2*lsh_x_cap
    hier_src: torch.Tensor     # [mh] flat index per hier slot (m = padding)
    lm_hier_x: torch.Tensor    # [lsh] hier slot of a shared landmark's x (mh = pad)
    lm_tray: torch.Tensor      # [lsh] owning tray (n_tray = cross, -1 = pad)

    @property
    def mh(self):
        return self.n_tray * self.wt + self.mk


def _span(g: FactorGraph, n_shards: int, group: int, n_groups: int):
    """(min, max) group observing each landmark [L], a group being `group`
    consecutive pose blocks, from the graph's edges (host)."""
    L = g.capacity.max_landmarks
    block = g.capacity.max_poses // n_shards
    n_obs = int(g.n_obs)
    op = g.obs_pose[:n_obs].cpu().numpy()
    ol = g.obs_lm[:n_obs].cpu().numpy()
    of_edge = (op // block) // group
    lo = np.full(L, n_groups, np.int64)
    hi = np.full(L, -1, np.int64)
    np.minimum.at(lo, ol, of_edge)
    np.maximum.at(hi, ol, of_edge)
    return lo, hi


def _cap8(n: int) -> int:
    return max(8, -(-max(n, 1) // 8) * 8)


def _place(hier_src, lm_hier_x, base: int, seps, lms, n_dev: int):
    """Fill one block of the hier layout from `base`: the separators of the
    ranks `seps` (3 slots each), then the shared landmarks `lms` (2 each)."""
    for i, dev in enumerate(seps):
        hier_src[base + 3 * i:base + 3 * i + 3] = np.arange(3 * dev, 3 * dev + 3)
    for r, s in enumerate(lms):
        pos = base + 3 * len(seps) + 2 * r
        hier_src[pos:pos + 2] = 3 * n_dev + 3 + 2 * s + np.arange(2)
        lm_hier_x[s] = pos


def partition_chain_hier(g: FactorGraph, n_shards: int, tray: int, lb=None,
                         shared_cap=None) -> HierChainPlan:
    """The resident plan, each shared landmark classified by the trays that
    observe it, and the two-level permutation. Raises `ValueError` when
    `tray` does not divide the ranks."""
    if n_shards % tray:
        raise ValueError(f"{n_shards} devices not divisible by tray {tray}")
    rp = partition_chain_resident(g, n_shards, lb=lb, shared_cap=shared_cap)
    d, G = n_shards, tray
    T = d // G
    lsh = rp.shared_cap
    L = g.capacity.max_landmarks
    min_t, max_t = _span(g, d, G, T)

    sh_ids = rp.shared_idx.cpu().numpy()
    lm_tray = np.full(lsh, -1, np.int64)
    real = sh_ids < L
    ids = sh_ids[real]
    lm_tray[real] = np.where(min_t[ids] != max_t[ids], T, min_t[ids])
    per_tray = [np.flatnonzero(lm_tray == t) for t in range(T)]
    cross_list = np.flatnonzero(lm_tray == T)
    lsh_t_cap = _cap8(max((len(p) for p in per_tray), default=1))
    lsh_x_cap = _cap8(len(cross_list))

    m = 3 * d + 3 + 2 * lsh
    wt = 3 * (G - 1) + 2 * lsh_t_cap
    mk = 3 * T + 3 + 2 * lsh_x_cap
    mh = T * wt + mk
    hier_src = np.full(mh, m, np.int64)              # m = padding
    lm_hier_x = np.full(lsh, mh, np.int64)
    for t in range(T):                               # tray interiors
        _place(hier_src, lm_hier_x, t * wt, [t * G + i for i in range(G - 1)], per_tray[t], d)
    # tray boundaries, the scratch slot (as a separator of rank d), cross lms
    _place(hier_src, lm_hier_x, T * wt, [t * G + G - 1 for t in range(T)] + [d], cross_list, d)
    dv = g.poses.device
    return HierChainPlan(
        rplan=rp, tray=G, n_tray=T, wt=wt, mk=mk,
        hier_src=torch.from_numpy(hier_src.astype(np.int32)).to(dv),
        lm_hier_x=torch.from_numpy(lm_hier_x.astype(np.int32)).to(dv),
        lm_tray=torch.from_numpy(lm_tray.astype(np.int32)).to(dv))


@dataclasses.dataclass(frozen=True)
class _Level:
    """One block of a rank's sub-interface: the shared landmarks it holds
    ([lsh] mask), its place in the hier layout and its width, whether this
    rank contributes the block's own terms (the first rank of its group),
    and the groups whose sum completes the block (None: the whole axis)."""
    lms: torch.Tensor
    offset: int
    width: int
    first: bool
    groups: list | None


def _nested_iteration(poses_l, lm_loc_l, lm_sh, levels, plan, sh, cfg, mesh):
    """One resident iteration whose interface is solved by nested
    dissection over `levels` (the last one the top, summed over the whole
    axis): each level's block is summed within its groups and eliminated,
    its Schur complement passed up by the first rank of each group, the top
    solved on every rank and the levels back-substituted."""
    rp = plan.rplan
    r = _resident_rows(poses_l, lm_loc_l, lm_sh, rp, sh, cfg, mesh)
    # the reduced system in FP32, whatever the assembly's precision
    with gn._fp32():
        dtype = poses_l.dtype
        # each shared landmark's own Hll and gl come in once, from the first
        # rank of the group whose sum completes it
        own = sum(lv.lms.to(dtype) * float(lv.first) for lv in levels)
        e = _eliminate_rows(r, rp, sh, own)
        m = e.s_if.shape[0]
        src = torch.cat([plan.hier_src[lv.offset:lv.offset + lv.width] for lv in levels]).long()
        s_pad = torch.zeros((m + 1, m + 1), dtype=dtype, device=poses_l.device)
        s_pad[:m, :m] = e.s_if
        g_pad = torch.cat([e.g_if, e.g_if.new_zeros(1)])
        act = torch.cat([_interface_activity(r.sh_ok, sh, mesh), e.g_if.new_zeros(1)])[src]

        s, g = psum([s_pad[src][:, src], g_pad[src]], mesh, AXIS, groups=levels[0].groups)
        s, g = _masked(s, g, act)
        eliminated = []
        for lv, up in zip(levels[:-1], levels[1:]):
            w = lv.width
            c = torch.linalg.cholesky_ex(s[:w, :w]).L
            ainv_b = torch.cholesky_solve(s[:w, w:], c)
            ainv_g = torch.cholesky_solve(g[:w, None], c)[:, 0]
            eliminated.append((ainv_b, ainv_g))
            s, g = s[w:, w:] - s[:w, w:].T @ ainv_b, g[w:] - s[:w, w:].T @ ainv_g
            if not lv.first:
                s, g = torch.zeros_like(s), torch.zeros_like(g)
            s, g = psum([s, g], mesh, AXIS, groups=up.groups)
        x = _solve_spd(s, -g)
        for ainv_b, ainv_g in reversed(eliminated):
            x = torch.cat([-ainv_g - ainv_b @ x, x])

        dx_flat = x.new_zeros(m + 1).index_put((src,), x)[:m]
        # the shared landmarks' updates, replicated by one [lsh, 2] sum: each
        # from the first rank of the group that solved it
        ms = x.shape[0]
        pos = torch.full_like(plan.lm_hier_x, ms).long()
        sub = 0
        for lv in levels:
            pos = torch.where(lv.lms, plan.lm_hier_x.long() - lv.offset + sub, pos)
            sub += lv.width
        xp = torch.cat([x, x.new_zeros(2)])
        pos = torch.clamp(pos, 0, ms)
        dl_sh = torch.stack([xp[pos], xp[torch.clamp(pos + 1, 0, ms + 1)]], -1) * own[:, None]
        dl_sh = psum(dl_sh, mesh, AXIS) * r.sh_ok[:, None]

        new_local, dl = _back_substitute(e, dx_flat, poses_l, sh)
        return new_local, lm_loc_l + dl[:rp.lb], lm_sh + dl_sh


def _hier_levels(plan: HierChainPlan, d: int):
    G, T = plan.tray, plan.n_tray
    t = d // G
    return [_Level(plan.lm_tray == t, t * plan.wt, plan.wt, d % G == 0,
                   [[u * G + i for i in range(G)] for u in range(T)]),
            _Level(plan.lm_tray == T, T * plan.wt, plan.mk, d == 0, None)]


def _hier_iteration(poses_l, lm_loc_l, lm_sh, plan: HierChainPlan, sh, cfg, mesh):
    return _nested_iteration(poses_l, lm_loc_l, lm_sh, _hier_levels(plan, sh.d), plan, sh,
                             cfg, mesh)


def chain_gn_step_dd_hier(g: FactorGraph, hplan: HierChainPlan, cfg: gn.GNConfig,
                          mesh) -> FactorGraph:
    """One hierarchical resident GN iteration: the resident solve's linear
    algebra up to the interface, solved in two levels (a sum within each
    tray, then a sum of the tray Schur complements across trays)."""
    return _run_resident(hplan, _hier_iteration, g, cfg, mesh, 1)


def chain_optimize_hier(g: FactorGraph, cfg: gn.GNConfig, mesh, tray: int,
                        plan: HierChainPlan | None = None) -> FactorGraph:
    """Hierarchical resident DD GN (the contract of
    `resident.chain_optimize_resident`), `tray` ranks per tray."""
    if plan is None:
        plan = partition_chain_hier(g, shard(mesh, AXIS)[1], tray)
    return _run_resident(plan, _hier_iteration, g, cfg, mesh, cfg.iterations)


def hier_comm_bytes_per_iteration(hplan: HierChainPlan) -> dict:
    """Analytic per-iteration comm volume: the level-1 payload is summed
    within a tray, level 2 across trays."""
    ms = hplan.wt + hplan.mk                 # level-1 sub-interface width
    mk = hplan.mk
    lsh = hplan.rplan.shared_cap
    return {
        "level1_tray_psum": (ms * ms + ms) * 4,
        "level2_cross_psum": (mk * mk + mk) * 4,
        "shared_hll_gl_psum": lsh * 6 * 4,
        "dl_shared_psum": lsh * 2 * 4,
        "pose_halo_ppermute": 2 * (3 + 9 + 3) * 4,
        "note": ("level-1 payload is the tray's [wt+mk] sub-interface "
                 "(~flat m / T); only the [mk, mk] level-2 system crosses "
                 "trays, mk = 3T + 3 + 2*cross_cap"),
    }
