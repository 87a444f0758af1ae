"""Three-level nested dissection for the resident DD solve (counterpart of
`tpuslam.parallel.hier3`).

The two-level solve (`parallel/hier.py`) sums every tray-boundary system
across all trays. One more level groups the trays into pods:

    level 1 (within a tray):  eliminate the tray-interior separators and
                              the tray-local shared landmarks
    level 2 (within a pod):   sum the tray Schur complements of the pod's
                              trays; eliminate the pod-interior tray
                              boundaries and the pod-local shared landmarks
    level 3 (across pods):    sum the pod Schur complements; solve the
                              pod-boundary system

Correctness is the nested-dissection argument twice: a tray-interior
separator's row is whole in the tray's sum, a tray boundary inside a pod in
the pod's sum, a pod boundary at level 3; shared landmarks go to the level
of their observing span (tray-local, pod-local, cross-pod). Results equal
the flat and two-level solves and the single-device one up to the order of
the sums. The levels run in `hier._nested_iteration`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph
from tpuslam_torch.parallel.chain import AXIS
from tpuslam_torch.parallel.collectives import shard
from tpuslam_torch.parallel.hier import _Level, _cap8, _nested_iteration, _place, _span
from tpuslam_torch.parallel.resident import (
    ResidentChainPlan, _run_resident, partition_chain_resident,
)

__all__ = ["Hier3ChainPlan", "partition_chain_hier3",
           "chain_gn_step_dd_hier3", "chain_optimize_hier3",
           "hier3_comm_bytes_per_iteration"]


@dataclasses.dataclass(frozen=True, eq=False)
class Hier3ChainPlan:
    """Resident plan + the three-level interface permutation (host-side).

    Layout of `hier_src` (flat-interface index per hier slot; m = padding):
    [tray 0 W | ... | tray T-1 W | pod 0 K2 | ... | pod Np-1 K2 | K3],
    W = the tray's G-1 interior separators + its tray-local shared lms,
    K2 = the pod's Tp-1 interior tray boundaries + its pod-local shared
    lms, K3 = the Np pod boundaries + the scratch slot + cross-pod shared
    lms."""
    rplan: ResidentChainPlan
    tray: int                  # G: ranks per tray
    pod: int                   # Pd: ranks per pod
    n_tray: int                # T = D / G (all trays)
    n_pod: int                 # Np = D / Pd
    wt: int                    # per-tray W width
    wk2: int                   # per-pod K2 width
    mk3: int                   # K3 width
    hier_src: torch.Tensor     # [T*wt + Np*wk2 + mk3]
    lm_hier_x: torch.Tensor    # [lsh] hier slot of a shared landmark's x
    lm_tray: torch.Tensor      # [lsh] owning tray (-1 pad, T = not tray-local)
    lm_pod: torch.Tensor       # [lsh] owning pod (-1 pad, Np = cross-pod)


def partition_chain_hier3(g: FactorGraph, n_shards: int, tray: int, pod: int, lb=None,
                          shared_cap=None) -> Hier3ChainPlan:
    """The resident plan, every shared landmark classified by its span
    (tray-local / pod-local / cross-pod), and the three-level permutation.
    Raises `ValueError` unless tray | pod | n_shards."""
    if pod % tray or n_shards % pod:
        raise ValueError(f"need tray {tray} | pod {pod} | devices "
                         f"{n_shards} as a divisibility chain")
    rp = partition_chain_resident(g, n_shards, lb=lb, shared_cap=shared_cap)
    d, G, Pd = n_shards, tray, pod
    T, Tp, Np = d // G, Pd // G, d // Pd
    lsh = rp.shared_cap
    L = g.capacity.max_landmarks
    min_t, max_t = _span(g, d, G, T)
    min_p, max_p = _span(g, d, Pd, Np)

    sh_ids = rp.shared_idx.cpu().numpy()
    lm_tray = np.full(lsh, -1, np.int64)
    lm_pod = np.full(lsh, -1, np.int64)
    real = sh_ids < L
    ids = sh_ids[real]
    tray_local = min_t[ids] == max_t[ids]
    pod_local = ~tray_local & (min_p[ids] == max_p[ids])
    lm_tray[real] = np.where(tray_local, min_t[ids], T)
    lm_pod[real] = np.where(tray_local | pod_local, min_p[ids], Np)

    per_tray = [np.flatnonzero(lm_tray == t) for t in range(T)]
    per_pod = [np.flatnonzero((lm_tray == T) & (lm_pod == p)) for p in range(Np)]
    cross_list = np.flatnonzero(lm_pod == Np)
    lsh_t_cap = _cap8(max((len(x) for x in per_tray), default=1))
    lsh_p_cap = _cap8(max((len(x) for x in per_pod), default=1))
    lsh_x_cap = _cap8(len(cross_list))

    m = 3 * d + 3 + 2 * lsh
    wt = 3 * (G - 1) + 2 * lsh_t_cap
    wk2 = 3 * (Tp - 1) + 2 * lsh_p_cap
    mk3 = 3 * Np + 3 + 2 * lsh_x_cap
    mh = T * wt + Np * wk2 + mk3
    hier_src = np.full(mh, m, np.int64)              # m = padding
    lm_hier_x = np.full(lsh, mh, np.int64)
    for t in range(T):                               # tray interiors
        _place(hier_src, lm_hier_x, t * wt, [t * G + i for i in range(G - 1)], per_tray[t], d)
    for p in range(Np):                              # pod-interior tray boundaries
        _place(hier_src, lm_hier_x, T * wt + p * wk2,
               [p * Pd + (i + 1) * G - 1 for i in range(Tp - 1)], per_pod[p], d)
    # pod boundaries, the scratch slot (as a separator of rank d), cross lms
    _place(hier_src, lm_hier_x, T * wt + Np * wk2,
           [(p + 1) * Pd - 1 for p in range(Np)] + [d], cross_list, d)
    dv = g.poses.device

    def t32(x):
        return torch.from_numpy(x.astype(np.int32)).to(dv)
    return Hier3ChainPlan(rplan=rp, tray=G, pod=Pd, n_tray=T, n_pod=Np, wt=wt, wk2=wk2,
                          mk3=mk3, hier_src=t32(hier_src), lm_hier_x=t32(lm_hier_x),
                          lm_tray=t32(lm_tray), lm_pod=t32(lm_pod))


def _hier3_levels(plan: Hier3ChainPlan, d: int):
    G, Pd, T, Np = plan.tray, plan.pod, plan.n_tray, plan.n_pod
    t, p = d // G, d // Pd
    return [_Level(plan.lm_tray == t, t * plan.wt, plan.wt, d % G == 0,
                   [[u * G + i for i in range(G)] for u in range(T)]),
            _Level((plan.lm_tray == T) & (plan.lm_pod == p), T * plan.wt + p * plan.wk2,
                   plan.wk2, d % Pd == 0, [[q * Pd + i for i in range(Pd)] for q in range(Np)]),
            _Level(plan.lm_pod == Np, T * plan.wt + Np * plan.wk2, plan.mk3, d == 0, None)]


def _hier3_iteration(poses_l, lm_loc_l, lm_sh, plan: Hier3ChainPlan, sh, cfg, mesh):
    return _nested_iteration(poses_l, lm_loc_l, lm_sh, _hier3_levels(plan, sh.d), plan, sh,
                             cfg, mesh)


def chain_gn_step_dd_hier3(g: FactorGraph, hplan: Hier3ChainPlan, cfg: gn.GNConfig,
                           mesh) -> FactorGraph:
    """One three-level resident GN iteration: the two-level solve's linear
    algebra up to the interface, solved in three levels (within trays,
    within pods, across pods)."""
    return _run_resident(hplan, _hier3_iteration, g, cfg, mesh, 1)


def chain_optimize_hier3(g: FactorGraph, cfg: gn.GNConfig, mesh, tray: int, pod: int,
                         plan: Hier3ChainPlan | None = None) -> FactorGraph:
    """Three-level resident DD GN (the contract of
    `hier.chain_optimize_hier`)."""
    if plan is None:
        plan = partition_chain_hier3(g, shard(mesh, AXIS)[1], tray, pod)
    return _run_resident(plan, _hier3_iteration, g, cfg, mesh, cfg.iterations)


def hier3_comm_bytes_per_iteration(hplan: Hier3ChainPlan) -> dict:
    """Analytic per-iteration comm volume by level: level 1 within a tray,
    level 2 within a pod, level 3 (and the shared-landmark vectors) across
    pods."""
    ms = hplan.wt + hplan.wk2 + hplan.mk3     # level-1 sub-interface
    mw = hplan.wk2 + hplan.mk3                # level-2 sub-interface
    mk3 = hplan.mk3
    lsh = hplan.rplan.shared_cap
    return {
        "level1_tray_psum": (ms * ms + ms) * 4,
        "level2_pod_psum": (mw * mw + mw) * 4,
        "level3_cross_psum": (mk3 * mk3 + mk3) * 4,
        "shared_hll_gl_psum": lsh * 6 * 4,
        "dl_shared_psum": lsh * 2 * 4,
        "pose_halo_ppermute": 2 * (3 + 9 + 3) * 4,
        "note": ("level-1 payload ~ flat m/T within a tray; level 2 sums "
                 "tray complements within the pod; only the [mk3, mk3] "
                 "system and the O(lsh) shared-update vectors cross pods"),
    }
