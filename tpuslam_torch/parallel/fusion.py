"""Cross-session map fusion: S independent sessions -> one global map
(counterpart of `tpuslam.parallel.fusion`).

1. **Alignment** (`align_to_anchor`, `align_consensus_round`): each
   session's SE(2) registration onto the anchor session's landmarks (or
   onto the pooled other sessions'), by planar ICP: type-gated nearest
   pairs under an annealed gate, a closed-form weighted Kabsch update, and
   optionally trimmed to the best pairs. The S registrations are one
   batched computation over a leading session axis.
2. **Merge** (`fuse_graphs`): one `FactorGraph` of capacity (S*P, S*L,
   S*E). The pose chains are concatenated and compacted, the chain edge
   into each session's first pose severed (`odo_w = 0`); duplicate
   landmarks across sessions are the connected components of the
   type-gated radius graph, found by min-label propagation, and merged as
   information-weighted (with `lm_info`) or observation-count-weighted
   means; every observation edge is remapped into the merged map.
3. **Joint optimization**: `gauss_newton.optimize` on the fused graph.

With a mesh (`mesh`, a `DeviceMesh` with an 'edges' axis) the dedup is
landmark-sharded: each rank computes the adjacency rows of its block of the
concatenated landmark axis, and every propagation round gathers the labels
once; `fuse_sessions` then runs the joint GN as the edge-sharded
`distributed_optimize`.

The merge sums are `index_add_` scatters; on CUDA they are atomics, so the
fused positions may differ from the CPU's in the last bits. Labels,
landmark and merge counts are integer propagation and exact on both. The
chain solvers ('dd', 'hier', 'hier3') are not ported yet: `fuse_sessions`
refuses them with `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import FactorGraph, GraphCapacity, empty_graph
from tpuslam_torch.parallel.collectives import all_gather, shard
from tpuslam_torch.parallel.distributed import distributed_optimize

__all__ = ["estimate_se2", "transform_graph", "align_to_anchor", "align_consensus_round",
           "dedup_labels", "fuse_graphs", "fuse_sessions", "fusion_report"]

_BIG = 1e30
_I32 = torch.int32


# ---------------------------------------------------------------------------
# SE(2) registration
# ---------------------------------------------------------------------------

def _apply_se2(t, xy):
    """Apply transform t = (tx, ty, theta) [..., 3] to points [..., 2]."""
    c, s = torch.cos(t[..., 2]), torch.sin(t[..., 2])
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([c * x - s * y + t[..., 0], s * x + c * y + t[..., 1]], dim=-1)


def _anneal(iters: int, dtype, device):
    """The ICP gate's factors, 1 down to 0.5 in `iters` steps, with the
    float32 arithmetic of `jnp.linspace`."""
    if iters == 1:
        return torch.ones(1, dtype=dtype, device=device)
    step = torch.arange(iters - 1, dtype=dtype, device=device) / (iters - 1)
    return torch.cat([1.0 * (1 - step) + 0.5 * step,
                      torch.full((1,), 0.5, dtype=dtype, device=device)])


def _estimate_se2_batched(src_xy, src_type, src_valid, dst_xy, dst_type, dst_valid, gate,
                          iters: int, trim: float):
    """`estimate_se2` for S registrations at once: sources [S, N, ...],
    destinations [S or 1, M, ...] with validity [S or 1, M]. Returns
    (tforms [S, 3], n_matched [S] int32)."""
    S, N = src_xy.shape[:2]
    dtype, dev = src_xy.dtype, src_xy.device
    anneal = _anneal(iters, dtype, dev) * torch.tensor(gate, dtype=dtype, device=dev)
    sess = torch.arange(S, device=dev)[:, None] if dst_xy.shape[0] > 1 else 0
    t = torch.zeros((S, 3), dtype=dtype, device=dev)
    n = None
    for gate_i in anneal:
        moved = _apply_se2(t[:, None, :], src_xy)
        diff = moved[:, :, None, :] - dst_xy[:, None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        ok = (src_valid[:, :, None] & dst_valid[:, None, :]
              & (src_type[:, :, None] == dst_type[:, None, :]) & (d2 < gate_i * gate_i))
        # the lowest index wins a tie, as jnp.argmin
        j = torch.argmin(torch.where(ok, d2, _BIG), dim=-1)
        matched = torch.any(ok, dim=-1)
        if trim > 0.0:
            # trimmed ICP: keep the best `trim` fraction of the matched pairs
            d2_sel = torch.gather(d2, -1, j[..., None])[..., 0]
            vals = torch.where(matched, d2_sel, torch.inf)
            n_m = torch.sum(matched, dim=-1, dtype=_I32)
            k = torch.clamp((n_m.to(dtype) * torch.tensor(trim, dtype=dtype, device=dev)
                             ).to(_I32) - 1, 2, N - 1)
            thr = torch.gather(torch.sort(vals, dim=-1).values, -1, k.long()[:, None])
            matched = matched & (d2_sel <= thr)
        w = matched.to(dtype)
        n = torch.sum(w, dim=-1)
        wn = torch.clamp(n, min=1.0)[:, None]
        p = moved
        q = dst_xy[sess, j]
        pc = torch.sum(w[..., None] * p, dim=1) / wn
        qc = torch.sum(w[..., None] * q, dim=1) / wn
        pp = p - pc[:, None, :]
        qq = q - qc[:, None, :]
        a = torch.sum(w * (pp[..., 0] * qq[..., 0] + pp[..., 1] * qq[..., 1]), dim=-1)
        b = torch.sum(w * (pp[..., 0] * qq[..., 1] - pp[..., 1] * qq[..., 0]), dim=-1)
        dth = torch.atan2(b, a)
        c, s = torch.cos(dth), torch.sin(dth)
        dt = qc - torch.stack([c * pc[:, 0] - s * pc[:, 1], s * pc[:, 0] + c * pc[:, 1]], -1)
        # compose the increment with the running transform
        upd = torch.stack([c * t[:, 0] - s * t[:, 1] + dt[:, 0],
                           s * t[:, 0] + c * t[:, 1] + dt[:, 1], t[:, 2] + dth], dim=-1)
        t = torch.where((n >= 3)[:, None], upd, t)
    return t, n.to(_I32)


def estimate_se2(src_xy, src_type, src_valid, dst_xy, dst_type, dst_valid, gate,
                 iters: int = 8, trim: float = 0.0):
    """SE(2) registering src landmarks onto dst landmarks (planar ICP).

    Each of `iters` iterations: type-equal nearest pairs within the gate
    (annealed from `gate` down to gate / 2), then the closed-form weighted
    Kabsch update (rotation atan2(sum x^y, sum x.y) of the centred pairs,
    translation from the matched centroids); fewer than 3 matches leave the
    transform as it is. `trim` in (0, 1) keeps only the best `trim`
    fraction of the matched pairs of each iteration (trimmed ICP). Returns
    (tform [3] = (tx, ty, theta), n_matched) with n_matched the last
    iteration's."""
    t, n = _estimate_se2_batched(src_xy[None], src_type[None], src_valid[None], dst_xy[None],
                                 dst_type[None], dst_valid[None], gate, iters, trim)
    return t[0], n[0]


def transform_graph(g: FactorGraph, tform) -> FactorGraph:
    """Rigidly move a session's graph by tform = (tx, ty, theta), or each
    session of a stacked graph [S] by its row of tform [S, 3]. Poses,
    landmarks and priors move; relative odometry and body-frame
    measurements are frame-invariant and stay."""
    t = tform[..., None, :]

    def move_pose(p):
        return torch.cat([_apply_se2(t, p[..., :2]), p[..., 2:] + t[..., 2:]], dim=-1)

    return dataclasses.replace(g, poses=move_pose(g.poses), lm_xy=_apply_se2(t, g.lm_xy),
                               prior_pose=move_pose(g.prior_pose))


def _lm_valid(stacked: FactorGraph):
    return torch.arange(stacked.lm_xy.shape[1], device=stacked.lm_xy.device) \
        < stacked.n_landmarks[:, None]


def _anchor_fixed(tforms):
    """The anchor session (0) stays put."""
    return torch.cat([torch.zeros_like(tforms[:1]), tforms[1:]])


def align_to_anchor(stacked: FactorGraph, gate: float = 1.2, iters: int = 8,
                    trim: float = 0.0):
    """Register every session of a stacked graph [S] onto session 0's map,
    all S registrations as one batch. Returns (stacked graph with sessions
    1..S-1 rigidly moved, tforms [S, 3], n_matched [S])."""
    valid = _lm_valid(stacked)
    tforms, ns = _estimate_se2_batched(stacked.lm_xy, stacked.lm_type, valid,
                                       stacked.lm_xy[:1], stacked.lm_type[:1], valid[:1],
                                       gate, iters, trim)
    tforms = _anchor_fixed(tforms)
    return transform_graph(stacked, tforms), tforms, ns


def align_consensus_round(stacked: FactorGraph, gate: float, iters: int = 8,
                          trim: float = 0.0):
    """One consensus round: each session re-registers onto the union of
    every other session's landmarks (session 0 stays, to pin the gauge).
    Returns (moved stacked graph, incremental tforms [S, 3], n_matched
    [S])."""
    s, l_cap = stacked.lm_xy.shape[:2]
    dev = stacked.lm_xy.device
    valid = _lm_valid(stacked)
    sess_of = torch.arange(s * l_cap, device=dev) // l_cap
    dst_valid = valid.reshape(1, -1) & (sess_of[None, :] != torch.arange(s, device=dev)[:, None])
    tforms, ns = _estimate_se2_batched(stacked.lm_xy, stacked.lm_type, valid,
                                       stacked.lm_xy.reshape(1, -1, 2),
                                       stacked.lm_type.reshape(1, -1), dst_valid,
                                       gate, iters, trim)
    tforms = _anchor_fixed(tforms)
    return transform_graph(stacked, tforms), tforms, ns


# ---------------------------------------------------------------------------
# Landmark dedup + merge
# ---------------------------------------------------------------------------

def dedup_labels(all_xy, all_type, all_valid, gate, mesh=None, axis: str = "edges",
                 iters: int = 8):
    """Component label per landmark slot (the smallest index in its
    component, by min-label propagation over the type-gated radius graph);
    invalid slots get label SL. With `mesh`, each rank holds its block of
    adjacency rows [SL / n, SL] over `mesh[axis]` (SL a multiple of its
    size), and each round's labels of the block are gathered over `axis`,
    so every rank holds all of them."""
    gate2 = torch.tensor(gate, dtype=all_xy.dtype, device=all_xy.device) ** 2
    sl = all_xy.shape[0]
    rows = slice(None)
    if mesh is not None:
        i, n = shard(mesh, axis)
        if sl % n:
            raise ValueError(f"{sl} landmark slots do not divide over {n} '{axis}' shards")
        rows = slice(i * (sl // n), (i + 1) * (sl // n))
    diff = all_xy[rows, None, :] - all_xy[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    adj = ((d2 < gate2) & (all_type[rows, None] == all_type[None, :])
           & all_valid[rows, None] & all_valid[None, :])
    labels = torch.where(all_valid, torch.arange(sl, dtype=_I32, device=all_xy.device), sl)
    for _ in range(iters):
        neigh = torch.where(adj, labels[None, :], sl)
        labels = torch.minimum(labels[rows], torch.min(neigh, dim=1).values)
        if mesh is not None:
            labels = all_gather(labels, mesh, axis)
    return labels


def _session_obs_counts(stacked: FactorGraph):
    """Per-session per-landmark observation counts [S, L] (edges past n_obs
    not counted): the merge weights, integers, so exact on any device."""
    s, e_cap = stacked.obs_lm.shape
    l_cap = stacked.lm_xy.shape[1]
    dev = stacked.obs_lm.device
    lm = stacked.obs_lm.long()
    ok = ((torch.arange(e_cap, device=dev) < stacked.n_obs[:, None]) & (lm >= 0)
          & (lm < l_cap))
    idx = torch.where(ok, lm + torch.arange(s, device=dev)[:, None] * l_cap, s * l_cap)
    counts = torch.bincount(idx.reshape(-1), minlength=s * l_cap + 1)[:s * l_cap]
    return counts.reshape(s, l_cap).to(stacked.lm_xy.dtype)


def _scatter(n: int, to, values, reduce: str = "sum", init=0):
    """Out-of-place `full(n, init).at[to].<reduce>(values, mode="drop")`:
    rows `to` equal to n are dropped."""
    buf = torch.full((n + 1, *values.shape[1:]), init, dtype=values.dtype,
                     device=values.device)
    if reduce == "sum":
        buf = buf.index_add(0, to, values)
    else:
        buf = buf.scatter_reduce(0, to, values, reduce, include_self=True)
    return buf[:n]


def _set_drop(x, to, values):
    """Out-of-place `x.at[to].set(values, mode="drop")`, `to` unique where
    below len(x)."""
    buf = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
    return buf.index_put((to,), values)[:x.shape[0]]


def _offsets(counts):
    """Exclusive prefix sums of per-session counts [S] (int32)."""
    return torch.cumsum(counts, 0, dtype=_I32) - counts


def fuse_graphs(stacked: FactorGraph, gate: float = 1.2, mesh=None, axis: str = "edges",
                dedup_iters: int = 8, lm_info=None):
    """Merge an aligned stacked graph [S] into one fused `FactorGraph` of
    capacity (S*P, S*L, S*E). Returns (fused, report) with report's
    `n_merged_landmarks`, `n_cross_session_merges` and `labels`.

    With `lm_info` ([S, L, 3] packed per-landmark information, as
    `SlamState.lm_info_xy` accumulates it under Mahalanobis association) a
    merged landmark is the information-weighted combination (sum Lambda)^-1
    sum Lambda x; a member with no information weighs like an
    average-information member with its observation count. Without it, the
    observation-count-weighted mean."""
    s, p_cap = stacked.poses.shape[:2]
    l_cap = stacked.lm_xy.shape[1]
    e_cap = stacked.obs_pose.shape[1]
    sp, sl, se = s * p_cap, s * l_cap, s * e_cap
    dtype, dev = stacked.poses.dtype, stacked.poses.device

    # landmark dedup over the concatenated landmark axis
    all_xy = stacked.lm_xy.reshape(sl, 2)
    all_type = stacked.lm_type.reshape(sl)
    lm_valid = _lm_valid(stacked).reshape(sl)
    labels = dedup_labels(all_xy, all_type, lm_valid, gate, mesh=mesh, axis=axis,
                          iters=dedup_iters)
    k = torch.arange(sl, device=dev)
    is_root = (lm_valid & (labels == k)).to(_I32)
    root_rank = torch.cumsum(is_root, 0, dtype=_I32) - is_root
    n_merged = torch.sum(is_root, dtype=_I32)
    # each landmark's slot in the merged map is its root's rank; invalid
    # ones are dropped
    remap = torch.where(lm_valid, root_rank[torch.clamp(labels, 0, sl - 1).long()], sl)
    to = remap.long()

    # merged landmark positions
    w_obs = _session_obs_counts(stacked).reshape(sl)
    w_eff = torch.where(lm_valid, torch.clamp(w_obs, min=1.0), 0.0)
    if lm_info is not None:
        info = lm_info.reshape(sl, 3)
        has = (info[:, 0] + info[:, 2]) > 0.0
        has_f = (has & lm_valid).to(dtype)
        tot_info = torch.sum(0.5 * (info[:, 0] + info[:, 2]) * has_f)
        tot_obs = torch.sum(w_eff * has_f)
        nominal = torch.where(tot_obs > 0.0, tot_info / torch.clamp(tot_obs, min=1.0), 1.0)
        a = torch.where(has, info[:, 0], nominal * w_eff)
        b = torch.where(has, info[:, 1], 0.0)
        c = torch.where(has, info[:, 2], nominal * w_eff)
        lam_x = a * all_xy[:, 0] + b * all_xy[:, 1]
        lam_y = b * all_xy[:, 0] + c * all_xy[:, 1]
        msk = lm_valid.to(dtype)
        sa, sb, sc, sx, sy = (_scatter(sl, to, v * msk) for v in (a, b, c, lam_x, lam_y))
        det = torch.clamp(sa * sc - sb * sb, min=1e-12)
        merged_xy = torch.stack([(sc * sx - sb * sy) / det, (sa * sy - sb * sx) / det], dim=-1)
    else:
        sum_xy = _scatter(sl, to, w_eff[:, None] * all_xy)
        sum_w = _scatter(sl, to, w_eff)
        merged_xy = sum_xy / torch.clamp(sum_w, min=1e-9)[:, None]
    type_src = _scatter(sl, to, torch.where(lm_valid, all_type, 0), "amax")

    # cross-session merges (a diagnostic): components with members from at
    # least two sessions
    sess_of = (k // l_cap).to(_I32)
    first_sess = _scatter(sl, to, torch.where(lm_valid, sess_of, s), "amin", init=s)
    last_sess = _scatter(sl, to, torch.where(lm_valid, sess_of, -1), "amax", init=-1)
    cross = torch.sum((k < n_merged) & (last_sess > first_sess), dtype=_I32)

    # pose chains: sessions back to back, each chain severed at its first pose
    pose_offset = _offsets(stacked.n_poses)
    kp = torch.arange(p_cap, device=dev)[None, :]
    pose_ok = kp < stacked.n_poses[:, None]
    pose_to = torch.where(pose_ok, pose_offset[:, None] + kp, sp).reshape(sp).long()
    is_first = (kp == 0) & pose_ok
    fused = empty_graph(GraphCapacity(sp, sl, se), dev, dtype)
    fused = dataclasses.replace(
        fused,
        poses=_set_drop(fused.poses, pose_to, stacked.poses.reshape(sp, 3)),
        odo_meas=_set_drop(fused.odo_meas, pose_to, stacked.odo_meas.reshape(sp, 3)),
        odo_w=_set_drop(fused.odo_w, pose_to,
                        torch.where(is_first, 0.0, stacked.odo_w).reshape(sp)),
        prior_pose=_set_drop(fused.prior_pose, pose_to, stacked.prior_pose.reshape(sp, 3)),
        prior_info=_set_drop(fused.prior_info, pose_to, stacked.prior_info.reshape(sp, 2)),
        n_poses=torch.sum(stacked.n_poses, dtype=_I32),
        lm_xy=merged_xy, lm_type=type_src, n_landmarks=n_merged)

    # observation edges: compacted, their pose and landmark indices remapped
    edge_offset = _offsets(stacked.n_obs)
    ke = torch.arange(e_cap, device=dev)[None, :]
    edge_to = torch.where(ke < stacked.n_obs[:, None], edge_offset[:, None] + ke,
                          se).reshape(se).long()
    obs_pose_g = (pose_offset[:, None] + stacked.obs_pose).reshape(se)
    lm_local = (torch.arange(s, device=dev)[:, None] * l_cap + stacked.obs_lm).reshape(se)
    obs_lm_g = remap[torch.clamp(lm_local, 0, sl - 1).long()]
    fused = dataclasses.replace(
        fused,
        obs_pose=_set_drop(fused.obs_pose, edge_to, obs_pose_g),
        obs_lm=_set_drop(fused.obs_lm, edge_to, torch.clamp(obs_lm_g, 0, sl - 1)),
        obs_xy=_set_drop(fused.obs_xy, edge_to, stacked.obs_xy.reshape(se, 2)),
        n_obs=torch.sum(stacked.n_obs, dtype=_I32))
    return fused, dict(n_merged_landmarks=n_merged, n_cross_session_merges=cross,
                       labels=labels)


def fusion_report(report) -> dict:
    """Host-side summary of a `fuse_graphs` report (one read)."""
    n, cross = torch.stack([report["n_merged_landmarks"],
                            report["n_cross_session_merges"]]).tolist()
    return {"n_merged_landmarks": n, "n_cross_session_merges": cross}


# ---------------------------------------------------------------------------
# The end-to-end flow
# ---------------------------------------------------------------------------

def fuse_sessions(stacked: FactorGraph, cfg: gn.GNConfig | None = None, gate: float = 1.2,
                  mesh=None, align: bool = True, align_iters: int = 8, dedup_iters: int = 8,
                  lm_info=None, solver: str = "auto", tray: int | None = None,
                  solve_mesh=None, robust: bool = False, consensus_rounds: int = 0):
    """S sessions (a stacked graph [S]) -> one jointly optimized map.

    `align` registers every session onto session 0 (trimmed to the best
    75% of pairs with `robust`), then runs `consensus_rounds` rounds of
    `align_consensus_round`; `lm_info` [S, L, 3] rotates with each
    session. Sessions anchored by GPS priors in one frame pass
    align=False. Then `fuse_graphs` and, with `cfg`, `gauss_newton.optimize`
    on the fused graph. Returns (fused graph, report dict) with the
    `fuse_graphs` report, `tforms`, `n_align_matched` and `solver`.

    With `mesh` the dedup is landmark-sharded over its 'edges' axis and the
    joint GN is `distributed_optimize` over it (solver 'auto'). `solver`
    'dd', 'hier' or 'hier3' runs the joint GN through
    `chain.chain_optimize` over `solve_mesh` (a ('chain',) mesh; a fresh
    one over every rank of the world when None), `tray` ranks per group for
    the hierarchical solves; the fused pose capacity S·P must divide by its
    ranks. Raises `ValueError` for an unknown solver."""
    if solver not in ("auto", "dd", "hier", "hier3"):
        raise ValueError(f"unknown fusion solver {solver!r} (auto | dd | hier | hier3)")
    s = stacked.poses.shape[0]
    if align:
        trim = 0.75 if robust else 0.0
        stacked, tforms, n_matched = align_to_anchor(stacked, gate, iters=align_iters,
                                                     trim=trim)
        theta_tot = tforms[:, 2]
        for _ in range(consensus_rounds):
            stacked, dtf, n_matched = align_consensus_round(stacked, gate, iters=align_iters,
                                                            trim=trim)
            theta_tot = theta_tot + dtf[:, 2]
        if lm_info is not None:
            # information rotates with the session: Lambda' = R Lambda R^T
            c = torch.cos(theta_tot)[:, None]
            sn = torch.sin(theta_tot)[:, None]
            a, b, cc = lm_info[..., 0], lm_info[..., 1], lm_info[..., 2]
            lm_info = torch.stack([c * c * a - 2 * c * sn * b + sn * sn * cc,
                                   c * sn * (a - cc) + (c * c - sn * sn) * b,
                                   sn * sn * a + 2 * c * sn * b + c * c * cc], dim=-1)
    else:
        tforms = torch.zeros((s, 3), dtype=stacked.poses.dtype, device=stacked.poses.device)
        n_matched = torch.zeros(s, dtype=_I32, device=stacked.poses.device)
    fused, report = fuse_graphs(stacked, gate, mesh=mesh, dedup_iters=dedup_iters,
                                lm_info=lm_info)
    report = dict(report, tforms=tforms, n_align_matched=n_matched, solver=solver)
    if cfg is not None and solver != "auto":
        from tpuslam_torch.parallel.chain import chain_optimize
        if solve_mesh is None:
            from tpuslam_torch.parallel.mesh import make_chain_mesh
            solve_mesh = make_chain_mesh(device_type=fused.poses.device.type)
        fused = chain_optimize(fused, cfg, solve_mesh, solver=solver, tray=tray)
    elif cfg is not None and mesh is not None:
        fused = distributed_optimize(fused, cfg, mesh)
    elif cfg is not None:
        fused = gn.optimize(fused, cfg)
    return fused, report
