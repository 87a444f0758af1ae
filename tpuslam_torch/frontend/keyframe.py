"""The per-keyframe SLAM update (counterpart of `tpuslam.frontend.keyframe`).

GPS-outlier guard, pose insertion, data association, landmark creation,
loop-closure detection, the one-shot closure Gauss-Newton, localization and
the egress packet, with the reference's sequential-within-frame semantics
expressed as vector ops over the observation axis (the JAX package's
vectorized mapping step).

The JAX package's `lax.cond` gates become Python branches: each keyframe
reads (pose in bounds, map frozen, enough valid cones) from the device in
one transfer, and a mapping keyframe reads its closure flag in a second.

Supported here: the reference-compat configuration and 'first' / 'nearest'
association, dense or through the association kernel
(`use_pallas_association`). `perform_keyframe` raises `NotImplementedError`,
naming the field, for every configuration outside that.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend import graph as G
from tpuslam_torch.frontend.state import SlamState
from tpuslam_torch.geometry import se2
from tpuslam_torch.geometry.spherical import (
    cone_to_global, global_to_body_spherical, spherical_to_cartesian,
)
from tpuslam_torch.ops.assoc_kernel import associate_kernel
from tpuslam_torch.runtime.config import SlamConfig

_INF = float("inf")


@dataclasses.dataclass
class KeyframeOutputs:
    """What the service publishes after a keyframe update."""
    pose: torch.Tensor           # [3] published pose (local Cartesian + heading)
    cone_azimuth: torch.Tensor   # [K] degrees, car frame (reference quirk units)
    cone_distance: torch.Tensor  # [K] meters
    cone_type: torch.Tensor      # [K] int32
    send: torch.Tensor           # bool — whether this keyframe publishes
    loop_closed: torch.Tensor    # bool — closure optimization ran this keyframe
    n_landmarks: torch.Tensor    # i32 diagnostic


def _gn_config(cfg: SlamConfig) -> gn.GNConfig:
    if cfg.use_gps_prior:
        return gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                           iterations=cfg.gn_iterations,
                           fix_first_poses=0, fix_first_landmarks=0,
                           matmul_precision=cfg.gn_matmul_precision,
                           early_exit_tol=cfg.gn_early_exit_tol)
    return gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                       iterations=cfg.gn_iterations,
                       matmul_precision=cfg.gn_matmul_precision,
                       early_exit_tol=cfg.gn_early_exit_tol)


def _check_supported(cfg: SlamConfig, assoc_mesh) -> None:
    """Refuse, by field name, every configuration this port does not run."""
    if cfg.association == "first" and cfg.use_pallas_association:
        # the kernel takes the nearest landmark; 'first' needs index order
        raise ValueError("use_pallas_association needs association='nearest' "
                         "or 'mahalanobis'; 'first' needs index order")
    unsupported = {
        "association": cfg.association not in ("first", "nearest"),
        "use_gps_prior": cfg.use_gps_prior,
        "periodic_gn_every": cfg.periodic_gn_every > 0,
        "localizer_refine": cfg.localizer_refine,
        "mapping_publish_refine": cfg.mapping_publish_refine,
        "vectorized_mapping": not cfg.vectorized_mapping,
        "use_ekf_fusion": cfg.use_ekf_fusion,
        "assoc_mesh": assoc_mesh is not None,
    }
    for name, bad in unsupported.items():
        if bad:
            value = assoc_mesh if name == "assoc_mesh" else getattr(cfg, name)
            raise NotImplementedError(
                f"{name}={value!r} is not ported to tpuslam_torch yet")


def _body_xy(ob, cfg: SlamConfig):
    """Observation spherical triple -> body-frame Cartesian measurement."""
    xyz = spherical_to_cartesian(ob[..., 0], ob[..., 1], ob[..., 2],
                                 cfg.lidar_to_cog, cfg.reference_compat)
    return xyz[..., :2]


def _gate_cost(d2, cfg: SlamConfig):
    """(N x M) gating cost + threshold: squared Euclidean against the
    reference threshold (the Mahalanobis branch is not ported yet)."""
    return d2, cfg.same_cone_threshold ** 2


def _use_assoc_kernel(cfg: SlamConfig) -> bool:
    """True when the association payload is (match_idx, matched) from the
    kernel instead of the dense (N x M) cost matrix."""
    return cfg.use_pallas_association and cfg.association != "first"


def _associate_shared(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig):
    """Observations to the global frame, body-frame measurements, and the
    association payload: the dense (N x M) gating cost and its gate, or the
    kernel's (match_idx, matched) without the cost matrix."""
    glob_all = cone_to_global(pose, obs[:, 0], obs[:, 1], obs[:, 2],
                              cfg.lidar_to_cog, cfg.reference_compat)
    body_all = _body_xy(obs, cfg)
    g = state.graph
    if _use_assoc_kernel(cfg):
        j, matched, _ = _provider_associate(glob_all, obs[:, 3], obs_valid,
                                            g.lm_xy, g.lm_type, g.n_landmarks, cfg)
        return glob_all, body_all, j, matched
    diff = glob_all[:, None, :] - g.lm_xy[None, :, :]
    cost, gate = _gate_cost(torch.sum(diff * diff, dim=-1), cfg)
    return glob_all, body_all, cost, gate


def _provider_associate(glob, otype, valid, lm_xy, lm_type, n_landmarks, cfg: SlamConfig):
    """(match_idx, matched, cost) for a flat observation batch from the
    association kernel, which reads the float type column `otype` as int32
    and masks invalid observations and landmarks past `n_landmarks` itself:
    neither ever matches, as the types -2 and -1 of the JAX package's
    `_provider_associate` do."""
    return associate_kernel(glob.contiguous(), otype, lm_xy, lm_type,
                            cfg.same_cone_threshold ** 2, obs_valid=valid, lm_count=n_landmarks)


def _first_index(mask):
    """Index of the first True along the last axis (0 if none), like
    `jnp.argmax` on a bool mask; `torch.argmax` refuses bools."""
    return torch.argmax(mask.to(torch.uint8), dim=-1).to(torch.int32)


def _prefix_argmin_exclusive(vals, idxs):
    """Running (min, argmin) over k < i, ties keeping the earliest; (inf, -1)
    at i = 0. `torch.cummin` keeps the latest on ties, so this takes a
    masked [N, N] min with a first-index argmin instead."""
    n = vals.shape[0]
    k = torch.arange(n, device=vals.device)
    before = torch.where(k[None, :] < k[:, None], vals[None, :], _INF)
    mv = torch.min(before, dim=1).values
    mi = idxs[torch.argmin(before, dim=1)]
    mi = torch.where(k == 0, -1, mi).to(idxs.dtype)
    return mv, mi


def _mapping_step_vectorized(state: SlamState, obs, obs_valid, pose, pose_idx,
                             cfg: SlamConfig, pre, indexed: bool):
    """Mapping-mode update with the reference's sequential semantics as
    vector ops: an (N x M) gated association, prefix scans over the
    observation axis for the in-frame running state, in-frame duplicate
    merging, and one contiguous edge-block append. Returns the new state and
    whether the closure GN is due."""
    g = state.graph
    dev = obs.device
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    n = obs.shape[0]
    cap_l = g.lm_xy.shape[0]
    cap_e = g.obs_pose.shape[0]

    # Bootstrap (reference src/slam.cpp:554-567): an empty map seeds landmark
    # 0 from observation 0, which phase A then re-matches.
    glob_all, body_all, pay_a, pay_b = pre
    boot = (g.n_landmarks == 0) & obs_valid[0]
    g = G.add_landmark(g, glob_all[0], obs[0, 3].to(torch.int32), enable=boot)
    g = G.add_observation(g, pose_idx, 0, body_all[0], enable=boot)

    otype = obs[:, 3].to(torch.int32)
    d2car = obs[:, 2]

    # --- phase A: association against the pre-frame map. The payload was
    # computed before the bootstrap, which writes only slot 0 of an empty
    # map, so its matches are patched in here.
    diff0 = glob_all - g.lm_xy[0][None, :]
    d2_col0 = torch.sum(diff0 * diff0, dim=-1)
    if indexed:
        j, matched0 = pay_a, pay_b
        hit0 = boot & (d2_col0 < thresh2) & (g.lm_type[0] == otype) & obs_valid
        j = torch.where(hit0, 0, j).to(torch.int32)
        matched0 = matched0 | hit0
    else:
        cost_pre, gate = pay_a, pay_b
        cost_col0 = d2_col0 * (gate / thresh2)
        cost_boot = torch.cat([cost_col0[:, None], cost_pre[:, 1:]], dim=1)
        cost = torch.where(boot, cost_boot, cost_pre)
        ok = ((g.lm_type[None, :] == otype[:, None]) & g.lm_valid[None, :]
              & (cost < gate) & obs_valid[:, None])
        if cfg.association == "first":
            j = _first_index(ok)
        else:
            j = torch.argmin(torch.where(ok, cost, 1e30), dim=1).to(torch.int32)
        matched0 = torch.any(ok, dim=1)
    jl = j.long()

    # --- in-frame sequential state as prefix scans
    vals = torch.where(matched0, d2car, _INF)
    pm, pi = _prefix_argmin_exclusive(vals, torch.arange(n, dtype=torch.int32, device=dev))
    cur_before = torch.where(pm < 100.0, j[torch.clamp(pi, min=0).long()],
                             state.current_cone_index)

    dfirst2 = torch.sum((g.lm_xy[jl] - g.lm_xy[0]) ** 2, dim=-1)
    closure0 = (matched0 & (dfirst2 < cfg.loop_closure_radius ** 2)
                & (cur_before > cfg.loop_closure_min_index)
                & (d2car < cfg.cone_mapping_threshold))
    c0 = closure0.to(torch.int32)
    closed_before = state.loop_closing | ((torch.cumsum(c0, 0) - c0) > 0)
    closing = state.loop_closing | torch.any(closure0)

    matched = matched0 & ~closed_before

    # --- phase B: new landmarks with in-frame duplicate merging
    cand = obs_valid & ~matched0 & ~closed_before & (d2car < cfg.cone_mapping_threshold)
    gd = glob_all[:, None, :] - glob_all[None, :, :]
    gd2 = torch.sum(gd * gd, dim=-1)
    ar = torch.arange(n, device=dev)
    lower = ar[:, None] > ar[None, :]                       # k < i
    gsame = (otype[:, None] == otype[None, :]) & (gd2 < thresh2) & lower
    is_new = cand
    for _ in range(cfg.in_frame_dup_depth):
        # first-representative fixpoint; physical layouts have chain depth <= 1
        dup_of_new = torch.any(gsame & is_new[None, :], dim=1)
        is_new = cand & ~dup_of_new
    rep_ok = gsame & is_new[None, :]
    rep = _first_index(rep_ok)
    is_dup = cand & torch.any(rep_ok, dim=1)

    new_i = is_new.to(torch.int32)
    new_rank = torch.cumsum(new_i, 0, dtype=torch.int32) - new_i
    slot_self = g.n_landmarks + new_rank
    slot = torch.where(is_new, slot_self, slot_self[rep.long()])   # dup -> rep's slot
    slot_ok = slot < cap_l

    # landmark writes: disjoint slots; out-of-range ones land in a spare row
    # past the capacity and are dropped
    scatter_to = torch.where(is_new & slot_ok, slot, cap_l).long()
    lm_xy = torch.cat([g.lm_xy, g.lm_xy.new_zeros(1, 2)]).index_put((scatter_to,), glob_all)
    lm_type = torch.cat([g.lm_type, g.lm_type.new_zeros(1)]).index_put((scatter_to,), otype)
    g = dataclasses.replace(
        g, lm_xy=lm_xy[:cap_l], lm_type=lm_type[:cap_l],
        n_landmarks=torch.clamp(g.n_landmarks + torch.sum(new_i), max=cap_l).to(torch.int32))

    # currentConeIndex: only matches update it in the reference; duplicate
    # observations run its match branch sequentially, so they count too
    target = torch.where(matched, j, slot).to(torch.int32)
    cur_cand = matched | (is_dup & slot_ok)
    vals_f = torch.where(cur_cand, d2car, _INF)
    best = torch.argmin(vals_f, dim=0, keepdim=True)   # [1]: no host read-back
    cur = torch.where(vals_f[best][0] < 100.0, target[best][0], state.current_cone_index)

    # --- contiguous edge-block append (keeps reference insertion order):
    # stable keep-first permutation, written at `base` as the JAX package's
    # dynamic_update_slice does (its start is clamped, hence the min)
    keep = matched | ((is_new | is_dup) & slot_ok)
    keep_i = keep.to(torch.int32)
    n_keep = torch.sum(keep_i)
    rank_keep = torch.cumsum(keep_i, 0) - keep_i
    rank_drop = torch.cumsum(1 - keep_i, 0) - (1 - keep_i)
    pos = torch.where(keep, rank_keep, n_keep + rank_drop).long()
    perm = torch.empty(n, dtype=torch.long, device=dev).index_put((pos,), ar)
    base = torch.clamp(g.n_obs, max=cap_e - n)
    rows = (base + ar).long()
    g = dataclasses.replace(
        g,
        obs_pose=g.obs_pose.index_put((rows,), pose_idx.to(torch.int32).expand(n)),
        obs_lm=g.obs_lm.index_put((rows,), target[perm]),
        obs_xy=g.obs_xy.index_put((rows,), body_all[perm]),
        n_obs=torch.clamp(g.n_obs + n_keep, max=cap_e).to(torch.int32),
    )

    do_opt = closing & ~state.loop_closure_complete
    return dataclasses.replace(
        state, graph=g, current_cone_index=cur.to(torch.int32), loop_closing=closing,
        loop_closure_complete=state.loop_closure_complete | closing,
    ), do_opt


def _localization_step(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                       pre, indexed: bool):
    """Localization mode against the frozen map: first match per
    observation (the kernel's nearest match on the indexed path) and
    min-range current-cone tracking. Publishes the odometry pose."""
    g = state.graph
    _glob, _body, pay_a, pay_b = pre
    if indexed:
        j, matched = pay_a, pay_b
    else:
        cost, gate = pay_a, pay_b
        if cfg.reference_compat and cfg.localizer_type_bug:
            # signed compare, reference src/slam.cpp:360
            type_ok = (g.lm_type[None, :].to(torch.float32) - obs[:, 3][:, None]) < 1e-4
        else:
            type_ok = g.lm_type[None, :] == obs[:, 3].to(torch.int32)[:, None]
        ok = type_ok & g.lm_valid[None, :] & obs_valid[:, None] & (cost < gate)
        j = _first_index(ok)
        matched = torch.any(ok, dim=1)

    dist2car = torch.where(matched, obs[:, 2], 1e30)
    best = torch.argmin(dist2car, dim=0, keepdim=True)
    cur_new = torch.where(torch.any(matched), j[best][0], state.current_cone_index)
    send_cones = cur_new != state.current_cone_index
    return dataclasses.replace(state, current_cone_index=cur_new.to(torch.int32),
                               send_cone_data=send_cones), pose


def _cone_packet(state: SlamState, out_pose, cfg: SlamConfig):
    """Upcoming-cone egress: the `cones_per_packet` map cones from
    current_cone_index, ring-wrapped once as the reference does."""
    g = state.graph
    k = torch.arange(cfg.cones_per_packet, device=out_pose.device)
    idx = state.current_cone_index + k
    n = torch.clamp(g.n_landmarks, min=1)
    idx = torch.where(idx < n, idx, idx - n)
    idx = torch.minimum(torch.clamp(idx, min=0), n - 1).long()
    az, dist = global_to_body_spherical(out_pose, g.lm_xy[idx], cfg.reference_compat)
    return az, dist, g.lm_type[idx]


def perform_keyframe(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                     assoc_mesh=None):
    """Full keyframe update. obs [N,4] = (az_deg, zen_deg, dist, type),
    obs_valid [N] bool, pose [3] (odometry, heading-corrected), all on one
    device. Returns (new_state, KeyframeOutputs); `state` is not modified.
    """
    _check_supported(cfg, assoc_mesh)
    dev = obs.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    # GPS outlier guard (reference src/slam.cpp:300-303)
    ok_pose = (torch.abs(pose[0]) <= cfg.gps_outlier_bound) & \
              (torch.abs(pose[1]) <= cfg.gps_outlier_bound)
    n_valid = torch.sum(obs_valid)
    run, frozen, enough = torch.stack(
        [ok_pose, state.loop_closure_complete, n_valid > 1]).tolist()

    out_pose, closed, send = pose, false, false
    if run:
        g = state.graph
        prev = g.poses[torch.clamp(g.n_poses - 1, min=0).reshape(1).long()][0]
        odo = torch.where(g.n_poses > 0, se2.between(prev, pose), torch.zeros_like(pose))
        g = G.add_pose(g, pose, odo)
        pose_idx = g.n_poses - 1
        state = dataclasses.replace(state, graph=g, keyframe_count=state.keyframe_count + 1)
        pre = _associate_shared(state, obs, obs_valid, pose, cfg)
        indexed = _use_assoc_kernel(cfg)
        if frozen:
            # the reference needs more than one cone to localize (src/slam.cpp:332)
            if enough:
                state, out_pose = _localization_step(state, obs, obs_valid, pose, cfg,
                                                     pre, indexed)
                send = ~false
        else:
            state, closed = _mapping_step_vectorized(state, obs, obs_valid, pose, pose_idx,
                                                     cfg, pre, indexed)
            if bool(closed):
                # one-shot closure: full GN re-optimization, then the map freezes
                state = dataclasses.replace(
                    state, graph=gn.optimize(state.graph, _gn_config(cfg)))
    az, dist, ctype = _cone_packet(state, out_pose, cfg)
    outputs = KeyframeOutputs(pose=out_pose, cone_azimuth=az, cone_distance=dist,
                              cone_type=ctype, send=send, loop_closed=closed,
                              n_landmarks=state.graph.n_landmarks)
    return state, outputs
