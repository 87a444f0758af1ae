"""The per-keyframe SLAM update (counterpart of `tpuslam.frontend.keyframe`).

GPS-outlier guard, pose insertion, data association, landmark creation,
loop-closure detection, the one-shot closure Gauss-Newton, localization and
the egress packet, with the reference's sequential-within-frame semantics
expressed as vector ops over the observation axis (the JAX package's
vectorized mapping step).

The JAX package's `lax.cond` gates become Python branches: each keyframe
reads (pose in bounds, map frozen, enough valid cones, periodic GN due in
localization) from the device in one transfer, and a mapping keyframe reads
(closure due, periodic GN due) in a second. The periodic GN adds one read
per iteration for its early exit.

Supported here: the reference-compat configuration and the improved mode
(GPS/heading priors, Mahalanobis gating, the localizer and publish
refines, fixed-lag or full-batch periodic GN), with 'first', 'nearest' or
'mahalanobis' association, dense or, for the last two, through the
association kernel (`use_pallas_association`; 'first' needs index order
and stays dense, as in the JAX package), and the scan-form mapping step
(`vectorized_mapping=False`). `use_ekf_fusion` is read by the service's
`core.slam.Slam` alone, as in the JAX package.

With `assoc_mesh` (a `DeviceMesh` with an 'edges' axis) the association
runs against the landmark map sharded over that axis
(`parallel.map_blocks.associate_sharded`), every policy, 'first' too; like
the kernel it is an index provider, so localization takes its semantics
(type equality without the reference's signed compare), as in the JAX
package. `defer_gn=True` runs no full GN: the keyframe returns whether it
wants the closure GN and a full-batch periodic GN, for the per-frame
batched engine (`parallel.batch`) to run after the frame.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend import graph as G
from tpuslam_torch.frontend.state import SlamState, map_state, session_state
from tpuslam_torch.geometry import se2
from tpuslam_torch.geometry.spherical import (
    cone_to_global, global_to_body_spherical, lane_uniform, spherical_to_cartesian,
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


def _check_supported(cfg: SlamConfig) -> None:
    """Refuse, as the JAX package does, the two combinations that have no
    meaning."""
    if not cfg.vectorized_mapping:
        if cfg.association == "mahalanobis":
            raise ValueError("mahalanobis association requires vectorized_mapping=True "
                             "(the scan-form mapping step is the reference-faithful "
                             "Euclidean path)")
        if cfg.mapping_publish_refine:
            raise ValueError("mapping_publish_refine requires vectorized_mapping=True")


def _body_xy(ob, cfg: SlamConfig):
    """Observation spherical triple -> body-frame Cartesian measurement."""
    xyz = spherical_to_cartesian(ob[..., 0], ob[..., 1], ob[..., 2],
                                 cfg.lidar_to_cog, cfg.reference_compat)
    return xyz[..., :2]


def _f32(x) -> float:
    """A Python float holding the f32 value of `x`, so an f32 tensor times
    it computes what the JAX package's f32 constant does."""
    return float(np.float32(x))


def _obs_information(glob, pose, dist, cfg: SlamConfig):
    """Per-observation 2x2 measurement information in the global frame,
    packed (a, b, c): range noise along the pose-to-landmark ray, bearing
    noise (range * sigma_az) across it. It accumulates into
    `SlamState.lm_info_xy` and drives the Mahalanobis gate. `dist` is
    unused, as in the JAX package."""
    d = glob[..., :2] - pose[..., :2]
    rng = torch.clamp(torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]), min=1e-3)
    ux, uy = d[..., 0] / rng, d[..., 1] / rng
    sig_r = np.float32(cfg.obs_noise_std)
    sig_t = torch.clamp(rng * _f32(np.float32(cfg.obs_noise_az_deg) * np.float32(np.pi / 180)),
                        min=1e-2)
    ir = _f32(np.float32(1.0) / (sig_r * sig_r))
    it = 1.0 / (sig_t * sig_t)
    # R^-1 = ir u u^T + it t t^T with t = (-uy, ux)
    a = ir * ux * ux + it * uy * uy
    b = (ir - it) * ux * uy
    c = ir * uy * uy + it * ux * ux
    return torch.stack([a, b, c], dim=-1)


def _innovation_info(lm_info, cfg: SlamConfig):
    """Packed (a, b, c) landmark information -> packed innovation
    information (Sigma_lm + sigma_r^2 I)^-1: the gate tightens from the
    fresh-landmark radius toward the sensor-noise floor, and no further."""
    a, b, c = lm_info[..., 0], lm_info[..., 1], lm_info[..., 2]
    det = torch.clamp(a * c - b * b, min=1e-12)
    s2 = _f32(np.float32(cfg.obs_noise_std) ** 2)
    sa = c / det + s2
    sb = -b / det
    sc = a / det + s2
    dets = torch.clamp(sa * sc - sb * sb, min=1e-12)
    return torch.stack([sc / dets, -sb / dets, sa / dets], dim=-1)


def _gate_cost(diff, d2, lm_info, cfg: SlamConfig):
    """(N x M) gating cost and its threshold: squared Euclidean against the
    reference threshold, or Mahalanobis d^T S^-1 d (S the innovation
    covariance) against the chi-square bound, where a landmark with no
    information yet takes the Euclidean cost scaled to that bound."""
    thresh2 = cfg.same_cone_threshold ** 2
    if cfg.association != "mahalanobis":
        return d2, thresh2
    inno = _innovation_info(lm_info, cfg)
    a, b, c = inno[..., None, :, 0], inno[..., None, :, 1], inno[..., None, :, 2]
    dx, dy = diff[..., 0], diff[..., 1]
    mahal = a * dx * dx + 2.0 * b * dx * dy + c * dy * dy
    has_info = (lm_info[..., 0] + lm_info[..., 2])[..., None, :] > 0.0
    cost = torch.where(has_info, mahal, d2 * (cfg.mahalanobis_gate / thresh2))
    return cost, cfg.mahalanobis_gate


def _use_assoc_kernel(cfg: SlamConfig) -> bool:
    """True when the association payload is (match_idx, matched) from the
    kernel instead of the dense (N x M) cost matrix."""
    return cfg.use_pallas_association and cfg.association != "first"


def _indexed_assoc(cfg: SlamConfig, assoc_mesh=None) -> bool:
    """True when the association payload is (match_idx, matched) from an
    index provider (the kernel, or the mesh-sharded map) instead of the
    dense (N x M) cost matrix."""
    return assoc_mesh is not None or _use_assoc_kernel(cfg)


def _associate_shared(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                      assoc_mesh=None):
    """Observations to the global frame, body-frame measurements, and the
    association payload: the dense (N x M) gating cost and its gate, or an
    index provider's (match_idx, matched) without the cost matrix."""
    glob_all = cone_to_global(pose, obs[:, 0], obs[:, 1], obs[:, 2],
                              cfg.lidar_to_cog, cfg.reference_compat)
    body_all = _body_xy(obs, cfg)
    g = state.graph
    if _indexed_assoc(cfg, assoc_mesh):
        j, matched, _ = _provider_associate(glob_all, obs[:, 3], obs_valid, g.lm_xy,
                                            g.lm_type, g.n_landmarks, state.lm_info_xy, cfg,
                                            assoc_mesh)
        return glob_all, body_all, j, matched
    diff = glob_all[:, None, :] - g.lm_xy[None, :, :]
    cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), state.lm_info_xy, cfg)
    return glob_all, body_all, cost, gate


@functools.lru_cache(maxsize=64)
def _const(values: tuple, dtype, device):
    """A small constant tensor, made once per device: a copy from host
    memory cannot be captured into a CUDA graph, so code that a graph
    captures (`frontend.blocked`) takes its constants from here, made
    by the eager run before the capture. Never written to."""
    return torch.tensor(values, dtype=dtype, device=device)


def _mahal_packed(lm_info, cfg: SlamConfig):
    """Packed innovation information, with the scaled-Euclidean cost of a
    landmark that has no information yet: the per-landmark payload the
    kernel gates with under 'mahalanobis'."""
    fallback = cfg.mahalanobis_gate / cfg.same_cone_threshold ** 2
    has = (lm_info[..., 0] + lm_info[..., 2]) > 0.0
    return torch.where(has[..., None], _innovation_info(lm_info, cfg),
                       _const((fallback, 0.0, fallback), lm_info.dtype, lm_info.device))


def _provider_associate(glob, otype, valid, lm_xy, lm_type, n_landmarks, lm_info,
                        cfg: SlamConfig, assoc_mesh=None):
    """(match_idx, matched, cost) for a flat observation batch, or one per
    session with a leading session axis on every argument. With
    `assoc_mesh`, from the landmark map sharded over its 'edges' axis
    (`parallel.map_blocks.associate_sharded`, in `cfg.association`'s
    policy). Else from the association kernel, Euclidean or Mahalanobis
    (against `lm_info`), which reads the float type column `otype` as int32
    and masks invalid observations and landmarks past `n_landmarks` itself:
    neither ever matches, as the types -2 and -1 of the JAX package's
    `_provider_associate` do."""
    if assoc_mesh is not None:
        from tpuslam_torch.parallel.map_blocks import associate_sharded
        lm_valid = torch.arange(lm_xy.shape[-2], device=lm_xy.device) < n_landmarks[..., None]
        otype = otype.to(torch.int32)
        if cfg.association == "mahalanobis":
            p = _mahal_packed(lm_info, cfg)
            a, b, c = p[..., 0], p[..., 1], p[..., 2]
            cov_inv = torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)], -2)
            return associate_sharded(glob, otype, valid, lm_xy, lm_type, lm_valid,
                                     cfg.mahalanobis_gate, assoc_mesh, mode="mahalanobis",
                                     lm_cov_inv=cov_inv)
        return associate_sharded(glob, otype, valid, lm_xy, lm_type, lm_valid,
                                 cfg.same_cone_threshold, assoc_mesh, mode=cfg.association)
    return _launch_assoc(*_assoc_kernel_args(glob, otype, valid, lm_xy, lm_type, n_landmarks,
                                             lm_info, cfg))


def _assoc_kernel_args(glob, otype, valid, lm_xy, lm_type, n_landmarks, lm_info,
                       cfg: SlamConfig):
    """The association kernel's (positional, keyword) arguments for
    `_provider_associate`'s inputs, in `cfg.association`'s gate."""
    kw = dict(obs_valid=valid, lm_count=n_landmarks)
    if cfg.association == "mahalanobis":
        return ((glob.contiguous(), otype, lm_xy, lm_type, cfg.mahalanobis_gate,
                 _mahal_packed(lm_info, cfg)), dict(kw, mahalanobis=True))
    return (glob.contiguous(), otype, lm_xy, lm_type, cfg.same_cone_threshold ** 2), kw


def _launch_assoc(args, kw, out=None):
    """The association kernel on `_assoc_kernel_args`' arguments, into `out`
    (idx, matched, cost) when given."""
    return associate_kernel(*args, **kw, out=out)


def _add_info(lm_info, to, info):
    """Out-of-place `lm_info[to] += info`, rows `to` equal to len(lm_info)
    dropped. An accumulating `index_put` adds the rows of one destination
    in row order, on the CPU and (after a stable sort) on CUDA, so the sums
    do not depend on thread timing."""
    buf = torch.cat([lm_info, lm_info.new_zeros(1, 3)])
    return buf.index_put((to,), info, accumulate=True)[:lm_info.shape[0]]


def _first_index(mask):
    """Index of the first True along the last axis (0 if none), like
    `jnp.argmax` on a bool mask; `torch.argmax` refuses bools."""
    return torch.argmax(mask.to(torch.uint8), dim=-1).to(torch.int32)


def _prefix_argmin_exclusive(vals, idxs):
    """Running (min, argmin) along the last axis over k < i, ties keeping
    the earliest; (inf, -1) at i = 0. `torch.cummin` keeps the latest on
    ties, so this takes a masked [..., N, N] min with a first-index argmin
    instead."""
    n = vals.shape[-1]
    k = torch.arange(n, device=vals.device)
    before = torch.where(k[None, :] < k[:, None], vals[..., None, :], _INF)
    mv = torch.min(before, dim=-1).values
    mi = idxs[torch.argmin(before, dim=-1)]
    mi = torch.where(k == 0, -1, mi).to(idxs.dtype)
    return mv, mi


def _mapping_step_vectorized(state: SlamState, obs, obs_valid, pose, pose_idx,
                             cfg: SlamConfig, pre, indexed: bool):
    """Mapping-mode update with the reference's sequential semantics as
    vector ops: an (N x M) gated association, prefix scans over the
    observation axis for the in-frame running state, in-frame duplicate
    merging, and one contiguous edge-block append. Returns the new state,
    whether the closure GN is due, and the rows the publish refine weighs
    (landmark index, matched, body-frame measurement)."""
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

    # per-landmark measurement information (Mahalanobis): matched and
    # duplicate observations add theirs to the landmark's row, a new
    # landmark starts with its first observation's (the bootstrap landmark
    # is matched again in phase A, so its first observation counts there)
    lm_info = state.lm_info_xy
    if cfg.association == "mahalanobis":
        contributes = matched | ((is_new | is_dup) & slot_ok)
        lm_info = _add_info(lm_info, torch.where(contributes, target, cap_l).long(),
                            _obs_information(glob_all, pose, d2car, cfg))

    do_opt = closing & ~state.loop_closure_complete
    return dataclasses.replace(
        state, graph=g, current_cone_index=cur.to(torch.int32), loop_closing=closing,
        loop_closure_complete=state.loop_closure_complete | closing, lm_info_xy=lm_info,
    ), do_opt, (torch.where(matched, j, 0).long(), matched, body_all)


def _mapping_step(state: SlamState, obs, obs_valid, pose, pose_idx, cfg: SlamConfig,
                  enable=None):
    """Reference-faithful mapping-mode update (src/slam.cpp:552-635) of each
    session of a stacked state [S]: one observation slot after the other,
    each gated against its session's map as the earlier ones of the frame
    left it. obs [S, N, 4], obs_valid [S, N], pose [S, 3], pose_idx [S];
    `enable` [S] (None: every session) leaves the other sessions as they
    were. Every step is one [S, L] op per quantity, masked per session, so
    the loop reads nothing back from the device; one session's update is
    the case S = 1. Returns the new state and whether each session's
    closure GN is due [S]."""
    g = state.graph
    S, N = obs_valid.shape
    dev = obs.device
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    glob_all = cone_to_global(pose[:, None, :], obs[..., 0], obs[..., 1], obs[..., 2],
                              cfg.lidar_to_cog, cfg.reference_compat)
    body_all = _body_xy(obs, cfg)
    otype = obs[..., 3].to(torch.int32)
    if enable is not None:
        obs_valid = obs_valid & enable[:, None]
    kl = torch.arange(g.lm_xy.shape[-2], device=dev)
    sess = None if S == 1 else torch.arange(S, device=dev)

    def lm_at(idx):
        return g.lm_xy[0][idx] if sess is None else g.lm_xy[sess, idx]

    # Bootstrap: an empty map seeds landmark 0 from observation 0, which the
    # loop then matches again: two edges, as in the reference
    boot = (g.n_landmarks == 0) & obs_valid[:, 0]
    g = G.add_landmark(g, glob_all[:, 0], otype[:, 0], enable=boot)
    g = G.add_observation(g, pose_idx, 0, body_all[:, 0], enable=boot)

    cur, closing = state.current_cone_index, state.loop_closing
    min_dist = torch.full((S,), 100.0, dtype=obs.dtype, device=dev)
    for i in range(N):
        glob, dist2car = glob_all[:, i], obs[:, i, 2]
        live = obs_valid[:, i] & ~closing
        d = g.lm_xy - glob[:, None, :]
        d2 = torch.sum(d * d, dim=-1)
        ok = ((g.lm_type == otype[:, i, None]) & (kl < g.n_landmarks[:, None])
              & (d2 < thresh2) & live[:, None])
        if cfg.association == "first":
            j = _first_index(ok)
        else:
            j = torch.argmin(torch.where(ok, d2, 1e30), dim=-1).to(torch.int32)
        matched = torch.any(ok, dim=-1)
        g = G.add_observation(g, pose_idx, j, body_all[:, i], enable=matched)
        # the closure test runs before the current-index update, with the
        # index before it (reference src/slam.cpp:593 before :598)
        d_first = torch.sum((lm_at(j.long()) - g.lm_xy[:, 0]) ** 2, dim=-1)
        closure = (matched & (d_first < cfg.loop_closure_radius ** 2)
                   & (cur > cfg.loop_closure_min_index)
                   & (dist2car < cfg.cone_mapping_threshold))
        upd = matched & (dist2car < min_dist)
        cur = torch.where(upd, j, cur)
        min_dist = torch.where(upd, dist2car, min_dist)
        new_cone = live & ~matched & (dist2car < cfg.cone_mapping_threshold)
        slot = g.n_landmarks
        g = G.add_landmark(g, glob, otype[:, i], enable=new_cone)
        g = G.add_observation(g, pose_idx, slot, body_all[:, i], enable=new_cone)
        closing = closing | closure

    do_opt = closing & ~state.loop_closure_complete
    return dataclasses.replace(
        state, graph=g, current_cone_index=cur.to(torch.int32), loop_closing=closing,
        loop_closure_complete=state.loop_closure_complete | closing,
    ), do_opt


def _sum_rows(x, dim: int):
    """Sum along `dim` in row order. On the CPU a cumulative sum adds the
    rows one after the other (in float64), so zero rows anywhere leave the
    total bit-equal: a keyframe's 64 observation slots and a block's
    compacted ones give the same sums."""
    return torch.cumsum(x, dim).select(dim, -1)


def _with_heading_wrapped(p):
    return torch.cat([p[..., :2], se2.wrap_angle(p[..., 2:])], dim=-1)


def _refine_system(p, lm, meas_xy, w):
    """(H [..., 3, 3], g [..., 3]) of the landmark-fixed pose GN at poses
    `p` [..., 3] over rows lm [..., E, 2] / meas_xy [..., E, 2] weighted by
    w [..., E]: the residual and pose Jacobian of
    `backend.residuals.landmark_residuals`, written out per element so that
    a batch of keyframes and a single one compute each value alike."""
    c = lane_uniform(torch.cos, p[..., 2])[..., None]
    s = lane_uniform(torch.sin, p[..., 2])[..., None]
    dx = lm[..., 0] - p[..., 0:1]
    dy = lm[..., 1] - p[..., 1:2]
    r0 = c * dx + s * dy - meas_xy[..., 0]
    r1 = -s * dx + c * dy - meas_xy[..., 1]
    j0 = torch.stack([-c.expand_as(dx), -s.expand_as(dx), -s * dx + c * dy], dim=-1)
    j1 = torch.stack([s.expand_as(dx), -c.expand_as(dx), -c * dx - s * dy], dim=-1)
    jj = j0[..., :, None] * j0[..., None, :] + j1[..., :, None] * j1[..., None, :]
    jr = j0 * r0[..., None] + j1 * r1[..., None]
    return _sum_rows(w[..., None, None] * jj, -3), _sum_rows(w[..., None] * jr, -2)


def _solve3(h, rhs):
    """Batched 3x3 solve with no host read (`solve` checks for singular
    matrices on the host)."""
    return torch.linalg.solve_ex(h, rhs).result


def _pose_refine_rows(pose, lm, matched, meas_xy, iters: int = 3):
    """Pose-only GN against fixed landmark rows (the localizer refine, an
    improvement over the reference, whose localization-mode optimize is
    disabled, src/slam.cpp:403), batched over leading axes; poses with
    fewer than two matched rows come back unchanged."""
    w = matched.to(pose.dtype)
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device) * 1e-6
    p = pose
    for _ in range(iters):
        h, b = _refine_system(p, lm, meas_xy, w)
        p = _with_heading_wrapped(p + _solve3(h + eye, -b))
    return torch.where((torch.sum(w, dim=-1) >= 2)[..., None], p, pose)


def _publish_refine(pose_meas, lm, matched, meas_xy, cfg: SlamConfig, iters: int = 3):
    """MAP estimate of the published pose (`mapping_publish_refine`),
    batched over leading axes: landmark-fixed GN over the matched cone
    measurements plus the GPS/heading prior anchored at the measured pose,
    which keeps the 3x3 system nonsingular (no match: the measured pose
    back). Output only; the graph never sees it."""
    w = matched.to(pose_meas.dtype) * cfg.publish_refine_obs_info
    ixy = 1.0 / cfg.gps_prior_std ** 2
    ith = 1.0 / cfg.heading_prior_std ** 2
    prior_d = _const((ixy, ixy, ith), pose_meas.dtype, pose_meas.device)
    p = pose_meas
    for _ in range(iters):
        h, b = _refine_system(p, lm, meas_xy, w)
        b = b + prior_d * _with_heading_wrapped(p - pose_meas)
        p = _with_heading_wrapped(p + _solve3(h + torch.diag(prior_d), -b))
    return p


def _localization_step(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                       pre, indexed: bool):
    """Localization mode against the frozen map: first match per
    observation (the kernel's nearest match on the indexed path) and
    min-range current-cone tracking. Publishes the odometry pose, or with
    `localizer_refine` its pose-only refine against the matched landmarks."""
    g = state.graph
    _glob, body_all, pay_a, pay_b = pre
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
    out_pose = pose
    if cfg.localizer_refine:
        out_pose = _pose_refine_rows(pose, g.lm_xy[j.long()], matched, body_all)
    return dataclasses.replace(state, current_cone_index=cur_new.to(torch.int32),
                               send_cone_data=send_cones), out_pose


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


def _periodic_due(keyframe_count, n_landmarks, cfg: SlamConfig):
    """Whether the periodic GN fires after a keyframe: every
    `periodic_gn_every` keyframes, once the map holds more than 4 landmarks."""
    if cfg.periodic_gn_every <= 0:
        return torch.zeros_like(n_landmarks, dtype=torch.bool)
    return (torch.remainder(keyframe_count, cfg.periodic_gn_every) == 0) & (n_landmarks > 4)


def _periodic_gn_config(cfg: SlamConfig) -> gn.GNConfig:
    return dataclasses.replace(_gn_config(cfg), iterations=cfg.periodic_gn_iterations)


def periodic_gn(g, cfg: SlamConfig, end=None, end_obs=None, enable=None):
    """One firing of the periodic re-optimization: fixed-lag over the last
    `periodic_gn_window` poses (anchored at `end` / `end_obs` when given),
    or full-batch when the window is 0. On a stacked graph [S], `enable`
    [S] says which sessions fire (the others come back bit for bit), and
    `end` / `end_obs` are [S]."""
    pcfg = _periodic_gn_config(cfg)
    if cfg.periodic_gn_window > 0:
        return gn.optimize_window(g, pcfg, cfg.periodic_gn_window, cfg.periodic_gn_edge_window,
                                  enable=enable, landmarks=cfg.periodic_gn_window_landmarks,
                                  end=end, end_obs=end_obs)
    return gn.optimize(g, pcfg, enable=enable)


def _prior_info(cfg: SlamConfig):
    """The GPS/heading prior information of a new pose, or None."""
    if not cfg.use_gps_prior:
        return None
    return (1.0 / cfg.gps_prior_std ** 2, 1.0 / cfg.heading_prior_std ** 2)


def perform_keyframe(state: SlamState, obs, obs_valid, pose, cfg: SlamConfig,
                     defer_gn: bool = False, assoc_mesh=None):
    """Full keyframe update. obs [N,4] = (az_deg, zen_deg, dist, type),
    obs_valid [N] bool, pose [3] (odometry, heading-corrected), all on one
    device. Returns (new_state, KeyframeOutputs); `state` is not modified.

    `defer_gn=True` runs neither the closure GN nor a full-batch periodic GN
    (a fixed-lag window GN still runs in the keyframe) and returns
    (new_state, outputs, closure wanted, periodic GN wanted), the last two
    0-dim bools: the outputs are then those before those GNs. `assoc_mesh`
    routes the association through the mesh-sharded map.
    """
    _check_supported(cfg)
    dev = obs.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    # GPS outlier guard (reference src/slam.cpp:300-303)
    ok_pose = (torch.abs(pose[0]) <= cfg.gps_outlier_bound) & \
              (torch.abs(pose[1]) <= cfg.gps_outlier_bound)
    n_valid = torch.sum(obs_valid)
    # in localization the map does not grow, so whether the periodic GN
    # fires is known before the update
    run, frozen, enough, fire = torch.stack(
        [ok_pose, state.loop_closure_complete, n_valid > 1,
         _periodic_due(state.keyframe_count + 1, state.graph.n_landmarks, cfg)]).tolist()

    out_pose, closed, send = pose, false, false
    want_periodic = False
    if run:
        g = state.graph
        prev = g.poses[torch.clamp(g.n_poses - 1, min=0).reshape(1).long()][0]
        odo = torch.where(g.n_poses > 0, se2.between(prev, pose), torch.zeros_like(pose))
        g = G.add_pose(g, pose, odo, prior_info=_prior_info(cfg))
        pose_idx = g.n_poses - 1
        state = dataclasses.replace(state, graph=g, keyframe_count=state.keyframe_count + 1)
        pre = _associate_shared(state, obs, obs_valid, pose, cfg, assoc_mesh)
        indexed = _indexed_assoc(cfg, assoc_mesh)
        if frozen:
            # the reference needs more than one cone to localize (src/slam.cpp:332)
            if enough:
                state, out_pose = _localization_step(state, obs, obs_valid, pose, cfg,
                                                     pre, indexed)
                send = ~false
        else:
            if cfg.vectorized_mapping:
                state, closed, pub_rows = _mapping_step_vectorized(
                    state, obs, obs_valid, pose, pose_idx, cfg, pre, indexed)
            else:
                st1, closed = _mapping_step(map_state(lambda x: x[None], state), obs[None],
                                            obs_valid[None], pose[None], pose_idx.reshape(1), cfg)
                state, closed = session_state(st1, 0), closed[0]
            do_close, fire = torch.stack(
                [closed, _periodic_due(state.keyframe_count, state.graph.n_landmarks,
                                       cfg)]).tolist()
            if do_close and not defer_gn:
                # one-shot closure: full GN re-optimization, then the map freezes
                state = dataclasses.replace(
                    state, graph=gn.optimize(state.graph, _gn_config(cfg)))
            if cfg.mapping_publish_refine:
                # refine the published pose against the committed landmark
                # rows, once the first periodic refresh has run: against a
                # never-optimized map the refine measures worse than the raw
                # publish
                lm_idx, matched, body = pub_rows
                ref = _publish_refine(pose, state.graph.lm_xy[lm_idx], matched, body, cfg)
                out_pose = torch.where(pose_idx >= cfg.periodic_gn_every, ref, pose)
        if fire and defer_gn and cfg.periodic_gn_window == 0:
            want_periodic = True
        elif fire:
            state = dataclasses.replace(state, graph=periodic_gn(state.graph, cfg))
        if cfg.use_gps_prior and not cfg.mapping_publish_refine:
            # mapping mode publishes the graph's latest pose (refreshed by the
            # periodic GN); localization keeps the localizer's pose
            use_graph = ~state.loop_closure_complete & (state.graph.n_landmarks > 4)
            out_pose = torch.where(use_graph,
                                   state.graph.poses[pose_idx.reshape(1).long()][0], out_pose)
    az, dist, ctype = _cone_packet(state, out_pose, cfg)
    outputs = KeyframeOutputs(pose=out_pose, cone_azimuth=az, cone_distance=dist,
                              cone_type=ctype, send=send, loop_closed=closed,
                              n_landmarks=state.graph.n_landmarks)
    if defer_gn:
        # `loop_closed` then says the closure GN is wanted, not that it ran
        return state, outputs, closed, torch.tensor(want_periodic, device=dev)
    return state, outputs
