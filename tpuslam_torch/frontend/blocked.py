"""Frame-blocked pipeline: B keyframes per step (counterpart of
`tpuslam.frontend.blocked`).

A pass runs in three parts, as in the JAX package:

- **mapping blocks** run the batched mapping update over the flattened
  [B * nc] observation axis of B keyframes at once: one association against
  the block-start map, in-block landmark creations with duplicate
  representatives across and within frames, the reference's
  ``currentConeIndex`` carry as a within-frame prefix argmin plus a
  last-valid carry across frames, and exact loop-closure detection. The
  closure block commits its frames up to and including the closure frame;
  the blocks stop there.
- **the closure**: one `gauss_newton.optimize` on exactly the graph the
  per-frame path's closure GN saw, then the closure frame's cone packet is
  recomputed from the optimized map.
- **localization blocks** run the frozen-map localizer for every frame after
  the closure frame.

The JAX package writes each part as a straight-line `lax.scan` body with
elementwise state selects, because a conditional in a TPU loop costs
whether taken or not. Here the blocks are a Python loop: each block computes
its candidate state out of place, reads (fallback, closure, closure frame
and, with a periodic GN, which frames fire) from the device in one
transfer, and a Python branch keeps the old state or the new one. Blocks
the JAX package runs as exact no-ops (mapping blocks after the closure,
localization blocks before it) do not run, and the edge rows are appended
per block. Host reads per pass: one for the compaction width, one per
block, and the GNs' own (one per iteration).

A write the JAX package drops with ``mode="drop"`` (a landmark slot, pose
or edge past its capacity) is sent to a spare row past the end of the
array, which is sliced off: on CUDA an out-of-range index is a device-side
assert.

Blocks the blocked form cannot commit exactly (an empty map whose first
observation slot is invalid, capacity saturation, a frame with more valid
observations than the compaction width) stop the pass at their first
frame, `done_upto`, and `run_sequence_blocked` finishes the remaining
frames with the per-frame `perform_keyframe`.

The improved mode runs here as in the JAX package:

- **GPS/heading priors** go in with the block's poses; the localizer refine
  runs for every frame of a localization block, and the publish refine for
  every frame of a mapping block.
- **Periodic GN** in two regimes (`_mapping_periodic`): a period that is a
  whole number of blocks fires only on a block's last frame, exactly where
  the per-frame path fires; a period that divides the block runs each
  firing's fixed-lag solve after the block's mapping, anchored at its
  firing frame's pose and edge counts, and frames after a firing see the
  refined map only from the next block on. A firing the blocks cannot
  reproduce (mid-block in the first regime, or on the closure frame)
  stops the blocks there.
- **Mahalanobis association** gates a block against the information at
  block start, so it lags the per-frame path by up to block - 1 frames
  (exact at block 1); in-block creations compete at the zero-information
  scaled-Euclidean cost, and the block's committed observations add their
  information once.

On the CPU, results equal `run_sequence`'s bit for bit wherever the JAX
package's blocked path equals its per-frame path (tests/test_torch_blocked.py);
on CUDA the GN's sums are atomics, so values after a GN may differ in the
last bits from run to run. Association is 'first', 'nearest' or
'mahalanobis', dense or, for the last two, through the association kernel
(`use_pallas_association`), which then runs once per block over all its
observations. `run_sequence_blocked` raises `ValueError` where the JAX
package's does (`blocked_supported`), and `NotImplementedError`, naming the
field, for the EKF fusion and `assoc_mesh`, which are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend import graph as G
from tpuslam_torch.frontend.keyframe import (
    KeyframeOutputs, _add_info, _body_xy, _check_supported, _first_index, _gate_cost,
    _gn_config, _obs_information, _periodic_due, _pose_refine_rows, _prefix_argmin_exclusive,
    _prior_info, _provider_associate, _publish_refine, _use_assoc_kernel, periodic_gn,
)
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import SlamState, initial_state
from tpuslam_torch.geometry import se2
from tpuslam_torch.geometry.spherical import cone_to_global, global_to_body_spherical
from tpuslam_torch.runtime.config import SlamConfig

__all__ = ["run_sequence_blocked", "run_pass_blocked", "blocked_supported",
           "blocked_core"]

_INF = float("inf")
_I32 = torch.int32


def _midblock_gn(cfg: SlamConfig, block: int) -> bool:
    """True when the periodic GN fires at sub-boundaries inside a block: its
    period divides the block, and each block runs up to block / period
    fixed-lag solves after its mapping, each anchored at its firing
    frame's pose and edge counts."""
    return (0 < cfg.periodic_gn_every < block
            and block % cfg.periodic_gn_every == 0
            and cfg.periodic_gn_window > 0)


def blocked_supported(cfg: SlamConfig, block: int = 8) -> bool:
    """Configurations the JAX package's blocked path reproduces; the port
    refuses the same ones with `ValueError`."""
    return (cfg.association in ("first", "nearest", "mahalanobis")
            and not (cfg.use_pallas_association
                     and cfg.association == "first")
            and cfg.vectorized_mapping
            and (cfg.periodic_gn_every == 0
                 or cfg.periodic_gn_every % block == 0
                 or _midblock_gn(cfg, block)))


def _last_valid_inclusive(init, has, val):
    """s[f] = val[f] if has[f] else s[f-1], with s[-1] = init."""
    ar = torch.arange(has.shape[0], device=has.device)
    last = torch.cummax(torch.where(has, ar, -1), dim=0).values
    return torch.where(last >= 0, val[torch.clamp(last, min=0)], init).to(val.dtype)


def _exclusive_from_inclusive(series, init):
    head = (init.reshape(1).to(series.dtype) if torch.is_tensor(init)
            else series.new_full((1,), init))
    return torch.cat([head, series[:-1]])


def _drop_set(x, to, values):
    """Out-of-place `x[to] = values` where rows `to` equal to len(x) are
    dropped: they land in a spare row that is sliced off."""
    spare = x.new_zeros((1,) + tuple(x.shape[1:]))
    return torch.cat([x, spare]).index_put((to,), values)[:x.shape[0]]


def _pose_insert_plan(g, poses, ok_pose):
    """Per-frame pose indices and odometry measurements of the block's
    insertions (no writes). The session's first pose gets a zero
    measurement; every other insertion measures against the previous
    inserted pose's estimate: the graph's last pose for the block's first
    insertion, the raw input pose after it (no GN runs inside a block)."""
    B = poses.shape[0]
    ins_i = ok_pose.to(_I32)
    pose_idx = g.n_poses + torch.cumsum(ins_i, 0, dtype=_I32) - 1
    fidx = torch.arange(B, dtype=_I32, device=poses.device)
    prev_f = _exclusive_from_inclusive(_last_valid_inclusive(-1, ok_pose, fidx), -1)
    prev0 = g.poses[torch.clamp(g.n_poses - 1, min=0).reshape(1).long()]
    prev = torch.where((prev_f >= 0)[:, None], poses[torch.clamp(prev_f, min=0).long()], prev0)
    odo = torch.where((pose_idx == 0)[:, None], torch.zeros_like(poses),
                      se2.between(prev, poses))
    return pose_idx, odo


def _scatter_poses(g, poses, odo, pose_idx, ins, cfg: SlamConfig):
    """Masked block pose insertion; with `use_gps_prior` the inserted rows
    get their absolute GPS/heading priors, as `graph.add_pose` gives them."""
    cap_p = g.poses.shape[0]
    to = torch.where(ins & (pose_idx < cap_p), pose_idx, cap_p).long()
    g = dataclasses.replace(
        g, poses=_drop_set(g.poses, to, poses), odo_meas=_drop_set(g.odo_meas, to, odo),
        n_poses=g.n_poses + torch.sum(ins, dtype=_I32))
    info = _prior_info(cfg)
    if info is not None:
        g = dataclasses.replace(
            g, prior_pose=_drop_set(g.prior_pose, to, poses),
            prior_info=_drop_set(g.prior_info, to, poses.new_tensor(info).expand(len(poses), 2)))
    return g


def _compact_observations(obs_seq, valid_seq, nc: int):
    """Per-frame stable compaction of the valid observations to the first
    `nc` slots: [T, N, 4] -> [T, nc, 4]. Every consumer of the observation
    axis is gated on validity and depends only on the relative order of
    the valid observations, so dropping padding is exact; the bootstrap
    tests the original first slot, which `first_valid` keeps. Frames with
    more than `nc` valid observations are marked in `overflow` for the
    per-frame path."""
    order = torch.argsort((~valid_seq).to(torch.uint8), dim=-1, stable=True)[..., :nc]
    obs_c = torch.gather(obs_seq, -2, order[..., None].expand(*order.shape, obs_seq.shape[-1]))
    valid_c = torch.gather(valid_seq, -1, order)
    return obs_c, valid_c, valid_seq[..., 0], torch.sum(valid_seq, dim=-1) > nc


def _packet_series(lm_xy, lm_type, n_lm_after, cur_after, out_pose, cfg: SlamConfig):
    """Per-frame upcoming-cone packets (see `keyframe._cone_packet`) from
    given landmark arrays with per-frame (currentConeIndex, n_landmarks)."""
    k = torch.arange(cfg.cones_per_packet, device=lm_xy.device)
    idx = cur_after[:, None] + k[None, :]
    n = torch.clamp(n_lm_after, min=1)[:, None]
    idx = torch.where(idx < n, idx, idx - n)
    idx = torch.minimum(torch.clamp(idx, min=0), n - 1).long()
    az, dist = global_to_body_spherical(out_pose[:, None, :], lm_xy[idx], cfg.reference_compat)
    return az, dist, lm_type[idx]


def _block_glob(obs, poses, cfg: SlamConfig):
    """Global-frame (x, y) of every observation of a block, [B * N, 2]."""
    glob = cone_to_global(poses[:, None, :], obs[..., 0], obs[..., 1], obs[..., 2],
                          cfg.lidar_to_cog, cfg.reference_compat)
    return glob.reshape(-1, 2)


def _inblock_duplicates(glob_k, otype_k, frame_of, cand, snap_match, cost_snap,
                        thresh2, gate, cfg: SlamConfig):
    """In-block creations and duplicate representatives over the flattened
    [BN] observation axis (the JAX package's naive form: a [BN, BN] pair
    mask and a fixpoint over it). Candidates are taken before closure
    suppression, which the caller applies afterwards. `cost_snap` is the
    phase-A matched cost in the units of `gate` ('nearest', 'mahalanobis')
    or None ('first'). Returns (is_new, use_ib, dup_same, rep_prev,
    rep_same, matched_pf)."""
    BN = glob_k.shape[0]
    gd = glob_k[:, None, :] - glob_k[None, :, :]
    gd2 = torch.sum(gd * gd, dim=-1)
    ar = torch.arange(BN, device=glob_k.device)
    lower = ar[:, None] > ar[None, :]
    gsame = (otype_k[:, None] == otype_k[None, :]) & (gd2 < thresh2) & lower
    is_new = cand
    for _ in range(cfg.in_frame_dup_depth + 4):
        dup_of_new = torch.any(gsame & is_new[None, :], dim=1)
        is_new = cand & ~dup_of_new
    rep_ok = gsame & is_new[None, :]
    prev_ok = rep_ok & (frame_of[None, :] < frame_of[:, None])
    same_ok = rep_ok & (frame_of[None, :] == frame_of[:, None])
    prev_any = torch.any(prev_ok, dim=1)
    if cfg.association in ("nearest", "mahalanobis"):
        gd2_prev = torch.where(prev_ok, gd2, _INF)
        rep_prev = torch.argmin(gd2_prev, dim=1).to(_I32)
        ib_cost = torch.min(gd2_prev, dim=1).values
        if cfg.association == "mahalanobis":
            # an in-block creation has no information at block start, so it
            # competes at the zero-information scaled-Euclidean cost
            ib_cost = ib_cost * (gate / thresh2)
        # strict <: ties go to the snapshot landmark (the lower index)
        use_ib = prev_any & (ib_cost < cost_snap)
    else:
        rep_prev = _first_index(prev_ok)
        use_ib = prev_any & ~snap_match
    matched_pf = snap_match | prev_any
    rep_same = _first_index(same_ok)
    dup_same = cand & ~matched_pf & torch.any(same_ok, dim=1)
    return is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf


def _mapping_block(state: SlamState, obs, valid, poses, okp, boot_ok, overflow,
                   cfg: SlamConfig):
    """Mapping-mode block (reference src/slam.cpp:552-635) without GN: on
    a closure, frames up to the closure frame commit and the map freezes;
    the caller runs the closure GN. Mahalanobis gating uses the information
    at block start (the per-frame path's, lagged by up to block - 1
    frames; exact at block 1), and the block's committed observations add
    theirs once. Returns (new_state, outputs [B], aux) with aux's
    `fallback`, `closure_any` and `kc_frame` (B when no closure) the values
    the caller reads, and the per-frame series the periodic GN and the
    closure patch use: `cur_series`, `n_lm_series`, `ins`, `n_pose_series`,
    `n_obs_series` and `pub_rows` (landmark index and matched flag per
    observation)."""
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    dev = obs.device
    cap_l, cap_e, cap_p = g0.lm_xy.shape[0], g0.obs_pose.shape[0], g0.poses.shape[0]
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    n_poses0, n_obs0, n_lm0 = g0.n_poses, g0.n_obs, g0.n_landmarks

    pose_idx_f, odo_f = _pose_insert_plan(g0, poses, okp)
    frame_of = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(N)
    fidx = torch.arange(B, dtype=_I32, device=dev)
    valid_k = (valid & okp[:, None]).reshape(BN)
    obs_k = obs.reshape(BN, 4)
    glob_k = _block_glob(obs, poses, cfg)
    body_k = _body_xy(obs, cfg).reshape(BN, 2)
    otype_k = obs_k[:, 3].to(_I32)
    d2car_k = obs_k[:, 2]

    # bootstrap (reference src/slam.cpp:554-567): an empty map and a valid
    # first observation seed landmark 0 with an extra edge; it joins the
    # phase-A map, so observation (0, 0) matches it again (the double edge)
    boot = (n_lm0 == 0) & boot_ok[0] & okp[0]
    g = G.add_landmark(g0, glob_k[0], otype_k[0], enable=boot)

    # phase A: association against the block-start (post-boot) map; the
    # boot landmark's zero information row gives it the per-frame path's
    # scaled-Euclidean bootstrap cost
    if _use_assoc_kernel(cfg):
        j_snap, snap_match, cost = _provider_associate(
            glob_k, obs_k[:, 3], valid_k, g.lm_xy, g.lm_type, g.n_landmarks,
            state.lm_info_xy, cfg)
        gate = cfg.mahalanobis_gate if cfg.association == "mahalanobis" else thresh2
        cost_snap = torch.where(snap_match, cost, _INF)
    else:
        diff = glob_k[:, None, :] - g.lm_xy[None, :, :]
        cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), state.lm_info_xy, cfg)
        ok = ((g.lm_type[None, :] == otype_k[:, None]) & g.lm_valid[None, :]
              & (cost < gate) & valid_k[:, None])
        if cfg.association == "first":
            j_snap = _first_index(ok)
        else:
            j_snap = torch.argmin(torch.where(ok, cost, 1e30), dim=1).to(_I32)
        snap_match = torch.any(ok, dim=1)
        cost_snap = None
        if cfg.association != "first":
            cost_snap = torch.where(
                snap_match, torch.gather(cost, 1, j_snap.long()[:, None])[:, 0], _INF)

    # in-block creations and duplicate representatives
    cand = valid_k & ~snap_match & (d2car_k < cfg.cone_mapping_threshold)
    is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf = _inblock_duplicates(
        glob_k, otype_k, frame_of, cand, snap_match, cost_snap, thresh2, gate, cfg)
    new_i = is_new.to(_I32)
    slot_self = g.n_landmarks + torch.cumsum(new_i, 0, dtype=_I32) - new_i
    row_rep = torch.where(use_ib, rep_prev,
                          torch.where(dup_same, rep_same,
                                      torch.arange(BN, dtype=_I32, device=dev))).long()
    slot = torch.where(is_new, slot_self, slot_self[row_rep])
    slot_ok = slot < cap_l
    snap_tgt = matched_pf & ~use_ib
    target = torch.where(snap_tgt, j_snap, slot)
    target_xy = torch.where(snap_tgt[:, None], g.lm_xy[j_snap.long()], glob_k[row_rep])

    # exact loop-closure detection (reference src/slam.cpp:593-596):
    # cur_before evolves from the unsuppressed matches within the frame,
    # carried across frames, which equals the committed carry up to and
    # including the first closure observation
    target_f = target.reshape(B, N)
    rows = torch.arange(B, device=dev)
    vals_cl = torch.where(matched_pf, d2car_k, _INF).reshape(B, N)
    pm_cl, pi_cl = _prefix_argmin_exclusive(vals_cl, torch.arange(N, dtype=_I32, device=dev))
    vals_uns = torch.where(matched_pf | (dup_same & slot_ok), d2car_k, _INF).reshape(B, N)
    min_uns, arg_uns = torch.min(vals_uns, dim=1)
    cur_after_uns = _last_valid_inclusive(state.current_cone_index, min_uns < 100.0,
                                          target_f[rows, arg_uns])
    cur_start_uns = _exclusive_from_inclusive(cur_after_uns, state.current_cone_index)
    frame_l = frame_of.long()
    in_frame_tgt = target_f[frame_l, torch.clamp(pi_cl.reshape(BN), min=0).long()]
    cur_before = torch.where(pm_cl.reshape(BN) < 100.0, in_frame_tgt, cur_start_uns[frame_l])
    dfirst2 = torch.sum((target_xy - g.lm_xy[0]) ** 2, dim=-1)
    closure0 = (matched_pf & (dfirst2 < cfg.loop_closure_radius ** 2)
                & (cur_before > cfg.loop_closure_min_index)
                & (d2car_k < cfg.cone_mapping_threshold))
    closure_any = torch.any(closure0)
    kc_obs = _first_index(closure0)
    kc_frame = torch.where(closure_any, kc_obs // N, B).to(_I32)
    closed_before = closure_any & (torch.arange(BN, device=dev) > kc_obs)

    # suppression after the first closure observation; frames after the
    # closure frame belong to the localization blocks
    matched = matched_pf & ~closed_before
    is_new_s = is_new & ~closed_before
    dup_same_s = dup_same & ~closed_before
    ins = okp & (fidx <= kc_frame)
    g = _scatter_poses(g, poses, odo_f, pose_idx_f, ins, cfg)

    # landmark writes: disjoint slots, those past the capacity dropped
    scatter_to = torch.where(is_new_s & slot_ok, slot, cap_l).long()
    n_new_per_frame = torch.sum(is_new_s.reshape(B, N), dim=1, dtype=_I32)
    n_lm_after = torch.clamp(g.n_landmarks + torch.cumsum(n_new_per_frame, 0, dtype=_I32),
                             max=cap_l)
    n_new_total = torch.sum(is_new_s, dtype=_I32)
    g = dataclasses.replace(
        g, lm_xy=_drop_set(g.lm_xy, scatter_to, glob_k),
        lm_type=_drop_set(g.lm_type, scatter_to, otype_k),
        n_landmarks=torch.clamp(g.n_landmarks + n_new_total, max=cap_l))

    # edge append in global observation order: the boot edge first, then the
    # kept rows, each at n_obs0 + its rank among the kept ones
    keep = matched | ((is_new_s | dup_same_s) & slot_ok)
    keep_e = torch.cat([boot.reshape(1), keep])
    keep_i = keep_e.to(_I32)
    dest = n_obs0 + torch.cumsum(keep_i, 0, dtype=_I32) - keep_i
    dest = torch.where(keep_e & (dest < cap_e), dest, cap_e).long()
    g = dataclasses.replace(
        g,
        obs_pose=_drop_set(g.obs_pose, dest, torch.cat([pose_idx_f[:1], pose_idx_f[frame_l]])),
        obs_lm=_drop_set(g.obs_lm, dest, torch.cat([target.new_zeros(1), target])),
        obs_xy=_drop_set(g.obs_xy, dest, torch.cat([body_k[:1], body_k])),
        n_obs=torch.clamp(n_obs0 + torch.sum(keep_i, dtype=_I32), max=cap_e))

    # per-landmark information (Mahalanobis): the committed observations'
    # sums, added once for the block
    lm_info = state.lm_info_xy
    if cfg.association == "mahalanobis":
        lm_info = _add_info(lm_info, torch.where(keep, target, cap_l).long(),
                            _obs_information(glob_k, poses[frame_l], d2car_k, cfg))

    # committed currentConeIndex series
    vals_cur = torch.where(matched | (dup_same_s & slot_ok), d2car_k, _INF).reshape(B, N)
    min_cur, arg_cur = torch.min(vals_cur, dim=1)
    cur_after = _last_valid_inclusive(state.current_cone_index, min_cur < 100.0,
                                      target_f[rows, arg_cur])

    out_pose = poses
    matched_f = matched.reshape(B, N)
    if cfg.mapping_publish_refine:
        # the published pose's refine, against the committed landmark rows,
        # once the first periodic refresh has run
        ref = _publish_refine(poses, target_xy.reshape(B, N, 2), matched_f,
                              body_k.reshape(B, N, 2), cfg)
        out_pose = torch.where((pose_idx_f >= cfg.periodic_gn_every)[:, None], ref, poses)
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm_after, cur_after, out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=torch.zeros(B, dtype=torch.bool, device=dev),
        loop_closed=closure_any & (fidx == kc_frame), n_landmarks=n_lm_after)
    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[-1],
        loop_closing=state.loop_closing | closure_any,
        loop_closure_complete=state.loop_closure_complete | closure_any,
        keyframe_count=state.keyframe_count + torch.sum(ins, dtype=_I32), lm_info_xy=lm_info)

    any_act = torch.any(okp)
    fallback = (((n_lm0 == 0) & ~boot & torch.any(valid_k))
                | ((n_poses0 + B > cap_p) & any_act)
                | ((n_obs0 + 1 + BN > cap_e) & any_act)
                | (n_lm0 + boot.to(_I32) + n_new_total > cap_l)
                | torch.any(overflow & okp))
    keep_pf = torch.sum(keep.reshape(B, N), dim=1, dtype=_I32)
    aux = dict(fallback=fallback, closure_any=closure_any, kc_frame=kc_frame,
               cur_series=cur_after, n_lm_series=n_lm_after, ins=ins,
               n_pose_series=n_poses0 + torch.cumsum(ins, 0, dtype=_I32),
               n_obs_series=torch.clamp(n_obs0 + boot.to(_I32) + torch.cumsum(keep_pf, 0,
                                                                              dtype=_I32),
                                        max=cap_e),
               pub_rows=((torch.clamp(target_f, max=cap_l - 1).long(), matched_f)
                         if cfg.mapping_publish_refine else None))
    return new_state, outputs, aux


def _loc_block(state: SlamState, obs, valid, poses, okp, overflow, cfg: SlamConfig):
    """Localization-mode block against the frozen map (reference
    src/slam.cpp:340-414); the information is frozen too, so Mahalanobis
    gating is exact at any block size. Returns (new_state, outputs [B],
    aux) with aux's `fallback`, `cur_series` and `n_lm_series`."""
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    dev = obs.device

    pose_idx_f, odo_f = _pose_insert_plan(g0, poses, okp)
    g = _scatter_poses(g0, poses, odo_f, pose_idx_f, okp, cfg)

    ran = okp & (torch.sum(valid & okp[:, None], dim=1) > 1)     # src/slam.cpp:332
    glob_k = _block_glob(obs, poses, cfg)
    obs_k = obs.reshape(BN, 4)
    vloc_k = (valid & ran[:, None]).reshape(BN)
    if _use_assoc_kernel(cfg):
        j, matched, _ = _provider_associate(glob_k, obs_k[:, 3], vloc_k, g.lm_xy, g.lm_type,
                                            g.n_landmarks, state.lm_info_xy, cfg)
    else:
        diff = glob_k[:, None, :] - g.lm_xy[None, :, :]
        cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), state.lm_info_xy, cfg)
        if cfg.reference_compat and cfg.localizer_type_bug:
            # signed compare, reference src/slam.cpp:360
            type_ok = (g.lm_type[None, :].to(torch.float32) - obs_k[:, 3][:, None]) < 1e-4
        else:
            type_ok = g.lm_type[None, :] == obs_k[:, 3].to(_I32)[:, None]
        okm = type_ok & g.lm_valid[None, :] & vloc_k[:, None] & (cost < gate)
        j = _first_index(okm)
        matched = torch.any(okm, dim=1)

    d2 = torch.where(matched, obs_k[:, 2], 1e30).reshape(B, N)
    best = torch.argmin(d2, dim=1)
    any_m = torch.any(matched.reshape(B, N), dim=1)
    j_best = j.reshape(B, N)[torch.arange(B, device=dev), best]
    cur_after = _last_valid_inclusive(state.current_cone_index, ran & any_m, j_best)
    cur_start = _exclusive_from_inclusive(cur_after, state.current_cone_index)
    # state.send_cone_data is the reference's "currentConeIndex changed"
    # flag (src/slam.cpp:385); the per-frame `send` output is "a
    # localization update ran"
    cur_changed = ran & (cur_after != cur_start)
    send_state = _last_valid_inclusive(state.send_cone_data, ran, cur_changed)[-1]

    out_pose = poses
    if cfg.localizer_refine:
        # each frame's pose-only refine, as the per-frame path computes it
        # (batched, but every value is computed alike: _refine_system)
        ref = _pose_refine_rows(poses, g.lm_xy[j.long()].reshape(B, N, 2),
                                matched.reshape(B, N), _body_xy(obs, cfg))
        out_pose = torch.where(ran[:, None], ref, poses)

    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[-1], send_cone_data=send_state,
        keyframe_count=state.keyframe_count + torch.sum(okp, dtype=_I32))
    n_lm = g.n_landmarks.expand(B)
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm, cur_after, out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype, send=ran,
        loop_closed=torch.zeros(B, dtype=torch.bool, device=dev), n_landmarks=n_lm)
    fallback = ((g0.n_poses + B > g0.poses.shape[0]) & torch.any(okp)) \
        | torch.any(overflow & okp)
    return new_state, outputs, dict(fallback=fallback, cur_series=cur_after, n_lm_series=n_lm)


def _rows(outs: KeyframeOutputs, lo: int, hi: int) -> KeyframeOutputs:
    return KeyframeOutputs(**{f.name: getattr(outs, f.name)[lo:hi]
                              for f in dataclasses.fields(KeyframeOutputs)})


def _cat(parts) -> KeyframeOutputs:
    return KeyframeOutputs(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                              for f in dataclasses.fields(KeyframeOutputs)})


def _in_bounds(p, cfg: SlamConfig):
    """The GPS outlier guard (reference src/slam.cpp:300-303) per frame."""
    return (torch.abs(p[:, 0]) <= cfg.gps_outlier_bound) & \
        (torch.abs(p[:, 1]) <= cfg.gps_outlier_bound)


def _periodic_fires(count0, ins, n_lm_series, cfg: SlamConfig):
    """[B] whether the periodic GN fires after each frame of a block, from
    the keyframe count before the block and the frames it inserted."""
    return ins & _periodic_due(count0 + torch.cumsum(ins, 0, dtype=_I32), n_lm_series, cfg)


def _read_flags(flags, fires):
    """One device-to-host read of a block's flags and, with a periodic GN,
    its [B] firing mask: (flags as ints, firing mask as bools or None)."""
    t = torch.stack([f.to(_I32) for f in flags])
    if fires is None:
        return t.tolist(), None
    read = torch.cat([t, fires.to(_I32)]).tolist()
    return read[:len(flags)], [bool(x) for x in read[len(flags):]]


def _patch_last(outs: KeyframeOutputs, g, aux, cfg: SlamConfig, pose=None) -> KeyframeOutputs:
    """The block's last frame after a periodic GN at its end: its cone
    packet from map `g`, published from `pose` [1, 3] when given."""
    pose = outs.pose[-1:] if pose is None else pose
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, aux["n_lm_series"][-1:],
                                     aux["cur_series"][-1:], pose, cfg)
    return dataclasses.replace(
        outs, pose=torch.cat([outs.pose[:-1], pose]),
        cone_azimuth=torch.cat([outs.cone_azimuth[:-1], az]),
        cone_distance=torch.cat([outs.cone_distance[:-1], dist]),
        cone_type=torch.cat([outs.cone_type[:-1], ctype]))


def _mapping_periodic(ns: SlamState, outs, aux, fires, closed: bool, kcf: int, obs, poses,
                      cfg: SlamConfig):
    """The periodic GN of a committed mapping block. Either its period is a
    whole number of blocks, and it fires only on the block's last frame
    (exactly where the per-frame path fires); or it divides the block, and
    each firing frame's fixed-lag solve runs after the block's mapping, in
    the order of the frames, anchored at that frame's pose and edge counts;
    frames after a firing publish their refine against the block's final
    map. A firing the block cannot reproduce (mid-block in the first
    regime, or on the closure frame) returns fallback True instead.
    Returns (fallback, state, outputs)."""
    B = len(fires)
    g2 = ns.graph
    if _midblock_gn(cfg, B):
        if closed and fires[min(max(kcf, 0), B - 1)]:
            return True, ns, outs
        for fj in (f for f in range(B) if fires[f]):
            g2 = periodic_gn(g2, cfg, end=aux["n_pose_series"][fj], end_obs=aux["n_obs_series"][fj])
        if cfg.mapping_publish_refine and any(fires):
            lm_idx, matched = aux["pub_rows"]
            ref = _publish_refine(poses, g2.lm_xy[lm_idx], matched, _body_xy(obs, cfg), cfg)
            fired_before = torch.tensor([any(fires[:f]) for f in range(B)], device=poses.device)
            upd = fired_before & (aux["n_pose_series"] - 1 >= cfg.periodic_gn_every)
            outs = dataclasses.replace(outs, pose=torch.where(upd[:, None], ref, outs.pose))
    else:
        if any(fires[:-1]) or (fires[-1] and closed):
            return True, ns, outs
        if fires[-1]:
            g2 = periodic_gn(g2, cfg)
    if fires[-1]:
        pose = None
        if cfg.use_gps_prior and not cfg.mapping_publish_refine:
            # the firing frame publishes its post-GN graph estimate
            pose = g2.poses[torch.clamp(g2.n_poses - 1, min=0).reshape(1).long()]
        outs = _patch_last(outs, g2, aux, cfg, pose)
    return False, dataclasses.replace(ns, graph=g2), outs


def _loc_periodic(st: SlamState, ns: SlamState, outs, aux, fires, okp, cfg: SlamConfig):
    """The periodic GN of a committed localization block, in the two
    regimes of `_mapping_periodic`; localization inserts poses only, so a
    mid-block window is anchored at its firing frame's pose count and the
    graph's edge count. The published poses are the localizer's, computed
    before the GN, so only the last frame's packet sees the new map.
    Returns (fallback, state, outputs)."""
    B = len(fires)
    g2 = ns.graph
    if _midblock_gn(cfg, B):
        n_pose_series = st.graph.n_poses + torch.cumsum(okp, 0, dtype=_I32)
        for fj in (f for f in range(B) if fires[f]):
            g2 = periodic_gn(g2, cfg, end=n_pose_series[fj])
    else:
        if any(fires[:-1]):
            return True, ns, outs
        if fires[-1]:
            g2 = periodic_gn(g2, cfg)
    if fires[-1] and (cfg.periodic_gn_window == 0 or cfg.periodic_gn_window_landmarks):
        outs = _patch_last(outs, g2, aux, cfg)
    return False, dataclasses.replace(ns, graph=g2), outs


def blocked_core(state: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                 block: int = 8, compact_obs: int = 32, frozen: bool | None = None):
    """Mapping blocks, the closure GN and localization blocks over inputs
    already padded to a multiple of `block`. `frozen` is whether the map
    was already frozen (read from the state when None).

    Returns (state, outputs [done_upto], done_upto): frames from done_upto on
    were not processed (a fallback fired) and must be finished by the
    per-frame path; done_upto equals the padded length on a complete pass.
    """
    B = block
    Tp = obs_seq.shape[0]
    nb = Tp // B
    if frozen is None:
        frozen = bool(state.loop_closure_complete)
    if 0 < compact_obs < valid_seq.shape[-1]:
        obs_c, valid_c, first_valid, overflow = _compact_observations(
            obs_seq, valid_seq, compact_obs)
    else:
        obs_c, valid_c = obs_seq, valid_seq
        first_valid = valid_seq[:, 0]
        overflow = torch.zeros(Tp, dtype=torch.bool, device=obs_seq.device)
    okp_all = _in_bounds(pose_seq, cfg)
    fidx = torch.arange(B, device=obs_seq.device)
    periodic = cfg.periodic_gn_every > 0

    parts, done_upto = [], Tp
    kc_global = -1 if frozen else Tp
    if not frozen:
        for ib in range(nb):
            f = slice(ib * B, (ib + 1) * B)
            ns, outs, aux = _mapping_block(state, obs_c[f], valid_c[f], pose_seq[f],
                                           okp_all[f], first_valid[f], overflow[f], cfg)
            fires = _periodic_fires(state.keyframe_count, aux["ins"], aux["n_lm_series"],
                                    cfg) if periodic else None
            (fb, closed, kcf), fires = _read_flags(
                (aux["fallback"], aux["closure_any"], aux["kc_frame"]), fires)
            if periodic and not fb:
                fb, ns, outs = _mapping_periodic(ns, outs, aux, fires, bool(closed), kcf,
                                                 obs_c[f], pose_seq[f], cfg)
            if fb:
                done_upto = ib * B
                break
            state = ns
            if not closed:
                parts.append(outs)
                continue
            # the one-shot closure GN on exactly the graph the per-frame
            # path's closure GN saw, then the closure frame's packet (and,
            # with the publish refine, its pose) from the optimized map: the
            # per-frame path computes both after its GN
            kc_global = ib * B + kcf
            g = gn.optimize(state.graph, _gn_config(cfg))
            state = dataclasses.replace(state, graph=g)
            at = slice(kcf, kcf + 1)
            pose_kc = pose_seq[kc_global][None]
            if cfg.mapping_publish_refine:
                lm_idx, matched = aux["pub_rows"]
                pose_kc = _publish_refine(pose_kc, g.lm_xy[lm_idx[at]], matched[at],
                                          _body_xy(obs_c[kc_global], cfg)[None], cfg)
            az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, aux["n_lm_series"][at],
                                             aux["cur_series"][at], pose_kc, cfg)
            parts.append(_rows(outs, 0, kcf))
            parts.append(dataclasses.replace(_rows(outs, kcf, kcf + 1), pose=pose_kc,
                                             cone_azimuth=az, cone_distance=dist,
                                             cone_type=ctype))
            break

    if kc_global < Tp and done_upto == Tp:
        for ib in range((kc_global + 1) // B, nb):
            f = slice(ib * B, (ib + 1) * B)
            lo = max(kc_global + 1 - ib * B, 0)
            okp = okp_all[f] & (fidx >= lo)
            ns, outs, aux = _loc_block(state, obs_c[f], valid_c[f], pose_seq[f], okp,
                                       overflow[f], cfg)
            fires = _periodic_fires(state.keyframe_count, okp,
                                    ns.graph.n_landmarks.expand(B), cfg) if periodic else None
            (fb,), fires = _read_flags((aux["fallback"],), fires)
            if periodic and not fb:
                fb, ns, outs = _loc_periodic(state, ns, outs, aux, fires, okp, cfg)
            if fb:
                done_upto = ib * B
                break
            state = ns
            parts.append(_rows(outs, lo, B))

    outs = _rows(_cat(parts), 0, done_upto) if parts else None
    return state, outs, done_upto


def _pick_compact(valid_seq, state: SlamState):
    """(compaction width, map frozen) from one host read of the largest
    per-frame valid count and of the state's frozen flag. The in-block pair
    machinery is O((B * nc)^2), so the width is the smallest of 16, 32 and
    64 that holds every frame; a denser frame overflows and goes to the
    per-frame path, so the pick is always sound."""
    nmax, frozen = torch.stack([torch.sum(valid_seq, dim=-1).max(),
                                state.loop_closure_complete.long()]).tolist()
    n = valid_seq.shape[-1]
    for nc in (16, 32, 64):
        if nmax <= nc:
            return min(nc, n), bool(frozen)
    return n, bool(frozen)


def _pad_inputs(obs_seq, valid_seq, pose_seq, cfg: SlamConfig, B: int):
    """Pad the frame axis to a multiple of B with frames that fail the GPS
    outlier guard (exact no-ops)."""
    pad = (-obs_seq.shape[0]) % B
    if pad:
        far = torch.full((pad, 3), 2.0 * cfg.gps_outlier_bound + 1.0,
                         dtype=pose_seq.dtype, device=pose_seq.device)
        obs_seq = torch.cat([obs_seq, obs_seq.new_zeros((pad,) + tuple(obs_seq.shape[1:]))])
        valid_seq = torch.cat([valid_seq, valid_seq.new_zeros((pad,) + tuple(valid_seq.shape[1:]))])
        pose_seq = torch.cat([pose_seq, far])
    return obs_seq, valid_seq, pose_seq


def run_sequence_blocked(state: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                         block: int = 8, assoc_mesh=None):
    """Process T keyframes through the blocked pipeline. Same signature and
    results as `run_sequence`; frames the blocks could not commit are
    finished by the per-frame path."""
    if not blocked_supported(cfg, block):
        raise ValueError(
            "run_sequence_blocked: unsupported config (needs association in "
            "('first','nearest','mahalanobis'), no kernel association with "
            "'first', vectorized mapping, periodic_gn_every a multiple of the "
            "block size, or dividing it with a fixed-lag window): use run_sequence")
    _check_supported(cfg, assoc_mesh)
    T = obs_seq.shape[0]
    # an edge capacity below one block's rows cannot take a block's edge
    # append: the per-frame path is the whole pass
    if T == 0 or cfg.capacity.max_obs < block * min(obs_seq.shape[1], 32) + 1:
        return run_sequence(state, obs_seq, valid_seq, pose_seq, cfg)
    obs_p, valid_p, pose_p = _pad_inputs(obs_seq, valid_seq, pose_seq, cfg, block)
    nc, frozen = _pick_compact(valid_p, state)
    state, outs, done_upto = blocked_core(state, obs_p, valid_p, pose_p, cfg, block,
                                          compact_obs=nc, frozen=frozen)
    if done_upto >= T:
        return state, _rows(outs, 0, T)
    state, rest = run_sequence(state, obs_seq[done_upto:], valid_seq[done_upto:],
                               pose_seq[done_upto:], cfg)
    return state, rest if outs is None else _cat([outs, rest])


def run_pass_blocked(obs_seq, valid_seq, pose_seq, cfg: SlamConfig, block: int = 8,
                     assoc_mesh=None):
    """One whole session from a fresh state via the blocked pipeline."""
    return run_sequence_blocked(initial_state(cfg.capacity, obs_seq.device), obs_seq,
                                valid_seq, pose_seq, cfg, block, assoc_mesh=assoc_mesh)
