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
its candidate state out of place, reads (fallback, closure, closure frame)
from the device in one transfer, and a Python branch keeps the old state or
the new one. Blocks the JAX package runs as exact no-ops (mapping blocks
after the closure, localization blocks before it) do not run, and the edge
rows are appended per block. Host reads per pass: one for the compaction
width, one per block, and the closure GN's own.

A write the JAX package drops with ``mode="drop"`` (a landmark slot, pose
or edge past its capacity) is sent to a spare row past the end of the
array, which is sliced off: on CUDA an out-of-range index is a device-side
assert.

Blocks the blocked form cannot commit exactly (an empty map whose first
observation slot is invalid, capacity saturation, a frame with more valid
observations than the compaction width) stop the pass at their first
frame, `done_upto`, and `run_sequence_blocked` finishes the remaining
frames with the per-frame `perform_keyframe`.

On the CPU, results equal `run_sequence`'s bit for bit
(tests/test_torch_blocked.py); on CUDA the closure GN's sums are atomics,
so values after it may differ in the last bits from run to run.
Supported: the reference-compat configuration and 'first' / 'nearest'
association, dense or, for 'nearest', through the association kernel
(`use_pallas_association`), which then runs once per block over all its
observations. `run_sequence_blocked` raises `ValueError` where the JAX
package's does (`blocked_supported`), and `NotImplementedError`, naming the
field, for what the port does not run yet.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend import graph as G
from tpuslam_torch.frontend.keyframe import (
    KeyframeOutputs, _body_xy, _check_supported, _first_index, _gn_config,
    _prefix_argmin_exclusive, _provider_associate, _use_assoc_kernel,
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
    """True when periodic GN fires at sub-boundaries inside a block (the
    JAX package's mid-block firing; not ported yet)."""
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


def _scatter_poses(g, poses, odo, pose_idx, ins):
    """Masked block pose insertion (no GPS priors: not ported yet)."""
    cap_p = g.poses.shape[0]
    to = torch.where(ins & (pose_idx < cap_p), pose_idx, cap_p).long()
    return dataclasses.replace(
        g, poses=_drop_set(g.poses, to, poses), odo_meas=_drop_set(g.odo_meas, to, odo),
        n_poses=g.n_poses + torch.sum(ins, dtype=_I32))


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
                        thresh2, cfg: SlamConfig):
    """In-block creations and duplicate representatives over the flattened
    [BN] observation axis (the JAX package's naive form: a [BN, BN] pair
    mask and a fixpoint over it). Candidates are taken before closure
    suppression, which the caller applies afterwards. `cost_snap` is the
    phase-A matched cost ('nearest') or None ('first'). Returns (is_new,
    use_ib, dup_same, rep_prev, rep_same, matched_pf)."""
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
    if cfg.association == "nearest":
        gd2_prev = torch.where(prev_ok, gd2, _INF)
        rep_prev = torch.argmin(gd2_prev, dim=1).to(_I32)
        # strict <: ties go to the snapshot landmark (the lower index)
        use_ib = prev_any & (torch.min(gd2_prev, dim=1).values < cost_snap)
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
    the caller runs the closure GN. Returns (new_state, outputs [B], aux)
    with aux's `fallback`, `closure_any` and `kc_frame` (B when no closure)
    the three values the caller reads, and the per-frame `cur_series` and
    `n_lm_series`."""
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

    # phase A: association against the block-start (post-boot) map
    if _use_assoc_kernel(cfg):
        j_snap, snap_match, cost = _provider_associate(
            glob_k, obs_k[:, 3], valid_k, g.lm_xy, g.lm_type, g.n_landmarks, cfg)
        cost_snap = torch.where(snap_match, cost, _INF)
    else:
        diff = glob_k[:, None, :] - g.lm_xy[None, :, :]
        cost = torch.sum(diff * diff, dim=-1)
        ok = ((g.lm_type[None, :] == otype_k[:, None]) & g.lm_valid[None, :]
              & (cost < cfg.same_cone_threshold ** 2) & valid_k[:, None])
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
        glob_k, otype_k, frame_of, cand, snap_match, cost_snap, thresh2, cfg)
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
    g = _scatter_poses(g, poses, odo_f, pose_idx_f, ins)

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

    # committed currentConeIndex series
    vals_cur = torch.where(matched | (dup_same_s & slot_ok), d2car_k, _INF).reshape(B, N)
    min_cur, arg_cur = torch.min(vals_cur, dim=1)
    cur_after = _last_valid_inclusive(state.current_cone_index, min_cur < 100.0,
                                      target_f[rows, arg_cur])

    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm_after, cur_after, poses, cfg)
    outputs = KeyframeOutputs(
        pose=poses, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=torch.zeros(B, dtype=torch.bool, device=dev),
        loop_closed=closure_any & (fidx == kc_frame), n_landmarks=n_lm_after)
    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[-1],
        loop_closing=state.loop_closing | closure_any,
        loop_closure_complete=state.loop_closure_complete | closure_any,
        keyframe_count=state.keyframe_count + torch.sum(ins, dtype=_I32))

    any_act = torch.any(okp)
    fallback = (((n_lm0 == 0) & ~boot & torch.any(valid_k))
                | ((n_poses0 + B > cap_p) & any_act)
                | ((n_obs0 + 1 + BN > cap_e) & any_act)
                | (n_lm0 + boot.to(_I32) + n_new_total > cap_l)
                | torch.any(overflow & okp))
    aux = dict(fallback=fallback, closure_any=closure_any, kc_frame=kc_frame,
               cur_series=cur_after, n_lm_series=n_lm_after)
    return new_state, outputs, aux


def _loc_block(state: SlamState, obs, valid, poses, okp, overflow, cfg: SlamConfig):
    """Localization-mode block against the frozen map (reference
    src/slam.cpp:340-414). Returns (new_state, outputs [B], fallback)."""
    g0 = state.graph
    B, N = valid.shape
    BN = B * N
    dev = obs.device

    pose_idx_f, odo_f = _pose_insert_plan(g0, poses, okp)
    g = _scatter_poses(g0, poses, odo_f, pose_idx_f, okp)

    ran = okp & (torch.sum(valid & okp[:, None], dim=1) > 1)     # src/slam.cpp:332
    glob_k = _block_glob(obs, poses, cfg)
    obs_k = obs.reshape(BN, 4)
    vloc_k = (valid & ran[:, None]).reshape(BN)
    if _use_assoc_kernel(cfg):
        j, matched, _ = _provider_associate(glob_k, obs_k[:, 3], vloc_k, g.lm_xy, g.lm_type,
                                            g.n_landmarks, cfg)
    else:
        diff = glob_k[:, None, :] - g.lm_xy[None, :, :]
        cost = torch.sum(diff * diff, dim=-1)
        if cfg.reference_compat and cfg.localizer_type_bug:
            # signed compare, reference src/slam.cpp:360
            type_ok = (g.lm_type[None, :].to(torch.float32) - obs_k[:, 3][:, None]) < 1e-4
        else:
            type_ok = g.lm_type[None, :] == obs_k[:, 3].to(_I32)[:, None]
        okm = (type_ok & g.lm_valid[None, :] & vloc_k[:, None]
               & (cost < cfg.same_cone_threshold ** 2))
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

    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[-1], send_cone_data=send_state,
        keyframe_count=state.keyframe_count + torch.sum(okp, dtype=_I32))
    n_lm = g.n_landmarks.expand(B)
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm, cur_after, poses, cfg)
    outputs = KeyframeOutputs(
        pose=poses, cone_azimuth=az, cone_distance=dist, cone_type=ctype, send=ran,
        loop_closed=torch.zeros(B, dtype=torch.bool, device=dev), n_landmarks=n_lm)
    fallback = ((g0.n_poses + B > g0.poses.shape[0]) & torch.any(okp)) \
        | torch.any(overflow & okp)
    return new_state, outputs, fallback


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

    parts, done_upto = [], Tp
    kc_global = -1 if frozen else Tp
    if not frozen:
        for ib in range(nb):
            f = slice(ib * B, (ib + 1) * B)
            ns, outs, aux = _mapping_block(state, obs_c[f], valid_c[f], pose_seq[f],
                                           okp_all[f], first_valid[f], overflow[f], cfg)
            fb, closed, kcf = torch.stack([aux["fallback"].to(_I32), aux["closure_any"].to(_I32),
                                           aux["kc_frame"]]).tolist()
            if fb:
                done_upto = ib * B
                break
            state = ns
            if not closed:
                parts.append(outs)
                continue
            # the one-shot closure GN on exactly the graph the per-frame
            # path's closure GN saw, then the closure frame's packet from
            # the optimized map (the per-frame path computes it after its GN)
            kc_global = ib * B + kcf
            g = gn.optimize(state.graph, _gn_config(cfg))
            state = dataclasses.replace(state, graph=g)
            at = slice(kcf, kcf + 1)
            az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, aux["n_lm_series"][at],
                                             aux["cur_series"][at], pose_seq[kc_global][None],
                                             cfg)
            parts.append(_rows(outs, 0, kcf))
            parts.append(dataclasses.replace(_rows(outs, kcf, kcf + 1), cone_azimuth=az,
                                             cone_distance=dist, cone_type=ctype))
            break

    if kc_global < Tp and done_upto == Tp:
        for ib in range((kc_global + 1) // B, nb):
            f = slice(ib * B, (ib + 1) * B)
            lo = max(kc_global + 1 - ib * B, 0)
            okp = okp_all[f] & (fidx >= lo)
            ns, outs, fb = _loc_block(state, obs_c[f], valid_c[f], pose_seq[f], okp,
                                      overflow[f], cfg)
            if fb.item():
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
