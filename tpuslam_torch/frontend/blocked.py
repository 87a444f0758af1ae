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

On CUDA, without a mesh, `blocked_core_batched` replays each block's body
as CUDA graphs (`_run_block`, `runtime/cuda_graphs.py`), split at its
association: a graph up to the kernel's inputs, the association kernel
launched eagerly into fixed outputs, a graph of the rest (one graph where
the association is dense). The host reads, the GNs, the state holds and the
merge stay eager, and the graphs replay the eager kernels in the eager
order, so the results are the eager path's bit for bit. `block_graphs`
keeps the captures and counts what this process captured and replayed.
Each batched periodic-GN round is a `slam.window_gn` span, counted in
`window_gn_rounds` and `window_gn_firings`, and the publish refine after a
block's firings a `slam.publish_refine` span. A round of S > 1 sessions on
CUDA replays its iterations as CUDA graphs of its own
(`gauss_newton.optimize_window`).

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

Batched sessions (`run_sequences_blocked_batched`, `blocked_core_batched`;
the JAX package vmaps `blocked_core` over them): every block function takes
a leading session axis S, so one block of S independent sessions is one
stream of ops, and a single session (`blocked_core`) is the case S = 1. A
session that has closed or fallen back has its frames masked out of later
blocks, which makes them exact no-ops for it; each block reads its [S]
flags once; the closure GN runs once for all sessions, at full capacity
(a single session: on its buckets, as the JAX package's unbatched path);
the localization blocks start at the earliest closed session's block. In
the improved mode the [S, B] firing mask comes with the block's flags, and
the sessions that fire in a block are one batched periodic GN (each
session's window at its own offsets, the others held bit for bit); each
session's Mahalanobis gate reads its own block-start information.

On the CPU, results equal `run_sequence`'s bit for bit wherever the JAX
package's blocked path equals its per-frame path (tests/test_torch_blocked.py);
on CUDA the GN's sums are atomics, so values after a GN may differ in the
last bits from run to run. Association is 'first', 'nearest' or
'mahalanobis', dense or, for the last two, through the association kernel
(`use_pallas_association`), which then runs once per block over all its
observations, or, with `assoc_mesh`, against the landmark map sharded over
the mesh's 'edges' axis (`parallel.map_blocks`), once per block too, with
the index providers' localization semantics; frames the blocks leave to
the per-frame path run without the mesh, as the JAX package's completion
does. `run_sequence_blocked` raises `ValueError` where the JAX package's
does (`blocked_supported`).
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.frontend.keyframe import (
    KeyframeOutputs, _add_info, _assoc_kernel_args, _body_xy, _check_supported,
    _first_index, _gate_cost, _gn_config, _indexed_assoc, _launch_assoc, _obs_information,
    _periodic_due, _pose_refine_rows, _prefix_argmin_exclusive, _prior_info,
    _provider_associate, _publish_refine, periodic_gn,
)
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import (
    SlamState, initial_state, map_state, session_state, stack_states,
)
from tpuslam_torch.geometry import se2
from tpuslam_torch.geometry.spherical import cone_to_global, global_to_body_spherical
from tpuslam_torch.runtime import cuda_graphs as cg
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.runtime.tracing import stage

__all__ = ["run_sequence_blocked", "run_pass_blocked", "blocked_supported",
           "blocked_core", "blocked_core_batched", "run_sequences_blocked_batched"]

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
    """s[f] = val[f] if has[f] else s[f-1] along the last axis, with s[-1] =
    init (a number, or one per leading index)."""
    ar = torch.arange(has.shape[-1], device=has.device)
    last = torch.cummax(torch.where(has, ar, -1), dim=-1).values
    if torch.is_tensor(init) and init.dim():
        init = init[..., None]
    return torch.where(last >= 0, torch.gather(val, -1, torch.clamp(last, min=0)),
                       init).to(val.dtype)


def _exclusive_from_inclusive(series, init):
    """The series shifted one step along the last axis, `init` first."""
    head = (init.reshape(*series.shape[:-1], 1).to(series.dtype) if torch.is_tensor(init)
            else series.new_full((*series.shape[:-1], 1), init))
    return torch.cat([head, series[..., :-1]], dim=-1)


def _rows_at(x, idx):
    """Rows `idx` [S, ...] of each session's `x` [S, R, ...]."""
    if x.shape[0] == 1:       # one session: one plain gather
        return x[0][idx[0]][None]
    sess = torch.arange(x.shape[0], device=x.device).reshape(-1, *([1] * (idx.dim() - 1)))
    return x[sess, idx]


def _drop_set(x, to, values):
    """Out-of-place `x[s, to[s]] = values[s]` for x [S, R, ...], where rows
    `to` equal to R are dropped: they land in a spare row past the sessions'
    rows, which is sliced off."""
    S, R = x.shape[:2]
    flat = x.reshape(S * R, *x.shape[2:])
    if S > 1:                 # (with one session, row R is the spare row already)
        sess = torch.arange(S, device=x.device)[:, None] * R
        to = torch.where(to < R, to + sess, S * R)
    buf = torch.cat([flat, flat.new_zeros((1,) + tuple(flat.shape[1:]))])
    return buf.index_put((to.reshape(-1),), values.reshape(-1, *x.shape[2:])
                         )[:S * R].reshape(x.shape)


def _add_info_rows(lm_info, to, info):
    """`keyframe._add_info` per session: lm_info [S, L, 3], rows `to` [S, K]
    equal to L dropped."""
    S, L = lm_info.shape[:2]
    if S == 1:
        return _add_info(lm_info[0], to[0], info[0])[None]
    sess = torch.arange(S, device=lm_info.device)[:, None] * (L + 1)
    flat = torch.cat([lm_info, lm_info.new_zeros(S, 1, 3)], dim=1).reshape(-1, 3)
    return _add_info(flat, (to + sess).reshape(-1), info.reshape(-1, 3)
                     ).reshape(S, L + 1, 3)[:, :L]


def _pose_insert_plan(g, poses, ok_pose):
    """Per-frame pose indices and odometry measurements of the block's
    insertions [S, B] (no writes). The session's first pose gets a zero
    measurement; every other insertion measures against the previous
    inserted pose's estimate: the graph's last pose for the block's first
    insertion, the raw input pose after it (no GN runs inside a block)."""
    S, B = poses.shape[:2]
    ins_i = ok_pose.to(_I32)
    pose_idx = g.n_poses[:, None] + torch.cumsum(ins_i, -1, dtype=_I32) - 1
    fidx = torch.arange(B, dtype=_I32, device=poses.device).expand(S, B)
    prev_f = _exclusive_from_inclusive(_last_valid_inclusive(-1, ok_pose, fidx), -1)
    prev0 = _rows_at(g.poses, torch.clamp(g.n_poses - 1, min=0).long()[:, None])
    prev = torch.where((prev_f >= 0)[..., None],
                       _rows_at(poses, torch.clamp(prev_f, min=0).long()), prev0)
    odo = torch.where((pose_idx == 0)[..., None], torch.zeros_like(poses),
                      se2.between(prev, poses))
    return pose_idx, odo


def _scatter_poses(g, poses, odo, pose_idx, ins, cfg: SlamConfig):
    """Masked block pose insertion; with `use_gps_prior` the inserted rows
    get their absolute GPS/heading priors, as `graph.add_pose` gives them."""
    cap_p = g.poses.shape[-2]
    to = torch.where(ins & (pose_idx < cap_p), pose_idx, cap_p).long()
    g = dataclasses.replace(
        g, poses=_drop_set(g.poses, to, poses), odo_meas=_drop_set(g.odo_meas, to, odo),
        n_poses=g.n_poses + torch.sum(ins, dim=-1, dtype=_I32))
    info = _prior_info(cfg)
    if info is not None:
        g = dataclasses.replace(
            g, prior_pose=_drop_set(g.prior_pose, to, poses),
            prior_info=_drop_set(g.prior_info, to,
                                 cg.const(info, poses.dtype, poses.device).expand(*to.shape, 2)))
    return g


def _compact_observations(obs_seq, valid_seq, nc: int):
    """Per-frame stable compaction of the valid observations to the first
    `nc` slots: [..., T, N, 4] -> [..., T, nc, 4]. Every consumer of the
    observation axis is gated on validity and depends only on the relative
    order of the valid observations, so dropping padding is exact; the
    bootstrap tests the original first slot, which `first_valid` keeps.
    Frames with more than `nc` valid observations are marked in `overflow`
    for the per-frame path."""
    order = torch.argsort((~valid_seq).to(torch.uint8), dim=-1, stable=True)[..., :nc]
    obs_c = torch.gather(obs_seq, -2, order[..., None].expand(*order.shape, obs_seq.shape[-1]))
    valid_c = torch.gather(valid_seq, -1, order)
    return obs_c, valid_c, valid_seq[..., 0], torch.sum(valid_seq, dim=-1) > nc


def _packet_series(lm_xy, lm_type, n_lm_after, cur_after, out_pose, cfg: SlamConfig):
    """Per-frame upcoming-cone packets (see `keyframe._cone_packet`) from
    each session's landmark arrays [S, L, ...] with per-frame
    (currentConeIndex, n_landmarks) [S, B] and published poses [S, B, 3]."""
    k = torch.arange(cfg.cones_per_packet, device=lm_xy.device)
    idx = cur_after[..., None] + k
    n = torch.clamp(n_lm_after, min=1)[..., None]
    idx = torch.where(idx < n, idx, idx - n)
    idx = torch.minimum(torch.clamp(idx, min=0), n - 1).long()
    az, dist = global_to_body_spherical(out_pose[..., None, :], _rows_at(lm_xy, idx),
                                        cfg.reference_compat)
    return az, dist, _rows_at(lm_type, idx)


def _block_glob(obs, poses, cfg: SlamConfig):
    """Global-frame (x, y) of every observation of each session's block,
    [S, B * N, 2]."""
    glob = cone_to_global(poses[..., None, :], obs[..., 0], obs[..., 1], obs[..., 2],
                          cfg.lidar_to_cog, cfg.reference_compat)
    return glob.reshape(obs.shape[0], -1, 2)


def _inblock_duplicates(glob_k, otype_k, frame_of, cand, snap_match, cost_snap,
                        thresh2, gate, cfg: SlamConfig):
    """In-block creations and duplicate representatives over each session's
    flattened [BN] observation axis (the JAX package's naive form: a
    [S, BN, BN] pair mask and a fixpoint over it). Candidates are taken
    before closure suppression, which the caller applies afterwards.
    `cost_snap` is the phase-A matched cost in the units of `gate`
    ('nearest', 'mahalanobis') or None ('first'). Returns (is_new, use_ib,
    dup_same, rep_prev, rep_same, matched_pf), each [S, BN]."""
    BN = glob_k.shape[-2]
    gd = glob_k[..., :, None, :] - glob_k[..., None, :, :]
    gd2 = torch.sum(gd * gd, dim=-1)
    ar = torch.arange(BN, device=glob_k.device)
    lower = ar[:, None] > ar[None, :]
    gsame = (otype_k[..., :, None] == otype_k[..., None, :]) & (gd2 < thresh2) & lower
    is_new = cand
    for _ in range(cfg.in_frame_dup_depth + 4):
        dup_of_new = torch.any(gsame & is_new[..., None, :], dim=-1)
        is_new = cand & ~dup_of_new
    rep_ok = gsame & is_new[..., None, :]
    prev_ok = rep_ok & (frame_of[None, :] < frame_of[:, None])
    same_ok = rep_ok & (frame_of[None, :] == frame_of[:, None])
    prev_any = torch.any(prev_ok, dim=-1)
    if cfg.association in ("nearest", "mahalanobis"):
        gd2_prev = torch.where(prev_ok, gd2, _INF)
        rep_prev = torch.argmin(gd2_prev, dim=-1).to(_I32)
        ib_cost = torch.min(gd2_prev, dim=-1).values
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
    dup_same = cand & ~matched_pf & torch.any(same_ok, dim=-1)
    return is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf


def _mapping_block(state: SlamState, obs, valid, poses, okp, boot_ok, overflow,
                   cfg: SlamConfig, assoc_mesh=None):
    """Mapping-mode block (reference src/slam.cpp:552-635) of each session of
    a stacked state [S], without GN: on a closure, frames up to the closure
    frame commit and the map freezes; the caller runs the closure GN. A
    session whose `okp` [S, B] is all False comes back unchanged.
    Mahalanobis gating uses the information at block start (the per-frame
    path's, lagged by up to block - 1 frames; exact at block 1), and the
    block's committed observations add theirs once. Returns (new_state,
    outputs [S, B], aux) with aux's `fallback`, `closure_any` and
    `kc_frame` (B when no closure) [S], the values the caller reads, and
    the per-frame series [S, B] the periodic GN and the closure patch use:
    `cur_series`, `n_lm_series`, `ins`, `n_pose_series`, `n_obs_series`
    and `pub_rows` (landmark index and matched flag per observation)."""
    return _body(_mapping_head, _mapping_tail,
                 (state, obs, valid, poses, okp, boot_ok, overflow), cfg, assoc_mesh)


def _body(head, tail, args, cfg: SlamConfig, assoc_mesh=None):
    """A block's body run eagerly: `head` up to the association, the
    association (None where it is dense: `tail` computes it), `tail`."""
    h = head(*args, cfg)
    found = _provider_associate(*h["assoc_in"], cfg, assoc_mesh) \
        if _indexed_assoc(cfg, assoc_mesh) else None
    return tail(*args, h, found, cfg)


def _mapping_head(state: SlamState, obs, valid, poses, okp, boot_ok, overflow, cfg: SlamConfig):
    """A mapping block up to its association: the pose plan, the block's
    observations in the global frame, and the bootstrap (reference
    src/slam.cpp:554-567): an empty map and a valid first observation seed
    landmark 0 with an extra edge; it joins the phase-A map, so observation
    (0, 0) matches it again (the double edge). `assoc_in` holds the
    association's inputs."""
    g0 = state.graph
    S, B, N = valid.shape
    cap_l = g0.lm_xy.shape[-2]
    n_lm0 = g0.n_landmarks
    pose_idx_f, odo_f = _pose_insert_plan(g0, poses, okp)
    valid_k = (valid & okp[..., None]).reshape(S, B * N)
    obs_k = obs.reshape(S, B * N, 4)
    glob_k = _block_glob(obs, poses, cfg)
    otype_k = obs_k[..., 3].to(_I32)
    boot = (n_lm0 == 0) & boot_ok[:, 0] & okp[:, 0]
    boot_to = torch.where(boot, 0, cap_l)[:, None]
    g = dataclasses.replace(
        g0, lm_xy=_drop_set(g0.lm_xy, boot_to, glob_k[:, :1]),
        lm_type=_drop_set(g0.lm_type, boot_to, otype_k[:, :1]),
        n_landmarks=n_lm0 + boot.to(_I32))
    # phase A associates against the block-start (post-boot) map; the boot
    # landmark's zero information row gives it the per-frame path's
    # scaled-Euclidean bootstrap cost
    return dict(g=g, boot=boot, pose_idx_f=pose_idx_f, odo_f=odo_f, valid_k=valid_k,
                obs_k=obs_k, glob_k=glob_k, otype_k=otype_k,
                assoc_in=(glob_k, obs_k[..., 3], valid_k, g.lm_xy, g.lm_type, g.n_landmarks,
                          state.lm_info_xy))


def _mapping_tail(state: SlamState, obs, valid, poses, okp, boot_ok, overflow, h, found,
                  cfg: SlamConfig):
    """A mapping block from its association on: `h` is `_mapping_head`'s,
    `found` the index provider's (match_idx, matched, cost), or None for
    the dense association, computed here. See `_mapping_block`."""
    g0 = state.graph
    g, boot, pose_idx_f, odo_f = h["g"], h["boot"], h["pose_idx_f"], h["odo_f"]
    valid_k, obs_k, glob_k, otype_k = h["valid_k"], h["obs_k"], h["glob_k"], h["otype_k"]
    S, B, N = valid.shape
    BN = B * N
    dev = obs.device
    cap_l = g0.lm_xy.shape[-2]
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    frame_of = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(N)
    frame_l = frame_of.long()
    fidx = torch.arange(B, dtype=_I32, device=dev)
    body_k = _body_xy(obs, cfg).reshape(S, BN, 2)
    d2car_k = obs_k[..., 2]

    if found is not None:
        j_snap, snap_match, cost = found
        gate = cfg.mahalanobis_gate if cfg.association == "mahalanobis" else thresh2
        cost_snap = torch.where(snap_match, cost, _INF)
    else:
        diff = glob_k[..., :, None, :] - g.lm_xy[..., None, :, :]
        cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), state.lm_info_xy, cfg)
        ok = ((g.lm_type[..., None, :] == otype_k[..., None]) & g.lm_valid[..., None, :]
              & (cost < gate) & valid_k[..., None])
        if cfg.association == "first":
            j_snap = _first_index(ok)
        else:
            j_snap = torch.argmin(torch.where(ok, cost, 1e30), dim=-1).to(_I32)
        snap_match = torch.any(ok, dim=-1)
        cost_snap = None
        if cfg.association != "first":
            cost_snap = torch.where(
                snap_match, torch.gather(cost, -1, j_snap.long()[..., None])[..., 0], _INF)

    # in-block creations and duplicate representatives
    cand = valid_k & ~snap_match & (d2car_k < cfg.cone_mapping_threshold)
    is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf = _inblock_duplicates(
        glob_k, otype_k, frame_of, cand, snap_match, cost_snap, thresh2, gate, cfg)
    slot, slot_ok, target, target_xy = _block_targets(
        g.n_landmarks, is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf, j_snap,
        _rows_at(g.lm_xy, j_snap.long()), glob_k, cap_l)
    closure_any, kc_frame, closed_before = _block_closure(
        state, target, target_xy, g.lm_xy[:, :1], matched_pf, dup_same & slot_ok, d2car_k,
        frame_l, B, cfg)

    # suppression after the first closure observation; frames after the
    # closure frame belong to the localization blocks
    matched = matched_pf & ~closed_before
    is_new_s = is_new & ~closed_before
    dup_same_s = dup_same & ~closed_before
    ins = okp & (fidx <= kc_frame[:, None])
    g = _scatter_poses(g, poses, odo_f, pose_idx_f, ins, cfg)

    # landmark writes: disjoint slots, those past the capacity dropped
    scatter_to = torch.where(is_new_s & slot_ok, slot, cap_l).long()
    n_new_per_frame = torch.sum(is_new_s.reshape(S, B, N), dim=-1, dtype=_I32)
    n_lm_after = torch.clamp(
        g.n_landmarks[:, None] + torch.cumsum(n_new_per_frame, -1, dtype=_I32), max=cap_l)
    n_new_total = torch.sum(is_new_s, dim=-1, dtype=_I32)
    g = dataclasses.replace(
        g, lm_xy=_drop_set(g.lm_xy, scatter_to, glob_k),
        lm_type=_drop_set(g.lm_type, scatter_to, otype_k),
        n_landmarks=torch.clamp(g.n_landmarks + n_new_total, max=cap_l))

    keep = matched | ((is_new_s | dup_same_s) & slot_ok)
    g = _append_edges(g, boot, keep, pose_idx_f, frame_l, target, body_k)

    # per-landmark information (Mahalanobis): the committed observations'
    # sums, added once for the block
    lm_info = state.lm_info_xy
    if cfg.association == "mahalanobis":
        lm_info = _add_info_rows(lm_info, torch.where(keep, target, cap_l).long(),
                                 _obs_information(glob_k, poses[:, frame_l], d2car_k, cfg))

    target_f = target.reshape(S, B, N)
    matched_f = matched.reshape(S, B, N)
    cur_after = _current_series(state, matched | (dup_same_s & slot_ok), d2car_k, target_f)
    out_pose = _published_poses(poses, target_xy, matched_f, body_k, pose_idx_f, cfg)
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm_after, cur_after, out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=torch.zeros(S, B, dtype=torch.bool, device=dev),
        loop_closed=closure_any[:, None] & (fidx == kc_frame[:, None]), n_landmarks=n_lm_after)
    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[:, -1],
        loop_closing=state.loop_closing | closure_any,
        loop_closure_complete=state.loop_closure_complete | closure_any,
        keyframe_count=state.keyframe_count + torch.sum(ins, dim=-1, dtype=_I32),
        lm_info_xy=lm_info)

    aux = _mapping_aux(g0, boot, valid_k, okp, overflow, n_new_total, ins, keep, cap_l,
                       closure_any=closure_any, kc_frame=kc_frame, cur_series=cur_after,
                       n_lm_series=n_lm_after,
                       pub_rows=((torch.clamp(target_f, max=cap_l - 1).long(), matched_f)
                                 if cfg.mapping_publish_refine else None))
    return new_state, outputs, aux


def _block_targets(n_landmarks, is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf, j_snap,
                   snap_xy, glob_k, cap_l: int):
    """Each observation's landmark slot (a new one's, or its in-block
    representative's) and target (the matched snapshot landmark, or that
    slot) with the target's position: (slot, slot_ok, target, target_xy),
    each [S, BN]. `snap_xy` are the rows of `j_snap`; `cap_l` the number of
    landmark slots."""
    new_i = is_new.to(_I32)
    slot_self = n_landmarks[:, None] + torch.cumsum(new_i, -1, dtype=_I32) - new_i
    ar = torch.arange(is_new.shape[-1], dtype=_I32, device=is_new.device)
    row_rep = torch.where(use_ib, rep_prev, torch.where(dup_same, rep_same, ar)).long()
    slot = torch.where(is_new, slot_self, torch.gather(slot_self, -1, row_rep))
    snap_tgt = matched_pf & ~use_ib
    return (slot, slot < cap_l, torch.where(snap_tgt, j_snap, slot),
            torch.where(snap_tgt[..., None], snap_xy, _rows_at(glob_k, row_rep)))


def _block_closure(state: SlamState, target, target_xy, anchor, matched_pf, dup_ok, d2car_k,
                   frame_l, B: int, cfg: SlamConfig):
    """Exact loop-closure detection (reference src/slam.cpp:593-596) over a
    block's [S, BN] observations: cur_before evolves from the unsuppressed
    matches (and slotted duplicates, `dup_ok`) within the frame, carried
    across frames, which equals the committed carry up to and including the
    first closure observation; `anchor` [S, 1, 2] is landmark 0; `frame_l`
    [BN] each observation's frame of the B. Returns (closure_any [S],
    kc_frame [S], B when none, closed_before [S, BN])."""
    S, BN = target.shape
    N = BN // B
    dev = target.device
    target_f = target.reshape(S, B, N)
    vals_cl = torch.where(matched_pf, d2car_k, _INF).reshape(S, B, N)
    pm_cl, pi_cl = _prefix_argmin_exclusive(vals_cl, torch.arange(N, dtype=_I32, device=dev))
    vals_uns = torch.where(matched_pf | dup_ok, d2car_k, _INF).reshape(S, B, N)
    min_uns, arg_uns = torch.min(vals_uns, dim=-1)
    cur_after_uns = _last_valid_inclusive(
        state.current_cone_index, min_uns < 100.0,
        torch.gather(target_f, -1, arg_uns[..., None])[..., 0])
    cur_start_uns = _exclusive_from_inclusive(cur_after_uns, state.current_cone_index)
    in_frame_tgt = torch.gather(
        target, -1, frame_l * N + torch.clamp(pi_cl.reshape(S, BN), min=0).long())
    cur_before = torch.where(pm_cl.reshape(S, BN) < 100.0, in_frame_tgt,
                             cur_start_uns[:, frame_l])
    dfirst2 = torch.sum((target_xy - anchor) ** 2, dim=-1)
    closure0 = (matched_pf & (dfirst2 < cfg.loop_closure_radius ** 2)
                & (cur_before > cfg.loop_closure_min_index)
                & (d2car_k < cfg.cone_mapping_threshold))
    closure_any = torch.any(closure0, dim=-1)
    kc_obs = _first_index(closure0)
    kc_frame = torch.where(closure_any, kc_obs // N, B).to(_I32)
    return (closure_any, kc_frame,
            closure_any[:, None] & (torch.arange(BN, device=dev) > kc_obs[:, None]))


def _append_edges(g, boot, keep, pose_idx_f, frame_l, target, body_k):
    """The block's edge append in global observation order: the boot edge
    first, then the kept rows [S, BN], each at n_obs + its rank among the
    kept ones (those past the capacity dropped)."""
    S = keep.shape[0]
    cap_e = g.obs_pose.shape[-1]
    keep_e = torch.cat([boot[:, None], keep], dim=-1)
    keep_i = keep_e.to(_I32)
    dest = g.n_obs[:, None] + torch.cumsum(keep_i, -1, dtype=_I32) - keep_i
    dest = torch.where(keep_e & (dest < cap_e), dest, cap_e).long()
    return dataclasses.replace(
        g,
        obs_pose=_drop_set(g.obs_pose, dest,
                           torch.cat([pose_idx_f[:, :1], pose_idx_f[:, frame_l]], dim=-1)),
        obs_lm=_drop_set(g.obs_lm, dest, torch.cat([target.new_zeros(S, 1), target], dim=-1)),
        obs_xy=_drop_set(g.obs_xy, dest, torch.cat([body_k[:, :1], body_k], dim=1)),
        n_obs=torch.clamp(g.n_obs + torch.sum(keep_i, dim=-1, dtype=_I32), max=cap_e))


def _current_series(state: SlamState, cand, d2car_k, target_f):
    """The committed currentConeIndex after each frame [S, B]: the target of
    the frame's nearest candidate (`cand` [S, BN]) closer than 100 m."""
    S, B, N = target_f.shape
    vals = torch.where(cand, d2car_k, _INF).reshape(S, B, N)
    min_cur, arg_cur = torch.min(vals, dim=-1)
    return _last_valid_inclusive(state.current_cone_index, min_cur < 100.0,
                                 torch.gather(target_f, -1, arg_cur[..., None])[..., 0])


def _published_poses(poses, target_xy, matched_f, body_k, pose_idx_f, cfg: SlamConfig):
    """The block's published poses [S, B, 3]: with `mapping_publish_refine`
    each frame's refine against its committed landmark rows, once the first
    periodic refresh has run."""
    if not cfg.mapping_publish_refine:
        return poses
    S, B, N = matched_f.shape
    ref = _publish_refine(poses, target_xy.reshape(S, B, N, 2), matched_f,
                          body_k.reshape(S, B, N, 2), cfg)
    return torch.where((pose_idx_f >= cfg.periodic_gn_every)[..., None], ref, poses)


def _mapping_aux(g0, boot, valid_k, okp, overflow, n_new_total, ins, keep, cap_l: int, **aux):
    """A mapping block's aux dict: `aux` with the fallback [S] (an empty
    map whose first observation slot is invalid, the pose, edge or landmark
    capacity (`cap_l` slots) reached, or an overflowing frame), the
    inserted frames and the pose and edge counts after each frame [S, B]."""
    S, B = okp.shape
    cap_e, cap_p = g0.obs_pose.shape[-1], g0.poses.shape[-2]
    any_act = torch.any(okp, dim=-1)
    fallback = (((g0.n_landmarks == 0) & ~boot & torch.any(valid_k, dim=-1))
                | ((g0.n_poses + B > cap_p) & any_act)
                | ((g0.n_obs + 1 + valid_k.shape[-1] > cap_e) & any_act)
                | (g0.n_landmarks + boot.to(_I32) + n_new_total > cap_l)
                | torch.any(overflow & okp, dim=-1))
    keep_pf = torch.sum(keep.reshape(S, B, -1), dim=-1, dtype=_I32)
    return dict(aux, fallback=fallback, ins=ins,
                n_pose_series=g0.n_poses[:, None] + torch.cumsum(ins, -1, dtype=_I32),
                n_obs_series=torch.clamp(g0.n_obs[:, None] + boot.to(_I32)[:, None]
                                         + torch.cumsum(keep_pf, -1, dtype=_I32), max=cap_e))


def _loc_block(state: SlamState, obs, valid, poses, okp, overflow, cfg: SlamConfig,
               assoc_mesh=None):
    """Localization-mode block of each session of a stacked state [S] against
    its frozen map (reference src/slam.cpp:340-414); the information is
    frozen too, so Mahalanobis gating is exact at any block size. A session
    whose `okp` [S, B] is all False comes back unchanged. Returns
    (new_state, outputs [S, B], aux) with aux's `fallback` [S], `cur_series`
    and `n_lm_series` [S, B]."""
    return _body(_loc_head, _loc_tail, (state, obs, valid, poses, okp, overflow), cfg,
                 assoc_mesh)


def _loc_head(state: SlamState, obs, valid, poses, okp, overflow, cfg: SlamConfig):
    """A localization block up to its association: the pose insertion, the
    frames that run (src/slam.cpp:332) and the observations in the global
    frame; `assoc_in` holds the association's inputs."""
    S, B, N = valid.shape
    pose_idx_f, odo_f = _pose_insert_plan(state.graph, poses, okp)
    g = _scatter_poses(state.graph, poses, odo_f, pose_idx_f, okp, cfg)
    ran = okp & (torch.sum(valid & okp[..., None], dim=-1) > 1)
    glob_k = _block_glob(obs, poses, cfg)
    obs_k = obs.reshape(S, B * N, 4)
    vloc_k = (valid & ran[..., None]).reshape(S, B * N)
    return dict(g=g, ran=ran, obs_k=obs_k, vloc_k=vloc_k,
                assoc_in=(glob_k, obs_k[..., 3], vloc_k, g.lm_xy, g.lm_type, g.n_landmarks,
                          state.lm_info_xy))


def _loc_tail(state: SlamState, obs, valid, poses, okp, overflow, h, found, cfg: SlamConfig):
    """A localization block from its association on, as `_mapping_tail`
    for `_loc_head`. See `_loc_block`."""
    g0 = state.graph
    g, ran, obs_k, vloc_k = h["g"], h["ran"], h["obs_k"], h["vloc_k"]
    S, B, N = valid.shape
    dev = obs.device
    if found is not None:
        j, matched, _ = found
    else:
        glob_k = h["assoc_in"][0]
        diff = glob_k[..., :, None, :] - g.lm_xy[..., None, :, :]
        cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), state.lm_info_xy, cfg)
        if cfg.reference_compat and cfg.localizer_type_bug:
            # signed compare, reference src/slam.cpp:360
            type_ok = (g.lm_type[..., None, :].to(torch.float32) - obs_k[..., 3][..., None]) < 1e-4
        else:
            type_ok = g.lm_type[..., None, :] == obs_k[..., 3].to(_I32)[..., None]
        okm = type_ok & g.lm_valid[..., None, :] & vloc_k[..., None] & (cost < gate)
        j = _first_index(okm)
        matched = torch.any(okm, dim=-1)

    cur_after, send_state = _loc_current(state, j, matched, ran, obs_k[..., 2])

    out_pose = poses
    if cfg.localizer_refine:
        # each frame's pose-only refine, as the per-frame path computes it
        # (batched, but every value is computed alike: _refine_system)
        ref = _pose_refine_rows(poses, _rows_at(g.lm_xy, j.long()).reshape(S, B, N, 2),
                                matched.reshape(S, B, N), _body_xy(obs, cfg))
        out_pose = torch.where(ran[..., None], ref, poses)

    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[:, -1], send_cone_data=send_state,
        keyframe_count=state.keyframe_count + torch.sum(okp, dim=-1, dtype=_I32))
    n_lm = g.n_landmarks[:, None].expand(S, B)
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, n_lm, cur_after, out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype, send=ran,
        loop_closed=torch.zeros(S, B, dtype=torch.bool, device=dev), n_landmarks=n_lm)
    fallback = ((g0.n_poses + B > g0.poses.shape[-2]) & torch.any(okp, dim=-1)) \
        | torch.any(overflow & okp, dim=-1)
    return new_state, outputs, dict(fallback=fallback, cur_series=cur_after, n_lm_series=n_lm)


def _loc_current(state: SlamState, j, matched, ran, d2car_k):
    """A localization block's currentConeIndex after each frame [S, B] (the
    match of the frame's nearest matched observation, in frames that ran)
    and the final "currentConeIndex changed" flag [S]: the reference's
    send flag (src/slam.cpp:385); the per-frame `send` output is "a
    localization update ran"."""
    S, B = ran.shape
    d2 = torch.where(matched, d2car_k, 1e30).reshape(S, B, -1)
    best = torch.argmin(d2, dim=-1)
    any_m = torch.any(matched.reshape(S, B, -1), dim=-1)
    j_best = torch.gather(j.reshape(S, B, -1), -1, best[..., None])[..., 0]
    cur_after = _last_valid_inclusive(state.current_cone_index, ran & any_m, j_best)
    cur_start = _exclusive_from_inclusive(cur_after, state.current_cone_index)
    cur_changed = ran & (cur_after != cur_start)
    return cur_after, _last_valid_inclusive(state.send_cone_data, ran, cur_changed)[:, -1]


def _map_outputs(fn, *outs: KeyframeOutputs) -> KeyframeOutputs:
    """`fn` applied field by field across `outs`."""
    return KeyframeOutputs(**{f.name: fn(*(getattr(o, f.name) for o in outs))
                              for f in dataclasses.fields(KeyframeOutputs)})


def _take(x, s: int):
    """Session `s` of a block's result: a state, outputs, or aux dict."""
    if isinstance(x, SlamState):
        return session_state(x, s)
    if isinstance(x, KeyframeOutputs):
        return _map_outputs(lambda v: v[s], x)
    if isinstance(x, dict):
        return {k: _take(v, s) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_take(v, s) for v in x)
    return None if x is None else x[s]


def _rows(outs: KeyframeOutputs, lo: int, hi: int) -> KeyframeOutputs:
    return _map_outputs(lambda v: v[lo:hi], outs)


def _cat(parts, dim: int = 0) -> KeyframeOutputs:
    return _map_outputs(lambda *vs: torch.cat(vs, dim=dim), *parts)


def _in_bounds(p, cfg: SlamConfig):
    """The GPS outlier guard (reference src/slam.cpp:300-303) per frame."""
    return (torch.abs(p[..., 0]) <= cfg.gps_outlier_bound) & \
        (torch.abs(p[..., 1]) <= cfg.gps_outlier_bound)


def _periodic_fires(count0, ins, n_lm_series, cfg: SlamConfig):
    """[S, B] whether the periodic GN fires after each frame of a block,
    from each session's keyframe count before the block [S] and the frames
    it inserted [S, B]."""
    return ins & _periodic_due(count0[:, None] + torch.cumsum(ins, -1, dtype=_I32),
                               n_lm_series, cfg)


def _read_flags(flags, fires):
    """One device-to-host read of a block's [S] flags and, with a periodic
    GN, its [S, B] firing mask: (each flag as a list of S ints, the firing
    mask as S lists of bools or None)."""
    t = torch.stack([f.to(_I32) for f in flags])
    if fires is None:
        return t.tolist(), None
    read = torch.cat([t.reshape(-1), fires.to(_I32).reshape(-1)]).tolist()
    S, B = fires.shape
    return ([read[i * S:(i + 1) * S] for i in range(len(flags))],
            [[bool(x) for x in read[t.numel() + s * B:t.numel() + (s + 1) * B]]
             for s in range(S)])


def _patch_last(outs: KeyframeOutputs, g, aux, cfg: SlamConfig, sel,
                pose=None) -> KeyframeOutputs:
    """The block's last frame after a periodic GN at its end, for the
    sessions `sel` (S host bools): its cone packet from each session's map
    `g`, published from `pose` [S, 1, 3] when given."""
    last = outs.pose[:, -1:] if pose is None else pose
    az, dist, ctype = _packet_series(g.lm_xy, g.lm_type, aux["n_lm_series"][:, -1:],
                                     aux["cur_series"][:, -1:], last, cfg)
    at = _enable(sel, last.device)

    def put(x, v):
        if at is not None:
            v = torch.where(at.reshape(-1, *([1] * (x.dim() - 1))), v, x[:, -1:])
        return torch.cat([x[:, :-1], v], dim=1)
    return dataclasses.replace(
        outs, pose=put(outs.pose, last), cone_azimuth=put(outs.cone_azimuth, az),
        cone_distance=put(outs.cone_distance, dist), cone_type=put(outs.cone_type, ctype))


def _enable(flags, device):
    """A batched GN's [S] enable mask from S host flags; None (every
    session) when all are set, which costs a one-session GN no read."""
    return None if all(flags) else torch.tensor(flags, device=device)


def _periodic_round(g, cfg: SlamConfig, fire, enable, end=None, end_obs=None):
    """One batched round of the periodic GN for the sessions whose `fire`
    (S host bools) is set, `enable` its [S] mask on the device (None when
    all are), the others held bit for bit: one `slam.window_gn` span,
    counted in `window_gn_rounds` and, per firing session, in
    `window_gn_firings`."""
    global window_gn_rounds, window_gn_firings
    window_gn_rounds += 1
    window_gn_firings += sum(fire)
    with stage("slam.window_gn"):
        return periodic_gn(g, cfg, end=end, end_obs=end_obs, enable=enable)


def _midblock_firings(g, cfg: SlamConfig, firing, n_pose_series, n_obs_series=None):
    """The mid-block firings of a batched block, in the order of their
    frames: firing[s] lists session s's firing frames. Round j runs every
    session's j-th firing as one batched window GN, each anchored at its
    firing frame's pose (and edge) counts; a session with fewer firings
    sits the round out, bit for bit. Each round's firing frames and enable
    mask go to the device in one copy."""
    S = len(firing)
    dev = n_pose_series.device
    for j in range(max(map(len, firing), default=0)):
        fire = [j < len(x) for x in firing]
        ints = torch.tensor([x[j] if j < len(x) else 0 for x in firing] + fire, device=dev)
        at = ints[:S, None]
        g = _periodic_round(g, cfg, fire, None if all(fire) else ints[S:].bool(),
                            end=torch.gather(n_pose_series, 1, at)[:, 0],
                            end_obs=(None if n_obs_series is None
                                     else torch.gather(n_obs_series, 1, at)[:, 0]))
    return g


def _mapping_periodic(ns: SlamState, outs, aux, fires, act, closed, kcf, obs, poses,
                      cfg: SlamConfig):
    """The periodic GN of a committed mapping block, from the block's one
    read: `fires` [S][B], `closed` and `kcf` [S], and `act` [S] (mapping,
    and not fallen back in the block). Either its period is a whole number
    of blocks, and it fires only on the block's last frame (exactly where
    the per-frame path fires): one GN enabled for the sessions firing
    there. Or it divides the block, and each firing frame's fixed-lag solve
    runs after the block's mapping, in the order of the frames, anchored
    at that frame's pose and edge counts (`_midblock_firings`); frames
    after a firing publish their refine against the block's final map. A
    firing the block cannot reproduce (mid-block in the first regime, or
    on the closure frame) is a fallback for its session instead. Returns
    (fallback [S] bools, state, outputs)."""
    S, B = len(fires), len(fires[0])
    dev = poses.device
    g2 = ns.graph
    if _midblock_gn(cfg, B):
        fb = [act[s] and bool(closed[s]) and fires[s][min(max(kcf[s], 0), B - 1)]
              for s in range(S)]
        gate = [act[s] and not fb[s] for s in range(S)]
        firing = [[f for f in range(B) if fires[s][f]] if gate[s] else [] for s in range(S)]
        g2 = _midblock_firings(g2, cfg, firing, aux["n_pose_series"], aux["n_obs_series"])
        if cfg.mapping_publish_refine and any(firing):
            with stage("slam.publish_refine"):
                lm_idx, matched = aux["pub_rows"]
                lm = _rows_at(g2.lm_xy, lm_idx.reshape(S, -1)).reshape(*lm_idx.shape, 2)
                ref = _publish_refine(poses, lm, matched, _body_xy(obs, cfg), cfg)
                fired_before = torch.tensor([[gate[s] and any(fires[s][:f]) for f in range(B)]
                                             for s in range(S)], device=dev)
                upd = fired_before & (aux["n_pose_series"] - 1 >= cfg.periodic_gn_every)
                outs = dataclasses.replace(outs, pose=torch.where(upd[..., None], ref, outs.pose))
        do_p = [gate[s] and fires[s][-1] for s in range(S)]
    else:
        fb = [act[s] and (any(fires[s][:-1]) or (fires[s][-1] and bool(closed[s])))
              for s in range(S)]
        do_p = [act[s] and not fb[s] and fires[s][-1] for s in range(S)]
        if any(do_p):
            g2 = _periodic_round(g2, cfg, do_p, _enable(do_p, dev))
    if any(do_p):
        pose = None
        if cfg.use_gps_prior and not cfg.mapping_publish_refine:
            # the firing frame publishes its post-GN graph estimate
            pose = _rows_at(g2.poses, torch.clamp(g2.n_poses - 1, min=0).long()[:, None])
        outs = _patch_last(outs, g2, aux, cfg, do_p, pose)
    return fb, dataclasses.replace(ns, graph=g2), outs


def _loc_periodic(st: SlamState, ns: SlamState, outs, aux, fires, act, okp, cfg: SlamConfig):
    """The periodic GN of a committed localization block for the sessions
    `act` [S], with `fires` [S][B] from the block's one read, in the two
    regimes of `_mapping_periodic`; localization inserts poses only, so a
    mid-block window is anchored at its firing frame's pose count and the
    graph's edge count. The published poses are the localizer's, computed
    before the GN, so only the last frame's packet sees the new map.
    Returns (fallback [S] bools, state, outputs)."""
    S, B = len(fires), len(fires[0])
    dev = okp.device
    g2 = ns.graph
    if _midblock_gn(cfg, B):
        fb = [False] * S
        firing = [[f for f in range(B) if fires[s][f]] if act[s] else [] for s in range(S)]
        g2 = _midblock_firings(g2, cfg, firing,
                               st.graph.n_poses[:, None] + torch.cumsum(okp, -1, dtype=_I32))
    else:
        fb = [act[s] and any(fires[s][:-1]) for s in range(S)]
        do_gn = [act[s] and not fb[s] and fires[s][-1] for s in range(S)]
        if any(do_gn):
            g2 = _periodic_round(g2, cfg, do_gn, _enable(do_gn, dev))
    do_p = [act[s] and not fb[s] and fires[s][-1] for s in range(S)]
    if any(do_p) and (cfg.periodic_gn_window == 0 or cfg.periodic_gn_window_landmarks):
        outs = _patch_last(outs, g2, aux, cfg, do_p)
    return fb, dataclasses.replace(ns, graph=g2), outs


def _compacted(obs_seq, valid_seq, compact_obs: int):
    """`_compact_observations` to `compact_obs` slots when that is fewer
    than the frames have: (obs, valid, first_valid, overflow)."""
    if 0 < compact_obs < valid_seq.shape[-1]:
        return _compact_observations(obs_seq, valid_seq, compact_obs)
    return (obs_seq, valid_seq, valid_seq[..., 0],
            torch.zeros(valid_seq.shape[:-1], dtype=torch.bool, device=valid_seq.device))


def blocked_core(state: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                 block: int = 8, compact_obs: int = 32, frozen: bool | None = None,
                 assoc_mesh=None):
    """Mapping blocks, the closure GN and localization blocks over inputs
    already padded to a multiple of `block`: `blocked_core_batched` for one
    session. `frozen` is whether the map was already frozen (read from the
    state when None); `assoc_mesh` as `blocked_core_batched`'s.

    Returns (state, outputs [done_upto], done_upto): frames from done_upto on
    were not processed (a fallback fired) and must be finished by the
    per-frame path; done_upto equals the padded length on a complete pass.
    """
    states, outs, done = blocked_core_batched(
        map_state(lambda v: v[None], state), obs_seq[None], valid_seq[None], pose_seq[None],
        cfg, block, compact_obs, None if frozen is None else [frozen], assoc_mesh)
    d = done[0]
    return session_state(states, 0), (_rows(_take(outs, 0), 0, d) if d else None), d


def _hold(held, new: SlamState, old: SlamState) -> SlamState:
    """`new`, but `old` for the sessions whose `held` (host bools) is True."""
    if not any(held):
        return new
    mask = torch.tensor(held, device=new.keyframe_count.device)
    return map_state(lambda a, b: torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), b, a),
                     new, old)


def _block_fires(state: SlamState, okp, aux, cfg: SlamConfig):
    """With a periodic GN, the [S, B] mask of the frames of a block (from
    `state`, its `okp` and its aux) after which the GN fires; else None. A
    localization block inserts each frame of `okp`, a mapping block those
    of its aux's `ins`."""
    if cfg.periodic_gn_every <= 0:
        return None
    return _periodic_fires(state.keyframe_count, aux.get("ins", okp), aux["n_lm_series"], cfg)


_BODIES = {"mapping": (_mapping_head, _mapping_tail), "loc": (_loc_head, _loc_tail)}

window_gn_rounds = 0  # batched periodic-GN rounds this process ran (`_periodic_round`)
window_gn_firings = 0  # session windows those rounds solved: their firing sessions summed
block_graphs = cg.GraphCache(8)   # `_BlockGraph`s by key


def _use_graphs(x, assoc_mesh) -> bool:
    """Whether `blocked_core_batched` replays its blocks as CUDA graphs: for
    inputs `x` capturable, and without a mesh (the sharded association
    keeps its collectives eager)."""
    return assoc_mesh is None and cg.capturable(x)


class _BlockGraph(cg.SplitGraph):
    """One block kind's body at one key over static inputs (a copy of the
    first block's arguments): the head up to the association kernel's
    inputs, the kernel launched eagerly between the two graphs into static
    outputs, then the tail; one graph of the whole body where the
    association is dense."""

    def __init__(self, kind: str, args, cfg: SlamConfig):
        self.body, self.cfg = _BODIES[kind], cfg
        self.static = cg.fresh(args)
        S, B, N = args[2].shape
        self.found = tuple(torch.zeros(S, B * N, dtype=t, device=args[2].device)
                           for t in (_I32, torch.bool, torch.float32)) \
            if _indexed_assoc(cfg) else None
        super().__init__(cg.tensors(self.static), split=self.found is not None)

    def head(self):
        self.h = self.body[0](*self.static, self.cfg)
        if self.split:
            self.kargs = _assoc_kernel_args(*self.h["assoc_in"], self.cfg)

    def middle(self):
        _launch_assoc(*self.kargs, out=self.found)

    def tail(self):
        h, self.h = self.h, None   # the head's results are not kept past the tail
        ns, outs, aux = self.body[1](*self.static, h, self.found, self.cfg)
        self.out = ns, outs, aux, _block_fires(self.static[0], self.static[4], aux, self.cfg)


def _run_block(kind: str, args, cfg: SlamConfig, assoc_mesh, graphs: bool):
    """(the state before the block, (new_state, outputs, aux, fires)) of one
    block of `blocked_core_batched`: `kind`'s body run eagerly, or with
    `graphs` by replaying its `_BlockGraph`, captured at the first block of
    a key (`cuda_graphs.key`, with the kind and `cfg`). A replay's state
    before the block is its graphs' static inputs, and its new state, aux
    and fires are in their pool: both change at the key's next replay, so
    what is kept past it is copied. Its outputs are copies already."""
    if not graphs:
        block = _mapping_block if kind == "mapping" else _loc_block
        ns, outs, aux = block(*args, cfg, assoc_mesh)
        return args[0], (ns, outs, aux, _block_fires(args[0], args[4], aux, cfg))
    leaves = cg.tensors(args)
    bg = block_graphs.lookup(cg.key("block", (kind, cfg), leaves),
                             lambda: _BlockGraph(kind, args, cfg))
    with stage("slam.block_graph"):
        bg.load(leaves)
        bg.step()
        ns, outs, aux, fires = bg.out
        return bg.static[0], (ns, _map_outputs(torch.clone, outs), aux, fires)


def blocked_core_batched(states: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                         block: int = 8, compact_obs: int = 32, frozen=None, assoc_mesh=None):
    """`blocked_core` for S independent sessions at once: a stacked state
    [S] and inputs [S, Tp, ...] padded to a multiple of `block`. `frozen`
    is each session's map-frozen flag (read from the states when None).
    With `assoc_mesh`, every block's association runs against the maps
    sharded over the mesh's 'edges' axis (each session's landmark capacity
    a multiple of the axis size).

    The mapping blocks run over all sessions together, one block function
    call for the S sessions, and read the [S] (fallback, closure, closure
    frame) flags and, with a periodic GN, the [S, B] firing mask once per
    block. A session that has closed or fallen back has its frames masked
    out of later blocks (all frames fail the GPS guard), which makes those
    blocks exact no-ops for it; a session that falls back in a block keeps
    its state from before the block. The periodic GNs of the sessions that
    fire in a block run as batched GNs (`_mapping_periodic`). The
    blocks stop when no session is still mapping. Then one batched closure
    GN at full capacity (`gauss_newton.optimize` on the stacked graph,
    enabled for the sessions that closed; one Cholesky of all their
    systems per iteration) and each closed session's closure-frame packet
    (and, with the publish refine, its pose) from its optimized map. The
    localization blocks start at the earliest closed session's block and
    take, for each session, its frames after its closure frame; a session
    that never closed takes none. On CUDA without `assoc_mesh`, each block's
    body is a replay of its CUDA graphs, captured at the first block of
    each key (`_run_block`); what it returns is its own memory, never the
    graphs'.

    Returns (states, outputs [S, Tp], done_upto): done_upto[s] (a list of
    ints) is the first frame of session s the blocks did not process (a
    fallback fired), Tp on a complete pass; outputs past it are not set.
    """
    B = block
    S, Tp = obs_seq.shape[:2]
    nb = Tp // B
    dev = obs_seq.device
    if frozen is None:
        frozen = [bool(x) for x in states.loop_closure_complete.tolist()]
    obs_c, valid_c, first_valid, overflow = _compacted(obs_seq, valid_seq, compact_obs)
    okp_all = _in_bounds(pose_seq, cfg)
    periodic = cfg.periodic_gn_every > 0
    graphs = _use_graphs(obs_seq, assoc_mesh)

    done_upto = [Tp] * S
    kc_global = [-1 if fz else Tp for fz in frozen]
    mapping = [not fz for fz in frozen]
    map_parts = []
    kc_rows = None      # per session: (n_landmarks, currentConeIndex, publish rows) at its closure
    for ib in range(nb):
        if not any(mapping):
            break
        with stage("slam.mapping_block"):
            f = slice(ib * B, (ib + 1) * B)
            live = torch.tensor(mapping, device=dev)
            old, (ns, outs, aux, fires) = _run_block(
                "mapping", (states, obs_c[:, f], valid_c[:, f], pose_seq[:, f],
                            okp_all[:, f] & live[:, None], first_valid[:, f], overflow[:, f]),
                cfg, assoc_mesh, graphs)
            (fb, closed, kcf), fires = _read_flags(
                (aux["fallback"], aux["closure_any"], aux["kc_frame"]), fires)
            fell = [mapping[s] and bool(fb[s]) for s in range(S)]
            if periodic:
                pfb, ns, outs = _mapping_periodic(
                    ns, outs, aux, fires, [mapping[s] and not fell[s] for s in range(S)], closed,
                    kcf, obs_c[:, f], pose_seq[:, f], cfg)
                fell = [fell[s] or pfb[s] for s in range(S)]
            states = _hold(fell, ns, old)
            map_parts.append(outs)
            closing = [mapping[s] and not fell[s] and bool(closed[s]) for s in range(S)]
            if any(closing):
                # each closing session's (n_landmarks, currentConeIndex) and
                # publish rows after its closure frame, for its packet and pose
                # from the optimized map
                at = torch.clamp(aux["kc_frame"], max=B - 1).long()[:, None]
                rows = [torch.gather(aux["n_lm_series"], 1, at)[:, 0],
                        torch.gather(aux["cur_series"], 1, at)[:, 0]]
                if cfg.mapping_publish_refine:
                    rows += [_rows_at(x, at)[:, 0] for x in aux["pub_rows"]]
                sel = torch.tensor(closing, device=dev)
                kc_rows = rows if kc_rows is None else [
                    torch.where(sel.reshape(-1, *([1] * (a.dim() - 1))), a, b)
                    for a, b in zip(rows, kc_rows)]
            for s in range(S):
                if fell[s]:
                    done_upto[s] = ib * B
                elif closing[s]:
                    kc_global[s] = ib * B + kcf[s]
                if fell[s] or closing[s]:
                    mapping[s] = False

    closed_now = [not frozen[s] and kc_global[s] < Tp and done_upto[s] == Tp for s in range(S)]
    if any(closed_now):
        # the one-shot closure GN of every closed session, at full capacity
        # as the JAX package's batched GN (vmap_safe_gn; a single session
        # on its buckets, as its unbatched one), then each closure frame's
        # packet (and, with the publish refine, its pose) from its
        # optimized map; the per-frame path computes both after its GN
        gcfg = _gn_config(cfg)
        if S > 1:
            gcfg = dataclasses.replace(gcfg, solve_bucket_step=0, edge_bucket_step=0)
        with stage("slam.closure_gn"):
            g = gn.optimize(states.graph, gcfg, enable=_enable(closed_now, dev))
        states = dataclasses.replace(states, graph=g)
        kc_t = torch.tensor([min(max(k, 0), Tp - 1) for k in kc_global], device=dev)[:, None]
        pose_kc = _rows_at(pose_seq, kc_t)
        if cfg.mapping_publish_refine:
            lm_idx, matched = kc_rows[2:]
            pose_kc = _publish_refine(pose_kc, _rows_at(g.lm_xy, lm_idx)[:, None],
                                      matched[:, None], _body_xy(_rows_at(obs_c, kc_t), cfg),
                                      cfg)
        kc_packet = _packet_series(g.lm_xy, g.lm_type, kc_rows[0][:, None],
                                   kc_rows[1][:, None], pose_kc, cfg)

    # localization: every session whose map is frozen and that has not
    # fallen back, each from the frame after its closure
    loc = [kc_global[s] < Tp and done_upto[s] == Tp for s in range(S)]
    lo_block = min([(kc_global[s] + 1) // B for s in range(S) if loc[s]], default=nb)
    kc_dev = torch.tensor(kc_global, device=dev)
    fidx = torch.arange(B, device=dev)
    loc_parts = []
    for ib in range(lo_block, nb):
        if not any(loc):
            break
        with stage("slam.loc_block"):
            f = slice(ib * B, (ib + 1) * B)
            active = torch.tensor(loc, device=dev)
            okp = okp_all[:, f] & (ib * B + fidx > kc_dev[:, None]) & active[:, None]
            old, (ns, outs, aux, fires) = _run_block(
                "loc", (states, obs_c[:, f], valid_c[:, f], pose_seq[:, f], okp, overflow[:, f]),
                cfg, assoc_mesh, graphs)
            (fb,), fires = _read_flags((aux["fallback"],), fires)
            fell = [loc[s] and bool(fb[s]) for s in range(S)]
            if periodic:
                pfb, ns, outs = _loc_periodic(
                    old, ns, outs, aux, fires, [loc[s] and not fell[s] for s in range(S)], okp,
                    cfg)
                fell = [fell[s] or pfb[s] for s in range(S)]
            states = _hold(fell, ns, old)
            for s in range(S):
                if fell[s]:
                    done_upto[s], loc[s] = ib * B, False
            loc_parts.append(outs)

    # merge: frames up to each closure frame from the mapping blocks, later
    # ones from the localization blocks; the closure frame's packet patched
    def spread(parts, first_block):
        def fill(v):
            out = v.new_zeros((S, Tp) + tuple(v.shape[2:]))
            out[:, first_block * B:first_block * B + v.shape[1]] = v
            return out
        return _map_outputs(fill, _cat(parts, dim=1))

    t = torch.arange(Tp, device=dev)
    outs = spread(map_parts, 0) if map_parts else None
    if loc_parts:
        loc_out = spread(loc_parts, lo_block)
        is_loc = t > kc_dev[:, None]
        outs = loc_out if outs is None else _map_outputs(lambda a, b: torch.where(
            is_loc.reshape(S, Tp, *([1] * (a.dim() - 2))), a, b), loc_out, outs)
    if any(closed_now):
        at_kc = (t == kc_dev[:, None]) & torch.tensor(closed_now, device=dev)[:, None]
        sel = at_kc[..., None]
        az, dist, ctype = kc_packet
        outs = dataclasses.replace(
            outs, pose=torch.where(sel, pose_kc, outs.pose),
            cone_azimuth=torch.where(sel, az, outs.cone_azimuth),
            cone_distance=torch.where(sel, dist, outs.cone_distance),
            cone_type=torch.where(sel, ctype, outs.cone_type))
    # a replayed block's state lives in its graphs' memory: the caller's is a copy
    return (cg.fresh(states) if graphs else states), outs, done_upto


def _pick_compact(valid_seq, state: SlamState):
    """(compaction width, map frozen per session) from one host read of the
    largest per-frame valid count over all sessions and of the states'
    frozen flags. The in-block pair machinery is O((B * nc)^2), so the width
    is the smallest of 16, 32 and 64 that holds every frame; a denser frame
    overflows and goes to the per-frame path, so the pick is always sound."""
    nmax, *frozen = torch.cat([torch.sum(valid_seq, dim=-1).max().reshape(1),
                               state.loop_closure_complete.long().reshape(-1)]).tolist()
    frozen = [bool(x) for x in frozen]
    n = valid_seq.shape[-1]
    for nc in (16, 32, 64):
        if nmax <= nc:
            return min(nc, n), frozen
    return n, frozen


def _pad_inputs(obs_seq, valid_seq, pose_seq, cfg: SlamConfig, B: int):
    """Pad the frame axis (the first, or the second with a leading session
    axis) to a multiple of B with frames that fail the GPS outlier guard
    (exact no-ops)."""
    lead, t = tuple(pose_seq.shape[:-2]), pose_seq.shape[-2]
    pad = (-t) % B
    if pad:
        def cat(x, tail, fill=0.0):
            return torch.cat([x, x.new_full((*lead, pad, *tail), fill)], dim=len(lead))
        obs_seq = cat(obs_seq, obs_seq.shape[-2:])
        valid_seq = cat(valid_seq, valid_seq.shape[-1:], False)
        pose_seq = cat(pose_seq, (3,), 2.0 * cfg.gps_outlier_bound + 1.0)
    return obs_seq, valid_seq, pose_seq


def run_sequence_blocked(state: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                         block: int = 8, assoc_mesh=None):
    """Process T keyframes through the blocked pipeline. Same signature and
    results as `run_sequence`; frames the blocks could not commit are
    finished by the per-frame path (without the mesh)."""
    if not blocked_supported(cfg, block):
        raise ValueError(
            "run_sequence_blocked: unsupported config (needs association in "
            "('first','nearest','mahalanobis'), no kernel association with "
            "'first', vectorized mapping, periodic_gn_every a multiple of the "
            "block size, or dividing it with a fixed-lag window): use run_sequence")
    _check_supported(cfg)
    T = obs_seq.shape[0]
    # an edge capacity below one block's rows cannot take a block's edge
    # append: the per-frame path is the whole pass
    if T == 0 or cfg.capacity.max_obs < block * min(obs_seq.shape[1], 32) + 1:
        return run_sequence(state, obs_seq, valid_seq, pose_seq, cfg)
    obs_p, valid_p, pose_p = _pad_inputs(obs_seq, valid_seq, pose_seq, cfg, block)
    nc, frozen = _pick_compact(valid_p, state)
    state, outs, done_upto = blocked_core(state, obs_p, valid_p, pose_p, cfg, block,
                                          compact_obs=nc, frozen=frozen[0], assoc_mesh=assoc_mesh)
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


def run_sequences_blocked_batched(states: SlamState, obs_seq, valid_seq, pose_seq,
                                  cfg: SlamConfig, block: int = 8):
    """S independent sessions through the blocked pipeline at once: a
    stacked state [S] (`parallel.batch.initial_states`) and inputs
    obs [S, T, N, 4], valid [S, T, N], poses [S, T, 3]. Returns (stacked
    states, outputs [S, T]), each session's equal to its own
    `run_sequence_blocked` but for the closure GN, which runs at full
    capacity for all sessions at once (its sums in another order). A
    session the blocks could not finish is finished by the per-frame path
    (the improved mode's per-frame engine too). Raises `ValueError` where
    `run_sequence_blocked` does."""
    if not blocked_supported(cfg, block):
        raise ValueError("run_sequences_blocked_batched: unsupported config, see "
                         "run_sequence_blocked")
    _check_supported(cfg)
    S, T = obs_seq.shape[:2]
    if T == 0 or cfg.capacity.max_obs < block * min(obs_seq.shape[2], 32) + 1:
        # an edge capacity below one block's rows: the per-frame path is the
        # whole pass, session by session
        runs = []
        for s in range(S):
            with stage("slam.per_frame"):
                runs.append(run_sequence(session_state(states, s), obs_seq[s], valid_seq[s],
                                         pose_seq[s], cfg))
        return (stack_states([r[0] for r in runs]),
                _map_outputs(lambda *vs: torch.stack(vs), *(r[1] for r in runs)))
    obs_p, valid_p, pose_p = _pad_inputs(obs_seq, valid_seq, pose_seq, cfg, block)
    nc, frozen = _pick_compact(valid_p, states)
    states, outs, done_upto = blocked_core_batched(states, obs_p, valid_p, pose_p, cfg, block,
                                                   compact_obs=nc, frozen=frozen)
    outs = _map_outputs(lambda v: v[:, :T], outs)
    if min(done_upto) >= T:
        return states, outs
    per_state, per_outs = [], []
    for s in range(S):
        st, out = session_state(states, s), _take(outs, s)
        d = done_upto[s]
        if d < T:
            with stage("slam.per_frame"):
                st, rest = run_sequence(st, obs_seq[s, d:], valid_seq[s, d:], pose_seq[s, d:],
                                        cfg)
            out = _cat([_rows(out, 0, d), rest])
        per_state.append(st)
        per_outs.append(out)
    return stack_states(per_state), _map_outputs(lambda *vs: torch.stack(vs), *per_outs)
