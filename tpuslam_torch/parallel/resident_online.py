"""The online blocked pass with the landmark map sharded over a ('map',)
mesh (counterpart of `tpuslam.parallel.resident_online`).

- **Layout**: global landmark id g lives on rank g // Lb, in local slot
  g % Lb. The blocks are contiguous, so storage order is creation order and
  every index-based semantic of the reference (the ring cone packet, the
  closure's `currentConeIndex > 20` test, landmark 0 as the closure anchor,
  first-match ties) is untouched. Each rank holds only its own `lm_xy
  [Lb, 2]`, `lm_type [Lb]` and `lm_info [Lb, 3]`; the pose and edge graph
  and the counters are replicated, and edges carry global landmark ids.
- **Association** gates the block's observations against the rank's [Lb]
  slots (`keyframe._gate_cost`, elementwise, so every cost is the dense
  pass's) and one `pmin` of 64-bit keys picks each winner
  (`map_blocks.sharded_winner`): 'first' the smallest global index with a
  hit, 'nearest' / 'mahalanobis' the least cost, ties to the smallest
  global index, as the dense argmin breaks them.
- **Creation** keeps the global order: the per-observation decisions are
  the dense block's [B * nc] machinery (`frontend.blocked`, called, not
  copied), and each rank writes the new landmarks whose global slot it
  owns. Rows of other ranks (the matched landmarks, landmark 0, the ring
  packet) come through `_gather_lm`: one `psum` of one-hot parts.
- **Solves**: the one-shot closure GN and the fixed-lag window GN eliminate
  each rank's landmarks locally (an edge is weighted on its landmark's owner
  only) and sum the reduced pose system in one `psum` per iteration;
  nothing O(L) goes over the wire, and the dense reduced system is factored
  with `torch.linalg.cholesky_ex` on every rank, as the JAX package's
  `jnp.linalg.cholesky` (neither kernel runs on this path, as in the JAX
  package, which refuses the association provider here).

The JAX package runs the pass as two `lax.scan`s inside one `shard_map`;
here, as in `frontend.blocked.blocked_core`, it is a Python loop over
blocks on every rank, each block's decisions read on the host once.
**Every rank takes every branch the same way**: a rank that left a loop
early would leave the others waiting in a collective. So each host branch
reads a value every rank provably holds: a block's flags (fallback,
closure, closure frame, periodic firings) come from one `pmax` over the
flags and their negations, which gives every rank the maximum and the
minimum, and a rank whose flags were not the others' raises on every rank
alike instead of branching apart; the GNs' early exit reads one `pmax` of
the whole update (poses and landmarks). The closure GN steps in pairs and
tests convergence after each pair, exactly as the JAX package's (an odd
cap runs exactly `iterations` steps), so it may run one step more than the
dense `optimize`; the window GN tests after every step.

Results equal `frontend.blocked.run_pass_blocked`'s at the same block: every
decision up to the first solve exactly, values after a solve up to the
order of the psum'd sums (tests/test_torch_chain.py). A block the blocked
form cannot commit stops the pass at `done_upto`, and
`run_pass_resident_online` gathers the map and finishes the remaining
frames with the per-frame path.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.residuals import landmark_residuals
from tpuslam_torch.frontend.blocked import (
    _append_edges, _block_closure, _block_glob, _block_targets, _compacted, _current_series,
    _drop_set, _in_bounds, _inblock_duplicates, _loc_current, _map_outputs, _mapping_aux,
    _midblock_gn, _pad_inputs, _periodic_fires, _pick_compact, _pose_insert_plan,
    _published_poses, _rows, _scatter_poses,
)
from tpuslam_torch.frontend.keyframe import (
    KeyframeOutputs, _add_info, _body_xy, _check_supported, _first_index, _gate_cost,
    _gn_config, _obs_information, _periodic_gn_config, _pose_refine_rows, _publish_refine,
)
from tpuslam_torch.frontend.pipeline import empty_outputs, run_sequence
from tpuslam_torch.frontend.state import SlamState, initial_state, map_state, session_state
from tpuslam_torch.geometry import se2
from tpuslam_torch.geometry.spherical import global_to_body_spherical
from tpuslam_torch.parallel.collectives import all_gather, pmax, psum, shard
from tpuslam_torch.parallel.map_blocks import sharded_winner
from tpuslam_torch.runtime.config import SlamConfig

__all__ = ["resident_online_supported", "run_pass_resident_online",
           "resident_online_core", "initial_shards"]

_INF = float("inf")
_I32 = torch.int32


def resident_online_supported(cfg: SlamConfig, block: int = 16) -> bool:
    """Configurations the resident pass reproduces, as the JAX package's:
    the blocked contract without the association kernel, and a periodic GN,
    if any, fixed-lag (with the map) and firing on block ends or dividing
    the block (a full-batch periodic GN is a dense-map construct)."""
    return (cfg.association in ("first", "nearest", "mahalanobis")
            and not cfg.use_pallas_association
            and cfg.vectorized_mapping
            and (cfg.periodic_gn_every == 0
                 or ((cfg.periodic_gn_every % block == 0 or _midblock_gn(cfg, block))
                     and cfg.periodic_gn_window > 0
                     and cfg.periodic_gn_window_landmarks)))


def initial_shards(L_global: int, mesh, axis: str = "map", device=None):
    """This rank's zero block (lm_xy [Lb, 2], lm_type [Lb], lm_info [Lb, 3])
    of a fresh map of `L_global` landmarks over `mesh[axis]`, which must
    divide it. Unlike the JAX package's, which returns the global arrays
    for `shard_map` to split, it makes the block alone: no rank holds the
    whole map. The block lies on `device`, by default this rank's device of
    the mesh: `cuda:<current device>` on a cuda mesh, the CPU on a cpu one."""
    _, d = shard(mesh, axis)
    if L_global % d:
        raise ValueError(f"{L_global} landmarks do not divide over {d} '{axis}' shards")
    if device is None:
        if mesh.device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh, but no CUDA device is available")
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    lb = L_global // d
    return (torch.zeros((lb, 2), device=device), torch.zeros(lb, dtype=_I32, device=device),
            torch.zeros((lb, 3), device=device))


@dataclasses.dataclass
class _Shard:
    """This rank's block of the map and where it sits on the axis."""
    xy: torch.Tensor      # [Lb, 2]
    type: torch.Tensor    # [Lb] int32
    info: torch.Tensor    # [Lb, 3]
    base: int             # global id of local slot 0
    L_glob: int
    mesh: object
    axis: str

    @property
    def lb(self) -> int:
        return self.xy.shape[0]


def _gather_lm(gidx, sh: _Shard, *arrs):
    """Rows `gidx` (global ids, any shape) of this rank's arrays `arrs`
    gathered from every rank: the owner's rows, zeros elsewhere, summed in
    ONE `psum` (the integer arrays ride it as float32, exact below 2^24, so
    k arrays cost one call). Ids outside [0, L_glob) give zero rows."""
    loc = gidx.long() - sh.base
    own = (loc >= 0) & (loc < sh.lb)
    locc = torch.clamp(loc, 0, sh.lb - 1)
    parts = [torch.where(own.reshape(*own.shape, *([1] * (a.dim() - 1))), a[locc],
                         a.new_zeros(())).to(torch.float32) for a in arrs]
    summed = psum(parts, sh.mesh, sh.axis)
    return [s.to(a.dtype) for s, a in zip(summed, arrs)]


def _local_scatter_to(gidx, enable, sh: _Shard):
    """Global scatter targets -> local slots; rows not owned here (or not
    enabled) go to the dropped row Lb."""
    loc = gidx.long() - sh.base
    return torch.where(enable & (loc >= 0) & (loc < sh.lb), loc, sh.lb)


def _agreed(flags, mesh, axis: str) -> list:
    """The host's one read of a block's integer flags (tensors, any shape,
    flattened in order), the same on every rank: one `pmax` of the flags and
    their negations gives every rank their maximum and minimum over the
    axis, and where the two differ every rank raises alike."""
    t = torch.cat([f.reshape(-1).to(_I32) for f in flags])
    both = pmax(torch.cat([t, -t]), mesh, axis).tolist()
    hi, lo = both[:t.numel()], [-x for x in both[t.numel():]]
    if hi != lo:
        raise RuntimeError(f"the ranks of '{axis}' disagree on a block's decisions: "
                           f"max {hi}, min {lo}")
    return hi


def _associate_resident(glob_k, otype_k, valid_k, n_landmarks, sh: _Shard, cfg: SlamConfig,
                        type_signed_bug=False, force_first=False):
    """The block association against the sharded map: each rank gates the
    [BN] observations against its [Lb] slots, one `pmin` picks the winners.
    `otype_k` is the float type column. `force_first` takes the first-match
    policy whatever `cfg.association` says (the localizer's, reference
    src/slam.cpp:350-383). Returns (global index int32, 0 where unmatched;
    matched; cost in gate units, inf where unmatched; gate)."""
    gid = sh.base + torch.arange(sh.lb, device=glob_k.device)
    diff = glob_k[:, None, :] - sh.xy[None, :, :]
    cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), sh.info, cfg)
    if type_signed_bug:
        # signed compare, reference src/slam.cpp:360
        type_ok = (sh.type[None, :].to(torch.float32) - otype_k[:, None]) < 1e-4
    else:
        type_ok = sh.type[None, :] == otype_k.to(_I32)[:, None]
    ok = type_ok & (gid < n_landmarks)[None, :] & (cost < gate) & valid_k[:, None]
    first = force_first or cfg.association == "first"
    j = _first_index(ok) if first else torch.argmin(torch.where(ok, cost, 1e30), dim=1)
    c = torch.gather(cost, 1, j.long()[:, None])[:, 0]
    sel, matched, c = sharded_winner(gid[j.long()], c, torch.any(ok, dim=1), first,
                                     sh.mesh, sh.axis)
    return sel, matched, torch.where(matched, c, _INF), gate


def _ring_idx(n_lm_after, cur_after, cones: int):
    """Ring-packet global landmark ids [..., cones] (the reference's ring
    wrap, src/slam.cpp:667, on global ids)."""
    idx = cur_after[..., None] + torch.arange(cones, device=cur_after.device)
    n = torch.clamp(n_lm_after, min=1)[..., None]
    idx = torch.where(idx < n, idx, idx - n)
    return torch.minimum(torch.clamp(idx, min=0), n - 1)


def _packet_gather_resident(sh: _Shard, n_lm_after, cur_after, cfg: SlamConfig,
                            extra_xy_idx=None):
    """Ring-packet rows (xy, type) gathered from the shards; the xy rows of
    the extra global ids `extra_xy_idx` [M] (the localizer refine's) ride
    the same `psum`, returned third ([M, 2], or None)."""
    idx = _ring_idx(n_lm_after, cur_after, cfg.cones_per_packet)
    flat = idx.reshape(-1)
    if extra_xy_idx is not None:
        flat = torch.cat([flat, extra_xy_idx.reshape(-1)])
    xy, ty = _gather_lm(flat, sh, sh.xy, sh.type)
    m = idx.numel()
    return (xy[:m].reshape(*idx.shape, 2), ty[:m].reshape(idx.shape),
            None if extra_xy_idx is None else xy[m:])


def _packet_series_resident(sh: _Shard, n_lm_after, cur_after, out_pose, cfg: SlamConfig):
    """`frontend.blocked._packet_series` against the sharded map."""
    xy, ty, _ = _packet_gather_resident(sh, n_lm_after, cur_after, cfg)
    az, dist = global_to_body_spherical(out_pose[..., None, :], xy, cfg.reference_compat)
    return az, dist, ty


def _mapping_block_resident(state: SlamState, sh: _Shard, obs, valid, poses, okp, boot_ok,
                            overflow, cfg: SlamConfig, defer_packets: bool = False):
    """`frontend.blocked._mapping_block` of one session (a stacked state
    [1]; inputs [1, B, ...]) with the map sharded: the same decisions, the
    [BN] machinery shared, the [L] steps through the shard helpers. With
    `defer_packets` (no GN moves a landmark during the mapping blocks) the
    ring ids come back in aux['pkt_idx'] and the caller gathers every
    block's rows at once. Returns (new_state, new shard, outputs [1, B],
    aux)."""
    g0 = state.graph
    S, B, N = valid.shape
    BN = B * N
    dev = obs.device
    thresh2 = cfg.same_cone_threshold * cfg.same_cone_threshold
    n_lm0 = g0.n_landmarks

    pose_idx_f, odo_f = _pose_insert_plan(g0, poses, okp)
    frame_of = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(N)
    frame_l = frame_of.long()
    fidx = torch.arange(B, dtype=_I32, device=dev)
    valid_k = (valid & okp[..., None]).reshape(S, BN)
    obs_k = obs.reshape(S, BN, 4)
    glob_k = _block_glob(obs, poses, cfg)
    body_k = _body_xy(obs, cfg).reshape(S, BN, 2)
    otype_k = obs_k[..., 3].to(_I32)
    d2car_k = obs_k[..., 2]

    # bootstrap (reference src/slam.cpp:554-567): global slot 0, on shard 0
    boot = (n_lm0 == 0) & boot_ok[:, 0] & okp[:, 0]
    bto = _local_scatter_to(torch.zeros_like(boot, dtype=_I32), boot, sh)[:, None]
    sh = dataclasses.replace(sh, xy=_drop_set(sh.xy[None], bto, glob_k[:, :1])[0],
                             type=_drop_set(sh.type[None], bto, otype_k[:, :1])[0])
    n_lm = n_lm0 + boot.to(_I32)

    # phase A against the block-start (post-boot) sharded map, then ONE
    # gather of the matched rows and of the closure anchor, landmark 0
    j_snap, snap_match, cost, gate = _associate_resident(
        glob_k[0], obs_k[0, :, 3], valid_k[0], n_lm[0], sh, cfg)
    (rows,) = _gather_lm(torch.cat([j_snap, j_snap.new_zeros(1)]), sh, sh.xy)
    snap_xy, lm0 = rows[None, :BN], rows[BN:]
    j_snap, snap_match = j_snap[None], snap_match[None]
    cost_snap = None if cfg.association == "first" else cost[None]

    # in-block creations and duplicate representatives, and the closure
    # detection against landmark 0 (the dense block's)
    cand = valid_k & ~snap_match & (d2car_k < cfg.cone_mapping_threshold)
    is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf = _inblock_duplicates(
        glob_k, otype_k, frame_of, cand, snap_match, cost_snap, thresh2, gate, cfg)
    slot, slot_ok, target, target_xy = _block_targets(
        n_lm, is_new, use_ib, dup_same, rep_prev, rep_same, matched_pf, j_snap, snap_xy, glob_k,
        sh.L_glob)
    closure_any, kc_frame, closed_before = _block_closure(
        state, target, target_xy, lm0[None], matched_pf, dup_same & slot_ok, d2car_k, frame_l,
        B, cfg)

    matched = matched_pf & ~closed_before
    is_new_s = is_new & ~closed_before
    dup_same_s = dup_same & ~closed_before
    ins = okp & (fidx <= kc_frame[:, None])
    g = _scatter_poses(dataclasses.replace(g0, n_landmarks=n_lm), poses, odo_f, pose_idx_f,
                       ins, cfg)

    # landmark writes: disjoint global slots, each rank writes its own
    lto = _local_scatter_to(slot, is_new_s & slot_ok, sh)
    n_new_per_frame = torch.sum(is_new_s.reshape(S, B, N), dim=-1, dtype=_I32)
    n_lm_after = torch.clamp(n_lm[:, None] + torch.cumsum(n_new_per_frame, -1, dtype=_I32),
                             max=sh.L_glob)
    n_new_total = torch.sum(is_new_s, dim=-1, dtype=_I32)
    sh = dataclasses.replace(sh, xy=_drop_set(sh.xy[None], lto, glob_k)[0],
                             type=_drop_set(sh.type[None], lto, otype_k)[0])
    g = dataclasses.replace(g, n_landmarks=torch.clamp(n_lm + n_new_total, max=sh.L_glob))
    keep = matched | ((is_new_s | dup_same_s) & slot_ok)
    g = _append_edges(g, boot, keep, pose_idx_f, frame_l, target, body_k)

    # per-landmark information (Mahalanobis), accumulated on the owner
    if cfg.association == "mahalanobis":
        sh = dataclasses.replace(
            sh, info=_add_info(sh.info, _local_scatter_to(target, keep, sh)[0],
                               _obs_information(glob_k, poses[:, frame_l], d2car_k, cfg)[0]))

    # committed currentConeIndex series, published poses (target_xy holds
    # the committed rows: the refine needs no gather) and packets
    target_f = target.reshape(S, B, N)
    matched_f = matched.reshape(S, B, N)
    cur_after = _current_series(state, matched | (dup_same_s & slot_ok), d2car_k, target_f)
    out_pose = _published_poses(poses, target_xy, matched_f, body_k, pose_idx_f, cfg)
    C = cfg.cones_per_packet
    pkt_idx = None
    if defer_packets:
        pkt_idx = _ring_idx(n_lm_after, cur_after, C)
        az = dist = poses.new_zeros(S, B, C)
        ctype = torch.zeros(S, B, C, dtype=_I32, device=dev)
    else:
        az, dist, ctype = _packet_series_resident(sh, n_lm_after, cur_after, out_pose, cfg)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
        send=torch.zeros(S, B, dtype=torch.bool, device=dev),
        loop_closed=closure_any[:, None] & (fidx == kc_frame[:, None]), n_landmarks=n_lm_after)
    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[:, -1],
        loop_closing=state.loop_closing | closure_any,
        loop_closure_complete=state.loop_closure_complete | closure_any,
        keyframe_count=state.keyframe_count + torch.sum(ins, dim=-1, dtype=_I32))
    aux = _mapping_aux(g0, boot, valid_k, okp, overflow, n_new_total, ins, keep, sh.L_glob,
                       closure_any=closure_any, kc_frame=kc_frame, cur_series=cur_after,
                       n_lm_series=n_lm_after, pkt_idx=pkt_idx,
                       pub_rows=(target_f, matched_f) if cfg.mapping_publish_refine else None)
    return new_state, sh, outputs, aux


def _loc_block_resident(state: SlamState, sh: _Shard, obs, valid, poses, okp, overflow,
                        cfg: SlamConfig, defer_packets: bool = False):
    """`frontend.blocked._loc_block` of one session against the frozen
    sharded map: first match in index order, as the dense block's. The
    localizer refine's rows ride the packet gather; with `defer_packets`
    (the map frozen through the localization blocks, no refine) the ring
    ids come back in aux['pkt_idx']. Returns (new_state, outputs [1, B],
    aux)."""
    g0 = state.graph
    S, B, N = valid.shape
    BN = B * N
    dev = obs.device

    pose_idx_f, odo_f = _pose_insert_plan(g0, poses, okp)
    g = _scatter_poses(g0, poses, odo_f, pose_idx_f, okp, cfg)

    ran = okp & (torch.sum(valid & okp[..., None], dim=-1) > 1)     # src/slam.cpp:332
    glob_k = _block_glob(obs, poses, cfg)
    obs_k = obs.reshape(S, BN, 4)
    vloc_k = (valid & ran[..., None]).reshape(S, BN)
    j, matched, _, _ = _associate_resident(
        glob_k[0], obs_k[0, :, 3], vloc_k[0], g.n_landmarks[0], sh, cfg,
        type_signed_bug=cfg.reference_compat and cfg.localizer_type_bug, force_first=True)
    j, matched = j[None], matched[None]

    cur_after, send_state = _loc_current(state, j, matched, ran, obs_k[..., 2])

    n_lm = g.n_landmarks[:, None].expand(S, B)
    C = cfg.cones_per_packet
    out_pose, pkt_idx = poses, None
    if defer_packets:
        pkt_idx = _ring_idx(n_lm, cur_after, C)
        ring_xy = poses.new_zeros(S, B, C, 2)
        ctype = torch.zeros(S, B, C, dtype=_I32, device=dev)
    else:
        ring_xy, ctype, lm_rows = _packet_gather_resident(
            sh, n_lm, cur_after, cfg, extra_xy_idx=j if cfg.localizer_refine else None)
        if cfg.localizer_refine:
            ref = _pose_refine_rows(poses, lm_rows.reshape(S, B, N, 2),
                                    matched.reshape(S, B, N), _body_xy(obs, cfg))
            out_pose = torch.where(ran[..., None], ref, poses)

    new_state = dataclasses.replace(
        state, graph=g, current_cone_index=cur_after[:, -1], send_cone_data=send_state,
        keyframe_count=state.keyframe_count + torch.sum(okp, dim=-1, dtype=_I32))
    az, dist = global_to_body_spherical(out_pose[..., None, :], ring_xy, cfg.reference_compat)
    outputs = KeyframeOutputs(
        pose=out_pose, cone_azimuth=az, cone_distance=dist, cone_type=ctype, send=ran,
        loop_closed=torch.zeros(S, B, dtype=torch.bool, device=dev), n_landmarks=n_lm)
    fallback = ((g0.n_poses + B > g0.poses.shape[-2]) & torch.any(okp, dim=-1)) \
        | torch.any(overflow & okp, dim=-1)
    return new_state, outputs, dict(fallback=fallback, cur_series=cur_after, n_lm_series=n_lm,
                                    pkt_idx=pkt_idx)


# ---------------------------------------------------------------------------
# sharded-landmark Gauss-Newton (closure and fixed-lag window)

def _eliminate_and_solve(sh: _Shard, h_diag, h_off, gp, hd_lm, gp_lm, w0, w1, hll, gl,
                         free_pose, cfg: gn.GNConfig):
    """The reduced pose system with this rank's landmarks eliminated
    locally and every rank's parts summed in ONE `psum` (the pose rows'
    landmark blocks hd_lm, gp_lm ride it), the pose-side gauge after the
    sum, and the dense Cholesky on every rank. w0 / w1 [3P, Lb] and hll,
    gl come gauged. Returns (dp [3P], dl [Lb, 2]). The reduced system is
    FP32 whatever the GN's matmul precision, as `gauss_newton`'s."""
    dtype = h_diag.dtype
    with gn._fp32():
        s_part, r_part, hll_inv = gn._schur_eliminate(w0, w1, hll, gl)
    hd_lm, gp_lm, s_red, r_red = psum([hd_lm, gp_lm, s_part, r_part], sh.mesh, sh.axis)
    fpb = free_pose.to(dtype)[:, None, None]
    eye3 = torch.eye(3, dtype=dtype, device=h_diag.device)
    h_diag = (h_diag + hd_lm) * fpb + eye3 * (1.0 - fpb)
    gp = (gp + gp_lm) * free_pose.to(dtype)[:, None]
    if cfg.damping:
        h_diag = h_diag + eye3 * cfg.damping * fpb
    with gn._fp32():
        return gn._schur_back(gn.densify_hpp(h_diag, h_off) - s_red, -gp.reshape(-1) + r_red,
                              w0, w1, gl, hll_inv)


def _gauge_lm(hll, gl, free_lm, cfg: gn.GNConfig):
    """Identity Hll blocks and zero gradients for the fixed and padding
    landmarks (by global id), plus the damping."""
    dtype = hll.dtype
    fl = free_lm.to(dtype)
    eye2 = torch.eye(2, dtype=dtype, device=hll.device)
    flb = fl[:, None, None]
    hll = hll * flb + eye2 * (1.0 - flb)
    if cfg.damping:
        hll = hll + eye2 * cfg.damping * flb
    return hll, gl * fl[:, None]


def _gn_step_sharded(g, sh: _Shard, cfg: gn.GNConfig):
    """One closure-GN iteration of one graph `g` (the pose and edge graph,
    replicated) with this rank's landmarks `sh.xy`: `gauss_newton.gn_step`'s
    gauge and Schur algebra at full capacity, each edge weighted on its
    landmark's owner only, one `psum` of the reduced system. Returns (g with
    the new poses, the new landmark block)."""
    P = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    with gn.precision(cfg, g.poses):
        h_diag, h_off, gp = gn.assemble_odometry(g, cfg)
        own = (g.obs_lm >= sh.base) & (g.obs_lm < sh.base + sh.lb)
        w_l = cfg.lm_info * (g.obs_valid & own).to(dtype)
        h_diag_lm, w0, w1, hll, gp_lm, gl = gn._landmark_edge_blocks_split(
            g.poses, sh.xy, g.obs_pose, torch.clamp(g.obs_lm - sh.base, 0, sh.lb - 1),
            g.obs_xy, w_l, sh.lb)
        kp = torch.arange(P, device=dev)
        free_pose = (kp >= cfg.fix_first_poses) & (kp < g.n_poses)
        gid = sh.base + torch.arange(sh.lb, device=dev)
        free_lm = (gid >= cfg.fix_first_landmarks) & (gid < g.n_landmarks)
        pair = free_pose & torch.roll(free_pose, 1)
        pair[0] = False
        h_off = h_off * pair.to(dtype)[:, None, None]
        fw = free_pose.to(dtype).repeat_interleave(3)[:, None] * free_lm.to(dtype)[None, :]
        hll, gl = _gauge_lm(hll, gl, free_lm, cfg)
        dp, dl = _eliminate_and_solve(sh, h_diag, h_off, gp, h_diag_lm, gp_lm, w0 * fw, w1 * fw,
                                      hll, gl, free_pose, cfg)
    poses = g.poses + dp.reshape(P, 3)
    act = kp < g.n_poses
    theta = torch.where(act, se2.wrap_angle(poses[:, 2]), poses[:, 2])
    return (dataclasses.replace(g, poses=torch.cat([poses[:, :2], theta[:, None]], dim=1)),
            sh.xy + dl)


def _update_size(g, lm, g2, lm2, sh: _Shard) -> float:
    """max |update| over poses and landmarks, from ONE `pmax`: the value
    every rank's early exit reads."""
    d = torch.maximum(torch.max(torch.abs(g2.poses - g.poses)), torch.max(torch.abs(lm2 - lm)))
    return float(pmax(d, sh.mesh, sh.axis))


def _optimize_sharded(g, sh: _Shard, cfg: gn.GNConfig):
    """`gauss_newton.optimize`'s loop around `_gn_step_sharded`, stepping
    in pairs as the JAX package's: the convergence test (one `pmax`) after
    every pair, the pair's second step only within the iteration cap (an odd
    cap runs exactly `iterations` steps), and the update measured over the
    whole pair. Returns (g, the landmark block)."""
    tol = cfg.early_exit_tol if cfg.early_exit_tol > 0.0 else -_INF
    lm, i = sh.xy, 0
    while i < cfg.iterations:
        g2, lm2 = _gn_step_sharded(g, dataclasses.replace(sh, xy=lm), cfg)
        steps = 1
        if cfg.iterations > 1 and i + 1 < cfg.iterations:
            g2, lm2 = _gn_step_sharded(g2, dataclasses.replace(sh, xy=lm2), cfg)
            steps = 2
        delta = _update_size(g, lm, g2, lm2, sh)
        g, lm, i = g2, lm2, i + steps
        if not delta > tol:
            break
    return g, lm


def _window_gn_step_sharded(g, sh: _Shard, cfg: gn.GNConfig, window: int, edge_window: int,
                            lm_prior, end=None, end_obs=None):
    """`gauss_newton.window_gn_step(landmarks=True)` of one graph with the
    map sharded: the window's odometry chain and priors replicated, the
    trailing edges weighted on their landmark's owner, the landmark columns
    [.., Lb] local, one `psum` of the window's reduced system. The same
    marginalized-information prior, centred at `lm_prior` (this rank's
    block at the firing's entry); `end` / `end_obs` anchor the window at a
    past pose and edge count. Returns (g, the landmark block)."""
    W, EW = window, edge_window
    P, E = g.poses.shape[0], g.obs_pose.shape[0]
    if W > P or EW > E:
        raise ValueError(f"window {W} / edge window {EW} exceed the graph's capacity "
                         f"({P} poses, {E} edges)")
    Lb = sh.lb
    dtype, dev = g.poses.dtype, g.poses.device
    with gn.precision(cfg, g.poses):
        # the window's odometry chain and priors, replicated (the dense step's)
        n = g.n_poses if end is None else end
        e_stop = g.n_obs if end_obs is None else end_obs
        w0, kg, poses_w, h_diag, h_off, gp = (x[0] for x in gn._window_chain(
            gn._graph_fields(lambda v: v[None], g), cfg, W, n.reshape(1, 1), None))
        kgl = kg.long()

        # trailing landmark edges with their pose in the window, weighted on
        # the landmark's owner only
        e0 = torch.clamp(e_stop - EW, min=0)
        ke = (e0 + torch.arange(EW, device=dev)).long()
        op, ol = g.obs_pose[ke], g.obs_lm[ke].long()
        own_e = (ol >= sh.base) & (ol < sh.base + Lb)
        in_w = (ke < e_stop) & (op >= w0) & own_e
        w_l = cfg.lm_info * in_w.to(dtype)
        local = torch.clamp(op - w0, 0, W - 1).long()
        lol = torch.clamp(ol - sh.base, 0, Lb - 1)
        r_l, j_lp, j_ll = landmark_residuals(poses_w[local], sh.xy[lol], g.obs_xy[ke])
        wl3 = w_l[:, None, None]
        jtp = j_lp.mT
        hd_lm = h_diag.new_zeros(W, 3, 3).index_add(0, local, wl3 * (jtp @ j_lp))
        gp_lm = gp.new_zeros(W, 3).index_add(0, local,
                                             w_l[:, None] * (jtp @ r_l[..., None])[..., 0])

        # gauge by global pose index
        free = (kg >= cfg.fix_first_poses) & (kg < n)
        prev_free = torch.cat([free.new_zeros(1), free[:-1]])
        h_off = h_off * (free & prev_free).to(dtype)[:, None, None]

        # Hll from each owned landmark's total edge count before e_stop (the
        # marginalized edges' prior plus the in-window ones)
        lm_all = g.obs_lm.long()
        counted = ((torch.arange(E, device=dev) < e_stop) & (lm_all >= sh.base)
                   & (lm_all < sh.base + Lb))
        n_tot = g.poses.new_zeros(Lb + 1).index_add(
            0, torch.where(counted, lm_all - sh.base, Lb), counted.to(dtype))[:Lb]
        gid = sh.base + torch.arange(Lb, device=dev)
        free_lm = (gid >= cfg.fix_first_landmarks) & (gid < g.n_landmarks)
        flm = free_lm.to(dtype)
        hll_d = cfg.lm_info * n_tot * flm
        hll = torch.where(hll_d > 0, hll_d, 1.0)[:, None, None] * torch.eye(2, dtype=dtype,
                                                                           device=dev)
        if cfg.damping:
            hll = hll + torch.eye(2, dtype=dtype, device=dev) * cfg.damping * flm[:, None, None]
        wc = g.poses.new_zeros(W * Lb, 3, 2).index_add(0, local * Lb + lol, wl3 * (jtp @ j_ll))
        wc = wc.reshape(W, Lb, 3, 2).permute(0, 2, 1, 3).reshape(3 * W, Lb, 2)
        mask = free.to(dtype).repeat_interleave(3)[:, None] * flm[None, :]
        gl = g.poses.new_zeros(Lb, 2).index_add(
            0, lol, w_l[:, None] * (j_ll.mT @ r_l[..., None])[..., 0]) * flm[:, None]
        # the marginalized edges' restoring gradient, centred at lm_prior
        n_in = g.poses.new_zeros(Lb).index_add(0, lol, in_w.to(dtype))
        n_out = torch.clamp(n_tot - n_in, min=0.0)
        gl = gl + (cfg.lm_info * n_out * flm)[:, None] * (sh.xy - lm_prior)
        dp, dl = _eliminate_and_solve(sh, h_diag, h_off, gp, hd_lm, gp_lm, wc[..., 0] * mask,
                                      wc[..., 1] * mask, hll, gl, free, cfg)
    new_w = poses_w + dp.reshape(W, 3)
    theta = torch.where(free, se2.wrap_angle(new_w[:, 2]), new_w[:, 2])
    new_w = torch.cat([new_w[:, :2], theta[:, None]], dim=-1)
    return dataclasses.replace(g, poses=g.poses.index_put((kgl,), new_w)), sh.xy + dl


def _optimize_window_sharded(g, sh: _Shard, cfg: SlamConfig, end=None, end_obs=None):
    """One periodic firing: `gauss_newton.optimize_window`'s loop around
    `_window_gn_step_sharded`, the convergence test (one `pmax`) after every
    step, the prior centred at the entry block. Returns (g, the landmark
    block)."""
    pcfg = _periodic_gn_config(cfg)
    tol = pcfg.early_exit_tol if pcfg.early_exit_tol > 0.0 else -_INF
    lm_prior = lm = sh.xy
    for _ in range(pcfg.iterations):
        g2, lm2 = _window_gn_step_sharded(g, dataclasses.replace(sh, xy=lm), pcfg,
                                          cfg.periodic_gn_window, cfg.periodic_gn_edge_window,
                                          lm_prior, end, end_obs)
        delta = _update_size(g, lm, g2, lm2, sh)
        g, lm = g2, lm2
        if not delta > tol:
            break
    return g, lm


# ---------------------------------------------------------------------------
# the pass

def _fire(st, sh: _Shard, cfg: SlamConfig, end=None, end_obs=None):
    """One periodic firing (`_optimize_window_sharded`) of a stacked state
    [1]: (state, shard)."""
    g, lm = _optimize_window_sharded(gn._graph_fields(lambda v: v[0], st.graph), sh, cfg, end,
                                     end_obs)
    return (dataclasses.replace(st, graph=gn._graph_fields(lambda v: v[None], g)),
            dataclasses.replace(sh, xy=lm))


def _patch_last(outs: KeyframeOutputs, sh: _Shard, aux, cfg: SlamConfig,
                pose=None) -> KeyframeOutputs:
    """The block's last frame after a periodic GN at its end: its cone
    packet from the refined shards, published from `pose` [1, 1, 3] when
    given."""
    last = outs.pose[:, -1:] if pose is None else pose
    az, dist, ctype = _packet_series_resident(sh, aux["n_lm_series"][:, -1:],
                                              aux["cur_series"][:, -1:], last, cfg)

    def put(x, v):
        return torch.cat([x[:, :-1], v], dim=1)
    return dataclasses.replace(
        outs, pose=put(outs.pose, last), cone_azimuth=put(outs.cone_azimuth, az),
        cone_distance=put(outs.cone_distance, dist), cone_type=put(outs.cone_type, ctype))


def _mapping_periodic(ns, sh: _Shard, outs, aux, fires, closed, kcf, obs, poses,
                      cfg: SlamConfig):
    """`frontend.blocked._mapping_periodic` of one committed mapping block
    with the map sharded, from the block's agreed flags (`fires` B bools).
    Returns (fallback, state, shard, outputs)."""
    B = len(fires)
    if _midblock_gn(cfg, B):
        if closed and fires[min(max(kcf, 0), B - 1)]:
            return True, ns, sh, outs
        firing = [f for f in range(B) if fires[f]]
        for f in firing:
            ns, sh = _fire(ns, sh, cfg, aux["n_pose_series"][0, f], aux["n_obs_series"][0, f])
        if cfg.mapping_publish_refine and firing:
            # the frames after a firing publish their refine against the
            # block's final map: one gather of their rows
            lm_idx, matched = aux["pub_rows"]
            (rows,) = _gather_lm(lm_idx, sh, sh.xy)
            ref = _publish_refine(poses, rows, matched, _body_xy(obs, cfg), cfg)
            fired_before = torch.tensor([[any(fires[:f]) for f in range(B)]], device=poses.device)
            upd = fired_before & (aux["n_pose_series"] - 1 >= cfg.periodic_gn_every)
            outs = dataclasses.replace(outs, pose=torch.where(upd[..., None], ref, outs.pose))
        do_p = fires[-1]
    else:
        if any(fires[:-1]) or (fires[-1] and closed):
            return True, ns, sh, outs
        do_p = fires[-1]
        if do_p:
            ns, sh = _fire(ns, sh, cfg)
    if do_p:
        pose = None
        if cfg.use_gps_prior and not cfg.mapping_publish_refine:
            # the firing frame publishes its post-GN graph estimate
            g = ns.graph
            pose = g.poses[:, torch.clamp(g.n_poses[0] - 1, min=0).long()][:, None]
        outs = _patch_last(outs, sh, aux, cfg, pose)
    return False, ns, sh, outs


def _loc_periodic(st, ns, sh: _Shard, outs, aux, fires, okp, cfg: SlamConfig):
    """`frontend.blocked._loc_periodic` of one committed localization block
    with the map sharded. Returns (fallback, state, shard, outputs)."""
    B = len(fires)
    if _midblock_gn(cfg, B):
        n_pose_series = st.graph.n_poses[:, None] + torch.cumsum(okp, -1, dtype=_I32)
        for f in (f for f in range(B) if fires[f]):
            ns, sh = _fire(ns, sh, cfg, n_pose_series[0, f])
    elif any(fires[:-1]):
        return True, ns, sh, outs
    elif fires[-1]:
        ns, sh = _fire(ns, sh, cfg)
    if fires[-1]:
        outs = _patch_last(outs, sh, aux, cfg)
    return False, ns, sh, outs


def _deferred_packets(outs: KeyframeOutputs, pkt_idx, sh: _Shard, cfg: SlamConfig):
    """The cone packets of blocks run with `defer_packets`: every frame's
    ring rows in ONE gather from the map as it stands now."""
    xy, ty = _gather_lm(pkt_idx, sh, sh.xy, sh.type)
    az, dist = global_to_body_spherical(outs.pose[..., None, :], xy, cfg.reference_compat)
    return dataclasses.replace(outs, cone_azimuth=az, cone_distance=dist, cone_type=ty)


def _pass(st: SlamState, sh: _Shard, obs_c, valid_c, first_valid, overflow, pose_seq,
          cfg: SlamConfig, block: int):
    """The whole blocked pass of one session (a stacked state [1], inputs
    [1, Tp, ...]) with the map sharded: mapping blocks, the closure GN,
    localization blocks; `frontend.blocked.blocked_core_batched`'s control
    flow at S = 1, each branch on agreed flags. Returns (state, shard,
    outputs [1, done_upto], done_upto)."""
    B = block
    Tp = obs_c.shape[1]
    nb = Tp // B
    dev = obs_c.device
    okp_all = _in_bounds(pose_seq, cfg)
    periodic = cfg.periodic_gn_every > 0
    # with no GN during the blocks the map's rows do not move, so a scan's
    # ring rows are gathered once for all its blocks
    defer1 = not periodic
    defer2 = not periodic and not cfg.localizer_refine
    frozen = bool(_agreed([st.loop_closure_complete], sh.mesh, sh.axis)[0])

    done_upto, kc_global = Tp, -1 if frozen else Tp
    map_parts, pkt1, kc_rows = [], [], None
    for ib in range(0 if frozen else nb):
        f = slice(ib * B, (ib + 1) * B)
        ns, sh2, outs, aux = _mapping_block_resident(
            st, sh, obs_c[:, f], valid_c[:, f], pose_seq[:, f], okp_all[:, f],
            first_valid[:, f], overflow[:, f], cfg, defer_packets=defer1)
        flags = [aux["fallback"], aux["closure_any"], aux["kc_frame"]]
        if periodic:
            flags.append(_periodic_fires(st.keyframe_count, aux["ins"], aux["n_lm_series"], cfg))
        fb, closed, kcf, *fires = _agreed(flags, sh.mesh, sh.axis)
        fell = bool(fb)
        if periodic and not fell:
            fell, ns, sh2, outs = _mapping_periodic(ns, sh2, outs, aux, [bool(x) for x in fires],
                                                    closed, kcf, obs_c[:, f], pose_seq[:, f], cfg)
        if fell:
            done_upto = ib * B
            break
        st, sh = ns, sh2
        map_parts.append(outs)
        if defer1:
            pkt1.append(aux["pkt_idx"])
        if closed:
            kc_global = ib * B + kcf
            at = min(kcf, B - 1)
            kc_rows = (aux["n_lm_series"][:, at:at + 1], aux["cur_series"][:, at:at + 1],
                       aux["pub_rows"])
            break

    if map_parts:
        outs1 = _map_outputs(lambda *vs: torch.cat(vs, dim=1), *map_parts)
        if defer1:
            outs1 = _deferred_packets(outs1, torch.cat(pkt1, dim=1), sh, cfg)
    closed_now = not frozen and kc_global < Tp and done_upto == Tp
    if closed_now:
        # the one-shot closure GN, then the closure frame's packet (and,
        # with the publish refine, its pose) from the optimized shards
        g, lm = _optimize_sharded(gn._graph_fields(lambda v: v[0], st.graph), sh,
                                  _gn_config(cfg))
        st = dataclasses.replace(st, graph=gn._graph_fields(lambda v: v[None], g))
        sh = dataclasses.replace(sh, xy=lm)
        pose_kc = pose_seq[:, kc_global:kc_global + 1]
        if cfg.mapping_publish_refine:
            at = kc_global % B
            lm_idx, matched = (x[:, at:at + 1] for x in kc_rows[2])
            (rows,) = _gather_lm(lm_idx, sh, sh.xy)
            pose_kc = _publish_refine(pose_kc, rows, matched,
                                      _body_xy(obs_c[:, kc_global:kc_global + 1], cfg), cfg)
        az, dist, ctype = _packet_series_resident(sh, kc_rows[0], kc_rows[1], pose_kc, cfg)
        t = slice(kc_global, kc_global + 1)
        outs1 = dataclasses.replace(
            outs1, pose=_put(outs1.pose, t, pose_kc), cone_azimuth=_put(outs1.cone_azimuth, t, az),
            cone_distance=_put(outs1.cone_distance, t, dist),
            cone_type=_put(outs1.cone_type, t, ctype))

    # localization: the frames after the closure frame
    lo_block = (kc_global + 1) // B if kc_global < Tp and done_upto == Tp else nb
    fidx = torch.arange(B, device=dev)
    loc_parts, pkt2 = [], []
    for ib in range(lo_block, nb):
        f = slice(ib * B, (ib + 1) * B)
        okp = okp_all[:, f] & (ib * B + fidx > kc_global)
        ns, outs, aux = _loc_block_resident(st, sh, obs_c[:, f], valid_c[:, f], pose_seq[:, f],
                                            okp, overflow[:, f], cfg, defer_packets=defer2)
        flags = [aux["fallback"]]
        if periodic:
            flags.append(_periodic_fires(st.keyframe_count, okp, aux["n_lm_series"], cfg))
        fb, *fires = _agreed(flags, sh.mesh, sh.axis)
        fell, sh2 = bool(fb), sh
        if periodic and not fell:
            fell, ns, sh2, outs = _loc_periodic(st, ns, sh, outs, aux, [bool(x) for x in fires],
                                                okp, cfg)
        if fell:
            done_upto = ib * B
            break
        st, sh = ns, sh2
        loc_parts.append(outs)
        if defer2:
            pkt2.append(aux["pkt_idx"])

    # merge: frames up to the closure frame from the mapping blocks, later
    # ones from the localization blocks
    parts = []
    if map_parts:
        parts.append(_rows(_map_outputs(lambda v: v[0], outs1), 0, min(kc_global + 1,
                                                                         outs1.pose.shape[1])))
    if loc_parts:
        outs2 = _map_outputs(lambda *vs: torch.cat(vs, dim=1), *loc_parts)
        if defer2:
            outs2 = _deferred_packets(outs2, torch.cat(pkt2, dim=1), sh, cfg)
        first = max(kc_global + 1, lo_block * B)
        parts.append(_rows(_map_outputs(lambda v: v[0], outs2), first - lo_block * B,
                           outs2.pose.shape[1]))
    outs = _map_outputs(lambda *vs: torch.cat(vs), *parts) if parts else None
    if outs is not None and outs.pose.shape[0] > done_upto:
        outs = _rows(outs, 0, done_upto)
    return st, sh, outs, done_upto


def _put(x, t: slice, v):
    """`x` [1, T, ...] with frames `t` replaced by `v` (out of place)."""
    return torch.cat([x[:, :t.start], v, x[:, t.stop:]], dim=1)


def resident_online_core(state: SlamState, lm_xy, lm_type, lm_info, obs_seq, valid_seq,
                         pose_seq, cfg: SlamConfig, mesh, block: int = 16, axis: str = "map",
                         compact_obs: int = 32):
    """The resident pass over inputs already padded to a multiple of
    `block`, called by every rank of `mesh[axis]` with the same inputs.
    `state` carries the replicated pose and edge graph and the counters;
    its own landmark arrays are not read (a state of any landmark capacity
    will do). lm_xy [Lb, 2], lm_type [Lb] and lm_info [Lb, 3] are THIS
    rank's block of the map (`initial_shards`), global ids [rank * Lb,
    (rank + 1) * Lb).

    Returns (state, lm_xy, lm_type, lm_info, outputs [done_upto],
    done_upto): the state with the same landmark arrays it came with, this
    rank's new block, and the first frame the blocks did not process (a
    fallback), the padded length on a complete pass."""
    index, d = shard(mesh, axis)
    Lb = lm_xy.shape[0]
    sh = _Shard(lm_xy, lm_type, lm_info, index * Lb, Lb * d, mesh, axis)
    obs_c, valid_c, first_valid, overflow = _compacted(obs_seq[None], valid_seq[None],
                                                       compact_obs)
    st, sh, outs, done_upto = _pass(map_state(lambda v: v[None], state), sh, obs_c, valid_c,
                                    first_valid, overflow, pose_seq[None], cfg, block)
    return session_state(st, 0), sh.xy, sh.type, sh.info, outs, done_upto


def run_pass_resident_online(obs_seq, valid_seq, pose_seq, cfg: SlamConfig, mesh,
                             block: int = 16, axis: str = "map",
                             lm_per_device: int | None = None):
    """One whole session from a fresh state with the map sharded over
    `mesh[axis]` (`parallel.mesh.make_map_mesh`), called by every rank of
    it with the same inputs, on the device the mesh's backend reduces
    (CUDA for NCCL). Each rank holds `lm_per_device` landmark slots
    (`max_landmarks` over the axis size by default, which must divide it).
    The map is gathered once at the end (`collectives.all_gather`) and
    folded into the state, cut to `max_landmarks`; a block the blocked form
    cannot commit hands the frames from `done_upto` on to the per-frame
    path on that map.

    Returns (state, outputs [T]) on every rank, as
    `frontend.blocked.run_pass_blocked`. Raises `ValueError` on the
    configurations the JAX package's refuses (`resident_online_supported`)."""
    if not resident_online_supported(cfg, block):
        raise ValueError("run_pass_resident_online: unsupported config (needs the blocked "
                         "contract without the association kernel; a periodic GN must be "
                         "fixed-lag with the map, its boundaries on block ends or dividing "
                         "the block)")
    _check_supported(cfg)
    if obs_seq.device.type != mesh.device_type:
        raise ValueError(f"inputs on {obs_seq.device.type}, the mesh reduces "
                         f"{mesh.device_type} tensors")
    _, d = shard(mesh, axis)
    L = cfg.capacity.max_landmarks
    if lm_per_device is None:
        if L % d:
            raise ValueError(f"max_landmarks {L} not divisible by {d} '{axis}' shards "
                             "(pass lm_per_device)")
        lm_per_device = L // d
    dev = obs_seq.device
    T = obs_seq.shape[0]
    cap = dataclasses.replace(cfg.capacity, max_landmarks=1)
    state = initial_state(cap, dev)
    if T == 0:
        return _fold(state, initial_shards(lm_per_device * d, mesh, axis, dev), mesh, axis,
                     L), empty_outputs(cfg, dev)
    obs_p, valid_p, pose_p = _pad_inputs(obs_seq, valid_seq, pose_seq, cfg, block)
    nc, _ = _pick_compact(valid_p, state)
    state, *shards, outs, done_upto = resident_online_core(
        state, *initial_shards(lm_per_device * d, mesh, axis, dev), obs_p, valid_p, pose_p, cfg,
        mesh, block, axis, compact_obs=nc)
    state = _fold(state, shards, mesh, axis, L)
    if done_upto >= T:
        return state, _rows(outs, 0, T)
    state, rest = run_sequence(state, obs_seq[done_upto:], valid_seq[done_upto:],
                               pose_seq[done_upto:], cfg)
    return state, rest if outs is None else _map_outputs(lambda *vs: torch.cat(vs), outs, rest)


def _fold(state: SlamState, shards, mesh, axis: str, L: int) -> SlamState:
    """The state with the whole map in it: every rank's block gathered in
    ONE `all_gather` (the types ride as float32, exact below 2^24) and cut
    to `L` rows."""
    xy, ty, info = shards
    full = all_gather(torch.cat([xy, ty.to(torch.float32)[:, None], info], dim=1), mesh, axis)
    return dataclasses.replace(
        state, graph=dataclasses.replace(state.graph, lm_xy=full[:L, :2],
                                         lm_type=full[:L, 2].to(_I32)),
        lm_info_xy=full[:L, 3:])
