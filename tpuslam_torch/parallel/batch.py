"""Batched multi-session pipelines (counterpart of `tpuslam.parallel.batch`).

One session is dispatch-bound: its ops are small. S independent sessions
(cars, laps, replay shards) run as one stacked state, a leading axis S on
every field, so each op does the work of all S: the blocked pipeline
(`frontend.blocked.run_sequences_blocked_batched`) and, here, the per-frame
engine (`run_sequences_batched`).

The per-frame engine steps every session one keyframe at a time, as one op
stream: the blocked pipeline's block functions at one frame per block
(`_mapping_block` for the sessions still mapping, `_loc_block` for those
whose map is frozen) compute what `perform_keyframe` computes, and one
read per frame brings back the [S] fallback, closure and periodic-GN flags.
Under the scan-form mapping step (`vectorized_mapping=False`) the sessions
still mapping take `keyframe._mapping_step` instead of `_mapping_block`: its
loop over the observation slots runs once for all of them, each step an
[S, L] op masked per session.
As in the JAX package, the keyframe defers its full GNs (`defer_gn`): after
the frame's outputs, one stacked `gauss_newton.optimize` runs the closure
GN of the sessions that closed, and one more the full-batch periodic GN of
those that asked for it (a fixed-lag window GN runs within the frame). A
closure frame therefore publishes from the map before its GN, the JAX
package's documented deviation under `mapping_publish_refine`. A session
the blocks cannot step exactly (an empty map whose first observation slot
is invalid, or a full graph; under the scan form, whose appends saturate
as the per-frame ones do, a full pose store alone) runs that frame through
`perform_keyframe` alone.
"""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.core.slam import checked_device
from tpuslam_torch.frontend.blocked import (
    _I32, _cat, _enable, _in_bounds, _loc_block, _map_outputs, _mapping_block, _packet_series,
    _patch_last, _periodic_fires, _pose_insert_plan, _read_flags, _rows_at, _scatter_poses,
)
from tpuslam_torch.frontend.keyframe import (
    KeyframeOutputs, _check_supported, _gn_config, _mapping_step, perform_keyframe, periodic_gn,
)
from tpuslam_torch.frontend.pipeline import empty_outputs
from tpuslam_torch.frontend.state import (
    SlamState, initial_state, map_state, session_state, stack_states,
)
from tpuslam_torch.runtime.config import SlamConfig

__all__ = ["initial_states", "run_sequences_batched", "run_passes_batched"]


def initial_states(cap: GraphCapacity, n_sessions: int, device) -> SlamState:
    """Stacked initial state for `n_sessions` independent sessions."""
    return stack_states([initial_state(cap, device)] * n_sessions)


def _where(mask, a, b):
    """`a` for the sessions of `mask` [S], else `b`, field by field."""
    return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def _scan_frame(state: SlamState, obs, valid, poses, okp, cfg: SlamConfig):
    """`_mapping_block`'s (new_state, outputs [S, 1], aux) for one frame
    under the scan-form mapping step: the pose insertion of the blocks,
    then `keyframe._mapping_step` for the sessions of `okp` [S, 1] (the
    others come back unchanged). obs [S, 1, N, 4], valid [S, 1, N], poses
    [S, 1, 3]. Falls back where the insertion cannot match `graph.add_pose`
    (a full pose store)."""
    g0 = state.graph
    run = okp[:, 0]
    pose_idx, odo = _pose_insert_plan(g0, poses, okp)
    st = dataclasses.replace(state, graph=_scatter_poses(g0, poses, odo, pose_idx, okp, cfg),
                             keyframe_count=state.keyframe_count + run.to(_I32))
    st, closure = _mapping_step(st, obs[:, 0], valid[:, 0], poses[:, 0], pose_idx[:, 0], cfg,
                                enable=run)
    cur, n_lm = st.current_cone_index[:, None], st.graph.n_landmarks[:, None]
    az, dist, ctype = _packet_series(st.graph.lm_xy, st.graph.lm_type, n_lm, cur, poses, cfg)
    outs = KeyframeOutputs(pose=poses, cone_azimuth=az, cone_distance=dist, cone_type=ctype,
                           send=torch.zeros_like(okp), loop_closed=closure[:, None],
                           n_landmarks=n_lm)
    fallback = (g0.n_poses >= g0.poses.shape[-2]) & run
    return st, outs, dict(fallback=fallback, closure_any=closure, cur_series=cur,
                          n_lm_series=n_lm, ins=okp)


def _batched_frame(states: SlamState, frozen, obs, valid, pose, cfg: SlamConfig):
    """One keyframe of every session, `perform_keyframe(defer_gn=True)`'s
    results for each: obs [S, 1, N, 4], valid [S, 1, N], pose [S, 1, 3];
    `frozen` [S] host bools. Returns (state, outputs [S, 1], closure
    wanted, periodic GN wanted, fallback), the last three S host bools;
    a fallback session's results are not set."""
    S = obs.shape[0]
    dev = obs.device
    fz = torch.tensor(frozen, device=dev)
    okp = _in_bounds(pose, cfg)
    none = torch.zeros_like(okp)
    aux = None
    if not all(frozen) and not cfg.vectorized_mapping:
        ns, outs, aux = _scan_frame(states, obs, valid, pose, okp & ~fz[:, None], cfg)
        ins, fallback, closure = aux["ins"], aux["fallback"], aux["closure_any"]
    elif not all(frozen):
        ns, outs, aux = _mapping_block(states, obs, valid, pose, okp & ~fz[:, None],
                                       valid[..., 0], none, cfg)
        ins, fallback, closure = aux["ins"], aux["fallback"], aux["closure_any"]
    if any(frozen):
        lns, lo, laux = _loc_block(states, obs, valid, pose, okp & fz[:, None], none, cfg)
        if aux is None:
            ns, outs, aux = lns, lo, laux
            ins, fallback, closure = okp, laux["fallback"], none[:, 0]
        else:
            ns = map_state(lambda a, b: _where(fz, a, b), lns, ns)
            outs = _map_outputs(lambda a, b: _where(fz, a, b), lo, outs)
            aux = {k: _where(fz, laux[k], aux[k]) for k in ("cur_series", "n_lm_series")}
            ins = _where(fz, okp, ins)
            fallback = _where(fz, laux["fallback"], fallback)
            closure = closure & ~fz
    fires = None
    if cfg.periodic_gn_every > 0:
        fires = _periodic_fires(states.keyframe_count, ins, aux["n_lm_series"], cfg)
    (fell, closed), fires = _read_flags((fallback, closure), fires)
    fell = [bool(x) for x in fell]
    closed = [bool(x) and not f for x, f in zip(closed, fell)]
    fire = [bool(f[0]) and not x for f, x in zip(fires, fell)] if fires else [False] * S
    want_periodic = [False] * S
    if cfg.periodic_gn_window == 0:
        want_periodic = fire
    elif any(fire):
        # the fixed-lag window GN runs within the keyframe: its last frame
        # publishes from the refreshed map (and, in mapping mode with the
        # GPS prior, from the refreshed pose)
        g = periodic_gn(ns.graph, cfg, enable=_enable(fire, dev))
        ns = dataclasses.replace(ns, graph=g)
        pub = None
        if cfg.use_gps_prior and not cfg.mapping_publish_refine:
            use_graph = ~ns.loop_closure_complete & (g.n_landmarks > 4)
            pub = _where(use_graph, _rows_at(g.poses, torch.clamp(g.n_poses - 1, min=0)
                                             .long()[:, None]), outs.pose)
        outs = _patch_last(outs, g, aux, cfg, fire, pub)
    return ns, outs, closed, want_periodic, fell


def _put(stacked, one, s: int):
    """`stacked` [S, ...] with session s replaced by `one`."""
    return torch.cat([stacked[:s], one[None], stacked[s + 1:]])


def run_sequences_batched(states: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig):
    """Run S sessions of T keyframes each, frame by frame, on the states'
    device: states stacked [S] (`initial_states`), obs_seq [S, T, N, 4],
    valid_seq [S, T, N], pose_seq [S, T, 3]. Returns (final stacked state,
    KeyframeOutputs with axes [S, T]).

    Each session's results are those of its own `run_sequence` but for the
    deferred GNs, which run after their frame's outputs (see the module
    docstring), and a stacked GN of S > 1 sessions, which runs at full
    capacity with its sums in another order."""
    _check_supported(cfg)
    S, T = obs_seq.shape[:2]
    dev = states.keyframe_count.device
    obs_seq, valid_seq, pose_seq = (x.to(dev) for x in (obs_seq, valid_seq, pose_seq))
    if T == 0:
        return states, _map_outputs(lambda v: v.new_zeros((S, *v.shape)),
                                    empty_outputs(cfg, dev))
    gcfg = _gn_config(cfg)
    frozen = [bool(x) for x in states.loop_closure_complete.tolist()]
    parts = []
    for t in range(T):
        f = slice(t, t + 1)
        new, outs, closed, periodic, fell = _batched_frame(
            states, frozen, obs_seq[:, f], valid_seq[:, f], pose_seq[:, f], cfg)
        alone = {}
        for s in (s for s in range(S) if fell[s]):
            st, alone[s], wc, wp = perform_keyframe(session_state(states, s), obs_seq[s, t],
                                                    valid_seq[s, t], pose_seq[s, t], cfg,
                                                    defer_gn=True)
            new = map_state(lambda a, b: _put(a, b, s), new, st)
            closed[s], periodic[s] = bool(wc), bool(wp)
        if len(alone) == S:
            outs = _map_outputs(lambda *vs: torch.stack(vs)[:, None], *alone.values())
        for s, out in alone.items() if len(alone) < S else ():
            outs = _map_outputs(lambda a, b: _put(a, b[None], s), outs, out)
        states = new
        parts.append(outs)
        # the deferred GNs, after the frame's outputs: the closure GN, and
        # the full-batch periodic GN of the sessions that did not close
        if any(closed):
            states = dataclasses.replace(
                states, graph=gn.optimize(states.graph, gcfg, enable=_enable(closed, dev)))
        periodic = [p and not c for p, c in zip(periodic, closed)]
        if any(periodic):
            states = dataclasses.replace(
                states, graph=periodic_gn(states.graph, cfg, enable=_enable(periodic, dev)))
        frozen = [fz or c for fz, c in zip(frozen, closed)]
        if any(fell):
            frozen = [bool(x) for x in states.loop_closure_complete.tolist()]
    return states, _cat(parts, dim=1)


def run_passes_batched(obs_seq, valid_seq, pose_seq, cfg: SlamConfig, device="cuda"):
    """`run_sequences_batched` from fresh states on `device` (the card
    unless the caller asks for the CPU; a card asked for and missing
    raises), the inputs moved there."""
    dev = checked_device(device)
    obs_seq, valid_seq, pose_seq = (torch.as_tensor(x, device=dev)
                                    for x in (obs_seq, valid_seq, pose_seq))
    return run_sequences_batched(initial_states(cfg.capacity, obs_seq.shape[0], dev),
                                 obs_seq, valid_seq, pose_seq, cfg)

