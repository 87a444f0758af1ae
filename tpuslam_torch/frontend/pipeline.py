"""Whole-sequence pipeline (counterpart of `tpuslam.frontend.pipeline`):
`perform_keyframe` over the frame axis, outputs stacked per field."""
from __future__ import annotations

import dataclasses

import torch

from tpuslam_torch.frontend.keyframe import KeyframeOutputs, perform_keyframe
from tpuslam_torch.frontend.state import SlamState, initial_state
from tpuslam_torch.runtime.config import SlamConfig

__all__ = ["run_sequence", "run_pass", "empty_outputs"]


def run_sequence(state: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig,
                 assoc_mesh=None):
    """Process T keyframes in order.

    obs_seq [T, N, 4], valid_seq [T, N], pose_seq [T, 3] (odometry poses,
    already heading-corrected), all on the state's device. Returns
    (final_state, KeyframeOutputs with a leading T axis on every field).
    """
    outs = []
    for t in range(obs_seq.shape[0]):
        state, out = perform_keyframe(state, obs_seq[t], valid_seq[t], pose_seq[t], cfg,
                                      assoc_mesh=assoc_mesh)
        outs.append(out)
    if not outs:
        return state, empty_outputs(cfg, obs_seq.device)
    stacked = KeyframeOutputs(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(KeyframeOutputs)})
    return state, stacked


def empty_outputs(cfg: SlamConfig, device) -> KeyframeOutputs:
    """The outputs of zero keyframes: a leading axis of 0 on every field,
    with the dtypes and trailing shapes of `perform_keyframe`'s."""
    k = cfg.cones_per_packet
    f32, i32, b = torch.float32, torch.int32, torch.bool
    return KeyframeOutputs(
        pose=torch.zeros((0, 3), dtype=f32, device=device),
        cone_azimuth=torch.zeros((0, k), dtype=f32, device=device),
        cone_distance=torch.zeros((0, k), dtype=f32, device=device),
        cone_type=torch.zeros((0, k), dtype=i32, device=device),
        send=torch.zeros(0, dtype=b, device=device),
        loop_closed=torch.zeros(0, dtype=b, device=device),
        n_landmarks=torch.zeros(0, dtype=i32, device=device))


def run_pass(obs_seq, valid_seq, pose_seq, cfg: SlamConfig):
    """One whole session from a fresh state on the inputs' device.
    Returns (final_state, stacked KeyframeOutputs)."""
    state = initial_state(cfg.capacity, obs_seq.device)
    return run_sequence(state, obs_seq, valid_seq, pose_seq, cfg)
