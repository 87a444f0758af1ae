"""Fixed-capacity factor-graph state (counterpart of `tpuslam.backend.graph`).

The same structure-of-arrays layout as the JAX package: poses [P, 3],
landmarks [L, 2] + types [L], a flat landmark-observation edge list [E], and
0-d int32 counters. Every index and counter stays int32, as in the JAX
state, so states convert between the packages field by field.

The update functions are functional: they return a new `FactorGraph` and
never write into the tensors of the one they were given. Counters stay on
the device, so a masked append costs no host synchronisation.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class GraphCapacity:
    """Array capacities of the graph."""
    max_poses: int = 1024
    max_landmarks: int = 512
    max_obs: int = 8192


@dataclass
class FactorGraph:
    poses: torch.Tensor        # [P, 3] f32
    n_poses: torch.Tensor      # i32 scalar
    odo_meas: torch.Tensor     # [P, 3] f32; odo_meas[k] = between(pose[k-1], pose[k])
    odo_w: torch.Tensor        # [P] f32 odometry-edge weight multiplier
    lm_xy: torch.Tensor        # [L, 2] f32
    lm_type: torch.Tensor      # [L] i32
    n_landmarks: torch.Tensor  # i32 scalar
    obs_pose: torch.Tensor     # [E] i32
    obs_lm: torch.Tensor       # [E] i32
    obs_xy: torch.Tensor       # [E, 2] f32 body-frame measurement
    n_obs: torch.Tensor        # i32 scalar
    prior_pose: torch.Tensor   # [P, 3] f32 absolute pose priors
    prior_info: torch.Tensor   # [P, 2] f32 (xy, theta) information; 0 = off

    @property
    def pose_valid(self) -> torch.Tensor:
        return torch.arange(self.poses.shape[0], device=self.poses.device) < self.n_poses

    @property
    def lm_valid(self) -> torch.Tensor:
        return torch.arange(self.lm_xy.shape[0], device=self.lm_xy.device) < self.n_landmarks

    @property
    def obs_valid(self) -> torch.Tensor:
        return torch.arange(self.obs_pose.shape[0], device=self.obs_pose.device) < self.n_obs

    @property
    def capacity(self) -> GraphCapacity:
        return GraphCapacity(self.poses.shape[0], self.lm_xy.shape[0],
                             self.obs_pose.shape[0])


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def empty_graph(cap: GraphCapacity, device, dtype=torch.float32) -> FactorGraph:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return FactorGraph(
        poses=z(cap.max_poses, 3), n_poses=_i32(0, device),
        odo_meas=z(cap.max_poses, 3),
        odo_w=torch.ones(cap.max_poses, dtype=dtype, device=device),
        lm_xy=z(cap.max_landmarks, 2), lm_type=z(cap.max_landmarks, dt=torch.int32),
        n_landmarks=_i32(0, device),
        obs_pose=z(cap.max_obs, dt=torch.int32), obs_lm=z(cap.max_obs, dt=torch.int32),
        obs_xy=z(cap.max_obs, 2), n_obs=_i32(0, device),
        prior_pose=z(cap.max_poses, 3), prior_info=z(cap.max_poses, 2),
    )


def _row_index(count: torch.Tensor, cap: int) -> torch.Tensor:
    """[1] long index of the next free row, saturating at the last one. A
    one-element index (not a 0-d one, which PyTorch reads back to the host)
    keeps the update free of device synchronisation."""
    return torch.clamp(count, max=cap - 1).reshape(1).long()


def _set_row(x: torch.Tensor, k: torch.Tensor, value) -> torch.Tensor:
    """Out-of-place `x[k] = value` for a [1] index tensor `k`."""
    return x.index_put((k,), torch.as_tensor(value, dtype=x.dtype, device=x.device))


def add_pose(g: FactorGraph, pose, odo_meas, prior_info=None) -> FactorGraph:
    """Append a pose vertex + odometry edge from its predecessor. Saturates
    silently at capacity; `prior_info` (xy_info, theta_info) attaches an
    absolute prior at `pose`."""
    cap = g.poses.shape[0]
    k = _row_index(g.n_poses, cap)
    g = dataclasses.replace(
        g, poses=_set_row(g.poses, k, pose), odo_meas=_set_row(g.odo_meas, k, odo_meas),
        n_poses=torch.clamp(g.n_poses + 1, max=cap))
    if prior_info is not None:
        g = dataclasses.replace(
            g, prior_pose=_set_row(g.prior_pose, k, pose),
            prior_info=_set_row(g.prior_info, k, prior_info))
    return g


def _masked_row(x: torch.Tensor, k: torch.Tensor, value, en: torch.Tensor) -> torch.Tensor:
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return _set_row(x, k, torch.where(en, value, x[k]))


def add_landmark(g: FactorGraph, xy, lm_type, enable=True) -> FactorGraph:
    """Masked append of one landmark; no-op when `enable` is False."""
    cap = g.lm_xy.shape[0]
    k = _row_index(g.n_landmarks, cap)
    en = torch.as_tensor(enable, device=g.lm_xy.device)
    return dataclasses.replace(
        g, lm_xy=_masked_row(g.lm_xy, k, xy, en),
        lm_type=_masked_row(g.lm_type, k, lm_type, en),
        n_landmarks=torch.clamp(g.n_landmarks + en.to(torch.int32), max=cap))


def add_observation(g: FactorGraph, pose_idx, lm_idx, meas_xy, enable=True) -> FactorGraph:
    """Masked append of one landmark-observation edge."""
    cap = g.obs_pose.shape[0]
    k = _row_index(g.n_obs, cap)
    en = torch.as_tensor(enable, device=g.obs_pose.device)
    return dataclasses.replace(
        g, obs_pose=_masked_row(g.obs_pose, k, pose_idx, en),
        obs_lm=_masked_row(g.obs_lm, k, lm_idx, en),
        obs_xy=_masked_row(g.obs_xy, k, meas_xy, en),
        n_obs=torch.clamp(g.n_obs + en.to(torch.int32), max=cap))
