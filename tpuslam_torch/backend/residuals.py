"""Closed-form residuals and Jacobians for the two factor types
(counterpart of `tpuslam.backend.residuals`), batched over leading axes."""
from __future__ import annotations

import torch

from tpuslam_torch.geometry import se2

__all__ = ["odometry_residuals", "landmark_residuals"]


def _rot_t(theta):
    """R(theta)^T as [..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


def _drot_t(theta):
    """d(R^T)/dtheta as [..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([-s, c], -1), torch.stack([-c, -s], -1)], -2)


def odometry_residuals(pose_i, pose_j, meas):
    """Residual + Jacobians for batched odometry edges.

    Args:   pose_i, pose_j, meas: [..., 3].
    Returns r [..., 3], J_i [..., 3, 3], J_j [..., 3, 3].
    """
    rel = se2.between(pose_i, pose_j)
    rm_t = _rot_t(meas[..., 2])
    r = torch.cat([
        (rm_t @ (rel[..., :2] - meas[..., :2])[..., None])[..., 0],
        se2.wrap_angle(rel[..., 2] - meas[..., 2])[..., None],
    ], dim=-1)

    ri_t = _rot_t(pose_i[..., 2])
    d = pose_j[..., :2] - pose_i[..., :2]
    dtheta_col = (rm_t @ (_drot_t(pose_i[..., 2]) @ d[..., None]))[..., 0]
    rm_ri = rm_t @ ri_t

    zeros2 = torch.zeros_like(d)
    ones1 = torch.ones_like(d[..., :1])
    j_i_top = torch.cat([-rm_ri, dtheta_col[..., None]], dim=-1)
    j_i_bot = torch.cat([zeros2, -ones1], -1)[..., None, :]
    j_i = torch.cat([j_i_top, j_i_bot], dim=-2)

    j_j_top = torch.cat([rm_ri, torch.zeros_like(dtheta_col)[..., None]], dim=-1)
    j_j_bot = torch.cat([zeros2, ones1], -1)[..., None, :]
    j_j = torch.cat([j_j_top, j_j_bot], dim=-2)
    return r, j_i, j_j


def landmark_residuals(pose, lm_xy, meas_xy):
    """Residual + Jacobians for batched landmark-observation edges.

    Args:   pose [..., 3], lm_xy [..., 2], meas_xy [..., 2].
    Returns r [..., 2], J_pose [..., 2, 3], J_lm [..., 2, 2].
    """
    ri_t = _rot_t(pose[..., 2])
    d = lm_xy - pose[..., :2]
    r = (ri_t @ d[..., None])[..., 0] - meas_xy
    dtheta_col = (_drot_t(pose[..., 2]) @ d[..., None])[..., 0]
    j_pose = torch.cat([-ri_t, dtheta_col[..., None]], dim=-1)
    return r, j_pose, ri_t
