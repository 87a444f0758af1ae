"""Motion models (counterpart of `tpuslam.frontend.motion`): the
reference's yaw-rate heading correction and the CTRV EKF.

`compat_heading_correction` reproduces the reference's dead-reckoning
heading touch-up (reference src/slam.cpp:309-317). `Ekf` is the constant
turn-rate/velocity filter over (x, y, theta, v, omega) fusing GPS position,
geodetic heading and IMU yaw rate, as two float32 tensors on one device.

The innovation covariance of every update is 1x1 or 2x2, so its inverse is
the closed form (1 / s, and the adjugate over the determinant) where the
JAX package calls `jnp.linalg.inv`: no linear-algebra library call, and on
the card a handful of elementwise launches. `tests/test_torch_motion.py`
holds sequences of predicts and updates to the JAX package within 1e-5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuslam_torch.geometry import se2

__all__ = ["compat_heading_correction", "Ekf", "ekf_init", "ekf_predict",
           "ekf_update_position", "ekf_update_heading", "ekf_update_yaw_rate"]


def compat_heading_correction(pose, yaw_rate_scaled, dt_seconds):
    """reference src/slam.cpp:309-317: subtract scaled yaw rate over dt if
    0 < dt < 1 s. `yaw_rate_scaled` is angularVelocityZ/4 (src/slam.cpp:216)."""
    dt = torch.as_tensor(dt_seconds, dtype=pose.dtype, device=pose.device)
    apply = (dt > 0.0) & (dt < 1.0)
    new_heading = pose[..., 2] - yaw_rate_scaled * dt
    out = pose.clone()
    out[..., 2] = torch.where(apply, new_heading, pose[..., 2])
    return out


@dataclasses.dataclass
class Ekf:
    x: torch.Tensor   # [5] (x, y, theta, v, omega), float32
    p: torch.Tensor   # [5, 5] covariance, float32


def ekf_init(pose=None, pos_std=5.0, heading_std=0.5, v_std=5.0, w_std=1.0,
             device=None) -> Ekf:
    """A filter at `pose` (a [3] tensor, whose device it takes; else at the
    origin on `device`)."""
    if pose is not None:
        device = pose.device
    x = torch.zeros(5, dtype=torch.float32, device=device)
    if pose is not None:
        x[:3] = pose
    p = torch.diag(torch.tensor([pos_std**2, pos_std**2, heading_std**2, v_std**2, w_std**2],
                                dtype=torch.float32, device=device))
    return Ekf(x=x, p=p)


def ekf_predict(ekf: Ekf, dt, q_v=1.0, q_w=0.5) -> Ekf:
    """CTRV process model with white accel/yaw-accel noise."""
    x, y, th, v, w = ekf.x.unbind()
    c, s = torch.cos(th), torch.sin(th)
    xn = torch.stack([x + v * c * dt, y + v * s * dt, se2.wrap_angle(th + w * dt), v, w])
    f = torch.eye(5, dtype=ekf.p.dtype, device=ekf.p.device)
    f[0, 2], f[0, 3] = -v * s * dt, c * dt
    f[1, 2], f[1, 3] = v * c * dt, s * dt
    f[2, 4] = dt
    # G diag(q_v, q_w) G^T with G = dt at (3, 0) and (4, 1), in float32
    dt32 = np.float32(dt)
    q = torch.zeros_like(f)
    q[3, 3], q[4, 4] = float(dt32 * np.float32(q_v) * dt32), float(dt32 * np.float32(q_w) * dt32)
    return Ekf(x=xn, p=f @ ekf.p @ f.T + q)


def _inverse(s):
    """Inverse of a 1x1 or 2x2 innovation covariance, in closed form."""
    if s.shape[0] == 1:
        return 1.0 / s
    a, b, c, d = s[0, 0], s[0, 1], s[1, 0], s[1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) / det


def _joseph_update(ekf: Ekf, h, r_cov, innov) -> Ekf:
    s = h @ ekf.p @ h.T + r_cov
    k = ekf.p @ h.T @ _inverse(s)
    xn = ekf.x + k @ innov
    xn[2] = se2.wrap_angle(xn[2])
    ikh = torch.eye(5, dtype=ekf.p.dtype, device=ekf.p.device) - k @ h
    pn = ikh @ ekf.p @ ikh.T + k @ r_cov @ k.T
    return Ekf(x=xn, p=pn)


def _h(lo, hi, device):
    """The measurement matrix of state entries lo..hi-1: rows of I5."""
    return torch.eye(5, dtype=torch.float32, device=device)[lo:hi]


def _f32_tensor(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def ekf_update_position(ekf: Ekf, xy, std=0.5) -> Ekf:
    dev = ekf.x.device
    r = torch.eye(2, dtype=torch.float32, device=dev) * std**2
    return _joseph_update(ekf, _h(0, 2, dev), r, _f32_tensor(xy, dev) - ekf.x[:2])


def ekf_update_heading(ekf: Ekf, heading, std=0.1) -> Ekf:
    dev = ekf.x.device
    innov = se2.wrap_angle(_f32_tensor(heading, dev) - ekf.x[2]).reshape(1)
    r = torch.eye(1, dtype=torch.float32, device=dev) * std**2
    return _joseph_update(ekf, _h(2, 3, dev), r, innov)


def ekf_update_yaw_rate(ekf: Ekf, omega, std=0.05) -> Ekf:
    dev = ekf.x.device
    r = torch.eye(1, dtype=torch.float32, device=dev) * std**2
    return _joseph_update(ekf, _h(4, 5, dev), r,
                          (_f32_tensor(omega, dev) - ekf.x[4]).reshape(1))
