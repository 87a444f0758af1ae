"""SE(2) rigid-transform operations on `[..., 3]` (x, y, theta) tensors
(counterpart of `tpuslam.geometry.se2`)."""
from __future__ import annotations

import math

import torch

__all__ = [
    "wrap_angle", "compose", "inverse", "between",
    "transform_to_world", "transform_to_body", "exp", "log",
]


def wrap_angle(theta):
    """Wrap angles to (-pi, pi]. `torch.remainder` (not `fmod`) matches
    `jnp.mod`'s sign convention for negative angles."""
    return math.pi - torch.remainder(math.pi - theta, 2.0 * math.pi)


def compose(a, b):
    """SE(2) composition a*b: first apply b in a's frame."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], dim=-1)


def inverse(a):
    """SE(2) inverse."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], dim=-1)


def between(a, b):
    """Relative pose inv(a)*b — the odometry measurement between keyframes."""
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = ca * dx + sa * dy
    y = -sa * dx + ca * dy
    t = wrap_angle(b[..., 2] - a[..., 2])
    return torch.stack([x, y, t], dim=-1)


def transform_to_world(pose, pts):
    """Transform body-frame points `[..., 2]` into the world frame."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x = c * pts[..., 0] - s * pts[..., 1] + pose[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + pose[..., 1]
    return torch.stack([x, y], dim=-1)


def transform_to_body(pose, pts):
    """Transform world-frame points `[..., 2]` into the pose's body frame."""
    dx = pts[..., 0] - pose[..., 0]
    dy = pts[..., 1] - pose[..., 1]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x = c * dx + s * dy
    y = -s * dx + c * dy
    return torch.stack([x, y], dim=-1)


def exp(tangent):
    """SE(2) exponential map from a tangent vector (vx, vy, omega)."""
    w = tangent[..., 2]
    small = torch.abs(w) < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    s, c = torch.sin(ws), torch.cos(ws)
    a = torch.where(small, 1.0 - w * w / 6.0, s / ws)
    b = torch.where(small, w / 2.0, (1.0 - c) / ws)
    x = a * tangent[..., 0] - b * tangent[..., 1]
    y = b * tangent[..., 0] + a * tangent[..., 1]
    return torch.stack([x, y, wrap_angle(w)], dim=-1)


def log(pose):
    """SE(2) logarithm map to a tangent vector (vx, vy, omega)."""
    w = wrap_angle(pose[..., 2])
    small = torch.abs(w) < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    half = ws / 2.0
    cot = half / torch.tan(half)
    a = torch.where(small, 1.0 - w * w / 12.0, cot)
    b = torch.where(small, w / 2.0, half)
    x = a * pose[..., 0] + b * pose[..., 1]
    y = -b * pose[..., 0] + a * pose[..., 1]
    return torch.stack([x, y, w], dim=-1)
