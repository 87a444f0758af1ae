"""Sensor-frame spherical -> Cartesian cone observation model (counterpart of
`tpuslam.geometry.spherical`). Angles come in DEGREES; `ref_constants`
switches to the reference's quirky DEG2RAD/PI constants (`tpuslam_torch.compat`)."""
from __future__ import annotations

import math

import torch

from tpuslam_torch import compat

__all__ = [
    "lidar_to_cog", "spherical_to_cartesian", "cone_to_global", "cones_to_global",
    "global_to_body_spherical", "lane_uniform",
]


def _constants(ref_constants: bool):
    if ref_constants:
        return compat.REF_DEG2RAD, compat.REF_PI
    return math.pi / 180.0, math.pi


def lidar_to_cog(azimuth_deg, distance, lever_arm=compat.REF_LIDAR_TO_COG,
                 ref_constants: bool = True):
    """Correct (azimuth[deg], distance) for the lidar->CoG lever arm
    (law of cosines; safe sign +1 at exactly zero azimuth)."""
    d2r, pi = _constants(ref_constants)
    r2d = compat.REF_RAD2DEG if ref_constants else 180.0 / math.pi
    sign = torch.where(azimuth_deg >= 0, 1.0, -1.0).to(azimuth_deg.dtype)
    interior = pi - torch.abs(azimuth_deg * d2r)
    d_new = torch.sqrt(lever_arm * lever_arm + distance * distance
                       - 2.0 * lever_arm * distance * torch.cos(interior))
    ratio = torch.clamp(torch.sin(interior) * distance / torch.clamp(d_new, min=1e-12),
                        -1.0, 1.0)
    a_new = torch.asin(ratio) * r2d
    return a_new * sign, d_new


def spherical_to_cartesian(azimuth_deg, zenith_deg, distance,
                           lever_arm=compat.REF_LIDAR_TO_COG,
                           ref_constants: bool = True):
    """Spherical (deg, deg, m) -> body-frame Cartesian (x, y, z) at the CoG."""
    d2r, _ = _constants(ref_constants)
    az, dist = lidar_to_cog(azimuth_deg, distance, lever_arm, ref_constants)
    cz = torch.cos(zenith_deg * d2r)
    x = dist * cz * torch.cos(az * d2r)
    y = dist * cz * torch.sin(az * d2r)
    z = dist * torch.sin(zenith_deg * d2r)
    return torch.stack([x, y, z], dim=-1)


def cone_to_global(pose, obs_azd, obs_zend, obs_dist,
                   lever_arm=compat.REF_LIDAR_TO_COG, ref_constants: bool = True):
    """Observation spherical tuple -> global-frame (x, y)."""
    xyz = spherical_to_cartesian(obs_azd, obs_zend, obs_dist, lever_arm, ref_constants)
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    gx = xyz[..., 0] * c - xyz[..., 1] * s + pose[..., 0]
    gy = xyz[..., 0] * s + xyz[..., 1] * c + pose[..., 1]
    return torch.stack([gx, gy], dim=-1)


def cones_to_global(pose, obs, lever_arm=compat.REF_LIDAR_TO_COG,
                    ref_constants: bool = True):
    """Batched cone_to_global over an observation array `[N, 4]` of
    (azimuth_deg, zenith_deg, distance, type)."""
    return cone_to_global(pose[..., None, :], obs[..., 0], obs[..., 1], obs[..., 2],
                          lever_arm, ref_constants)


def lane_uniform(fn, *xs):
    """`fn(*xs)` for an elementwise torch function, with each element's
    value independent of how many elements the tensors hold. On the CPU,
    ATen computes the last (length mod twice the SIMD width) elements of a
    buffer with the scalar libm function and the rest with the vectorized
    one, which can differ in the last bit; padding the flat buffers to a
    multiple of 64 puts every element on the vectorized path, so one
    keyframe's values and a block of keyframes' values agree bit for bit.
    CUDA computes every element alike."""
    if xs[0].is_cuda:
        return fn(*xs)
    xs = torch.broadcast_tensors(*xs)
    shape, n = xs[0].shape, xs[0].numel()
    pad = (-n) % 64
    flat = [torch.cat([x.reshape(-1), x.new_ones(pad)]) for x in xs]
    return fn(*flat)[:n].reshape(shape)


def global_to_body_spherical(pose, cone_xy, ref_constants: bool = True):
    """Global cone (x, y) -> (azimuth_deg, distance) seen from `pose`; with
    `ref_constants` the azimuth keeps the reference's deg/rad unit mixture."""
    dx = cone_xy[..., 0] - pose[..., 0]
    dy = cone_xy[..., 1] - pose[..., 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    r2d = compat.REF_RAD2DEG if ref_constants else 180.0 / math.pi
    az = lane_uniform(torch.atan2, dy, dx) * r2d
    if ref_constants:
        az = az - pose[..., 2] / r2d
    else:
        az = az - pose[..., 2] * r2d
    return az, dist
