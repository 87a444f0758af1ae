"""Plain NumPy geometry of the cone observation model: the sensor's
spherical triple to the body and global frames and back, with the cfsd18
reference's constants (src/slam.hpp:134-136) where the configuration keeps
its quirks. Written from the reference's equations; shares no code with the
program. Every function takes arrays of any leading shape and computes in
their dtype."""
from __future__ import annotations

import math

import numpy as np

# reference src/slam.hpp:134-136: the slightly-off DEG2RAD, and PI as the
# double of the float literal 3.14159265f
REF_DEG2RAD = 0.017453292522222
REF_RAD2DEG = 57.295779513082325
REF_PI = float(np.float32(3.14159265))


def _constants(compat: bool):
    if compat:
        return REF_DEG2RAD, REF_RAD2DEG, REF_PI
    return math.pi / 180.0, 180.0 / math.pi, math.pi


def wrap(theta):
    """Angles to (-pi, pi]."""
    return math.pi - np.mod(math.pi - theta, 2.0 * math.pi)


def body_xy(az_deg, zen_deg, dist, lever: float, compat: bool):
    """Lidar spherical (deg, deg, m) -> body-frame (x, y) at the centre of
    gravity, `lever` metres behind the lidar (reference src/slam.cpp:513-523
    and :637-654: the law of cosines, sign +1 at azimuth 0)."""
    d2r, r2d, pi = _constants(compat)
    sign = np.where(az_deg >= 0, 1.0, -1.0).astype(az_deg.dtype)
    interior = pi - np.abs(az_deg * d2r)
    d_new = np.sqrt(lever * lever + dist * dist - 2.0 * lever * dist * np.cos(interior))
    ratio = np.clip(np.sin(interior) * dist / np.maximum(d_new, 1e-12), -1.0, 1.0)
    az = np.arcsin(ratio) * r2d * sign
    cz = np.cos(zen_deg * d2r)
    return np.stack([d_new * cz * np.cos(az * d2r), d_new * cz * np.sin(az * d2r)], axis=-1)


def to_global(pose, xy):
    """Body-frame points [..., 2] seen from pose [..., 3] -> global frame."""
    c, s = np.cos(pose[..., 2:3]), np.sin(pose[..., 2:3])
    x, y = xy[..., 0:1], xy[..., 1:2]
    return np.concatenate([x * c - y * s + pose[..., 0:1], x * s + y * c + pose[..., 1:2]],
                          axis=-1)


def to_body_spherical(pose, xy, compat: bool):
    """Global points [..., 2] -> (azimuth deg, distance) seen from pose
    [3]; with `compat` the azimuth keeps the reference's unit mixture
    (src/cone.cpp:34-44: the heading divided by RAD2DEG)."""
    _, r2d, _ = _constants(compat)
    dx, dy = xy[..., 0] - pose[0], xy[..., 1] - pose[1]
    az = np.arctan2(dy, dx) * r2d
    az = az - pose[2] / r2d if compat else az - pose[2] * r2d
    return az, np.sqrt(dx * dx + dy * dy)


def between(a, b):
    """Relative pose inv(a) * b."""
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([c * dx + s * dy, -s * dx + c * dy, wrap(b[..., 2] - a[..., 2])], axis=-1)
