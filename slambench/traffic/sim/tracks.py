"""Synthetic Formula Student track generators. A frozen copy of
`tpuslam_torch.sim.tracks`, held equal to it at the cells' seeds by
`slambench/tests/test_slambench_traffic.py`.

The reference repo has no fixtures or fake backends (SURVEY.md §4); its
validation was replaying recorded runs. These generators produce the three
BASELINE.json track configs — skidpad, acceleration, trackdrive — as cone
layouts + a drivable centerline, in the local Cartesian frame the engine uses.

Cone type convention (reference viewerbuild/src/drawer.cpp:22-41):
1 = yellow (right side), 2 = blue (left side), 3 = small orange, 4 = big
orange (start/stop zone).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

YELLOW, BLUE, ORANGE_SMALL, ORANGE_BIG = 1, 2, 3, 4


@dataclass
class Track:
    name: str
    centerline: np.ndarray   # [S, 2] dense uniformly-spaced samples
    headings: np.ndarray     # [S] tangent heading at each sample
    arclength: np.ndarray    # [S] cumulative arclength
    cones_xy: np.ndarray     # [C, 2]
    cones_type: np.ndarray   # [C] int
    closed: bool

    @property
    def length(self) -> float:
        return float(self.arclength[-1])

    def pose_at(self, s):
        """Interpolated SE(2) pose at arclength s (wraps if closed)."""
        s = np.asarray(s, dtype=np.float64)
        if self.closed:
            s = np.mod(s, self.length)
        x = np.interp(s, self.arclength, self.centerline[:, 0])
        y = np.interp(s, self.arclength, self.centerline[:, 1])
        cos_i = np.interp(s, self.arclength, np.cos(self.headings))
        sin_i = np.interp(s, self.arclength, np.sin(self.headings))
        th = np.arctan2(sin_i, cos_i)
        return np.stack([x, y, th], axis=-1)


def _resample_uniform(pts, n, closed):
    """Resample a polyline to n uniformly-spaced points."""
    if closed:
        pts = np.vstack([pts, pts[:1]])
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    su = np.linspace(0, s[-1], n, endpoint=not closed)
    x = np.interp(su, s, pts[:, 0])
    y = np.interp(su, s, pts[:, 1])
    return np.stack([x, y], axis=1), su


def _finish_track(name, center_pts, closed, cone_spacing, half_width, n_samples=2048):
    center, s = _resample_uniform(center_pts, n_samples, closed)
    d = np.gradient(center, axis=0)
    headings = np.arctan2(d[:, 1], d[:, 0])
    # lateral cone rows at +-half_width, spaced cone_spacing along the line
    n_cones = max(int(s[-1] // cone_spacing), 4)
    sc = np.linspace(0, s[-1], n_cones, endpoint=not closed)
    cx = np.interp(sc, s, center[:, 0])
    cy = np.interp(sc, s, center[:, 1])
    ch_c = np.interp(sc, s, np.cos(headings))
    ch_s = np.interp(sc, s, np.sin(headings))
    norm = np.stack([-ch_s, ch_c], axis=1)
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    ctr = np.stack([cx, cy], axis=1)
    left = ctr + half_width * norm
    right = ctr - half_width * norm
    cones = np.vstack([left, right])
    types = np.concatenate([np.full(len(left), BLUE), np.full(len(right), YELLOW)])
    # big orange pair at the start line
    start_n = norm[0]
    start = np.stack([ctr[0] + 0.6 * start_n, ctr[0] - 0.6 * start_n])
    cones = np.vstack([cones, start])
    types = np.concatenate([types, [ORANGE_BIG, ORANGE_BIG]])
    return Track(name=name, centerline=center, headings=headings, arclength=s,
                 cones_xy=cones, cones_type=types.astype(np.int32), closed=closed)


def skidpad(radius: float = 9.125, half_width: float = 1.5,
            cone_spacing: float = 3.0) -> Track:
    """FSG skidpad: the right-hand circle of the figure-eight as a closed
    loop (the reference SLAM maps one closed circuit; ~40-50 cones)."""
    phi = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    ctr = np.stack([radius * np.sin(phi), radius - radius * np.cos(phi)], axis=1)
    return _finish_track("skidpad", ctr, True, cone_spacing, half_width)


def acceleration(length: float = 75.0, half_width: float = 1.5,
                 cone_spacing: float = 5.0) -> Track:
    """FSG acceleration: a 75 m straight with cone walls every 5 m."""
    x = np.linspace(0, length, 128)
    ctr = np.stack([x, np.zeros_like(x)], axis=1)
    return _finish_track("acceleration", ctr, False, cone_spacing, half_width)


def trackdrive(seed: int = 0, mean_radius: float = 28.0, half_width: float = 1.5,
               cone_spacing: float = 4.0) -> Track:
    """FSG trackdrive: a smooth random closed circuit (~250-400 m, ~150 cones).

    Fourier-perturbed circle; low harmonics keep curvature drivable.
    """
    rng = np.random.default_rng(seed)
    phi = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    r = mean_radius * np.ones_like(phi)
    for k, amp in ((2, 0.18), (3, 0.10), (5, 0.04)):
        r += mean_radius * amp * np.sin(k * phi + rng.uniform(0, 2 * np.pi))
    ctr = np.stack([r * np.cos(phi), r * np.sin(phi)], axis=1)
    ctr -= ctr[0]  # start at origin
    return _finish_track(f"trackdrive-{seed}", ctr, True, cone_spacing, half_width)
