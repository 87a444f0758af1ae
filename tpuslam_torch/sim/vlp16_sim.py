"""Synthetic VLP-16 scenes: ground + cone point clusters -> clouds/packets.
A copy of `tpuslam.sim.vlp16_sim` (numpy only), for the port's tests and
`chip_smoke.py`; `tests/test_torch_perception.py` holds the two equal.

Closes the loop for the raw-lidar eval config (BASELINE.json config 4): a
cone scene renders to a simulated VLP-16 sweep (or encoded packets), the
perception front-end re-detects the cones, and the detections feed the
normal SLAM ingest path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpuslam_torch.perception import vlp16

CONE_BASE_RADIUS = 0.114  # FSG small cone: 228 mm square base
CONE_HEIGHT = 0.325


@dataclass
class Vlp16SceneConfig:
    sensor_height: float = 0.9         # lidar above ground [m]
    ground_points: int = 1500
    points_per_cone: int = 40
    ground_extent: float = 14.0
    noise: float = 0.01
    intensity_type_scale: float = 10.0  # intensity = type * scale
    seed: int = 0
    # raycast-only: radius of a surrounding vertical wall (buildings/fences/
    # spectators at an outdoor event). 0 = open field — upward beams return
    # nothing and a rev carries ~half its rays. With a wall every beam
    # returns, reproducing the ~28.8k returns/rev of a real VLP-16 at 10 Hz
    # (1800 azimuth steps x 16 beams; usecase/VLP-16.xml beam pattern).
    surround_range: float = 0.0


def render_scene(cones_xy: np.ndarray, cones_type: np.ndarray,
                 cfg: Vlp16SceneConfig = Vlp16SceneConfig()):
    """Cones in the sensor xy frame -> (points [N,3], intensity [N]).

    z = 0 at the ground; the sensor sits at z = sensor_height, so points are
    returned in the sensor frame (z shifted down by sensor_height).
    """
    rng = np.random.default_rng(cfg.seed)
    pts = []
    inten = []

    g = rng.uniform([-2.0, -cfg.ground_extent / 2, 0],
                    [cfg.ground_extent, cfg.ground_extent / 2, 0],
                    (cfg.ground_points, 3))
    g[:, 2] = rng.normal(0, cfg.noise, cfg.ground_points)
    pts.append(g)
    inten.append(np.full(cfg.ground_points, 1.0))

    for (cx, cy), ct in zip(cones_xy, cones_type):
        k = cfg.points_per_cone
        h = rng.uniform(0.02, CONE_HEIGHT, k)
        r = CONE_BASE_RADIUS * (1.0 - h / CONE_HEIGHT) + 0.01
        phi = rng.uniform(0, 2 * np.pi, k)
        c = np.stack([cx + r * np.cos(phi), cy + r * np.sin(phi), h], axis=1)
        c += rng.normal(0, cfg.noise, c.shape)
        pts.append(c)
        inten.append(np.full(k, ct * cfg.intensity_type_scale))

    points = np.vstack(pts)
    points[:, 2] -= cfg.sensor_height  # into the sensor frame
    return points, np.concatenate(inten)


def raycast_range_image(cones_xy: np.ndarray, cfg: Vlp16SceneConfig,
                        step: float = 0.2, max_range: float = 60.0):
    """Analytic VLP-16 sweep: rays along the real beam pattern against the
    ground plane + cone cylinders. Unlike point-snapping, this preserves the
    physical constraint that every return lies ON its beam — exactly what a
    real sensor produces and what the decoders reconstruct.

    Returns a [n_az, 16] range image (0 = no return), azimuth step `step` deg.
    """
    rng = np.random.default_rng(cfg.seed)
    az = np.radians(np.arange(0.0, 360.0, step))              # [A]
    el = np.radians(vlp16.VLP16_ELEVATIONS_DEG)               # [16]
    ch = np.cos(el)[None, :]                                  # [1, 16]
    sz = np.sin(el)[None, :]
    ux = ch * np.cos(az)[:, None]                             # [A, 16]
    uy = -ch * np.sin(az)[:, None]
    h = cfg.sensor_height

    # ground plane z = -h (sensor at origin)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(sz < -1e-6, -h / sz, np.inf)
    t_ground = np.broadcast_to(t_ground, ux.shape).copy()
    t_ground[t_ground > max_range] = np.inf

    best = t_ground
    r_cone = CONE_BASE_RADIUS * 0.7   # effective cylinder radius
    for cx, cy in np.atleast_2d(cones_xy):
        b = ux * cx + uy * cy                                  # [A, 16]
        c0 = cx * cx + cy * cy - r_cone * r_cone
        disc = b * b - (ch * ch) * c0
        with np.errstate(invalid="ignore", divide="ignore"):
            t = np.where(disc > 0, (b - np.sqrt(np.maximum(disc, 0.0)))
                         / np.maximum(ch * ch, 1e-12), np.inf)
        z_hit = np.broadcast_to(sz, t.shape) * t
        hit = (t > 0.5) & (z_hit > -h - 0.02) & (z_hit < -h + CONE_HEIGHT)
        t = np.where(hit, t, np.inf)
        best = np.minimum(best, t)

    if cfg.surround_range > 0.0:
        # vertical cylinder wall at radius R: the ray's horizontal component
        # ch covers R at t = R / ch (tall wall: no z gate) — gives upward
        # beams a return like real surroundings do
        with np.errstate(divide="ignore"):
            t_wall = np.where(ch > 1e-6, cfg.surround_range / ch, np.inf)
        t_wall = np.broadcast_to(t_wall, best.shape)
        best = np.minimum(best, np.where(t_wall <= max_range, t_wall, np.inf))

    image = np.where(np.isinf(best), 0.0, best)
    image = np.where(image > 0, image + rng.normal(0, cfg.noise, image.shape), 0.0)
    return image, step


def scene_to_point_cloud_reading(cones_xy: np.ndarray,
                                 cfg: Vlp16SceneConfig = Vlp16SceneConfig()):
    """Cone scene -> opendlv.proxy.PointCloudReading via beam raycasting.

    Distances are big-endian uint16 counts at the 0.2 cm LSB of the usecase
    calibration (usecase/VLP-16.xml distLSB_=0.2), interleaved per azimuth
    step — the format tpuslam_torch.perception.vlp16.decode_point_cloud_reading
    consumes.
    """
    from tpuslam_torch.io import messages as M
    image, step = raycast_range_image(cones_xy, cfg)
    counts = np.clip(image / 0.002, 0, 0xFFFF).astype(">u2")
    return M.PointCloudReading(
        startAzimuth=0.0, endAzimuth=360.0 - step,
        entriesPerAzimuth=16, distances=counts.tobytes(),
        numberOfBitsForIntensity=0)


def scene_to_packets(points: np.ndarray, cfg: Vlp16SceneConfig = Vlp16SceneConfig()):
    """Quantize a scene onto the VLP-16 beam pattern and emit packets.

    Projects each point to (azimuth, nearest beam elevation, range) and fills
    per-(azimuth-step, beam) range images; azimuth step 0.2 deg.
    """
    az = np.degrees(np.arctan2(-points[:, 1], points[:, 0])) % 360.0
    rng_d = np.linalg.norm(points, axis=1)
    el = np.degrees(np.arcsin(np.clip(points[:, 2] / np.maximum(rng_d, 1e-9),
                                      -1, 1)))
    beam = np.argmin(np.abs(el[:, None] - vlp16.VLP16_ELEVATIONS_DEG[None, :]),
                     axis=1)
    step = 0.2
    col = (az / step).astype(int) % int(360 / step)
    n_cols = int(360 / step)
    image = np.zeros((n_cols, 16))
    for c, b, d in zip(col, beam, rng_d):
        if image[c, b] == 0 or d < image[c, b]:
            image[c, b] = d

    packets = []
    cols_per_packet = 24
    for c0 in range(0, n_cols, cols_per_packet):
        block = image[c0:c0 + cols_per_packet]
        if block.shape[0] < cols_per_packet:
            pad = np.zeros((cols_per_packet - block.shape[0], 16))
            block = np.vstack([block, pad])
        azs = ((c0 + np.arange(cols_per_packet)) * step) % 360.0
        packets.append(vlp16.encode_packet(
            np.repeat(azs[:, None], 16, axis=1), block))
    return packets
