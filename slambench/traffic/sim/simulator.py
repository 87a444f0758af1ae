"""Observation/odometry simulator: drives a Track, emits what the real car's
sensor stack would put on the bus. A frozen copy of
`tpuslam_torch.sim.simulator`, so that no change to the program can move the
benchmark's traffic; `slambench/tests/test_slambench_traffic.py` holds the
two equal at the cells' seeds.

Produces exactly the engine's ingest quantities (SURVEY.md §1 dataflow):
per-keyframe cone observation frames (azimuth_deg, zenith_deg, distance, type)
as seen from the *lidar* (mounted `lidar_to_cog` ahead of the CoG — the engine
undoes that lever arm, reference src/slam.cpp:513-523), noisy GPS/heading
odometry, and IMU yaw rate. Also supports input fault injection
(drop/duplicate/reorder) per SURVEY.md §5.3.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from slambench.traffic.sim.tracks import Track


@dataclass
class SimConfig:
    speed: float = 8.0               # m/s along the centerline
    keyframe_dt: float = 0.5         # s between frames (2 Hz — usecase value)
    laps: float = 1.1                # fraction of track length to drive
    fov_deg: float = 100.0           # detector field of view (half-angle*2)
    max_range: float = 18.0          # detector range
    obs_noise_range: float = 0.05    # m (1-sigma)
    obs_noise_az_deg: float = 0.3    # deg (1-sigma)
    gps_noise: float = 0.15          # m
    heading_noise: float = 0.02      # rad
    yaw_noise: float = 0.01          # rad/s
    detection_prob: float = 0.97
    lidar_to_cog: float = 1.5
    max_obs: int = 64
    # fault injection
    drop_frame_prob: float = 0.0
    dup_frame_prob: float = 0.0
    reorder_frame_prob: float = 0.0   # swap a frame with its successor (UDP
                                      # reordering; timestamps keep original
                                      # sample times, arrival order swaps)
    seed: int = 0


@dataclass
class Scenario:
    track: Track
    times: np.ndarray       # [T] seconds
    gt_poses: np.ndarray    # [T, 3] ground truth CoG poses
    odom_poses: np.ndarray  # [T, 3] noisy GPS xy + noisy heading
    yaw_rates: np.ndarray   # [T] true yaw rate + noise (rad/s, unscaled)
    obs: np.ndarray         # [T, N, 4] az_deg, zen_deg, dist, type (lidar frame)
    obs_valid: np.ndarray   # [T, N] bool
    meta: dict = field(default_factory=dict)


def simulate(track: Track, cfg: SimConfig = SimConfig()) -> Scenario:
    rng = np.random.default_rng(cfg.seed)
    total_s = track.length * cfg.laps
    n_frames = int(total_s / (cfg.speed * cfg.keyframe_dt))
    times = np.arange(n_frames) * cfg.keyframe_dt
    s = times * cfg.speed
    gt = track.pose_at(s)  # [T, 3]

    # yaw rate from heading finite differences
    dth = np.diff(gt[:, 2], append=gt[-1:, 2])
    dth = np.arctan2(np.sin(dth), np.cos(dth))
    yaw = dth / cfg.keyframe_dt
    yaw[-1] = yaw[-2] if n_frames > 1 else 0.0

    odom = gt.copy()
    odom[:, 0] += rng.normal(0, cfg.gps_noise, n_frames)
    odom[:, 1] += rng.normal(0, cfg.gps_noise, n_frames)
    odom[:, 2] += rng.normal(0, cfg.heading_noise, n_frames)
    yaw_noisy = yaw + rng.normal(0, cfg.yaw_noise, n_frames)

    obs = np.zeros((n_frames, cfg.max_obs, 4))
    valid = np.zeros((n_frames, cfg.max_obs), dtype=bool)
    half_fov = np.radians(cfg.fov_deg / 2)
    for t in range(n_frames):
        p = gt[t]
        c, si = np.cos(p[2]), np.sin(p[2])
        lidar = p[:2] + cfg.lidar_to_cog * np.array([c, si])
        d = track.cones_xy - lidar
        rng_d = np.linalg.norm(d, axis=1)
        az = np.arctan2(d[:, 1], d[:, 0]) - p[2]
        az = np.arctan2(np.sin(az), np.cos(az))
        vis = (rng_d < cfg.max_range) & (np.abs(az) < half_fov) & (rng_d > 0.5)
        vis &= rng.random(len(vis)) < cfg.detection_prob
        idx = np.flatnonzero(vis)[: cfg.max_obs]
        k = len(idx)
        if k:
            obs[t, :k, 0] = np.degrees(az[idx]) + rng.normal(0, cfg.obs_noise_az_deg, k)
            obs[t, :k, 1] = 0.0
            obs[t, :k, 2] = rng_d[idx] + rng.normal(0, cfg.obs_noise_range, k)
            obs[t, :k, 3] = track.cones_type[idx]
            valid[t, :k] = True

    # fault injection: dropped/duplicated/reordered frames
    keep = rng.random(n_frames) >= cfg.drop_frame_prob
    order = []
    for t in range(n_frames):
        if not keep[t]:
            continue
        order.append(t)
        if rng.random() < cfg.dup_frame_prob:
            order.append(t)
    if cfg.reorder_frame_prob > 0.0:
        i = 0
        while i + 1 < len(order):
            if rng.random() < cfg.reorder_frame_prob:
                order[i], order[i + 1] = order[i + 1], order[i]
                i += 2  # a swapped pair is final (single-hop reordering)
            else:
                i += 1
    order = np.asarray(order, dtype=int)
    return Scenario(track=track, times=times[order], gt_poses=gt[order],
                    odom_poses=odom[order], yaw_rates=yaw_noisy[order],
                    obs=obs[order], obs_valid=valid[order],
                    meta={"n_frames": len(order), "track": track.name})


def ate(estimated_xy: np.ndarray, gt_xy: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of position), the BASELINE metric."""
    d = estimated_xy - gt_xy
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
