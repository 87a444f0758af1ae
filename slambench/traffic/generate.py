"""The one generator of the benchmark's traffic. A mix is a data file
(`slambench/traffic/<name>.json`) of parameters, and its `kind` names the
function here that turns it into the inputs of one run, the same for the
same seed.

Two kinds of mix:

- `sessions`: recorded sessions to replay, `sessions` laps of one circuit
  driven by the frozen simulator (`slambench/traffic/sim/`), each with its
  own noise seed drawn from the run's seed: cone observations [S, T, N, 4],
  their validity [S, T, N] and GPS/heading poses [S, T, 3], cut to the
  shortest session and to a multiple of `frame_multiple`, the sessions in an
  order shuffled by the seed.
- `session_graphs`: `fleets` fleets of `sessions` mapped sessions each, as
  a map server receives them: every session's factor graph (GPS/heading
  pose priors, odometry edges, one landmark per cone it saw, placed at the
  mean of its sightings, the observation edges of its first `map_laps` laps
  and each landmark's summed measurement information), all in one GPS
  datum.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from slambench.traffic.sim.simulator import SimConfig, simulate
from slambench.traffic.sim.tracks import acceleration, skidpad, trackdrive

HERE = Path(__file__).resolve().parent
TRACKS = {"trackdrive": trackdrive, "skidpad": skidpad, "acceleration": acceleration}
SIM_KEYS = ("speed", "keyframe_dt", "laps", "fov_deg", "max_range", "obs_noise_range",
            "obs_noise_az_deg", "gps_noise", "heading_noise", "yaw_noise", "detection_prob",
            "lidar_to_cog", "max_obs")


def load(name: str, root: Path | None = None) -> dict:
    """The mix `name` from `<root>/slambench/traffic/<name>.json`."""
    base = HERE if root is None else Path(root) / "slambench" / "traffic"
    return json.loads((base / f"{name}.json").read_text())


def session_seeds(seed: int, n: int, salt: int = 0) -> list[int]:
    """`n` noise seeds drawn from the run's seed (any non-negative integer)."""
    return [int(x) for x in np.random.SeedSequence([seed, salt]).generate_state(n)]


def track_of(mix: dict):
    kw = dict(mix.get("track_args", {}))
    if mix.get("track", "trackdrive") == "trackdrive":
        kw.setdefault("seed", mix.get("track_seed", 0))
    return TRACKS[mix.get("track", "trackdrive")](**kw)


def _scenarios(mix: dict, track, seeds):
    sim = {k: mix[k] for k in SIM_KEYS if k in mix}
    return [simulate(track, SimConfig(**sim, seed=s)) for s in seeds]


def _cut(mix: dict, scens) -> int:
    t = min(len(sc.times) for sc in scens)
    return t - t % mix.get("frame_multiple", 1)


def sessions(mix: dict, seed: int) -> dict:
    """A `sessions` mix: numpy obs [S, T, N, 4] f32, valid [S, T, N] bool,
    poses [S, T, 3] f32, and the session seeds."""
    seeds = session_seeds(seed, mix["sessions"])
    scens = _scenarios(mix, track_of(mix), seeds)
    t = _cut(mix, scens)
    order = np.random.default_rng(np.random.SeedSequence([seed, 1])).permutation(len(seeds))
    return dict(obs=np.stack([scens[i].obs[:t] for i in order]).astype(np.float32),
                valid=np.stack([scens[i].obs_valid[:t] for i in order]),
                poses=np.stack([scens[i].odom_poses[:t] for i in order]).astype(np.float32),
                seeds=[seeds[i] for i in order])


def _glob(pose, az_deg, dist, lever):
    """Standard-constant lidar (deg, m) -> body (x, y) -> global (x, y)."""
    a = np.radians(az_deg)
    lx, ly = dist * np.cos(a) + lever, dist * np.sin(a)
    c, s = np.cos(pose[..., 2]), np.sin(pose[..., 2])
    body = np.stack([lx, ly], -1)
    return body, np.stack([lx * c - ly * s + pose[..., 0], lx * s + ly * c + pose[..., 1]], -1)


def _information(glob, pose, sig_r, sig_az_deg):
    """Packed (a, b, c) 2x2 information of one sighting in the global
    frame: range noise along the ray, bearing noise across it."""
    d = glob - pose[..., :2]
    rng = np.maximum(np.linalg.norm(d, axis=-1), 1e-3)
    ux, uy = d[..., 0] / rng, d[..., 1] / rng
    sig_t = np.maximum(rng * np.radians(sig_az_deg), 1e-2)
    ir, it = 1.0 / sig_r ** 2, 1.0 / sig_t ** 2
    return np.stack([ir * ux * ux + it * uy * uy, (ir - it) * ux * uy,
                     ir * uy * uy + it * ux * ux], -1)


def _between(a, b):
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    th = math.pi - np.mod(math.pi - (b[..., 2] - a[..., 2]), 2 * math.pi)
    return np.stack([c * dx + s * dy, -s * dx + c * dy, th], -1)


def _session_graph(mix: dict, track, scen, t: int, cap) -> dict:
    """One mapped session's graph, at the capacities `cap` (P, L, E)."""
    cp, cl, ce = cap
    poses = scen.odom_poses[:t]
    lever = mix.get("lidar_to_cog", 1.5)
    map_frames = min(t, int(math.ceil(mix.get("map_laps", 1.0) * track.length
                                      / (mix["speed"] * mix["keyframe_dt"]))))
    lm_of_cone, sums, counts, info, lm_type = {}, [], [], [], []
    e_pose, e_lm, e_xy = [], [], []
    for k in range(map_frames):
        v = scen.obs_valid[k]
        body, glob = _glob(poses[k], scen.obs[k, v, 0], scen.obs[k, v, 2], lever)
        _, glob_true = _glob(scen.gt_poses[k], scen.obs[k, v, 0], scen.obs[k, v, 2], lever)
        cone = np.argmin(np.linalg.norm(glob_true[:, None] - track.cones_xy[None], axis=-1), 1)
        inf = _information(glob, poses[k], mix.get("obs_noise_std", 0.3),
                           mix.get("obs_noise_az_deg", 0.3))
        for i, c in enumerate(cone):
            if c not in lm_of_cone:
                lm_of_cone[c] = len(sums)
                sums.append(np.zeros(2))
                counts.append(0)
                info.append(np.zeros(3))
                lm_type.append(int(track.cones_type[c]))
            j = lm_of_cone[c]
            sums[j] += glob[i]
            counts[j] += 1
            info[j] += inf[i]
            e_pose.append(k)
            e_lm.append(j)
            e_xy.append(body[i])
    n_l, n_e = len(sums), len(e_pose)
    if t > cp or n_l > cl or n_e > ce:
        raise ValueError(f"session graph ({t}, {n_l}, {n_e}) over its capacity {cap}")
    g = dict(poses=np.zeros((cp, 3)), n_poses=t, odo_meas=np.zeros((cp, 3)),
             odo_w=np.ones(cp), lm_xy=np.zeros((cl, 2)), lm_type=np.zeros(cl, np.int32),
             n_landmarks=n_l, obs_pose=np.zeros(ce, np.int32), obs_lm=np.zeros(ce, np.int32),
             obs_xy=np.zeros((ce, 2)), n_obs=n_e, prior_pose=np.zeros((cp, 3)),
             prior_info=np.zeros((cp, 2)), lm_info=np.zeros((cl, 3)))
    g["poses"][:t] = poses
    g["odo_meas"][1:t] = _between(poses[:-1], poses[1:])
    g["prior_pose"][:t] = poses
    g["prior_info"][:t] = (1.0 / mix["gps_prior_std"] ** 2, 1.0 / mix["heading_prior_std"] ** 2)
    g["lm_xy"][:n_l] = np.array(sums) / np.array(counts)[:, None]
    g["lm_type"][:n_l] = lm_type
    g["lm_info"][:n_l] = np.array(info)
    g["obs_pose"][:n_e], g["obs_lm"][:n_e], g["obs_xy"][:n_e] = e_pose, e_lm, e_xy
    return g


def session_graphs(mix: dict, seed: int, cap) -> list[dict]:
    """A `session_graphs` mix: `fleets` lists of `sessions` graphs (numpy,
    the program's FactorGraph fields plus `lm_info`), float32."""
    track = track_of(mix)
    fleets = []
    for f in range(mix["fleets"]):
        seeds = session_seeds(seed, mix["sessions"], salt=1 + f)
        scens = _scenarios(mix, track, seeds)
        t = _cut(mix, scens)
        graphs = [_session_graph(mix, track, sc, t, cap) for sc in scens]
        fleets.append([{k: (v.astype(np.float32) if isinstance(v, np.ndarray)
                            and v.dtype == np.float64 else v) for k, v in g.items()}
                       for g in graphs])
    return fleets
