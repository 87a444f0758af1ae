"""The Slam orchestrator (counterpart of `tpuslam.core.slam`): the host-side
shell around the engine, with the engine's state on one device.

Mirrors the reference `Slam` class surface (reference src/slam.hpp:43-137):
`next_cone` / `next_pose` / `next_split_pose` / `next_yaw_rate` ingest plus
`draw_cones` / `draw_poses` / `draw_current_pose` / `draw_graph`
introspection. As in the JAX package, frames assemble on sample time (a
frame closes when a message's sample time passes the gathering window, or
on an explicit flush) and the keyframe gate reads sample time, so a replay
is reproducible.

The device is explicit: `Slam(cfg, device="cuda")` keeps the SLAM state and
the CTRV EKF (`cfg.use_ekf_fusion`) on the card, and raises if there is
none. The host keeps what the JAX package keeps on it: the float64
geodetic projection (`geometry.wgs84`), the odometry and the cone
collector. `process_frame` pads one frame on the host and moves it to the
device; `_publish` reads the send flag and, when it is set, the pose and
the cone rows back.
"""
from __future__ import annotations

import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from tpuslam_torch import compat
from tpuslam_torch.frontend import motion
from tpuslam_torch.frontend.keyframe import perform_keyframe
from tpuslam_torch.frontend.state import initial_state
from tpuslam_torch.geometry import wgs84
from tpuslam_torch.io import messages as M
from tpuslam_torch.runtime.config import SlamConfig

COLLECTOR_CAPACITY = 1000  # reference resets to 4x1000 (src/slam.cpp:244)


def checked_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device is available")
    return device


class Slam:
    def __init__(self, cfg: SlamConfig, publish: Optional[Callable] = None,
                 device="cuda"):
        self.cfg = cfg
        self.publish = publish
        self.device = checked_device(device)
        self.state = initial_state(cfg.capacity, self.device)
        self._gps_ref = np.array([cfg.ref_latitude, cfg.ref_longitude])

        # odometry state (reference m_odometryData, m_yawRate and timestamps)
        self._odometry = np.zeros(3)
        self._yaw_rate = 0.0
        self._yaw_received_us = 0
        self._geolocation_received_us = 0

        # cone collector (reference m_coneCollector / m_lastObjectId / m_newFrame)
        self._collector = np.zeros((4, COLLECTOR_CAPACITY))
        self._collector_seen = np.zeros(COLLECTOR_CAPACITY, dtype=bool)
        self._last_object_id = -1
        self._frame_open = False
        self._frame_start_us = 0
        self._last_cone_us = 0
        self._last_cone_wall = 0.0
        # odometry snapshot for the open frame: the reference samples
        # m_odometryData at the END of the gathering window (src/slam.cpp:
        # 304-307); in sample-time terms that is the latest odometry whose
        # sample time falls inside the window
        self._frame_pose = np.zeros(3)
        self._frame_yaw_rate = 0.0
        self._frame_yaw_us = 0
        self._keyframe_us: Optional[int] = None
        self.last_outputs = None
        self.keyframes_processed = 0

        # optional message-rate CTRV EKF (cfg.use_ekf_fusion), on the device
        self._ekf: Optional[motion.Ekf] = None
        self._ekf_us: Optional[int] = None

    # ------------------------------------------------------------ EKF fusion
    def _ekf_predict_to(self, sample_us: int):
        if self._ekf is None:
            self._ekf = motion.ekf_init(self._to_device(self._odometry))
            self._ekf_us = sample_us
            return
        dt = (sample_us - (self._ekf_us or sample_us)) / 1e6
        if 0.0 < dt < 1.0:
            self._ekf = motion.ekf_predict(self._ekf, dt)
        self._ekf_us = max(self._ekf_us or sample_us, sample_us)

    def _to_device(self, a) -> torch.Tensor:
        """A host array as a float32 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(self.device)

    # ------------------------------------------------------------ ingest API
    def _in_gathering_window(self, sample_us: int) -> bool:
        return self._frame_open and \
            sample_us <= self._frame_start_us + self.cfg.gathering_time_ms * 1000

    def _sync_frame_snapshot(self, sample_us: int):
        if self._in_gathering_window(sample_us):
            self._frame_pose[:] = self._odometry
            self._frame_yaw_rate = self._yaw_rate
            self._frame_yaw_us = self._yaw_received_us

    def next_pose(self, msg: M.Geolocation, sample_us: int):
        """Fused Geolocation odometry (reference src/slam.cpp:186-210)."""
        self._geolocation_received_us = sample_us
        xy = wgs84.to_cartesian(self._gps_ref, np.array([msg.latitude, msg.longitude]))
        self._odometry[:] = (xy[0], xy[1], msg.heading)
        if self.cfg.use_ekf_fusion:
            self._ekf_predict_to(sample_us)
            self._ekf = motion.ekf_update_position(self._ekf, self._to_device(xy),
                                                   std=self.cfg.gps_prior_std)
            self._ekf = motion.ekf_update_heading(self._ekf, msg.heading)
        self._sync_frame_snapshot(sample_us)

    def next_split_pose(self, msg, sample_us: int):
        """Split GPS / heading messages (reference src/slam.cpp:154-184)."""
        if isinstance(msg, M.GeodeticWgs84Reading):
            xy = wgs84.to_cartesian(self._gps_ref, np.array([msg.latitude, msg.longitude]))
            self._odometry[0], self._odometry[1] = xy[0], xy[1]
        elif isinstance(msg, M.GeodeticHeadingReading):
            h = msg.northHeading
            if self.cfg.reference_compat:
                h = float(compat.remap_north_heading(np.float64(h)))
            self._odometry[2] = h
        else:
            raise TypeError(f"unexpected split-pose message {type(msg)}")
        self._sync_frame_snapshot(sample_us)

    def next_yaw_rate(self, msg: M.AngularVelocityReading, sample_us: int):
        """IMU yaw rate, pre-scaled like the reference (src/slam.cpp:212-219)."""
        self._yaw_rate = msg.angularVelocityZ * self.cfg.yaw_rate_scale
        self._yaw_received_us = sample_us
        if self.cfg.use_ekf_fusion:
            self._ekf_predict_to(sample_us)
            # the EKF fuses the *raw* rate — the /4 scaling is a compat quirk
            self._ekf = motion.ekf_update_yaw_rate(self._ekf, msg.angularVelocityZ)
        self._sync_frame_snapshot(sample_us)

    def next_cone(self, msg, sample_us: int):
        """Interleaved ObjectDirection/Distance/Type accumulation
        (reference src/slam.cpp:67-152)."""
        if self._frame_open and \
                sample_us - self._frame_start_us > self.cfg.gathering_time_ms * 1000:
            self._close_frame()
        self._last_cone_us = sample_us
        self._last_cone_wall = _time.monotonic()
        if not self._frame_open:
            self._frame_open = True
            self._frame_start_us = sample_us
            self._frame_pose[:] = self._odometry
            self._frame_yaw_rate = self._yaw_rate
            self._frame_yaw_us = self._yaw_received_us
        oid = msg.objectId
        if oid >= COLLECTOR_CAPACITY:
            return
        self._last_object_id = max(self._last_object_id, oid)
        self._collector_seen[oid] = True
        if isinstance(msg, M.ObjectDirection):
            self._collector[0, oid] = msg.azimuthAngle
            self._collector[1, oid] = msg.zenithAngle
        elif isinstance(msg, M.ObjectDistance):
            self._collector[2, oid] = msg.distance
        elif isinstance(msg, M.ObjectType):
            self._collector[3, oid] = msg.type
        else:
            raise TypeError(f"unexpected cone message {type(msg)}")

    def flush(self):
        """Close any pending frame (end of stream / timer liveness)."""
        if self._frame_open:
            self._close_frame()

    def flush_if_idle(self, idle_s: float):
        """Close a pending frame only once no cone message has arrived for
        `idle_s` wall-clock seconds: the live-bus analogue of the
        reference's collector thread, which snapshots gatheringTimeMs AFTER
        the frame's first message (src/slam.cpp:227-241)."""
        if self._frame_open and \
                _time.monotonic() - self._last_cone_wall >= idle_s:
            self._close_frame()

    # ------------------------------------------------------ frame processing
    def _close_frame(self):
        n = self._last_object_id + 1
        obs = self._collector[:, :n].T.copy()  # [n, 4]
        self._collector[:, :max(n, 1)] = 0.0
        self._collector_seen[:max(n, 1)] = False
        self._last_object_id = -1
        self._frame_open = False
        if n > 0 and self._is_keyframe(self._last_cone_us):
            valid = np.ones(n, dtype=bool)
            self.process_frame(obs, valid, self._last_cone_us,
                               pose_override=self._frame_pose.copy(),
                               yaw_override=(self._frame_yaw_rate, self._frame_yaw_us))

    def _is_keyframe(self, now_us: int) -> bool:
        """Sample-time keyframe gate (reference src/slam.cpp:286-295)."""
        if self._keyframe_us is None or \
                abs(now_us - self._keyframe_us) / 1000.0 > self.cfg.time_between_keyframes_ms:
            self._keyframe_us = now_us
            return True
        return False

    def process_frame(self, obs: np.ndarray, valid: np.ndarray, sample_us: int,
                      pose_override=None, yaw_override=None):
        """Run one keyframe update on an assembled observation frame.

        obs [n, 4] rows of (azimuth_deg, zenith_deg, distance, type).
        Direct entry point for replays and simulations (bypasses the collector).
        """
        cfg = self.cfg
        n_max = cfg.max_obs_per_frame
        obs_pad = np.zeros((n_max, 4), dtype=np.float32)
        valid_pad = np.zeros(n_max, dtype=bool)
        n = min(len(obs), n_max)
        obs_pad[:n] = obs[:n]
        valid_pad[:n] = valid[:n]

        if cfg.use_ekf_fusion and self._ekf is not None:
            self._ekf_predict_to(sample_us)
            pose = self._ekf.x[:3].clone()
        else:
            pose = (self._odometry if pose_override is None else pose_override).copy()
            yaw_rate, yaw_us = ((self._yaw_rate, self._yaw_received_us)
                                if yaw_override is None else yaw_override)
            # yaw-rate heading correction (reference src/slam.cpp:309-317)
            dt = abs(yaw_us - sample_us) / 1e6
            if 0.0 < dt < 1.0:
                pose[2] -= yaw_rate * dt
            pose = self._to_device(pose)

        self.state, outputs = perform_keyframe(
            self.state, torch.from_numpy(obs_pad).to(self.device),
            torch.from_numpy(valid_pad).to(self.device), pose, cfg)
        self.last_outputs = outputs
        self.keyframes_processed += 1
        if self.publish is not None:
            self._publish(outputs)
        return outputs

    # ------------------------------------------------------------ publishing
    def _publish(self, outputs):
        if not bool(outputs.send):
            return
        sample = M.TimeStamp.from_micros(self._geolocation_received_us)
        pose = outputs.pose.cpu().numpy().astype(np.float64)
        latlon = wgs84.from_cartesian(self._gps_ref, pose[:2])
        # NOTE the reference swaps lon/lat into the outbound Geolocation
        # (src/slam.cpp:688-690); we publish correctly, as the JAX package
        geo = M.Geolocation(latitude=float(latlon[0]), longitude=float(latlon[1]),
                            heading=float(pose[2]))
        out = [(geo, sample, self.cfg.sender_id)]
        az = outputs.cone_azimuth.cpu().numpy()
        dist = outputs.cone_distance.cpu().numpy()
        ctype = outputs.cone_type.cpu().numpy()
        for i in range(self.cfg.cones_per_packet):
            out.append((M.ObjectDirection(objectId=i, azimuthAngle=float(az[i]),
                                          zenithAngle=0.0), sample, self.cfg.sender_id))
            out.append((M.ObjectDistance(objectId=i, distance=float(dist[i])),
                        sample, self.cfg.sender_id))
            out.append((M.ObjectType(objectId=i, type=int(ctype[i])),
                        sample, self.cfg.sender_id))
        for item in out:
            self.publish(*item)

    # ------------------------------------------------- introspection (viewer)
    def draw_cones(self):
        g = self.state.graph
        n = int(g.n_landmarks)
        return g.lm_xy[:n].cpu().numpy(), g.lm_type[:n].cpu().numpy()

    def draw_poses(self):
        g = self.state.graph
        return g.poses[: int(g.n_poses)].cpu().numpy()

    def draw_current_pose(self):
        if bool(self.state.loop_closure_complete) and self.last_outputs is not None:
            return self.last_outputs.pose.cpu().numpy()
        return self._odometry.copy()

    def draw_graph(self):
        """Pose->landmark connectivity (reference m_connectivityGraph)."""
        g = self.state.graph
        n = int(g.n_obs)
        return g.obs_pose[:n].cpu().numpy(), g.obs_lm[:n].cpu().numpy()

    # ------------------------------------------------------ checkpoint/resume
    def snapshot_host(self) -> dict:
        """Host-side ingest state for exact mid-run resume (the device state
        lives in `self.state` and is captured by runtime.checkpoint); the
        same dict as the JAX package's, so either package restores it."""
        snap = {
            "odometry": [float(v) for v in self._odometry],
            "yaw_rate": float(self._yaw_rate),
            "yaw_received_us": int(self._yaw_received_us),
            "geolocation_received_us": int(self._geolocation_received_us),
            "keyframe_us": (None if self._keyframe_us is None
                            else int(self._keyframe_us)),
            "keyframes_processed": int(self.keyframes_processed),
            # mid-gathering-window collector state (live ingest path)
            "frame_open": bool(self._frame_open),
            "frame_start_us": int(self._frame_start_us),
            "last_cone_us": int(self._last_cone_us),
            "last_object_id": int(self._last_object_id),
            "collector": self._collector.tolist(),
            "collector_seen": self._collector_seen.tolist(),
            "frame_pose": [float(v) for v in self._frame_pose],
            "frame_yaw_rate": float(self._frame_yaw_rate),
            "frame_yaw_us": int(self._frame_yaw_us),
        }
        if self._ekf is not None:
            snap["ekf"] = {"x": self._ekf.x.cpu().tolist(),
                           "p": self._ekf.p.cpu().tolist()}
            snap["ekf_us"] = int(self._ekf_us)
        return snap

    def restore_host(self, snap: dict):
        """Restore what `snapshot_host` captured; pair with assigning the
        checkpointed device state to `self.state`."""
        self._odometry[:] = snap["odometry"]
        self._yaw_rate = snap["yaw_rate"]
        self._yaw_received_us = snap["yaw_received_us"]
        self._geolocation_received_us = snap["geolocation_received_us"]
        self._keyframe_us = snap["keyframe_us"]
        self.keyframes_processed = snap["keyframes_processed"]
        if "frame_open" in snap:
            self._frame_open = snap["frame_open"]
            self._frame_start_us = snap["frame_start_us"]
            self._last_cone_us = snap["last_cone_us"]
            self._last_object_id = snap["last_object_id"]
            self._collector[:] = np.asarray(snap["collector"])
            self._collector_seen[:] = np.asarray(snap["collector_seen"])
            self._frame_pose[:] = snap["frame_pose"]
            self._frame_yaw_rate = snap["frame_yaw_rate"]
            self._frame_yaw_us = snap["frame_yaw_us"]
        if "ekf" in snap:
            self._ekf = motion.Ekf(x=self._to_device(snap["ekf"]["x"]),
                                   p=self._to_device(snap["ekf"]["p"]))
            self._ekf_us = snap["ekf_us"]

    # --------------------------------------------------------------- helpers
    @property
    def loop_closure_complete(self) -> bool:
        return bool(self.state.loop_closure_complete)

    def run_scenario(self, scenario):
        """Drive the engine from a simulated Scenario; returns the published
        trajectory [T, 3] (a host read per frame, as the JAX package's).

        Feeds odometry + frames in sample-time order, like a paced replay.
        """
        est = []
        for t in range(len(scenario.times)):
            us = int(scenario.times[t] * 1e6)
            self.next_pose(_geo_from_local(self._gps_ref, scenario.odom_poses[t]), us)
            self.next_yaw_rate(
                M.AngularVelocityReading(angularVelocityZ=float(scenario.yaw_rates[t])), us)
            out = self.process_frame(scenario.obs[t], scenario.obs_valid[t], us)
            est.append(out.pose.cpu().numpy())
        return np.stack(est)


def _geo_from_local(gps_ref, pose):
    latlon = wgs84.from_cartesian(gps_ref, np.asarray(pose[:2], dtype=np.float64))
    return M.Geolocation(latitude=float(latlon[0]), longitude=float(latlon[1]),
                         heading=float(pose[2]))
