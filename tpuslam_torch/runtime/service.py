"""Service shell (counterpart of `tpuslam.runtime.service`): wires the bus
(live OD4 or .rec replay) into the engine.

Equivalent of the reference's `main()` (reference
src/opendlv-logic-cfsd18-sensation-slam.cpp:49-119): route 7 message IDs to 4
handlers, filtered by senderStamp (`detectConeId` for cone messages,
`estimationId` for pose/yaw — reference :71-108), publish results back.
With an `AttentionConfig`, raw PointCloudReading messages go through the
port's cone detector on the engine's device and feed the engine directly.
The engine runs on `device` ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np
import torch

from tpuslam_torch.core.slam import Slam
from tpuslam_torch.geometry import wgs84
from tpuslam_torch.io import envelope as E
from tpuslam_torch.io import messages as M
from tpuslam_torch.io.rec import Player, RecWriter
from tpuslam_torch.perception.attention import detect_cones
from tpuslam_torch.perception.vlp16 import decode_point_cloud_reading
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.runtime.metrics import MetricsRegistry

CONE_TYPES = (M.ObjectDirection.ID, M.ObjectDistance.ID, M.ObjectType.ID)
POSE_TYPES = (M.Geolocation.ID,)
SPLIT_POSE_TYPES = (M.GeodeticWgs84Reading.ID, M.GeodeticHeadingReading.ID)
YAW_TYPES = (M.AngularVelocityReading.ID,)
POINT_CLOUD_TYPES = (49,)  # opendlv.proxy.PointCloudReading (odvd:160-166)


class SlamService:
    def __init__(self, cfg: SlamConfig, od4=None,
                 metrics: Optional[MetricsRegistry] = None,
                 attention_cfg=None, lidar_sender_id: Optional[int] = None,
                 device="cuda"):
        """`attention_cfg` (tpuslam_torch.perception.attention.AttentionConfig)
        enables the integrated lidar front-end: raw PointCloudReading
        messages run through the cone detector and feed the engine
        directly."""
        self.cfg = cfg
        self.od4 = od4
        self.metrics = metrics or MetricsRegistry()
        self.attention_cfg = attention_cfg
        self.lidar_sender_id = lidar_sender_id
        publish = None
        if od4 is not None:
            publish = lambda msg, ts, stamp: od4.send(msg, ts.micros, stamp)  # noqa: E731
        self.slam = Slam(cfg, publish=publish, device=device)

    # ------------------------------------------------------------- dispatch
    def dispatch_envelope(self, env: M.Envelope):
        """senderStamp-filtered routing (reference main :71-108)."""
        dt = env.dataType
        us = env.sampleTimeStamp.micros
        if dt in CONE_TYPES:
            if env.senderStamp != self.cfg.detect_cone_id:
                return
            self.slam.next_cone(E.unpack_message(env), us)
            self.metrics.inc("cone_messages")
        elif dt in POSE_TYPES:
            if env.senderStamp != self.cfg.estimation_id:
                return
            self.slam.next_pose(E.unpack_message(env), us)
            self.metrics.inc("pose_messages")
        elif dt in SPLIT_POSE_TYPES:
            if env.senderStamp != self.cfg.estimation_id:
                return
            self.slam.next_split_pose(E.unpack_message(env), us)
            self.metrics.inc("pose_messages")
        elif dt in YAW_TYPES:
            if env.senderStamp != self.cfg.estimation_id:
                return
            self.slam.next_yaw_rate(E.unpack_message(env), us)
            self.metrics.inc("yaw_messages")
        elif dt in POINT_CLOUD_TYPES and self.attention_cfg is not None:
            if self.lidar_sender_id is not None and \
                    env.senderStamp != self.lidar_sender_id:
                return
            self._process_point_cloud(E.unpack_message(env), us)
            self.metrics.inc("point_cloud_messages")

    def _process_point_cloud(self, msg, sample_us: int):
        """Integrated lidar front-end: PointCloudReading -> cone detection on
        the engine's device -> direct frame ingestion (bypassing the per-cone
        message hop the reference needed between its two microservices)."""
        points, _ = decode_point_cloud_reading(msg)
        acfg = self.attention_cfg
        cap = acfg.point_capacity
        if acfg.host_prefilter:
            # host-side ROI prefilter so a small device capacity holds the
            # relevant sector; with host_prefilter=False the FULL sweep goes
            # to the device and the grid clustering handles it — set
            # point_capacity >= the sweep size for that
            roi = ((np.abs(points[:, 1]) <= acfg.x_boundary)
                   & (points[:, 0] > 0.1) & (points[:, 0] <= acfg.y_boundary))
            points = points[roi]
        pts = np.zeros((cap, 3), dtype=np.float32)
        n = min(len(points), cap)
        pts[:n] = points[:n]
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        dev = self.slam.device
        cones, ok, _ = detect_cones(torch.from_numpy(pts).to(dev),
                                    torch.from_numpy(valid).to(dev), acfg)
        cones = cones[ok].cpu().numpy()
        if len(cones) and self.slam._is_keyframe(sample_us):
            self.slam.process_frame(cones, np.ones(len(cones), bool), sample_us)

    # --------------------------------------------------------------- replay
    def run_replay(self, rec_path: str, paced: bool = False, speedup: float = 1.0):
        """Replay a .rec recording through the engine (the reference ops
        path via cluon-replay)."""
        player = Player(rec_path)
        with self.metrics.timer("replay_total"):
            player.replay(self.dispatch_envelope, paced=paced, speedup=speedup)
            self.slam.flush()
        self.metrics.set("keyframes", self.slam.keyframes_processed)
        return self.slam

    # ----------------------------------------------------------------- live
    async def run_live(self):
        """Join the OD4 session and process until cancelled; a timer flushes
        pending cone frames for liveness (replaces the reference's detached
        busy-wait collector threads, src/slam.cpp:94-96, 227-233)."""
        if self.od4 is None:
            raise ValueError("run_live needs an OD4Session")
        types = CONE_TYPES + POSE_TYPES + SPLIT_POSE_TYPES + YAW_TYPES
        if self.attention_cfg is not None:
            types = types + POINT_CLOUD_TYPES
        for dt in types:
            self.od4.data_trigger(dt, self.dispatch_envelope)
        await self.od4.start()
        try:
            while True:
                await asyncio.sleep(self.cfg.gathering_time_ms / 1000.0)
                # idle-aware: only closes a frame once no cone message has
                # arrived for a full gathering window (a blind flush here
                # would split frames still streaming off the bus)
                self.slam.flush_if_idle(self.cfg.gathering_time_ms / 1000.0)
        except asyncio.CancelledError:
            pass
        finally:
            await self.od4.stop()


def scenario_to_rec(scenario, path: str, cfg: SlamConfig):
    """Serialize a simulated Scenario as a .rec the service can replay —
    the synthetic stand-in for real CFSD18 recordings."""
    ref = np.array(cfg.gps_reference)
    with RecWriter(path) as w:
        for t in range(len(scenario.times)):
            us = int(scenario.times[t] * 1e6)
            latlon = wgs84.from_cartesian(ref, scenario.odom_poses[t][:2])
            w.write_message(
                M.Geolocation(latitude=float(latlon[0]), longitude=float(latlon[1]),
                              heading=float(scenario.odom_poses[t][2])),
                sample_us=us, sender_stamp=cfg.estimation_id)
            w.write_message(
                M.AngularVelocityReading(angularVelocityZ=float(scenario.yaw_rates[t])),
                sample_us=us, sender_stamp=cfg.estimation_id)
            n = int(scenario.obs_valid[t].sum())
            for i in range(n):
                az, zen, dist, ct = scenario.obs[t, i]
                w.write_message(M.ObjectDirection(objectId=i, azimuthAngle=float(az),
                                                  zenithAngle=float(zen)),
                                sample_us=us, sender_stamp=cfg.detect_cone_id)
                w.write_message(M.ObjectDistance(objectId=i, distance=float(dist)),
                                sample_us=us, sender_stamp=cfg.detect_cone_id)
                w.write_message(M.ObjectType(objectId=i, type=int(ct)),
                                sample_us=us, sender_stamp=cfg.detect_cone_id)
