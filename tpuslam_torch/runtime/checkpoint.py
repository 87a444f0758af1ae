"""Checkpoint / resume for the SLAM state (counterpart of
`tpuslam.runtime.checkpoint`).

The full engine state (graph arrays, counters, mode flags, config
fingerprint) serializes to a single .npz in the JAX package's format
(`FORMAT_VERSION = 1`): the same array names and dtypes (int32 counters,
bool flags, float32 values), so a checkpoint written by either package
loads in the other (`tests/test_torch_service.py`). A restart restores the
device state and rejoins mid-run; the host-side ingest state travels in the
metadata (`Slam.snapshot_host`).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpuslam_torch.backend.graph import FactorGraph, GraphCapacity
from tpuslam_torch.core.slam import checked_device
from tpuslam_torch.frontend.state import SlamState

FORMAT_VERSION = 1

__all__ = ["save_checkpoint", "load_checkpoint"]


def _config_fingerprint(cfg) -> str:
    return json.dumps({k: v for k, v in dataclasses.asdict(cfg).items()
                       if not isinstance(v, dict)}, sort_keys=True, default=str)


def save_checkpoint(path: str, state: SlamState, cfg, extra: dict | None = None):
    g = state.graph

    def host(x):
        return x.cpu().numpy()

    arrays = {
        "poses": host(g.poses), "n_poses": host(g.n_poses),
        "odo_meas": host(g.odo_meas),
        "odo_w": host(g.odo_w),
        "lm_xy": host(g.lm_xy), "lm_type": host(g.lm_type),
        "n_landmarks": host(g.n_landmarks),
        "obs_pose": host(g.obs_pose), "obs_lm": host(g.obs_lm),
        "obs_xy": host(g.obs_xy), "n_obs": host(g.n_obs),
        "prior_pose": host(g.prior_pose),
        "prior_info": host(g.prior_info),
        "current_cone_index": host(state.current_cone_index),
        "loop_closing": host(state.loop_closing),
        "loop_closure_complete": host(state.loop_closure_complete),
        "keyframe_count": host(state.keyframe_count),
        "send_cone_data": host(state.send_cone_data),
        "lm_info_xy": host(state.lm_info_xy),
        "format_version": np.asarray(FORMAT_VERSION),
    }
    meta = {"config": _config_fingerprint(cfg)}
    if extra:
        meta.update(extra)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, cfg=None, device="cuda"):
    """Returns (SlamState on `device`, meta dict). Raises on capacity
    mismatch with cfg, and for a CUDA device without a card."""
    device = checked_device(device)
    z = np.load(path)
    if int(z["format_version"]) != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {z['format_version']}")
    meta = json.loads(bytes(z["meta_json"]).decode())

    def dev(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    g = FactorGraph(
        poses=dev(z["poses"]), n_poses=dev(z["n_poses"]),
        odo_meas=dev(z["odo_meas"]),
        # absent in format-1 checkpoints from before fusion: uniform chain
        odo_w=(dev(z["odo_w"]) if "odo_w" in z.files
               else dev(np.ones((z["poses"].shape[0],), np.float32))),
        lm_xy=dev(z["lm_xy"]), lm_type=dev(z["lm_type"]),
        n_landmarks=dev(z["n_landmarks"]),
        obs_pose=dev(z["obs_pose"]), obs_lm=dev(z["obs_lm"]),
        obs_xy=dev(z["obs_xy"]), n_obs=dev(z["n_obs"]),
        prior_pose=dev(z["prior_pose"]),
        prior_info=dev(z["prior_info"]),
    )
    if cfg is not None:
        cap = cfg.capacity
        want = GraphCapacity(g.poses.shape[0], g.lm_xy.shape[0], g.obs_pose.shape[0])
        if (cap.max_poses, cap.max_landmarks, cap.max_obs) != \
                (want.max_poses, want.max_landmarks, want.max_obs):
            raise ValueError(f"checkpoint capacity {want} != config {cap}")
    state = SlamState(
        graph=g,
        current_cone_index=dev(z["current_cone_index"]),
        loop_closing=dev(z["loop_closing"]),
        loop_closure_complete=dev(z["loop_closure_complete"]),
        keyframe_count=dev(z["keyframe_count"]),
        send_cone_data=dev(z["send_cone_data"]),
        lm_info_xy=(dev(z["lm_info_xy"]) if "lm_info_xy" in z.files
                    else dev(np.zeros((z["lm_xy"].shape[0], 3), np.float32))),
    )
    return state, meta
