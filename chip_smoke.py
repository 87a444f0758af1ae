#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tpuslam_torch`) once on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --assoc-plans    # phase 1, then the association
                                           # kernel's cluster sizes timed
                                           # (ASSOC_PLANS) and its wrapper's
                                           # host cost by piece

Phases, in order; the first that fails ends the run with exit code 1:
  1. build   — compile both CUDA kernels with nvcc (sm_90a), in parallel;
  2. kernels — each kernel against its plain PyTorch twin on the card: the
               association kernel bit-equal at ASSOC_CHECKS (the lap, both
               blocked and the pod shapes, ragged sizes, ties) and in its
               masked form;
  3. compat  — the per-frame engine (`run_pass`) in the reference-compat
               configuration ('first' association, plain PyTorch) on the
               trackdrive bench scenario, held to the JAX package's numbers;
  4. kernel association — the same lap with association='nearest' through
               the association kernel, held to the JAX package's numbers
               and to a CPU run of the port;
  blocked  — the blocked pipeline (`run_pass_blocked`, block 32: bench.py's
               path) on the same lap in both configurations, held to the
               per-frame runs of phases 3 and 4 and to the JAX package's
               numbers, every frame done by the blocks, and the association
               kernel launched once per block at 512 x 256;
  improved — the improved mode (`SlamConfig.improved`) on the same lap:
               I1 (nearest, dense) per frame and blocked at blocks 16 and
               32, I2 (Mahalanobis through the association kernel) per
               frame and at block 16, each held to the JAX package's numbers
               for its path and block and to the port's CPU run of it, and
               the kernel's Mahalanobis form launched once per keyframe per
               frame and once per block, at 256 x 256, blocked;
  batched  — bench.py's batched-sessions scenario (16 sessions, block 32)
               through `run_sequences_blocked_batched` in both
               configurations: every session held to its own single-session
               blocked run on the card and to BATCHED_REFERENCE, every frame
               done by the blocks, one association launch per block for all
               sessions at 16 x 512 x 256; then the closure GN of the 16
               closed graphs through the Cholesky kernel, one launch per
               iteration for all sessions, each factor held to float64;
  fusion   — bench.py's fusion section (8 improved-mode sessions with
               Mahalanobis gating and the periodic GN, `blocked_core_batched`
               at block 16; `fuse_sessions(align=False)` with the n = 9216
               joint GN; the drifted variant through
               `run_sequences_blocked_batched` and `fuse_sessions(align=True,
               robust=True)`), dense as bench.py has it and through the
               association kernel: each held to FUSION_REFERENCE and every
               session of the batched pass to its own single-session blocked
               run; with the kernel, one launch per block for all sessions at
               8 x 512 x 256 and, drifted, at 8 x 256 x 256;
  5. closure solve — `gauss_newton.optimize` on the graph the closure GN
               solves, through the Cholesky kernel and through
               `torch.linalg.cholesky_ex`, and the kernel's factor of the
               solve's ill-conditioned matrix held to a float64 factor;
  6. timing  — frames/s of the per-frame and blocked laps (compat,
               'nearest' and the improved mode), their kernel launches and
               device-to-host reads per keyframe and device-busy share; one
               periodic window-GN firing alone; each kernel's time per wrapper call beside its
               twin's and the library call's (CUDA events, in turns), its
               device time per launch (torch.profiler) and its bound from
               this run's shapes, the association kernel at each of
               ASSOC_SHAPES; batched compat passes at BATCHED_SWEEP sessions
               beside the 16 single-session laps run one after another, and
               both kernels at the batched shapes; the fusion section's
               batched improved pass, its fusions and joint GN alone, and the
               association kernel at the fusion shapes.
It prints a `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Without a
CUDA device it fails before any phase. It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from tpuslam_torch import _build
from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import blocked as blocked_mod
from tpuslam_torch.frontend import keyframe as keyframe_mod
from tpuslam_torch.frontend.blocked import (
    blocked_core_batched, run_pass_blocked, run_sequence_blocked, run_sequences_blocked_batched,
)
from tpuslam_torch.frontend.keyframe import _gate_cost, _gn_config, periodic_gn
from tpuslam_torch.frontend.pipeline import run_pass, run_sequence
from tpuslam_torch.frontend.state import initial_state, session_state
from tpuslam_torch.parallel.batch import initial_states
from tpuslam_torch.parallel.fusion import fuse_sessions, fusion_report
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.geometry.spherical import cone_to_global
from tpuslam_torch.sim import SimConfig, ate, simulate, trackdrive

# The bench scenario (bench.py:34-38) and capacity (bench.py:152-153).
SIM = dict(laps=1.4, keyframe_dt=0.1, speed=8.0, max_range=20.0, seed=12)
CAP = GraphCapacity(512, 256, 8192)
CLOSURE_FRAME = 212         # the graph after frame CLOSURE_FRAME - 1 is the one the closure GN solves
CLOSURE_N = 768             # 3 x the 256-pose bucket covering it
BLOCK = 32                  # bench.py's block (bench.py:167-169)

# The JAX package's results on this scenario, computed on the CPU with
# tpuslam.frontend.pipeline.run_sequence; tests/test_torch_pipeline.py
# recomputes them with JAX and holds these constants to them.
REFERENCE = {
    "first": dict(closure_frame=212, n_landmarks=112, n_obs=1974, sends=113,
                  current_cone_index=45, ate_published=0.210073,
                  ate_graph=0.403144, map_err_median=0.386530),
    "nearest": dict(closure_frame=212, n_landmarks=112, n_obs=1974, sends=113,
                    current_cone_index=45, ate_published=0.210073,
                    ate_graph=0.290211, map_err_median=0.278863),
    # the improved mode, each path held to the JAX package's same path and
    # block (its per-frame, blocked and kernel paths differ by design);
    # tests/test_torch_improved.py recomputes these
    "I1": dict(closure_frame=212, n_landmarks=110, n_obs=1974, sends=113,
               current_cone_index=44, ate_published=0.110485,
               ate_graph=0.139777, map_err_median=0.024462),
    "I1_b16": dict(closure_frame=212, n_landmarks=110, n_obs=1974, sends=113,
                   current_cone_index=44, ate_published=0.110485,
                   ate_graph=0.139777, map_err_median=0.024462),
    "I1_b32": dict(closure_frame=212, n_landmarks=110, n_obs=1974, sends=113,
                   current_cone_index=44, ate_published=0.101905,
                   ate_graph=0.140121, map_err_median=0.025022),
    "I2": dict(closure_frame=212, n_landmarks=142, n_obs=1974, sends=113,
               current_cone_index=57, ate_published=0.113266,
               ate_graph=0.141591, map_err_median=0.031187),
    "I2_b16": dict(closure_frame=212, n_landmarks=115, n_obs=1974, sends=113,
                   current_cone_index=46, ate_published=0.110796,
                   ate_graph=0.139851, map_err_median=0.024268),
}
METRIC_ATOL_M = 1e-3        # ATE / map-error tolerance against the JAX numbers
# The improved mode (tpuslam/runtime/config.py:145-170) as bench.py reports
# it: I1 with 'nearest' association, dense (bench.py:177-198, :834-882); I2
# with Mahalanobis gating through the association kernel
IMPROVED = {"I1": {}, "I2": dict(association="mahalanobis", use_pallas_association=True)}
# run (a key of REFERENCE) -> (configuration, block or None for per frame):
# block 16 is bench.py:848's primary row, block 32 fires the periodic GN
# mid-block (every 16)
IMPROVED_RUNS = {"I1": ("I1", None), "I1_b16": ("I1", 16), "I1_b32": ("I1", 32),
                 "I2": ("I2", None), "I2_b16": ("I2", 16)}
# the JAX package's own contract between two paths whose gate decisions may
# differ (tests/test_blocked_equivalence.py:192-208): landmarks within 2, and
# published poses within 0.05 m. It holds a GPU run whose gate decision
# flipped against the CPU run (the GN's CUDA sums are atomics, and the
# periodic GN feeds the map later frames are gated against)
CROSS_PATH_LANDMARKS, CROSS_PATH_POSE_M = 2, 0.05
IMPROVED_TIMED = ("I1", "I1_b16", "I1_b32", "I2_b16")   # the improved laps timed
FIRING_FRAME = 208          # frames before a periodic firing (keyframe 208 = 13 x 16)
POSE_ATOL = 1e-3            # GPU vs CPU port, and kernel vs library GN solve
CHOL_ATOL, CHOL_RTOL, CHOL_RECON_ATOL = 5e-4, 1e-3, 5e-3
LAPS_TIMED = 3              # a lap's rate is the median of this many laps (host-bound, noisy)
PROFILE_TRIES = 3           # profiled windows of one kernel before a short count fails
# H100 SXM peaks for the bound (NVIDIA's data sheet, at 700 W): FP32 outside
# the tensor cores, and HBM3
PEAK_FP32_FLOP_S, PEAK_HBM_BYTE_S = 67e12, 3.35e12
# (N observations, M landmarks) of the association kernel: the per-frame lap
# (the observation and landmark capacities); the blocked pipeline's launch,
# block 32 x the compaction width (tpuslam/frontend/blocked.py:1207-1227),
# which is 16 on the bench lap (at most 12 valid observations per frame) and
# 64 on denser streams; and the pod-scale map the TPU kernel was built for
# (scripts/exp_block_provider.py:104-110)
ASSOC_SHAPES = {"lap": (64, 256), "blocked16": (512, 256), "blocked64": (2048, 256),
                "blocked16_b16": (256, 256), "pod": (512, 4096)}
# the cluster sizes `--assoc-plans` times at each shape
ASSOC_PLANS = (1, 2, 4, 8)
# bench.py's batched-sessions scenario (bench.py:296-330): 16 laps of the
# bench track, session s with noise seed 20 + s, cut to the shortest (and to
# the bench lap's length); capacity GraphCapacity(max(384, t_b), 256, 4096)
BATCHED_SESSIONS, BATCHED_SEED0, BATCHED_POSES = 16, 20, 384
BATCHED_CAP_LM, BATCHED_CAP_OBS = 256, 4096
BATCHED_ATOL = 2e-3         # values of a batched session vs its own single run
# (tests/test_blocked_equivalence.py:276-283: the batched GN is full-capacity)
# The JAX package's `run_sequences_blocked_batched` on this scenario at block
# 32, the same in both configurations; computed on the CPU, and recomputed by
# tests/test_torch_batched_reference.py
BATCHED_REFERENCE = dict(
    closure_frame=[212] * 16,
    n_landmarks=[115, 117, 115, 115, 116, 113, 120, 111, 110, 110, 119, 124, 115, 111, 107, 119],
    n_obs=[1960, 1968, 1957, 1957, 1968, 1968, 1976, 1979, 1955, 1977, 1969, 1967, 1956, 1966,
           1963, 1968])
BATCHED_SWEEP = (1, 4, 16, 64)  # sessions per timed pass; 64 tiles the 16 (as bench.py does)
BATCHED_LAPS_TIMED = 3
# (S, N, M) of the association kernel on the batched path: 16 sessions of
# block 32 x width 16 against 256 landmarks, one launch per block
ASSOC_BATCHED = {"batched16": (16, 512, 256)}
# (S, N, M, seed, ties) at which phase 2 and tests/test_torch_cuda.py hold the
# batched association kernel to its twin, plain and masked: the path's shape,
# ragged sizes over several chunks and cluster ranks, and ties
ASSOC_BATCHED_CHECKS = [(16, 512, 256, 0, False), (3, 61, 2000, 5, False),
                        (16, 512, 256, 3, True), (3, 61, 2000, 4, True),
                        (8, 512, 256, 0, False), (8, 512, 256, 3, True),
                        (8, 256, 256, 0, False), (8, 256, 256, 3, True)]
# bench.py's fusion section (bench.py:663-800, the JAX package's BASELINE
# config 5 on one chip): 8 laps of the bench track, session s with noise
# seed 60 + s, cut to the shortest and to a multiple of the block; capacity
# GraphCapacity(max(384, t_f), 256, 4096); the improved mode with
# Mahalanobis gating, the periodic GN every 16, through
# `blocked_core_batched` at block 16 with its compaction width of 32; then
# `fuse_sessions(align=False)` and the joint GN. The drifted variant moves
# each session but the first rigidly (offsets from seed 7) and runs
# `run_sequences_blocked_batched` (compaction width 16), then
# `fuse_sessions(align=True, robust=True)` at twice the gate. Nothing is cut.
FUSION_SESSIONS, FUSION_SEED0, FUSION_BLOCK, FUSION_DRIFT_SEED = 8, 60, 16, 7
FUSION_POSES, FUSION_CAP_LM, FUSION_CAP_OBS = 384, 256, 4096
# bench.py's dense configuration, and the same with the association kernel
FUSION_CONFIGS = {"dense": {}, "kernel": dict(use_pallas_association=True)}
# The JAX package's run of that flow on the CPU, the same in both
# configurations; tests/test_torch_fusion_reference.py recomputes it with
# JAX and the port (the map errors, which need the n = 9216 joint GN, in
# its `slow` half)
FUSION_REFERENCE = dict(
    closure_frame=[212] * 8,
    n_landmarks=[126, 115, 117, 117, 118, 107, 110, 116],
    n_obs=[1952, 1976, 1958, 1967, 1973, 1966, 1963, 1954],
    fused_landmarks=93, cross_session_merges=93, map_error_fused_m=0.011457,
    drifted=dict(closure_frame=[212, 213, 216, 212, 212, 218, 215, 218],
                 n_landmarks=[126, 144, 127, 124, 117, 131, 123, 148],
                 n_obs=[1952, 1988, 2001, 1967, 1973, 2032, 1995, 2022]),
    fused_landmarks_drifted=93, cross_session_merges_drifted=93,
    map_error_fused_drifted_m=0.020163)
# (S, N, M) of the association kernel on the fusion path: 8 sessions of
# block 16 x width 32 (the direct `blocked_core_batched` call) and x width 16
# (the drifted variant, through `_pick_compact`) against 256 landmarks
ASSOC_FUSION = {"fusion": (8, 512, 256), "fusion_drifted": (8, 256, 256)}
# (S, n) at which the batched Cholesky kernel is held to its twin and to
# single launches: the path's [16, 1152, 1152] among them
CHOL_BATCHED_CHECKS = [(s, n) for s in (1, 3, 16) for n in (1, 33, 768, 1152)]


def configs():
    return {"first": SlamConfig(capacity=CAP),
            "nearest": SlamConfig(capacity=CAP, association="nearest",
                                  use_pallas_association=True)}


def improved_configs():
    return {name: SlamConfig.improved(capacity=CAP, **kw) for name, kw in IMPROVED.items()}


def scenario():
    track = trackdrive(seed=11)
    return track, simulate(track, SimConfig(**SIM))


def lap_metrics(track, scen, state, outs) -> dict:
    """The discrete outcome of a lap and its three error metrics."""
    t = len(scen.times)
    g = state.graph
    n_lm = int(g.n_landmarks)
    lm = g.lm_xy[:n_lm].cpu().numpy()
    closes = np.flatnonzero(outs.loop_closed.cpu().numpy())
    return dict(
        closure_frame=int(closes[0]) if len(closes) else -1,
        n_landmarks=n_lm, n_obs=int(g.n_obs), sends=int(outs.send.sum()),
        current_cone_index=int(state.current_cone_index),
        ate_published=ate(outs.pose.cpu().numpy()[:, :2], scen.gt_poses[:t, :2]),
        ate_graph=ate(g.poses[:t, :2].cpu().numpy(), scen.gt_poses[:t, :2]),
        map_err_median=float(np.median(np.linalg.norm(
            lm[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1))),
    )


def improved_lap(cfg, block, obs, valid, poses):
    """One lap of the improved mode: per frame when `block` is None."""
    if block is None:
        return run_pass(obs, valid, poses, cfg)
    return run_pass_blocked(obs, valid, poses, cfg, block=block)


def gate_margin(scen, cfg, frame) -> float:
    """How close to the gate the association of `frame` was: the smallest
    |cost - gate| / gate over its valid observations and the landmarks of
    their type, against the map of the port's CPU per-frame run before it."""
    obs, valid, poses = inputs(scen, "cpu")
    st, _ = run_sequence(initial_state(CAP, "cpu"), obs[:frame], valid[:frame], poses[:frame],
                         cfg)
    g = st.graph
    glob = cone_to_global(poses[frame], obs[frame, :, 0], obs[frame, :, 1], obs[frame, :, 2],
                          cfg.lidar_to_cog, cfg.reference_compat)
    diff = glob[:, None, :] - g.lm_xy[None, :, :]
    cost, gate = _gate_cost(diff, torch.sum(diff * diff, dim=-1), st.lm_info_xy, cfg)
    ok = (valid[frame][:, None] & g.lm_valid[None, :]
          & (g.lm_type[None, :] == obs[frame, :, 3].to(torch.int32)[:, None]))
    return float(((cost - gate).abs() / gate)[ok].min()) if bool(ok.any()) else float("inf")


def check_metrics(name: str, got: dict) -> None:
    want = REFERENCE[name]
    for k, v in want.items():
        if isinstance(v, int):
            ok = got[k] == v
        else:
            ok = abs(got[k] - v) <= METRIC_ATOL_M
        if not ok:
            raise AssertionError(f"{name}: {k} = {got[k]}, JAX package {v}")


def inputs(scen, device):
    return (torch.tensor(scen.obs, dtype=torch.float32, device=device),
            torch.tensor(scen.obs_valid, device=device),
            torch.tensor(scen.odom_poses, dtype=torch.float32, device=device))


def assoc_world(n, m, seed, device="cuda", ties=False):
    """Inputs made as tests/test_pallas_kernels.py makes them, with random
    SPD inverse covariances packed (a, b, c). With `ties`, half the
    landmarks (xy, type and covariance) are copied to the indices of the
    other half, paired at random so that a pair's two indices fall in
    different chunks and cluster ranks, and the first half of the
    observations lie near copied landmarks: each of those sees two landmarks
    at exactly the same cost."""
    rng = np.random.default_rng(seed)
    lm_xy = rng.uniform(-50, 50, (m, 2)).astype(np.float32)
    lm_type = rng.integers(1, 5, m).astype(np.int32)
    pick = rng.integers(0, m, n // 2)
    obs_a = lm_xy[pick] + rng.normal(0, 0.3, (n // 2, 2))
    obs_b = rng.uniform(-60, 60, (n - n // 2, 2))
    obs_xy = np.vstack([obs_a, obs_b]).astype(np.float32)
    obs_type = np.concatenate([lm_type[pick], rng.integers(1, 5, n - n // 2)]).astype(np.int32)
    sig = rng.uniform(0.2, 0.6, m)
    rho = rng.uniform(-0.3, 0.3, m)
    a = 1.0 / sig ** 2
    cov = np.stack([a, rho * a, a * (1 + rho ** 2)], axis=1).astype(np.float32)
    if ties:
        src, dst = tie_pairs(m, seed)
        for x in (lm_xy, lm_type, cov):
            x[dst] = x[src]
        k = min(n // 2, len(src))
        near = np.random.default_rng(seed + 1).normal(0, 0.3, (k, 2))
        obs_xy[:k] = (lm_xy[src[:k]] + near).astype(np.float32)
        obs_type[:k] = lm_type[src[:k]]
    return [torch.tensor(x, device=device) for x in (obs_xy, obs_type, lm_xy, lm_type, cov)]


def tie_pairs(m, seed):
    """(src, dst): the landmark indices `assoc_world(..., ties=True)` copies
    from and to."""
    perm = np.random.default_rng(seed + 2).permutation(m)
    return perm[:m // 2], perm[m // 2:2 * (m // 2)]


# (N, M, seed, ties) at which phase 2 and tests/test_torch_cuda.py hold the
# association kernel to its twin, Euclidean and Mahalanobis: the three shapes,
# the multi-tile case of tests/test_pallas_kernels.py, ragged sizes, and ties
# across chunks and ranks
ASSOC_CHECKS = ([(n, m, 0, False) for n, m in ASSOC_SHAPES.values()] + [(61, 2000, 5, False)]
                + [(n, m, 1, False) for n in (1, 129, 2049) for m in (0, 1, 4097)]
                + [(64, 256, 3, True), (512, 256, 3, True), (2048, 256, 3, True),
                   (256, 256, 3, True), (512, 4096, 4, True)])


def assoc_flop(n, m, mahalanobis):
    """FP32 operations of the association cost (csrc/assoc.cu) for n
    observations and m landmarks: per pair, Euclidean 2 sub, 2 mul, 1 add;
    Mahalanobis 2 sub, 6 mul, 2 add, and 2b once per landmark."""
    return 10 * n * m + m if mahalanobis else 5 * n * m


def assoc_check(n, m, seed, ties, mahalanobis):
    """The association kernel against its twin on `assoc_world`, cut to m
    landmarks. Raises unless idx, matched and cost are bit-equal and, with
    `ties`, unless some observations met a tie and every one went to the
    lower index. Returns (observations matched, ties met, max |cost -
    twin's cost|)."""
    oxy, ot, lxy, lt, cov = assoc_world(n, max(m, 1), seed, ties=ties)
    lxy, lt, cov = (x[:m].contiguous() for x in (lxy, lt, cov))
    gate2 = 9.21 if mahalanobis else 1.44
    got = A.associate_kernel(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis)
    want = A.associate_plain(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis)
    what = f"assoc N={n} M={m} ties={ties} mahalanobis={mahalanobis}"
    for g, w, name in zip(got, want, ("idx", "matched", "cost")):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs from the plain twin")
    met = 0
    if ties:
        met = tie_check(got[0].cpu().numpy()[got[1].cpu().numpy()], m, seed, what)
    return int(got[1].sum()), met, float((got[2] - want[2]).abs().max())


def tie_check(idx, m, seed, what):
    """The number of matched indices `idx` that have a copy in
    `tie_pairs(m, seed)`; raises if there are none or a higher copy won."""
    src, dst = tie_pairs(m, seed)
    partner = np.full(m, -1)
    partner[src], partner[dst] = dst, src
    tied = partner[idx] >= 0
    if not tied.any() or (idx[tied] > partner[idx[tied]]).any():
        raise AssertionError(f"{what}: {int(tied.sum())} ties, not all won by the lower index")
    return int(tied.sum())


def assoc_batched_check(s, n, m, seed, ties, mahalanobis, masked=False, device="cuda"):
    """The association kernel on S sessions in one launch against its twin
    on the stack and against S single twin calls: session i takes
    `assoc_world(n, m, seed + i)`; `masked` adds a random observation mask,
    a landmark count per session and the float type column of [S, N, 4]
    rows. Raises unless idx, matched and cost are bit-equal and, with
    `ties`, unless each session met a tie and every one went to the lower
    index. Returns (observations matched, ties met, max |cost - twin's|)."""
    worlds = [assoc_world(n, max(m, 1), seed + i, device, ties=ties) for i in range(s)]
    oxy, ot, lxy, lt, cov = (torch.stack([w[k] for w in worlds]) for k in range(5))
    lxy, lt, cov = (x[:, :m].contiguous() for x in (lxy, lt, cov))
    kw = {}
    if masked:
        rng = np.random.default_rng(seed)
        rows = torch.zeros(s, n, 4, device=device)
        rows[..., 3] = ot.float()
        ot = rows[..., 3]
        kw = dict(obs_valid=torch.tensor(rng.random((s, n)) < 0.8, device=device),
                  lm_count=torch.tensor(rng.integers(0, m + 1, s), dtype=torch.int32,
                                        device=device))
    gate2 = 9.21 if mahalanobis else 1.44
    got = A.associate_kernel(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis, **kw)
    want = A.associate_plain(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis, **kw)
    what = f"assoc S={s} N={n} M={m} ties={ties} mahalanobis={mahalanobis} masked={masked}"
    for g, w, name in zip(got, want, ("idx", "matched", "cost")):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs from the plain twin")
    met = 0
    for i in range(s):
        one = A.associate_plain(oxy[i], ot[i], lxy[i], lt[i], gate2, cov[i],
                                mahalanobis=mahalanobis, **{k: v[i] for k, v in kw.items()})
        if not all(torch.equal(g[i], w) for g, w in zip(got, one)):
            raise AssertionError(f"{what}: session {i} differs from its single twin call")
        if ties and not masked:
            idx = got[0][i].cpu().numpy()[got[1][i].cpu().numpy()]
            met += tie_check(idx, m, seed + i, f"{what} session {i}")
    return int(got[1].sum()), met, float((got[2] - want[2]).abs().max())


def chol_batched_check(s, n):
    """The Cholesky kernel on S random SPD matrices [S, n, n] in one launch
    against the twin on the stack (CHOL_ATOL, CHOL_RTOL) and against S
    single launches, bit for bit (each tile's sums run in a fixed order).
    Returns max |kernel - twin|."""
    a = torch.stack([spd(n, seed=1000 * n + i) for i in range(s)])
    before = C.launches
    got = C.cholesky_kernel(a)
    if C.launches != before + 1:
        raise AssertionError(f"cholesky S={s} n={n}: {C.launches - before} launches, want 1")
    want = C.cholesky_plain(a)
    torch.testing.assert_close(got, want, atol=CHOL_ATOL, rtol=CHOL_RTOL,
                               msg=f"cholesky S={s} n={n} against the twin")
    single = torch.stack([C.cholesky_kernel(a[i]) for i in range(s)])
    if not torch.equal(got, single):
        raise AssertionError(f"cholesky S={s} n={n}: the batch differs from single launches "
                             f"by {float((got - single).abs().max()):.3g}")
    return float((got - want).abs().max())


def batched_scenario(track, t_frames):
    """bench.py's batched scenario: (obs, valid, poses) numpy stacks
    [S, t_b, ...] of BATCHED_SESSIONS laps of `track`, cut to the shortest
    and to the bench lap's `t_frames`, and t_b."""
    scens = [simulate(track, SimConfig(**dict(SIM, seed=BATCHED_SEED0 + s)))
             for s in range(BATCHED_SESSIONS)]
    t_b = min(t_frames, *(len(sc.times) for sc in scens))
    return (np.stack([sc.obs[:t_b] for sc in scens]).astype(np.float32),
            np.stack([sc.obs_valid[:t_b] for sc in scens]),
            np.stack([sc.odom_poses[:t_b] for sc in scens]).astype(np.float32), t_b)


def batched_cap(t_b):
    return GraphCapacity(max(BATCHED_POSES, t_b), BATCHED_CAP_LM, BATCHED_CAP_OBS)


def batched_configs(cap):
    return {"first": SlamConfig(capacity=cap),
            "nearest": SlamConfig(capacity=cap, association="nearest",
                                  use_pallas_association=True)}


def session_metrics(states, outs, s) -> dict:
    """Closure frame, landmark and edge counts of session `s` of a batched run."""
    closes = np.flatnonzero(outs.loop_closed[s].cpu().numpy())
    g = states.graph
    return dict(closure_frame=int(closes[0]) if len(closes) else -1,
                n_landmarks=int(g.n_landmarks[s]), n_obs=int(g.n_obs[s]))


def fusion_scenario(track):
    """bench.py's fusion scenario: (obs, valid, poses) numpy stacks [S, t_f,
    ...] of FUSION_SESSIONS laps of `track`, cut to the shortest and to a
    multiple of FUSION_BLOCK, and t_f."""
    scens = [simulate(track, SimConfig(**dict(SIM, seed=FUSION_SEED0 + s)))
             for s in range(FUSION_SESSIONS)]
    t_f = min(len(sc.times) for sc in scens)
    t_f -= t_f % FUSION_BLOCK
    return (np.stack([sc.obs[:t_f] for sc in scens]).astype(np.float32),
            np.stack([sc.obs_valid[:t_f] for sc in scens]),
            np.stack([sc.odom_poses[:t_f] for sc in scens]).astype(np.float32), t_f)


def fusion_configs(cap):
    return {name: SlamConfig.improved(capacity=cap, association="mahalanobis",
                                      periodic_gn_every=16, **kw)
            for name, kw in FUSION_CONFIGS.items()}


def fusion_cap(t_f):
    return GraphCapacity(max(FUSION_POSES, t_f), FUSION_CAP_LM, FUSION_CAP_OBS)


def fusion_gn_config(cfg):
    """bench.py's joint GN over the fused graph (bench.py:706-710): no
    gauge clamping (the GPS priors anchor it) and no buckets."""
    return gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info, iterations=10,
                       fix_first_poses=0, fix_first_landmarks=0, solve_bucket_step=0,
                       edge_bucket_step=0, early_exit_tol=1e-4)


def drifted_poses(poses):
    """bench.py's drifted variant (bench.py:742-754): every session but the
    first rigidly moved by an offset from FUSION_DRIFT_SEED."""
    s = poses.shape[0]
    offs = np.random.default_rng(FUSION_DRIFT_SEED).uniform(
        [-0.6, -0.6, -0.04], [0.6, 0.6, 0.04], (s, 3))
    offs[0] = 0.0
    c, si = np.cos(offs[:, 2]), np.sin(offs[:, 2])
    xy = np.einsum("sij,stj->sti", np.stack([np.stack([c, si], -1), np.stack([-si, c], -1)], 1),
                   poses[:, :, :2])
    return np.stack([xy[..., 0] + offs[:, None, 0], xy[..., 1] + offs[:, None, 1],
                     poses[:, :, 2] + offs[:, None, 2]], -1).astype(np.float32)


def map_error(track, g) -> float:
    """Median distance of a map's landmarks to their nearest true cone."""
    lm = g.lm_xy[:int(g.n_landmarks)].cpu().numpy()
    return float(np.median(np.linalg.norm(lm[:, None, :] - track.cones_xy[None],
                                          axis=-1).min(axis=1)))


def fusion_flow(track, cfg, ins, poses_d, joint_gn=True, mark=lambda label: None):
    """bench.py's fusion flow on the device of `ins` = (obs, valid, poses)
    [S, t_f, ...]: the batched improved pass, `fuse_sessions(align=False)`,
    then the drifted pass on `poses_d` and `fuse_sessions(align=True,
    robust=True)`, each fusion with bench.py's joint GN unless not
    `joint_gn`. `mark(label)` is called before each pass ("fusion",
    "fusion_drifted") and with None after it. Returns the run's objects and
    its numbers in the layout of FUSION_REFERENCE (the map errors only with
    the joint GN)."""
    obs, valid, poses = ins
    S, t = obs.shape[:2]
    cap, dev = cfg.capacity, obs.device
    gcfg = fusion_gn_config(cfg) if joint_gn else None
    gate = cfg.same_cone_threshold
    mark("fusion")
    states, outs, done = blocked_core_batched(initial_states(cap, S, dev), obs, valid, poses,
                                              cfg, FUSION_BLOCK)
    mark(None)
    if done != [t] * S:
        raise AssertionError(f"fusion sessions incomplete: done_upto {done}, want {[t] * S}")
    fused, report = fuse_sessions(states.graph, cfg=gcfg, gate=gate, lm_info=states.lm_info_xy,
                                  align=False)
    mark("fusion_drifted")
    states_d, outs_d = run_sequences_blocked_batched(initial_states(cap, S, dev), obs, valid,
                                                     poses_d, cfg, block=FUSION_BLOCK)
    mark(None)
    fused_d, report_d = fuse_sessions(states_d.graph, cfg=gcfg, gate=2.0 * gate,
                                      lm_info=states_d.lm_info_xy, align=True, robust=True)

    def per_session(st, out):
        ms = [session_metrics(st, out, s) for s in range(S)]
        return {k: [m[k] for m in ms] for k in ("closure_frame", "n_landmarks", "n_obs")}

    rep, rep_d = fusion_report(report), fusion_report(report_d)
    got = dict(per_session(states, outs), fused_landmarks=rep["n_merged_landmarks"],
               cross_session_merges=rep["n_cross_session_merges"],
               drifted=per_session(states_d, outs_d),
               fused_landmarks_drifted=rep_d["n_merged_landmarks"],
               cross_session_merges_drifted=rep_d["n_cross_session_merges"])
    if joint_gn:
        got.update(map_error_fused_m=map_error(track, fused),
                   map_error_fused_drifted_m=map_error(track, fused_d))
    return dict(states=states, outs=outs, fused=fused, states_d=states_d, fused_d=fused_d,
                metrics=got)


def check_fusion(name, got) -> None:
    """A fusion run's numbers against FUSION_REFERENCE: counts exact, map
    errors within METRIC_ATOL_M (only those the run has)."""
    for k, want in FUSION_REFERENCE.items():
        if k not in got:
            continue
        ok = (abs(got[k] - want) <= METRIC_ATOL_M) if isinstance(want, float) else got[k] == want
        if not ok:
            raise AssertionError(f"fusion {name}: {k} = {got[k]}, JAX package {want}")


def compare_session(what, st_b, out_b, st_1, out_1):
    """A session of a batched run against its own single-session run:
    discrete outputs and state exact (edges up to n_obs), values within
    BATCHED_ATOL (the batched closure GN is full-capacity, its sums in
    another order)."""
    for f in dataclasses.fields(out_1):
        a, b = getattr(out_b, f.name), getattr(out_1, f.name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: outputs.{f.name} {a.dtype} {tuple(a.shape)}, "
                                 f"want {b.dtype} {tuple(b.shape)}")
        if a.is_floating_point():
            torch.testing.assert_close(a, b, atol=BATCHED_ATOL, rtol=0,
                                       msg=f"{what}: outputs.{f.name}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what}: outputs.{f.name} differs")
    n = int(st_1.graph.n_obs)
    for owner_b, owner_1, path in ((st_b, st_1, ""), (st_b.graph, st_1.graph, "graph.")):
        for f in dataclasses.fields(owner_1):
            if f.name == "graph":
                continue
            a, b = getattr(owner_b, f.name), getattr(owner_1, f.name)
            if f.name in ("obs_pose", "obs_lm", "obs_xy"):
                a, b = a[:n], b[:n]
            if a.is_floating_point():
                torch.testing.assert_close(a, b, atol=BATCHED_ATOL, rtol=0,
                                           msg=f"{what}: state.{path}{f.name}")
            elif not torch.equal(a, b):
                raise AssertionError(f"{what}: state.{path}{f.name} differs")


def assoc_masked_world(seed, device="cuda"):
    """A keyframe's association inputs at the lap shape as
    `_provider_associate` gets them: observation xy, the [N, 4] rows (type in
    the float column 3), the validity mask, the landmark store and its fill
    count (150 of 256)."""
    n, m = ASSOC_SHAPES["lap"]
    oxy, ot, lxy, lt, _ = assoc_world(n, m, seed, device)
    rows = torch.zeros(n, 4, device=device)
    rows[:, 3] = ot.float()
    valid = torch.tensor(np.random.default_rng(seed).random(n) < 0.8, device=device)
    return oxy, rows, valid, lxy, lt, torch.tensor(150, dtype=torch.int32, device=device)


def assoc_masked_check(seed, device="cuda"):
    """The masked form (obs_valid, lm_count, the float type column) against
    its twin and against the unmasked form with invalid observations typed
    -2 and landmarks past the count typed -1: raises unless all three are
    bit-equal. Returns (observations matched, max |cost - twin's cost|)."""
    oxy, rows, valid, lxy, lt, count = assoc_masked_world(seed, device)
    masked = A.associate_kernel(oxy, rows[:, 3], lxy, lt, 1.44, obs_valid=valid, lm_count=count)
    twin = A.associate_plain(oxy, rows[:, 3], lxy, lt, 1.44, obs_valid=valid, lm_count=count)
    otype = torch.where(valid, rows[:, 3].to(torch.int32), -2)
    lt_eff = torch.where(torch.arange(len(lt), device=device) < count, lt, -1).to(torch.int32)
    typed = A.associate_kernel(oxy, otype, lxy, lt_eff, 1.44)
    for a, b, c, name in zip(masked, twin, typed, ("idx", "matched", "cost")):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"assoc masked seed={seed}: {name} differs")
    return int(masked[1].sum()), float((masked[2] - twin[2]).abs().max())


def compare_runs(what, got, want, closure):
    """A lap (state, outputs) against another of the same configuration on
    the card: discrete outputs and state, published poses, edge rows up to
    n_obs and every output before the closure frame bit-equal; the rest
    (after the closure GN, whose CUDA sums are atomics) within POSE_ATOL,
    cone azimuths, in degrees, within 60 x POSE_ATOL."""
    (st_g, out_g), (st_w, out_w) = got, want
    for f in dataclasses.fields(out_w):
        a, b = getattr(out_g, f.name), getattr(out_w, f.name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what}: outputs.{f.name} {a.dtype} {tuple(a.shape)}, "
                                 f"want {b.dtype} {tuple(b.shape)}")
        exact = not a.is_floating_point() or f.name == "pose"
        if not torch.equal(a if exact else a[:closure], b if exact else b[:closure]):
            raise AssertionError(f"{what}: outputs.{f.name} differs")
        if not exact:
            atol = POSE_ATOL * (60.0 if f.name == "cone_azimuth" else 1.0)
            torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=f"{what}: {f.name}")
    n = int(st_w.graph.n_obs)
    for owner_g, owner_w, path in ((st_g, st_w, ""), (st_g.graph, st_w.graph, "graph.")):
        for f in dataclasses.fields(owner_w):
            if f.name == "graph":
                continue
            a, b = getattr(owner_g, f.name), getattr(owner_w, f.name)
            if f.name in ("obs_pose", "obs_lm", "obs_xy"):
                a, b = a[:n], b[:n]
            if a.is_floating_point() and f.name != "obs_xy":
                torch.testing.assert_close(a, b, atol=POSE_ATOL, rtol=0,
                                           msg=f"{what}: {path}{f.name}")
            elif not torch.equal(a, b):
                raise AssertionError(f"{what}: state.{path}{f.name} differs")


def profile_counts(fn):
    """(device busy ms, kernel launches, device-to-host copies) of one call
    of `fn` under torch.profiler: device time summed over kernels and
    copies."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset"))),
            sum(e.count for e in dev if e.key.startswith("Memcpy DtoH")))


def spd(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    m = rng.normal(0, 1, (n, n)).astype(np.float32)
    return torch.tensor(m @ m.T / n + np.eye(n, dtype=np.float32) * 2.0, device="cuda")


def bound(flop: float, nbytes: float):
    """(ms, "operations" or "bytes"): the least time the card could take for
    `flop` FP32 operations and `nbytes` moved, and which of the two sets it."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOP_S, nbytes / PEAK_HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of `fn` in ms over `reps` runs, after one warm-up
    run unless `warmup` is False."""
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Smoke:
    def __init__(self):
        self.card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        self.track, self.scen = scenario()
        self.kernels = {
            "assoc": dict(name="assoc", route="cuda", source="tpuslam_torch/csrc/assoc.cu",
                          replaces="tpuslam/ops/pallas_assoc.py:32"),
            "cholesky": dict(name="cholesky", route="cuda",
                             source="tpuslam_torch/csrc/cholesky.cu",
                             replaces="tpuslam/ops/cholesky.py:50"),
        }
        self.runs = {}
        self.batched_graph = self.batched_s = None
        self.closure_s = None
        self.closure_graph = None
        self.firing_graph = None
        self.fusion_run = None

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    # -- 1
    def build(self):
        t0 = time.perf_counter()
        reports = _build.build_all()
        self.log(f"build: both kernels in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
        for name, rep in reports.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    self.log(f"  ptxas {name}: {line.strip()}")

    # -- 2
    def kernels_vs_plain(self):
        A.launches = C.launches = 0
        err = 0.0
        for n, m, seed, ties in ASSOC_CHECKS:
            for mahal in (False, True):
                matched, met, e = assoc_check(n, m, seed, ties, mahal)
                err = max(err, e)
                self.log(f"kernels: assoc N={n} M={m} ties={ties} mahalanobis={mahal}: "
                         f"bit-equal to the plain twin ({matched} matched"
                         + (f", {met} ties to the lower index)" if ties else ")"))
        for seed in (0, 1):
            matched, e = assoc_masked_check(seed)
            err = max(err, e)
            self.log(f"kernels: assoc masked seed={seed}: bit-equal to the twin and to the "
                     f"-2/-1 typed form ({matched} matched)")
        for s_, n, m, seed, ties in ASSOC_BATCHED_CHECKS:
            for mahal in (False, True):
                for masked in (False, True):
                    matched, met, e = assoc_batched_check(s_, n, m, seed, ties, mahal, masked)
                    err = max(err, e)
                    self.log(f"kernels: assoc S={s_} N={n} M={m} ties={ties} mahalanobis="
                             f"{mahal} masked={masked}: one launch, bit-equal to the twin and "
                             f"to {s_} single twin calls ({matched} matched"
                             + (f", {met} ties to the lower index)" if met else ")"))
        self.kernels["assoc"]["max_abs_err"] = err
        err = 0.0
        for n in (200, 384, 768, 1536):
            a = spd(n)
            got, want = C.cholesky_kernel(a), C.cholesky_plain(a)
            torch.testing.assert_close(got, want, atol=CHOL_ATOL, rtol=CHOL_RTOL)
            recon = float((got @ got.T - a).abs().max())
            if recon > CHOL_RECON_ATOL:
                raise AssertionError(f"cholesky n={n}: |LL^T - A|max = {recon}")
            e = float((got - want).abs().max())
            err = max(err, e)
            self.log(f"kernels: cholesky n={n}: max|kernel - plain| = {e:.3g} "
                     f"(atol {CHOL_ATOL}, rtol {CHOL_RTOL}), |LL^T - A|max = {recon:.3g}")
        for s_, n in CHOL_BATCHED_CHECKS:
            e = chol_batched_check(s_, n)
            err = max(err, e)
            self.log(f"kernels: cholesky S={s_} n={n}: one launch, max|kernel - plain| = "
                     f"{e:.3g} (atol {CHOL_ATOL}, rtol {CHOL_RTOL}), bit-equal to {s_} single "
                     "launches")
        self.kernels["cholesky"]["max_abs_err"] = err
        launched = {"assoc": A.launches, "cholesky": C.launches}
        self.log("kernels: " + json.dumps({k: {"max_abs_err": v["max_abs_err"],
                                               "launches": launched[k]}
                                           for k, v in self.kernels.items()}))

    def _lap(self, name: str):
        obs, valid, poses = inputs(self.scen, "cuda")
        A.launches = C.launches = 0
        state, outs = run_pass(obs, valid, poses, configs()[name])
        torch.cuda.synchronize()
        counts = {"assoc": A.launches, "cholesky": C.launches}
        metrics = lap_metrics(self.track, self.scen, state, outs)
        self.runs[name] = (state, outs)
        self.log(f"{name}: " + json.dumps(metrics) + f" launches {counts}")
        check_metrics(name, metrics)
        return counts

    # -- 3
    def compat(self):
        counts = self._lap("first")
        if any(counts.values()):
            raise AssertionError(f"the compat path launched kernels: {counts}")

    # -- 4
    def kernel_association(self):
        counts = self._lap("nearest")
        odom = self.scen.odom_poses
        guarded = int(np.sum((np.abs(odom[:, 0]) <= 200.0) & (np.abs(odom[:, 1]) <= 200.0)))
        if counts["assoc"] != guarded:
            raise AssertionError(f"assoc launches {counts['assoc']} != {guarded} keyframes")
        self.kernels["assoc"]["launches_by_path"] = {"per_frame": counts["assoc"]}
        st_g, out_g = self.runs["nearest"]
        st_c, out_c = run_pass(*inputs(self.scen, "cpu"), configs()["nearest"])
        for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
            if not torch.equal(getattr(out_g, f).cpu(), getattr(out_c, f)):
                raise AssertionError(f"nearest: per-frame {f} differs from the CPU run")
        torch.testing.assert_close(out_g.pose.cpu(), out_c.pose, atol=POSE_ATOL, rtol=0)
        g_g, g_c = st_g.graph, st_c.graph
        n_obs = int(g_c.n_obs)
        for f in ("n_landmarks", "n_obs", "lm_type"):
            if not torch.equal(getattr(g_g, f).cpu(), getattr(g_c, f)):
                raise AssertionError(f"nearest: final graph {f} differs from the CPU run")
        if not torch.equal(g_g.obs_lm[:n_obs].cpu(), g_c.obs_lm[:n_obs]):
            raise AssertionError("nearest: edge list differs from the CPU run")
        torch.testing.assert_close(g_g.poses.cpu(), g_c.poses, atol=POSE_ATOL, rtol=0)
        self.log(f"nearest: {guarded} assoc launches = keyframes run; per-frame outputs "
                 f"equal the CPU run (discrete exact, poses within {POSE_ATOL})")

    # -- after 4
    def blocked(self):
        """bench.py's path, `run_pass_blocked(..., block=BLOCK)`, on the card in
        both configurations: held to the JAX package's numbers and to the
        per-frame run of phase 3 or 4 in this process; every frame is done by
        the blocks (none falls to the per-frame path); with the kernel, one
        association launch per block run, each at the blocked16 shape."""
        obs, valid, poses = inputs(self.scen, "cuda")
        t = obs.shape[0]
        t_pad = -(-t // BLOCK) * BLOCK
        done, shapes = [], []
        core, kernel = blocked_mod.blocked_core, keyframe_mod.associate_kernel

        def recording_core(*a, **kw):
            out = core(*a, **kw)
            done.append(out[2])
            return out

        def recording_kernel(obs_xy, obs_type, lm_xy, *a, **kw):
            # the blocked path passes one session as a leading axis of 1
            if obs_xy.dim() == 3 and obs_xy.shape[0] != 1:
                raise AssertionError(f"single-session kernel call of {obs_xy.shape[0]} sessions")
            shapes.append((obs_xy.shape[-2], lm_xy.shape[-2]))
            return kernel(obs_xy, obs_type, lm_xy, *a, **kw)

        blocked_mod.blocked_core, keyframe_mod.associate_kernel = recording_core, recording_kernel
        try:
            for name, cfg in configs().items():
                done.clear()
                shapes.clear()
                A.launches = C.launches = 0
                state, outs = run_pass_blocked(obs, valid, poses, cfg, block=BLOCK)
                torch.cuda.synchronize()
                counts = {"assoc": A.launches, "cholesky": C.launches}
                metrics = lap_metrics(self.track, self.scen, state, outs)
                self.log(f"blocked {name}: " + json.dumps(metrics) + f" launches {counts}, "
                         f"done_upto {done} of {t} frames ({t_pad} padded)")
                check_metrics(name, metrics)
                if done != [t_pad]:
                    raise AssertionError(f"blocked {name}: done_upto {done}, want [{t_pad}]: "
                                         "frames fell to the per-frame path")
                kc = metrics["closure_frame"]
                blocks = kc // BLOCK + 1 + t_pad // BLOCK - (kc + 1) // BLOCK
                want = {"assoc": blocks if name == "nearest" else 0, "cholesky": 0}
                if counts != want or len(shapes) != want["assoc"] \
                        or set(shapes) - {ASSOC_SHAPES["blocked16"]}:
                    raise AssertionError(f"blocked {name}: launches {counts}, shapes {shapes}; "
                                         f"want {want} at {ASSOC_SHAPES['blocked16']}")
                compare_runs(f"blocked {name}", (state, outs), self.runs[name], kc)
                self.log(f"blocked {name}: equal to the per-frame run (discrete outputs, poses, "
                         f"edges and frames before the closure exact; the rest within "
                         f"{POSE_ATOL}); {blocks} blocks run, " + (
                             f"one assoc launch each at N x M = {ASSOC_SHAPES['blocked16']}"
                             if want["assoc"] else "dense association, no kernel launch"))
                if name == "nearest":
                    self.kernels["assoc"]["launches"] = counts["assoc"]
                    self.kernels["assoc"]["launches_by_path"]["blocked"] = counts["assoc"]
        finally:
            blocked_mod.blocked_core, keyframe_mod.associate_kernel = core, kernel

    # -- after blocked
    def improved(self):
        """The improved mode on the card, every run of IMPROVED_RUNS: held to
        the JAX package's numbers for its path and block and to the port's
        CPU run of the same path; the blocked runs do every frame in the
        blocks; in I2 the association kernel's Mahalanobis form runs once per
        keyframe per frame and once per block blocked, at blocked16_b16. A
        gate decision that flips on the card is reported with its margin and
        held to the cross-path contract instead."""
        obs, valid, poses = inputs(self.scen, "cuda")
        cpu = inputs(self.scen, "cpu")
        t = obs.shape[0]
        cfgs = improved_configs()
        done, shapes = [], []
        core, kernel = blocked_mod.blocked_core, keyframe_mod.associate_kernel

        def recording_core(*a, **kw):
            out = core(*a, **kw)
            done.append(out[2])
            return out

        def recording_kernel(obs_xy, obs_type, lm_xy, *a, **kw):
            # the blocked path passes one session as a leading axis of 1
            if obs_xy.dim() == 3 and obs_xy.shape[0] != 1:
                raise AssertionError(f"single-session kernel call of {obs_xy.shape[0]} sessions")
            shapes.append((obs_xy.shape[-2], lm_xy.shape[-2]))
            return kernel(obs_xy, obs_type, lm_xy, *a, **kw)

        paths = self.kernels["assoc"].setdefault("launches_by_path", {})
        for run, (name, block) in IMPROVED_RUNS.items():
            blocked_mod.blocked_core, keyframe_mod.associate_kernel = (recording_core,
                                                                       recording_kernel)
            done.clear()
            shapes.clear()
            A.launches = C.launches = 0
            try:
                got = improved_lap(cfgs[name], block, obs, valid, poses)
                torch.cuda.synchronize()
            finally:
                blocked_mod.blocked_core, keyframe_mod.associate_kernel = core, kernel
            counts = {"assoc": A.launches, "cholesky": C.launches}
            seen, done_h = list(shapes), list(done)
            metrics = lap_metrics(self.track, self.scen, *got)
            self.log(f"improved {run}: " + json.dumps(metrics) + f" launches {counts}"
                     + (f", done_upto {done_h} of {t} frames" if block else ""))
            self.check_improved(run, cfgs[name], got, improved_lap(cfgs[name], block, *cpu),
                                metrics)
            kc = metrics["closure_frame"]
            if block is None:
                want_assoc = t if name == "I2" else 0
                shape = ASSOC_SHAPES["lap"]
            else:
                t_pad = -(-t // block) * block
                if done_h != [t_pad]:
                    raise AssertionError(f"improved {run}: done_upto {done_h}, want [{t_pad}]: "
                                         "frames fell to the per-frame path")
                want_assoc = (kc // block + 1 + t_pad // block - (kc + 1) // block
                              if name == "I2" else 0)
                shape = ASSOC_SHAPES["blocked16_b16"]
            if counts != {"assoc": want_assoc, "cholesky": 0} or len(seen) != want_assoc \
                    or set(seen) - {shape}:
                raise AssertionError(f"improved {run}: launches {counts}, shapes {set(seen)}; "
                                     f"want {want_assoc} assoc launches at {shape}")
            if name == "I2":
                paths[f"improved_{run}"] = counts["assoc"]
                self.log(f"improved {run}: {counts['assoc']} Mahalanobis assoc launches at "
                         f"N x M = {shape}" + (", one per keyframe" if block is None
                                               else ", one per block"))
        state, _ = run_sequence(initial_state(CAP, "cuda"), obs[:FIRING_FRAME],
                                valid[:FIRING_FRAME], poses[:FIRING_FRAME], cfgs["I1"])
        self.firing_graph = state.graph

    # -- after improved
    def batched(self):
        """bench.py's batched-sessions path on the card: both configurations
        through `run_sequences_blocked_batched` at block BLOCK, every session
        held to BATCHED_REFERENCE and to its own single-session blocked run,
        every frame done by the blocks, and with the kernel one association
        launch per block for all sessions, at ASSOC_BATCHED. Then the closure
        GN of the closed graphs through the Cholesky kernel."""
        obs_n, valid_n, poses_n, t = batched_scenario(self.track, len(self.scen.times))
        obs, valid, poses = (torch.tensor(x, device="cuda") for x in (obs_n, valid_n, poses_n))
        S = obs.shape[0]
        cap = batched_cap(t)
        t_pad = -(-t // BLOCK) * BLOCK
        done, shapes, graphs = [], [], []
        core, kernel, optimize = (blocked_mod.blocked_core_batched,
                                  keyframe_mod.associate_kernel, gn.optimize)

        def recording_core(*a, **kw):
            out = core(*a, **kw)
            done.append(out[2])
            return out

        def recording_kernel(obs_xy, obs_type, lm_xy, *a, **kw):
            shapes.append((*obs_xy.shape[:-1], lm_xy.shape[-2]))
            return kernel(obs_xy, obs_type, lm_xy, *a, **kw)

        def recording_optimize(g, cfg, enable=None):
            if g.n_poses.dim():
                graphs.append((g, enable))
            return optimize(g, cfg, enable)

        paths = self.kernels["assoc"].setdefault("launches_by_path", {})
        for name, cfg in batched_configs(cap).items():
            done.clear()
            shapes.clear()
            graphs.clear()
            blocked_mod.blocked_core_batched, keyframe_mod.associate_kernel, gn.optimize = (
                recording_core, recording_kernel, recording_optimize)
            A.launches = C.launches = 0
            try:
                states, outs = run_sequences_blocked_batched(
                    initial_states(cap, S, "cuda"), obs, valid, poses, cfg, block=BLOCK)
                torch.cuda.synchronize()
            finally:
                blocked_mod.blocked_core_batched, keyframe_mod.associate_kernel, gn.optimize = (
                    core, kernel, optimize)
            counts = {"assoc": A.launches, "cholesky": C.launches}
            metrics = [session_metrics(states, outs, s) for s in range(S)]
            self.log(f"batched {name}: {S} sessions x {t} frames, capacity {cap}: closure "
                     f"frames {[m['closure_frame'] for m in metrics]}, landmarks "
                     f"{[m['n_landmarks'] for m in metrics]}, edges "
                     f"{[m['n_obs'] for m in metrics]}; launches {counts}, done_upto {done}")
            for k, want in BATCHED_REFERENCE.items():
                got = [m[k] for m in metrics]
                if got != want:
                    raise AssertionError(f"batched {name}: {k} {got}, JAX package {want}")
            if done != [[t_pad] * S]:
                raise AssertionError(f"batched {name}: done_upto {done}, want [{[t_pad] * S}]: "
                                     "frames fell to the per-frame path")
            kc = [m["closure_frame"] for m in metrics]
            blocks = max(kc) // BLOCK + 1 + t_pad // BLOCK - min(kc) // BLOCK
            want = {"assoc": blocks if name == "nearest" else 0, "cholesky": 0}
            shape = (S,) + ASSOC_BATCHED["batched16"][1:]
            if counts != want or len(shapes) != want["assoc"] or set(shapes) - {shape}:
                raise AssertionError(f"batched {name}: launches {counts}, shapes {set(shapes)}; "
                                     f"want {want} at {shape}")
            if len(graphs) != 1:
                raise AssertionError(f"batched {name}: {len(graphs)} batched closure GNs, want 1")
            for s in range(S):
                one = run_sequence_blocked(initial_state(cap, "cuda"), obs[s], valid[s],
                                           poses[s], cfg, block=BLOCK)
                compare_session(f"batched {name} session {s}", session_state(states, s),
                                blocked_mod._take(outs, s), *one)
            self.log(f"batched {name}: every session equal to BATCHED_REFERENCE and to its own "
                     f"single-session blocked run (discrete exact, values within "
                     f"{BATCHED_ATOL}); {blocks} blocks, " + (
                         f"one assoc launch each for all {S} sessions at S x N x M = {shape}"
                         if want["assoc"] else "dense association, no kernel launch"))
            if name == "nearest":
                paths["batched"] = counts["assoc"]
            else:
                self.batched_graph = graphs[0][0]
        self.batched_closure_solve()

    # -- after batched
    def fusion(self):
        """bench.py's fusion section on the card (`fusion_flow`) in both
        configurations: each held to FUSION_REFERENCE, every session of the
        batched improved pass to its own single-session blocked run on the
        card, and with the kernel one association launch per block for all
        sessions, at ASSOC_FUSION's shape for each pass (the drifted pass's
        sessions that fall back are finished per frame, one launch per
        keyframe at the lap shape)."""
        track = self.track
        obs_n, valid_n, poses_n, t = fusion_scenario(track)
        ins = [torch.tensor(x, device="cuda") for x in (obs_n, valid_n, poses_n)]
        poses_d = torch.tensor(drifted_poses(poses_n), device="cuda")
        cap = fusion_cap(t)
        S = FUSION_SESSIONS
        shapes, launches = {}, {}
        label = [None]
        kernel = keyframe_mod.associate_kernel

        def recording_kernel(obs_xy, obs_type, lm_xy, *a, **kw):
            if label[0] is not None:
                shapes[label[0]].append((*obs_xy.shape[:-1], lm_xy.shape[-2]))
            return kernel(obs_xy, obs_type, lm_xy, *a, **kw)

        def mark(now):
            if now is not None:
                shapes[now], launches[now] = [], A.launches
            else:
                torch.cuda.synchronize()
                launches[label[0]] = A.launches - launches[label[0]]
            label[0] = now

        paths = self.kernels["assoc"].setdefault("launches_by_path", {})
        for name, cfg in fusion_configs(cap).items():
            keyframe_mod.associate_kernel = recording_kernel
            try:
                run = fusion_flow(track, cfg, ins, poses_d, mark=mark)
            finally:
                keyframe_mod.associate_kernel = kernel
            got = run["metrics"]
            self.log(f"fusion {name}: {S} sessions x {t} frames, capacity {cap}: "
                     + json.dumps(got) + f"; assoc launches {launches}")
            check_fusion(name, got)
            kc = got["closure_frame"]
            blocks = max(kc) // FUSION_BLOCK + 1 + t // FUSION_BLOCK - min(kc) // FUSION_BLOCK
            for path, (s_, n, m) in ASSOC_FUSION.items():
                seen = shapes[path]
                batched = [x for x in seen if x == (s_, n, m)]
                per_frame = [x for x in seen if x != (s_, n, m)]
                if name == "dense":
                    ok = not seen and launches[path] == 0
                elif path == "fusion":
                    ok = len(batched) == launches[path] == blocks and not per_frame
                else:
                    ok = (batched and len(seen) == launches[path]
                          and set(per_frame) <= {ASSOC_SHAPES["lap"]})
                if not ok:
                    raise AssertionError(f"fusion {name} {path}: {launches[path]} assoc launches "
                                         f"at {sorted(set(seen))}")
                if name == "kernel":
                    paths[path] = launches[path]
                    self.log(f"fusion kernel {path}: {launches[path]} assoc launches, "
                             f"{len(batched)} of them for all {S} sessions at S x N x M = "
                             f"{(s_, n, m)}, {len(per_frame)} per frame at {ASSOC_SHAPES['lap']}")
            states, outs = run["states"], run["outs"]
            for s in range(S):
                one = run_sequence_blocked(initial_state(cap, "cuda"), ins[0][s], ins[1][s],
                                           ins[2][s], cfg, block=FUSION_BLOCK)
                compare_session(f"fusion {name} session {s}", session_state(states, s),
                                blocked_mod._take(outs, s), *one)
            self.log(f"fusion {name}: equal to FUSION_REFERENCE (counts exact, map errors within "
                     f"{METRIC_ATOL_M} m) and every session of the batched pass to its own "
                     f"single-session blocked run (discrete exact, values within {BATCHED_ATOL})")
            if name == "dense":
                self.fusion_run = (cfg, run)

    def batched_closure_solve(self):
        """The closure GN of the 16 closed graphs of phase `batched`, at full
        capacity, through the Cholesky kernel: one launch of [S, n, n] per
        iteration for all sessions, within POSE_ATOL of the `cholesky_ex`
        batched solve, and each session's factor of the first iteration held
        to float64 as phase 5 holds one."""
        g = self.batched_graph
        S, P = g.poses.shape[:2]
        cfg = dataclasses.replace(_gn_config(configs()["first"]), solve_bucket_step=0,
                                  edge_bucket_step=0)
        enable = torch.ones(S, dtype=torch.bool, device="cuda")
        sizes, steps = [], []
        kernel, step = C.cholesky_kernel, gn.gn_step

        def recording(a):
            sizes.append(tuple(a.shape))
            if self.batched_s is None:
                self.batched_s = a
            return kernel(a)

        def counting(gg, c):
            steps.append(1)
            return step(gg, c)

        C.cholesky_kernel, gn.gn_step = recording, counting
        try:
            A.launches = C.launches = 0
            with_k = gn.optimize(g, dataclasses.replace(cfg, use_cholesky_kernel=True), enable)
            torch.cuda.synchronize()
            launches = C.launches
        finally:
            C.cholesky_kernel, gn.gn_step = kernel, step
        without = gn.optimize(g, cfg, enable)
        n = 3 * P
        self.log(f"batched closure: {S} graphs of {g.n_poses.tolist()} poses; {len(steps)} GN "
                 f"iterations, factorized shapes {sorted(set(sizes))}, cholesky launches "
                 f"{launches}")
        if launches != len(steps) or set(sizes) != {(S, n, n)}:
            raise AssertionError(f"batched closure: {launches} launches for {len(steps)} "
                                 f"iterations, shapes {set(sizes)}; want one [{S}, {n}, {n}] each")
        torch.testing.assert_close(with_k.poses, without.poses, atol=POSE_ATOL, rtol=0)
        torch.testing.assert_close(with_k.lm_xy, without.lm_xy, atol=POSE_ATOL, rtol=0)
        self.log(f"batched closure: kernel vs cholesky_ex: max|dpose| "
                 f"{float((with_k.poses - without.poses).abs().max()):.3g}, max|dlm| "
                 f"{float((with_k.lm_xy - without.lm_xy).abs().max()):.3g} (atol {POSE_ATOL})")
        self.kernels["cholesky"].setdefault("launches_by_path", {})["batched"] = launches
        s = self.batched_s
        factors = C.cholesky_kernel(s)
        twins = C.cholesky_plain(s)
        for i in range(S):
            self.closure_accuracy(s[i], kernel=factors[i], twin=twins[i], what=f"session {i}")

    def check_improved(self, run, cfg, got, cpu, metrics):
        """A GPU run of the improved mode against REFERENCE[run] and the
        port's CPU run of the same path. Closure frame, edges, sends and
        poses inserted are exact. Exact too, unless a gate decision flipped:
        landmark count, current cone and every discrete output, the JAX
        package's metrics within METRIC_ATOL_M and the values within
        POSE_ATOL of the CPU run. A flip is logged with its first frame and
        its margin to the gate, and the run is held to the cross-path
        contract instead."""
        want = REFERENCE[run]
        (st_g, out_g), (st_c, out_c) = got, cpu
        for k in ("closure_frame", "n_obs", "sends"):
            if metrics[k] != want[k]:
                raise AssertionError(f"improved {run}: {k} = {metrics[k]}, JAX package {want[k]}")
        if int(st_g.graph.n_poses) != int(st_c.graph.n_poses):
            raise AssertionError(f"improved {run}: n_poses differs from the CPU run")
        series = [f for f in ("n_landmarks", "cone_type", "send", "loop_closed")
                  if not torch.equal(getattr(out_g, f).cpu(), getattr(out_c, f))]
        flipped = series or any(metrics[k] != want[k] for k in ("n_landmarks",
                                                                 "current_cone_index"))
        if not flipped:
            check_metrics(run, metrics)
            n = int(st_c.graph.n_obs)
            for f in ("lm_type", "obs_lm", "obs_pose"):
                if not torch.equal(getattr(st_g.graph, f)[:n].cpu(), getattr(st_c.graph, f)[:n]):
                    raise AssertionError(f"improved {run}: graph.{f} differs from the CPU run")
            for a, b, what in ((out_g.pose, out_c.pose, "published poses"),
                               (st_g.graph.poses, st_c.graph.poses, "graph poses"),
                               (st_g.graph.lm_xy, st_c.graph.lm_xy, "landmarks")):
                torch.testing.assert_close(a.cpu(), b, atol=POSE_ATOL, rtol=0,
                                           msg=f"improved {run}: {what}")
            torch.testing.assert_close(st_g.lm_info_xy.cpu(), st_c.lm_info_xy, rtol=1e-4,
                                       atol=1e-3, msg=f"improved {run}: lm_info_xy")
            self.log(f"improved {run}: equal to the JAX package's numbers and, discrete "
                     f"exact, values within {POSE_ATOL}, to the CPU run")
            return
        differs = (out_g.n_landmarks.cpu() != out_c.n_landmarks) \
            | (out_g.cone_type.cpu() != out_c.cone_type).any(dim=1)
        frame = int(torch.nonzero(differs)[0]) if bool(differs.any()) else len(differs) - 1
        margin = gate_margin(self.scen, cfg, frame)
        d = float(torch.linalg.norm(out_g.pose.cpu()[:, :2] - out_c.pose[:, :2], dim=1).max())
        self.log(f"improved {run}: GATE FLIP against the CPU run ({series or 'final state'} "
                 f"differ) from frame {frame}, smallest |cost - gate| / gate there "
                 f"{margin:.3g}; landmarks {metrics['n_landmarks']} (JAX package "
                 f"{want['n_landmarks']}), published poses within {d:.4g} m of the CPU run")
        if abs(metrics["n_landmarks"] - want["n_landmarks"]) > CROSS_PATH_LANDMARKS \
                or d > CROSS_PATH_POSE_M:
            raise AssertionError(f"improved {run}: outside the cross-path contract "
                                 f"(+-{CROSS_PATH_LANDMARKS} landmarks, {CROSS_PATH_POSE_M} m)")

    # -- 5
    def closure_solve(self):
        obs, valid, poses = inputs(self.scen, "cuda")
        state, _ = run_pass(obs[:CLOSURE_FRAME], valid[:CLOSURE_FRAME],
                            poses[:CLOSURE_FRAME], configs()["first"])
        g = self.closure_graph = state.graph
        cfg = _gn_config(configs()["first"])
        sizes = []
        kernel = C.cholesky_kernel

        def recording(a):
            sizes.append(a.shape[0])
            self.closure_s = a
            return kernel(a)

        C.cholesky_kernel = recording
        try:
            A.launches = C.launches = 0
            with_k = gn.optimize(g, dataclasses.replace(cfg, use_cholesky_kernel=True))
            torch.cuda.synchronize()
            launches = C.launches
        finally:
            C.cholesky_kernel = kernel
        without = gn.optimize(g, cfg)
        self.log(f"closure: graph of {int(g.n_poses)} poses, {int(g.n_obs)} edges, "
                 f"{int(g.n_landmarks)} landmarks; factorized sizes {sizes}; "
                 f"cholesky launches {launches}")
        if launches == 0 or not sizes or set(sizes) != {CLOSURE_N}:
            raise AssertionError(f"closure solve: sizes {sizes}, launches {launches}")
        torch.testing.assert_close(with_k.poses, without.poses, atol=POSE_ATOL, rtol=0)
        torch.testing.assert_close(with_k.lm_xy, without.lm_xy, atol=POSE_ATOL, rtol=0)
        dp = float((with_k.poses - without.poses).abs().max())
        dl = float((with_k.lm_xy - without.lm_xy).abs().max())
        self.log(f"closure: kernel vs cholesky_ex: max|dpose| {dp:.3g}, max|dlm| {dl:.3g} "
                 f"(atol {POSE_ATOL})")
        self.kernels["cholesky"]["launches"] = launches
        self.kernels["cholesky"].setdefault("launches_by_path", {})["closure"] = launches
        self.closure_accuracy(self.closure_s)

    def closure_accuracy(self, s, kernel=None, twin=None, what="S"):
        """The closure's S is ill-conditioned in its last pose rows, where FP32
        factors in different summation orders differ by more than the twin
        tolerance of phase 2. So on S each FP32 factor (kernel,
        `torch.linalg.cholesky_ex`, plain twin) is held to the float64 one.
        The kernel must be as close to it as the farther of the two
        references, and its backward error |LL^T - S| must stay within the
        bound every FP32 Cholesky meets whatever its summation order,
        gamma_{n+1} |L| |L^T| elementwise (Higham, Accuracy and Stability of
        Numerical Algorithms, Thm 10.3). Every factorization reads only the
        lower triangle, and the GN's S is symmetric only up to the rounding
        of its matmul, so the backward error is taken against the lower
        triangle mirrored: the matrix all three factor."""
        n = s.shape[0]
        s64 = torch.tril(s.double())
        s64 = s64 + torch.tril(s64, -1).T
        exact = torch.linalg.cholesky(s64)
        u = 2.0 ** -24
        gamma = (n + 1) * u / (1 - (n + 1) * u)
        factors = {"kernel": C.cholesky_kernel(s) if kernel is None else kernel,
                   "cholesky_ex": torch.linalg.cholesky_ex(s).L,
                   "twin": C.cholesky_plain(s) if twin is None else twin}
        gap, ratio = {}, {}
        for name, f in factors.items():
            l = f.double()
            resid = (l @ l.T - s64).abs()
            gap[name] = float((l - exact).abs().max())
            ratio[name] = float((resid / (l.abs() @ l.abs().T).clamp_min(1e-300)).max())
            self.log(f"closure: {what} by {name}: max|L - L_float64| {gap[name]:.4g}, "
                     f"max|LL^T - S| {float(resid.max()):.4g}, backward error / gamma_(n+1) "
                     f"{ratio[name] / gamma:.4g}")
        self.log(f"closure: {what} in float64: condition number "
                 f"{float(torch.linalg.cond(s64)):.3g}, smallest pivot "
                 f"{float(exact.diagonal().min()):.3g}; max|kernel - twin| "
                 f"{float((factors['kernel'] - factors['twin']).abs().max()):.3g}")
        if gap["kernel"] > max(gap["cholesky_ex"], gap["twin"]):
            raise AssertionError(f"closure: the kernel's factor of {what} is farther from "
                                 f"float64 than both references: {gap}")
        if ratio["kernel"] > gamma:
            raise AssertionError(f"closure: the kernel's backward error on {what} is "
                                 f"{ratio['kernel'] / gamma:.3g} x gamma_(n+1)")

    # -- 6
    @staticmethod
    def laps(obs, valid, poses):
        """name -> one lap: the per-frame engine and the blocked pipeline
        (block BLOCK), each in both configurations, then the improved laps
        of IMPROVED_TIMED."""
        out = {}
        for name, cfg in configs().items():
            out[name] = functools.partial(run_pass, obs, valid, poses, cfg)
            out[f"blocked {name}"] = functools.partial(run_pass_blocked, obs, valid, poses, cfg,
                                                       block=BLOCK)
        cfgs = improved_configs()
        for run in IMPROVED_TIMED:
            name, block = IMPROVED_RUNS[run]
            out[f"improved {run}"] = functools.partial(improved_lap, cfgs[name], block, obs,
                                                       valid, poses)
        return out

    def timing(self):
        obs, valid, poses = inputs(self.scen, "cuda")
        t = obs.shape[0]
        lap_ms = {}
        for name, lap in self.laps(obs, valid, poses).items():
            lap()                                        # warm-up
            laps = sorted(cuda_ms(lap, reps=1, warmup=False) for _ in range(LAPS_TIMED))
            lap_ms[name] = ms = laps[len(laps) // 2]
            self.log(f"timing: {name} lap: median {ms:.1f} ms of {LAPS_TIMED} laps "
                     f"(min {laps[0]:.1f}, max {laps[-1]:.1f}) for {t} frames = "
                     f"{t / ms * 1e3:.1f} frames/s [{self.card}]")
        self.assoc_timing()
        s = self.closure_s
        n = s.shape[0]
        k = self.kernels["cholesky"]
        run = functools.partial(C.cholesky_kernel, s)
        library = functools.partial(torch.linalg.cholesky_ex, s)
        turns = [cuda_ms(f, reps=20) for f in (library, run, run, library)]
        k["ms"], k["library_ms"] = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        k["plain_ms"] = cuda_ms(lambda: C.cholesky_plain(s), reps=3)
        k["device_ms"] = self.device_ms("cholesky", "persistent_cholesky", run, reps=20)
        k["bound_ms"], k["bound_by"] = bound(n ** 3 / 3, 2 * n * n * s.element_size())
        self.batched_kernel_timing()
        self.lap_profile(obs, valid, poses, lap_ms)
        self.batched_timing()
        self.fusion_timing()
        for k in self.kernels.values():
            self.log(f"timing: {k['name']} per wrapper call {k['ms'] * 1e3:.1f} us, device "
                     f"{k['device_ms'] * 1e3:.2f} us per launch, plain twin "
                     f"{k['plain_ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.4g} us "
                     f"({k['bound_by']}) [{self.card}]")
        self.log(f"timing: cholesky n={n}: kernel {turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us, "
                 f"torch.linalg.cholesky_ex {turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us "
                 f"(in turns: library, kernel, kernel, library) [{self.card}]")

    def batched_timing(self):
        """Batched compat passes at BATCHED_SWEEP sessions (CUDA events, median
        of BATCHED_LAPS_TIMED after a warm-up; frames/s = S x t_b per pass),
        each with its device-busy share, launches and reads from one profiled
        pass, and the 16 single-session blocked laps of the same sessions
        run one after another."""
        obs_n, valid_n, poses_n, t = batched_scenario(self.track, len(self.scen.times))
        ins = [torch.tensor(x, device="cuda") for x in (obs_n, valid_n, poses_n)]
        cap = batched_cap(t)
        cfg = batched_configs(cap)["first"]
        per_pass = {}

        def batched_pass(S):
            reps = -(-S // BATCHED_SESSIONS)
            o, v, p = (x.repeat((reps,) + (1,) * (x.dim() - 1))[:S] for x in ins)
            return lambda: run_sequences_blocked_batched(initial_states(cap, S, "cuda"), o, v, p,
                                                         cfg, block=BLOCK)

        def singles():
            for s in range(BATCHED_SESSIONS):
                run_pass_blocked(ins[0][s], ins[1][s], ins[2][s], cfg, block=BLOCK)

        runs = {f"batched S={S}": (S, batched_pass(S)) for S in BATCHED_SWEEP}
        runs[f"{BATCHED_SESSIONS} single-session laps in turn"] = (BATCHED_SESSIONS, singles)
        step, steps = gn.gn_step, []

        def counting(g, c):
            steps.append(1)
            return step(g, c)

        for name, (S, fn) in runs.items():
            fn()
            ms = statistics.median(cuda_ms(fn, reps=1, warmup=False)
                                   for _ in range(BATCHED_LAPS_TIMED))
            steps.clear()
            gn.gn_step = counting
            try:
                busy, kernels, reads = profile_counts(fn)
            finally:
                gn.gn_step = step
            per_pass[name] = (ms, kernels, reads)
            self.log(f"timing: {name}: median {ms:.1f} ms of {BATCHED_LAPS_TIMED} passes for "
                     f"{S} x {t} frames = {S * t / ms * 1e3:.1f} frames/s; device busy "
                     f"{busy:.1f} ms ({100 * busy / ms:.1f}%), {kernels} kernel launches and "
                     f"{reads} device-to-host reads per pass, {len(steps)} closure-GN steps "
                     f"[{self.card}]")
        k1, k16 = per_pass["batched S=1"][1], per_pass[f"batched S={BATCHED_SESSIONS}"][1]
        self.log(f"timing: batched S={BATCHED_SESSIONS} pass makes {k16 / k1:.2f} x the kernel "
                 f"launches of the S=1 pass ({k16} / {k1})")
        if k16 > 2 * k1:
            raise AssertionError(f"batched S={BATCHED_SESSIONS}: {k16} launches, more than "
                                 f"twice the {k1} of S=1")

    def fusion_timing(self):
        """bench.py's fusion section, piece by piece: the batched improved
        pass at S = FUSION_SESSIONS, block 16, in both configurations
        (frames/s, and for bench.py's dense one, from one profiled pass, its
        device-busy share, launches and device-to-host reads); one `fuse_sessions(align=False)`
        of phase `fusion`'s dense sessions alone, its joint GN alone and one
        `torch.linalg.cholesky_ex` of the GN's reduced system; one drifted
        `fuse_sessions(align=True, robust=True)` alone; and the association
        kernel's Mahalanobis form at ASSOC_FUSION's shapes beside its twin,
        with its bound, into the `kernels` line's "fusion"."""
        obs_n, valid_n, poses_n, t = fusion_scenario(self.track)
        ins = [torch.tensor(x, device="cuda") for x in (obs_n, valid_n, poses_n)]
        cap = fusion_cap(t)
        S = FUSION_SESSIONS
        for name, cfg in fusion_configs(cap).items():
            def one_pass(cfg=cfg):
                return blocked_core_batched(initial_states(cap, S, "cuda"), *ins, cfg,
                                            FUSION_BLOCK)
            one_pass()
            ms = statistics.median(cuda_ms(one_pass, reps=1, warmup=False) for _ in range(3))
            self.log(f"timing: fusion batched improved pass {name} S={S} block {FUSION_BLOCK}: "
                     f"median {ms:.1f} ms of 3 passes for {S} x {t} frames = "
                     f"{S * t / ms * 1e3:.1f} frames/s [{self.card}]")
            if name == "dense":     # bench.py's configuration; the profile is slow to read
                busy, kernels, reads = profile_counts(one_pass)
                self.log(f"timing: fusion batched improved pass dense: device busy {busy:.1f} "
                         f"ms ({100 * busy / ms:.1f}%), {kernels} kernel launches and {reads} "
                         f"device-to-host reads per pass [{self.card}]")
        cfg, run = self.fusion_run
        gcfg, gate = fusion_gn_config(cfg), cfg.same_cone_threshold
        states, states_d = run["states"], run["states_d"]
        pieces = {
            "fuse_sessions(align=False) with the joint GN": functools.partial(
                fuse_sessions, states.graph, cfg=gcfg, gate=gate, lm_info=states.lm_info_xy,
                align=False),
            "fuse_sessions(align=False) without the GN (the merge)": functools.partial(
                fuse_sessions, states.graph, cfg=None, gate=gate, lm_info=states.lm_info_xy,
                align=False),
            "drifted fuse_sessions(align=True, robust=True) with the joint GN": functools.partial(
                fuse_sessions, states_d.graph, cfg=gcfg, gate=2.0 * gate,
                lm_info=states_d.lm_info_xy, align=True, robust=True),
        }
        merged, _ = pieces["fuse_sessions(align=False) without the GN (the merge)"]()
        pieces["the joint GN alone"] = functools.partial(gn.optimize, merged, gcfg)
        for what, fn in pieces.items():
            fn()
            ms = statistics.median(cuda_ms(fn, reps=1, warmup=False) for _ in range(3))
            busy, kernels, reads = profile_counts(fn)
            self.log(f"timing: {what}: median {ms:.2f} ms of 3, device busy {busy:.2f} ms "
                     f"({100 * busy / ms:.1f}%), {kernels} kernel launches, {reads} "
                     f"device-to-host reads [{self.card}]")
        library, systems = torch.linalg.cholesky_ex, []

        def recording(a, *args, **kw):
            systems.append(a)
            return library(a, *args, **kw)

        torch.linalg.cholesky_ex = recording
        try:
            gn.gn_step(merged, gcfg)
        finally:
            torch.linalg.cholesky_ex = library
        a = systems[0]
        n = a.shape[-1]
        ms = cuda_ms(functools.partial(torch.linalg.cholesky_ex, a), reps=5)
        b_ms, b_by = bound(n ** 3 / 3, 2 * a.numel() * a.element_size())
        self.log(f"timing: torch.linalg.cholesky_ex of the joint GN's reduced system, n={n}: "
                 f"{ms:.3f} ms per call (bound {b_ms:.3f} ms, {b_by}) [{self.card}]")
        k = self.kernels["assoc"]
        k["fusion"] = {}
        for path, (s_, n, m) in ASSOC_FUSION.items():
            worlds = [assoc_world(n, m, i) for i in range(s_)]
            oxy, ot, lxy, lt, cov = (torch.stack([w[j] for w in worlds]) for j in range(5))
            call = functools.partial(A.associate_kernel, oxy, ot, lxy, lt, 9.21, cov,
                                     mahalanobis=True)
            nbytes = sum(x.numel() * x.element_size() for x in (oxy, ot, lxy, lt, cov, *call()))
            r = dict(shape=[s_, n, m], launches=k["launches_by_path"][path],
                     max_abs_err=k["max_abs_err"],
                     ms=statistics.median(cuda_ms(call, reps=100) for _ in range(5)),
                     device_ms=self.device_ms("assoc", "assoc_kernel", call, reps=50),
                     plain_ms=cuda_ms(functools.partial(A.associate_plain, oxy, ot, lxy, lt, 9.21,
                                                        cov, mahalanobis=True), reps=50),
                     library_ms=None)
            r["bound_ms"], r["bound_by"] = bound(s_ * assoc_flop(n, m, True), nbytes)
            k["fusion"][path] = r
            self.log(f"timing: assoc {path} mahalanobis S={s_} N={n} M={m}: per wrapper call "
                     f"{r['ms'] * 1e3:.2f} us, device {r['device_ms'] * 1e3:.2f} us per launch, "
                     f"plain twin {r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.4g} us"
                     f" ({r['bound_by']}) [{self.card}]")

    def batched_kernel_timing(self):
        """Both kernels at the batched path's shapes, each beside its twin and
        its library call, into the `kernels` line's "batched": the
        association kernel on 16 sessions of `assoc_world`, the Cholesky
        kernel on the first iteration's [16, 1152, 1152] of phase `batched`,
        also against 16 single launches in turn."""
        S, n, m = ASSOC_BATCHED["batched16"]
        worlds = [assoc_world(n, m, i) for i in range(S)]
        oxy, ot, lxy, lt, _ = (torch.stack([w[k] for w in worlds]) for k in range(5))
        run = functools.partial(A.associate_kernel, oxy, ot, lxy, lt, 1.44)
        nbytes = sum(x.numel() * x.element_size() for x in (oxy, ot, lxy, lt, *run()))
        r = dict(shape=[S, n, m], launches=self.kernels["assoc"]["launches_by_path"]["batched"],
                 max_abs_err=self.kernels["assoc"]["max_abs_err"],
                 ms=statistics.median(cuda_ms(run, reps=100) for _ in range(5)),
                 device_ms=self.device_ms("assoc", "assoc_kernel", run, reps=50),
                 plain_ms=cuda_ms(functools.partial(A.associate_plain, oxy, ot, lxy, lt, 1.44),
                                  reps=50), library_ms=None)
        r["bound_ms"], r["bound_by"] = bound(S * assoc_flop(n, m, False), nbytes)
        self.kernels["assoc"]["batched"] = r
        self.log(f"timing: assoc batched16 S={S} N={n} M={m}: per wrapper call "
                 f"{r['ms'] * 1e3:.2f} us, device {r['device_ms'] * 1e3:.2f} us per launch, plain "
                 f"twin {r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.4g} us "
                 f"({r['bound_by']}) [{self.card}]")

        a = self.batched_s
        S, n = a.shape[0], a.shape[-1]
        run = functools.partial(C.cholesky_kernel, a)
        library = functools.partial(torch.linalg.cholesky_ex, a)

        def one_by_one():
            for i in range(S):
                C.cholesky_kernel(a[i])

        turns = [cuda_ms(f, reps=10) for f in (library, run, run, library)]
        r = dict(shape=[S, n, n], launches=self.kernels["cholesky"]["launches_by_path"]["batched"],
                 max_abs_err=self.kernels["cholesky"]["max_abs_err"],
                 ms=(turns[1] + turns[2]) / 2, library_ms=(turns[0] + turns[3]) / 2,
                 device_ms=self.device_ms("cholesky", "persistent_cholesky", run, reps=10),
                 singles_ms=cuda_ms(one_by_one, reps=5),
                 plain_ms=cuda_ms(lambda: C.cholesky_plain(a), reps=2))
        r["bound_ms"], r["bound_by"] = bound(S * n ** 3 / 3, 2 * a.numel() * a.element_size())
        self.kernels["cholesky"]["batched"] = r
        self.log(f"timing: cholesky batched S={S} n={n}: per wrapper call {r['ms'] * 1e3:.1f} us "
                 f"(turns {turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f}), device "
                 f"{r['device_ms'] * 1e3:.1f} us per launch; torch.linalg.cholesky_ex on the "
                 f"batch {turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us; {S} single kernel "
                 f"launches in turn {r['singles_ms'] * 1e3:.1f} us; plain twin "
                 f"{r['plain_ms'] * 1e3:.1f} us; bound {r['bound_ms'] * 1e3:.4g} us "
                 f"({r['bound_by']}) [{self.card}]")

    def assoc_timing(self):
        """The association kernel at each of ASSOC_SHAPES, Euclidean and
        Mahalanobis: time per wrapper call (CUDA events over 100 back-to-back
        calls, median of 5 such runs: the host is noisy), device time per
        launch (profiler), the plain twin's time and the bound. The blocked
        pipeline's Euclidean shape on the bench lap (blocked16) fills the
        `kernels` line."""
        k = self.kernels["assoc"]
        k["library_ms"] = None    # no single PyTorch call computes it
        k["shapes"] = {}
        for shape, (n, m) in ASSOC_SHAPES.items():
            for mahal in (False, True):
                oxy, ot, lxy, lt, cov = assoc_world(n, m, 0)
                gate2 = 9.21 if mahal else 1.44
                run = functools.partial(A.associate_kernel, oxy, ot, lxy, lt, gate2, cov,
                                        mahalanobis=mahal)
                ins = (oxy, ot, lxy, lt, cov) if mahal else (oxy, ot, lxy, lt)
                nbytes = sum(x.numel() * x.element_size() for x in (*ins, *run()))
                r = dict(ms=statistics.median(cuda_ms(run, reps=100) for _ in range(5)),
                         device_ms=self.device_ms("assoc", "assoc_kernel", run, reps=50),
                         plain_ms=cuda_ms(functools.partial(
                             A.associate_plain, oxy, ot, lxy, lt, gate2, cov,
                             mahalanobis=mahal), reps=50))
                r["bound_ms"], r["bound_by"] = bound(assoc_flop(n, m, mahal), nbytes)
                key = f"{shape}{'_mahalanobis' if mahal else ''}"
                k["shapes"][key] = r
                self.log(f"timing: assoc {key} N={n} M={m}: per wrapper call "
                         f"{r['ms'] * 1e3:.2f} us, device {r['device_ms'] * 1e3:.2f} us per "
                         f"launch, plain twin {r['plain_ms'] * 1e3:.1f} us, bound "
                         f"{r['bound_ms'] * 1e3:.4g} us ({r['bound_by']}) [{self.card}]")
        k.update({f: k["shapes"]["blocked16"][f]
                  for f in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")})

    def assoc_plans(self):
        """`--assoc-plans`: the association kernel's device time per launch
        (profiler) at each of ASSOC_SHAPES for every cluster size of
        ASSOC_PLANS, the one `_plan` picks marked; each result is held to the
        twin."""
        plan = A._plan
        try:
            for shape, (n, m) in ASSOC_SHAPES.items():
                picked = plan(n, m, A._sms(0))
                oxy, ot, lxy, lt, cov = assoc_world(n, m, 0)
                for mahal in (False, True):
                    gate2 = 9.21 if mahal else 1.44
                    want = A.associate_plain(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahal)
                    times = []
                    for p in ASSOC_PLANS:
                        A._plan = lambda *_, p=p: p
                        run = functools.partial(A.associate_kernel, oxy, ot, lxy, lt, gate2, cov,
                                                mahalanobis=mahal)
                        if not all(torch.equal(g, w) for g, w in zip(run(), want)):
                            raise AssertionError(f"assoc plan {p} at {shape}: differs from twin")
                        us = self.device_ms("assoc", "assoc_kernel", run, reps=20, rows=False) * 1e3
                        times.append(f"{p}{'*' if p == picked else ''} {us:.2f}")
                    self.log(f"plans: assoc {shape}{' mahalanobis' if mahal else ''} N={n} M={m}"
                             f": device us per launch by cluster size: " + ", ".join(times)
                             + f" [{self.card}]")
        finally:
            A._plan = plan

    def assoc_host(self):
        """`--assoc-plans`: host time per call of the association wrapper at
        the lap shape and of the pieces it is made of (host clock over many
        calls; the kernel is shorter than the wrapper, so the device never
        holds the host back)."""
        n, m = ASSOC_SHAPES["lap"]
        oxy, ot, lxy, lt, _ = assoc_world(n, m, 0)
        rows, valid, _, _, count = assoc_masked_world(0)[1:]
        dev = oxy.device

        def three():
            return (torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty(n, dtype=torch.float32, device=dev),
                    torch.empty(n, dtype=torch.bool, device=dev))

        pieces = {
            "wrapper": functools.partial(A.associate_kernel, oxy, ot, lxy, lt, 1.44),
            "wrapper, masked form": functools.partial(
                A.associate_kernel, oxy, rows[:, 3], lxy, lt, 1.44, obs_valid=valid,
                lm_count=count),
            "three torch.empty": three,
            "torch.cuda.current_stream(dev).cuda_stream":
                lambda: torch.cuda.current_stream(dev).cuda_stream,
            "the C entry through ctypes, N = 0 (returns before any launch)":
                functools.partial(A._load().tpuslam_assoc, *[0] * 10, 1, 0, m, 1.44,
                                  0, 1, *[0] * 4),
        }
        for name, fn in pieces.items():
            runs = []
            for _ in range(6):    # the first run warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                runs.append((time.perf_counter() - t0) / 1000 * 1e6)
            torch.cuda.synchronize()
            self.log(f"host: {name}: {statistics.median(runs[1:]):.2f} us per call (host "
                     f"clock, median of 5 x 1000 calls; min {min(runs[1:]):.2f}) [{self.card}]")

    def device_ms(self, name: str, symbol: str, fn, reps: int, rows: bool = True) -> float:
        """Device time per launch of kernel `name` (the `__global__` function
        `symbol`), from torch.profiler over `reps` calls of its wrapper `fn`.
        Logs every device row (unless not `rows`) and fails unless each call
        launched the kernel exactly once, by the wrapper's launch count. The
        profiler sometimes delivers fewer device events than ran (whole
        calls missing), so a window that shows fewer launches than calls is
        profiled again, up to PROFILE_TRIES times; if the last one still
        does, the time is the mean over the launches it saw (at least half
        of them), and the log says so."""
        from torch.profiler import ProfilerActivity, profile
        counter = {"assoc": A, "cholesky": C}[name]
        fn()
        torch.cuda.synchronize()
        for _ in range(PROFILE_TRIES):
            before = counter.launches
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            launched = counter.launches - before
            found = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            kernel = [e for e in found if symbol in e.key]
            counts = [e.count for e in kernel]
            if counts == [reps] or len(counts) != 1 or counts[0] > reps:
                break
            self.log(f"timing: {name}: the profiler saw {counts[0]} of {reps} launches; "
                     "profiling again")
        for e in found if rows else ():
            self.log(f"timing: {name} device row {e.key[:70]!r}: {e.count / reps:g} per call, "
                     f"{e.self_device_time_total / e.count:.2f} us each [{self.card}]")
        if launched != reps or len(counts) != 1 or not reps // 2 <= counts[0] <= reps:
            raise AssertionError(f"{name}: want one kernel launch per call: the wrapper "
                                 f"launched {launched} in {reps} calls, profiler rows "
                                 f"{[(e.key, e.count) for e in kernel]}")
        if counts[0] < reps:
            self.log(f"timing: {name}: device time per launch is the mean over the "
                     f"{counts[0]} of {reps} launches the profiler saw")
        return kernel[0].self_device_time_total / counts[0] / 1e3

    def lap_profile(self, obs, valid, poses, lap_ms):
        """Device-busy share of each lap, from one lap under torch.profiler:
        device time summed over kernels and copies, against the unprofiled
        lap time; plus kernel launches and device-to-host reads per frame.
        Then the same for the closure GN alone, the part of every lap that
        the blocks do not change."""
        t = obs.shape[0]
        for name, lap in self.laps(obs, valid, poses).items():
            busy, kernels, reads = profile_counts(lap)
            if busy == 0.0:
                self.log(f"timing: {name} lap device busy share: not measured "
                         "(the profiler saw no device time)")
                continue
            self.log(f"timing: {name} lap device busy {busy:.1f} ms of {lap_ms[name]:.1f} ms "
                     f"({100 * busy / lap_ms[name]:.1f}%), {kernels / t:.1f} kernel launches "
                     f"and {reads / t:.2f} device-to-host reads per frame [{self.card}]")
        solve = functools.partial(gn.optimize, self.closure_graph, _gn_config(configs()["first"]))
        ms = statistics.median(cuda_ms(solve, reps=1) for _ in range(5))
        busy, kernels, reads = profile_counts(solve)
        self.log(f"timing: closure GN alone (cholesky_ex): median {ms:.1f} ms of 5, device busy "
                 f"{busy:.1f} ms, {kernels} kernel launches, {reads} device-to-host reads "
                 f"[{self.card}]")
        firing = functools.partial(periodic_gn, self.firing_graph, improved_configs()["I1"])
        ms = statistics.median(cuda_ms(firing, reps=1) for _ in range(5))
        busy, kernels, reads = profile_counts(firing)
        self.log(f"timing: one periodic window-GN firing alone (I1, window 64, graph after "
                 f"{FIRING_FRAME} frames): median {ms:.2f} ms of 5, device busy {busy:.2f} ms, "
                 f"{kernels} kernel launches, {reads} device-to-host reads [{self.card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the GN contract is full FP32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        print("chip_smoke: TF32 could not be switched off", file=sys.stderr)
        return 1
    smoke = Smoke()
    phases = (smoke.build, smoke.kernels_vs_plain, smoke.compat, smoke.kernel_association,
              smoke.blocked, smoke.improved, smoke.batched, smoke.fusion, smoke.closure_solve,
              smoke.timing)
    if sys.argv[1:] == ["--assoc-plans"]:
        phases = (smoke.build, smoke.assoc_plans, smoke.assoc_host)
    elif sys.argv[1:]:
        print(f"usage: {sys.argv[0]} [--assoc-plans]", file=sys.stderr)
        return 2
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:  # noqa: BLE001 - report the failed phase, then stop
            traceback.print_exc()
            print(f"chip_smoke: phase {phase.__name__} failed", file=sys.stderr)
            return 1
        smoke.log(f"phase {phase.__name__}: ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
