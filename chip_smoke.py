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
  service  — the live service: the bench lap written as a .rec and replayed
               through `SlamService.run_replay` in both configurations
               (SERVICE_CONFIGS, every frame a keyframe), each held to
               SERVICE_REFERENCE and to the direct `Slam.run_scenario` on
               the card (every keyframe's outputs and published message),
               with the kernel one association launch per keyframe at
               64 x 256; the CTRV EKF (BASELINE config 2 and the skidpad lap
               through `Slam(use_ekf_fusion=True)`, held to EKF_REFERENCE);
               a checkpoint resume with an open frame and the EKF, held to
               the uninterrupted run;
  lidar    — bench.py's two vlp16_frontend scenes through `detect_cones`
               at its default seed, whose triples are the JAX package's,
               held to VLP16_REFERENCE and to its CPU run; the full-sweep
               replay through the service, held to
               tests/test_perception.py's bounds;
  5. closure solve — `gauss_newton.optimize` on the graph the closure GN
               solves, through the Cholesky kernel and through
               `torch.linalg.cholesky_ex`, and the kernel's factor of the
               solve's ill-conditioned matrix held to a float64 factor; the
               same solve under `GNConfig.matmul_precision` 'high' (TF32)
               and 'default' (bf16), each one's deviation from 'highest'
               printed ('high' within GN_PRECISION_RTOL), TF32 off again
               after each;
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
               association kernel at the fusion shapes; the service replay's
               ms per keyframe, launches and reads, one EKF message, and
               `detect_cones` at both scenes in sweeps/s beside 10 Hz.
  parallel — the multi-device tier on a one-rank NCCL mesh, each path
               timed: the per-frame batched engine (`run_passes_batched`) on
               the batched scenario in both configurations, held to
               BATCHED_REFERENCE and to each session's `run_sequence`, one
               association launch per frame for all sessions with the
               kernel; `run_fleet_blocked` held to
               `run_sequences_blocked_batched`, one launch per block;
               `distributed_optimize` on the closure graph through the
               Cholesky kernel at n = DISTRIBUTED_N, held to
               `gauss_newton.optimize` and DISTRIBUTED_REFERENCE;
               `multisession_optimize` on the batched sessions' graphs;
               `fuse_sessions(mesh=...)` held to FUSION_REFERENCE; the
               blocked lap with the mesh-sharded map (`assoc_mesh`) held to
               the lap without it; then the same mesh paths in a spawned
               world of GLOO_RANKS gloo ranks on cuda:0, held to the
               one-rank results; after phase 6, as its kernel
               rows need exact profiler counts. Beside the vectorized step,
               the scan-form mapping step of the per-frame batched engine
               (all sessions stepped together) on the first
               PARALLEL_SCAN_FRAMES frames: its launches per frame, held
               under SCAN_LAUNCHES_PER_FRAME.
  chain    — the pose-chain solvers (replicated, 'dd', resident, 'hier',
               'hier3') on bench_scaling.py's chain graph and on the
               fusion's joint graph (n = 9216), and `fuse_sessions`' chain
               solvers: each on a one-rank NCCL chain mesh (timed, its
               payload per iteration counted against `comm_model`), then in
               a spawned world of CHAIN_RANKS gloo ranks on cuda:0; each
               held to the single-device `gauss_newton.optimize` within the
               JAX tests' bounds (CHAIN_ATOL), no kernel launched (the
               solvers factor with `cholesky_ex`, as the JAX package's).
  resident — the map-resident online pass (`run_pass_resident_online`) on
               the bench lap in RESIDENT_RUNS' five configurations, on a
               one-rank NCCL ('map',) mesh and in a spawned world of
               RESIDENT_RANKS gloo ranks on cuda:0 (64 landmark slots each),
               each held to the dense `run_pass_blocked` of its
               configuration and block on the card (tests/test_resident_
               online.py's rules) and to REFERENCE's counts where they
               apply, the world to the one-rank runs; every returned shard
               of Lb rows; no kernel launched (the pass factors with
               `cholesky_ex` and gates densely, as the JAX package's);
               the collectives per keyframe of each run, and the
               RESIDENT_TIMED laps timed beside their dense laps.
  cli      — the port's command line (`cli.main.main`, `slamctl-torch`) in
               this process on the card: `sim skidpad` (live, with
               --rec-out) held to the same command on the CPU; `sim
               trackdrive` live, blocked and resident (block CLI_BLOCK, the
               resident one on a one-rank NCCL world the CLI makes and
               destroys), the two passes held to the live run's counts, each
               run's frames/s beside the direct `Slam.run_scenario` /
               `run_pass_blocked` / `run_pass_resident_online` lap of the
               same call; `replay --checkpoint` of the recording and
               `load_checkpoint` of that file; `export` (jsonl, csv) and
               `msc`; `fuse --sessions 2` held to the CPU run; the native
               codec built with g++, its scan of the recording equal to
               Python's framing; `trace_session` around one blocked lap in
               a fresh process (no earlier profile there), its trace file
               holding the lap's stage and CUDA kernel events; `entry()` against
               the same call on the CPU; `dryrun_multichip(1)` on one NCCL
               rank. No kernel is launched (no command sets a kernel
               switch, as in the JAX package), and no PNG is asked for
               (the machine has no matplotlib).
  deploy   — the deployment surface: the multi-process smoke
               (`tpuslam_torch.deploy.multihost_smoke`) in groups of
               DEPLOY_PROCS spawned ranks (one NCCL rank, then gloo ranks on
               cuda:0), every rank's multi-session GN and fleet held to its
               single-device solve, and its death case (the last rank
               SIGKILLed once up; the survivors must exit nonzero, not
               hang); `tpuslam_torch.scripts.bench_chain_solvers` at its
               default sizes on one NCCL rank, each row's n_shared held to
               the CPU plan's; the wheel of the tree built and installed
               with --target, and in a fresh process with nothing of the
               checkout on its path both kernels built by nvcc from that
               copy and each launched once against its twin. No kernel is
               launched in this process.
It prints a `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Without a
CUDA device it fails before any phase. It imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
from tpuslam_torch.parallel.batch import initial_states, run_passes_batched
from tpuslam_torch.parallel.fusion import fuse_sessions, fusion_report
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.core.slam import Slam, _geo_from_local
from tpuslam_torch.frontend import motion
from tpuslam_torch.geometry import wgs84
from tpuslam_torch.geometry.spherical import cone_to_global
from tpuslam_torch.io import messages as M
from tpuslam_torch.io.rec import RecWriter
from tpuslam_torch.perception.attention import AttentionConfig, detect_cones, ransac_triples
from tpuslam_torch.perception.vlp16 import decode_point_cloud_reading
from tpuslam_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.runtime.service import SlamService, scenario_to_rec
from tpuslam_torch.scripts.bench_chain_solvers import card, synth as chain_synth
from tpuslam_torch.sim import SimConfig, acceleration, ate, simulate, skidpad, trackdrive
from tpuslam_torch.sim.vlp16_sim import (
    Vlp16SceneConfig, render_scene, scene_to_point_cloud_reading,
)

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
# The live service (`runtime/service.py`): the bench lap written as a .rec by
# `scenario_to_rec` and replayed through `SlamService.run_replay`, with the
# keyframe gate below the lap's 100 ms frame spacing, so every frame is a
# keyframe; compat 'first' and 'nearest' through the association kernel
SERVICE_KEYFRAME_MS = 50.0
SERVICE_CONFIGS = {"first": {}, "nearest": dict(association="nearest",
                                                use_pallas_association=True)}
# The JAX package's `SlamService` replay of that .rec on the CPU, the same in
# both configurations; tests/test_torch_service_reference.py recomputes it
SERVICE_REFERENCE = dict(keyframes=326, closure_frame=212, n_landmarks=112, n_obs=1974,
                         sends=113, ate_published=0.210073)
# BASELINE config 2, the acceleration straight with the CTRV EKF at 20 Hz
# (tests/test_motion.py:57-77), and the skidpad lap through
# `Slam(use_ekf_fusion=True)` (tests/test_motion.py:80-96); the JAX
# package's numbers on the CPU, recomputed by
# tests/test_torch_service_reference.py
EKF_ACCEL_SIM = dict(laps=0.95, keyframe_dt=0.05, speed=10.0, gps_noise=0.25, seed=44)
EKF_SKIDPAD_SIM = dict(laps=1.3, seed=51, keyframe_dt=0.1)
EKF_SKIDPAD_CAP = GraphCapacity(128, 64, 2048)
EKF_REFERENCE = dict(accel_ate_gps=0.367423, accel_ate_ekf=0.070597,
                     skidpad=dict(closure_frame=65, n_landmarks=41, n_obs=465, sends=27,
                                  ate_published=0.114627, map_err_median=0.255198))
# The checkpoint resume (tests/test_runtime.py:163-204): the skidpad lap with
# the EKF, saved at half the lap with an open cone frame
RESUME_SIM = dict(laps=1.2, seed=7)
# bench.py's vlp16_frontend section (bench.py:982-1042): the 24-cone dense
# scene (seed 3, 4,096-point buffer, dense clustering) and the full
# 28,800-return sweep with the surround wall (seed 4, 32,768-point buffer,
# grid clustering). The JAX package's detections with its seed-0 RANSAC
# triples, on the CPU; tests/test_torch_service_reference.py recomputes them
VLP16_REFERENCE = {
    "dense": dict(points=2940, triples=[
        [869, 336, 4040], [2621, 3, 4051], [1168, 543, 1653], [1083, 1380, 2826],
        [600, 2883, 2779], [3683, 406, 146], [4074, 125, 2043], [1592, 2492, 1939],
        [2917, 381, 2932], [1033, 728, 3140]], cones=[
        [15.330334, 1.346462, 7.530363, 0.0], [25.462856, 1.093179, 8.806123, 0.0],
        [12.305235, 1.082450, 9.637036, 0.0]]),
    "full_sweep": dict(points=28800, triples=[
        [869, 8528, 24520], [27197, 3, 12243], [17552, 4639, 26229], [5179, 9572, 27402],
        [4696, 2883, 27355], [24163, 24982, 16530], [16362, 125, 14331], [26168, 2492, 1939],
        [15205, 8573, 2932], [5129, 728, 15428]], cones=[
        [31.700138, 3.715864, 3.299183, 0.0], [-23.200703, 1.216018, 6.289563, 0.0],
        [-5.999669, 1.786443, 6.630686, 0.0], [-16.600180, 1.964437, 7.411248, 0.0],
        [24.899565, 1.646880, 7.765529, 0.0], [-10.299736, 1.386880, 8.081858, 0.0],
        [3.199887, 1.074459, 8.497897, 0.0], [-4.399520, 0.437576, 9.494285, 0.0]]),
}
VLP16_ATOL = 1e-3           # cone tuples: metres in the range column, degrees in the angle columns
VLP16_RATE_HZ = 10.0        # the sensor's revolutions per second
# the full-sweep replay (tests/test_perception.py:325-373): four sweeps and
# GPS fixes 2 m apart through the service, the cones 1.5 m from the lidar
SWEEP_REPLAY_CONES = [[8.0, 1.5], [11.0, -1.5], [14.0, 1.5], [17.0, -1.5], [20.0, 1.5]]
# The multi-device tier (phase `parallel`): each mesh path on a one-rank NCCL
# mesh (1 x 1), where every collective runs and is an identity, then in a
# world of GLOO_RANKS gloo ranks spawned on cuda:0 (NCCL puts no two ranks on
# one card), each path's shards split over the ranks, held to the one-rank
# results. `distributed_optimize` solves the graph the closure GN solves
# with the dense [3P, 3P] system, P = CAP.max_poses, through the Cholesky
# kernel at the kernel's largest size; DISTRIBUTED_REFERENCE is the JAX
# package's `distributed_optimize` of that graph on the CPU (1 x 2 mesh, 10
# iterations), as `graph_metrics` gives it; tests/test_torch_parallel.py
# recomputes it
DISTRIBUTED_N = 3 * CAP.max_poses
DISTRIBUTED_REFERENCE = dict(ate_graph=0.436961, map_err_median=0.371798)
GLOO_RANKS, GLOO_TIMEOUT_S = 2, 300.0
# the per-frame batched engine: every session is held to the blocked batched
# run, and every PARALLEL_SINGLE_EVERY-th also to its own per-frame run
PARALLEL_SINGLE_EVERY = 8
# the scan-form mapping step in the per-frame batched engine, beside the
# vectorized step, on the first frames of its pass: one loop over the 64
# observation slots for all 16 sessions, a few thousand launches per frame
# (83,431 when each session looped alone, NVIDIA H100 80GB HBM3, 700 W);
# held under SCAN_LAUNCHES_PER_FRAME
PARALLEL_SCAN_FRAMES = 8
SCAN_LAUNCHES_PER_FRAME = 10_000
# the mesh-sharded association on the blocked lap: compat and I2 at block 16
ASSOC_MESH_RUNS = {"first": ("first", 16), "I2_b16": ("I2", 16)}
# Phase `chain`: the pose-chain solvers on bench_scaling.py's chain graph
# (scripts/bench_chain_solvers.py's synth(512, 512): a circular track of 512
# poses and 512 cones, 6 observations per pose; GNConfig(iterations=4),
# bench_scaling.py:226-233) and on the fusion's joint graph (phase
# `fusion`'s 8 sessions merged, 3,072 poses, n = 9,216). Every solver runs on
# a one-rank NCCL chain mesh, then in a world of CHAIN_RANKS gloo ranks on
# cuda:0 (hier at tray 2; hier3 at tray 2, pod 4), held to the single-device
# GN within the JAX tests' bounds: tests/test_parallel.py:342 (2e-3 at
# trackdrive scale), test_hier.py:56 (5e-3), test_fusion.py:364 (3e-3), :406
# and :448 (1e-2). The chain graph is held in float64: in FP32 its GN is
# ill-conditioned (on the CPU the single-device FP32 solve ends metres from
# the float64 one after 4 iterations, and the FP32 solvers decimetres from
# each other), so FP32 shows the arithmetic, not the solver; its FP32 solves
# are timed, with their deviation from the float64 solve printed. The fused
# graph, anchored by GPS priors, is held in FP32.
CHAIN_SYNTH, CHAIN_ITERATIONS, CHAIN_RANKS, CHAIN_TIMEOUT_S = 512, 4, 4, 600.0
CHAIN_SOLVERS = ("replicated", "dd", "resident", "hier", "hier3")
CHAIN_ATOL = {"synth64": dict(replicated=2e-3, dd=2e-3, resident=2e-3, hier=5e-3, hier3=5e-3),
              "fused": dict(replicated=3e-3, dd=3e-3, resident=3e-3, hier=1e-2, hier3=1e-2),
              "fuse_sessions": 1e-2}
# Phase `resident`: the map-resident online pass on the bench lap, as
# tests/test_resident_online.py runs it: name -> (configuration, block, the
# REFERENCE key whose counts it is held to, or None). The improved runs are
# held to the dense pass by the JAX tests' structure rule (landmarks exact,
# edges within 2, values within RESIDENT_STRUCT_ATOL), the others by their
# `_compare` (decisions exact, values within RESIDENT_ATOL)
RESIDENT_RANKS, RESIDENT_TIMEOUT_S = 4, 300.0
RESIDENT_ATOL, RESIDENT_STRUCT_ATOL = 2e-3, 5e-2
RESIDENT_STRUCTURE = ("I1_b16", "midblock8")
RESIDENT_TIMED = ("first", "I1_b16")     # the runs timed beside their dense laps
# phase 5: the closure GN under 'high' (TF32) within the JAX package's
# documented ~1e-3 relative error of 'highest'; 'default' (bf16) reported
GN_PRECISION_RTOL = 1e-3
# the gloo world's map-sharded association: the pod map over two shards
ASSOC_MESH_CASES = (("first", False), ("first", True), ("nearest", False),
                    ("mahalanobis", False))


# phase `cli`: the CLI's `sim` defaults (laps 1.3, seed 0), block 32 for
# the whole-lap pipelines, and the CLI runs' ATE / map error against their
# reference (the same command on the CPU, or the live run for the passes)
CLI_BLOCK = 32
CLI_SIM = SimConfig(laps=1.3, seed=0)
CLI_FUSE = ["fuse", "--sessions", "2"]

# phase `deploy`: the multi-process smoke (tpuslam_torch/deploy/
# multihost_smoke.py) in groups of DEPLOY_PROCS ranks (one NCCL rank, then
# gloo ranks on cuda:0) and its death case on the largest group; the chain
# script (tpuslam_torch/scripts/bench_chain_solvers.py) at its default sizes
# on one NCCL rank; the wheel of the tree installed with --target and, in a
# fresh process with nothing of the checkout on its path, both kernels built
# from it and checked: the association at the lap shape bit-equal to its
# twin, the Cholesky at DEPLOY_CHOL_N within phase 2's tolerance
DEPLOY_PROCS = (1, 2)
DEPLOY_PG_TIMEOUT_S, DEPLOY_GROUP_TIMEOUT_S, DEPLOY_SURVIVOR_TIMEOUT_S = 60.0, 300.0, 90.0
DEPLOY_CHAIN_SIZES = "256,1024,2048"
DEPLOY_CHOL_N = 768
PIP = (sys.executable, "-m", "pip", "--disable-pip-version-check")
# the fresh process of the installed copy: argv = (install dir, inputs file)
INSTALLED_CHECK = """
import json, sys, time
import torch
inst, inputs = sys.argv[1], sys.argv[2]
from tpuslam_torch import _build
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
t0 = time.perf_counter()
_build.build_all()
build_s = time.perf_counter() - t0
ins = torch.load(inputs)
assoc = [x.cuda() for x in ins["assoc"]]
a = ins["chol"].cuda()
got = A.associate_kernel(*assoc, ins["gate2"])
want = A.associate_plain(*assoc, ins["gate2"])
L, L_plain = C.cholesky_kernel(a), C.cholesky_plain(a)
launches = {"assoc": A.launches, "cholesky": C.launches}

def ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

print(json.dumps(dict(
    package=_build.__file__, libs=[str(_build.lib_path(n)) for n in _build.SOURCES],
    imported=sorted({m.split(".")[0] for m in sys.modules} & {"jax", "tpuslam"}),
    build_s=build_s, launches=launches,
    assoc_equal=all(torch.equal(g, w) for g, w in zip(got, want)),
    assoc_matched=int(got[1].sum()), chol_err=float((L - L_plain).abs().max()),
    chol_close=bool(torch.allclose(L, L_plain, atol=ins["atol"], rtol=ins["rtol"])),
    assoc_ms=ms(lambda: A.associate_kernel(*assoc, ins["gate2"]), 100),
    chol_ms=ms(lambda: C.cholesky_kernel(a), 20))))
"""


def cli_call(argv):
    """(stdout, stderr, wall seconds) of one `cli.main.main(argv)` call in
    this process, the card synchronised before the clock stops; a non-zero
    exit raises."""
    from tpuslam_torch.cli.main import main as cli_main
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}: {err.getvalue()[-2000:]}")
    if torch.distributed.is_initialized():
        raise AssertionError(f"cli {argv}: left a process group behind")
    return out.getvalue(), err.getvalue(), wall


def cli_json(argv):
    out, _, wall = cli_call(argv)
    return json.loads(out.strip().splitlines()[-1]), wall


def check_cli(what, got, want, exact, close=(), atol=METRIC_ATOL_M):
    for k in exact:
        if got[k] != want[k]:
            raise AssertionError(f"cli {what}: {k} = {got[k]}, want {want[k]}")
    for k in close:
        if abs(got[k] - want[k]) > atol:
            raise AssertionError(f"cli {what}: {k} = {got[k]}, want {want[k]} within {atol}")


def traced_blocked_lap(logdir):
    """One blocked trackdrive lap (CLI_SIM, block CLI_BLOCK) under
    `trace_session`, after a warm-up lap: the counts of the trace file it
    writes into `logdir`."""
    from tpuslam_torch.runtime.tracing import stage, trace_session
    torch.backends.cuda.matmul.allow_tf32 = False
    ins = inputs(simulate(trackdrive(seed=0), CLI_SIM), "cuda")
    cfg = SlamConfig()
    run_pass_blocked(*ins, cfg, block=CLI_BLOCK)
    with trace_session(logdir):
        with stage("blocked lap"):
            run_pass_blocked(*ins, cfg, block=CLI_BLOCK)
    (trace,) = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    events = json.load(open(trace))["traceEvents"]
    return {"kernels": sum(e.get("cat") == "kernel" for e in events),
            "stages": sum(e.get("name") == "blocked lap" for e in events),
            "events": len(events), "bytes": os.path.getsize(trace)}


def traced_blocked_lap_in_child(logdir, timeout_s=300):
    """`traced_blocked_lap` in a child Python process, so that no profile
    taken earlier in this process bears on the trace; its counts and the
    child's wall seconds. A failed or overdue child raises."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"print(json.dumps(chip_smoke.traced_blocked_lap({logdir!r})))")
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True,
                          text=True, timeout=timeout_s)
    if done.returncode != 0:
        raise AssertionError(f"cli trace: the child exited {done.returncode}: "
                             f"{done.stderr[-2000:]}")
    return {**json.loads(done.stdout.strip().splitlines()[-1]),
            "wall_s": time.perf_counter() - t0}


def run_checked(cmd, what, **kw):
    """`subprocess.run(cmd)` with its output captured; raises with the
    output's tail when the command fails."""
    done = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if done.returncode != 0:
        raise AssertionError(f"{what}: exit {done.returncode}: "
                             f"{(done.stdout + done.stderr)[-2000:]}")
    return done


def tree_wheel(dest):
    """The wheel of this checkout (`pip wheel --no-deps --no-build-isolation`)
    built into `dest`/wheel from a copy of the package sources under `dest`
    (setuptools writes build/ and an egg-info beside the sources it builds),
    the built libraries left out. Returns the wheel's path."""
    import shutil
    from pathlib import Path
    root, src = Path(__file__).resolve().parent, Path(dest) / "src"
    src.mkdir(parents=True)
    shutil.copy(root / "pyproject.toml", src)
    for pkg in ("tpuslam", "tpuslam_torch"):
        shutil.copytree(root / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("build", "__pycache__", "*.pyc"))
    run_checked([*PIP, "wheel", "--no-deps", "--no-build-isolation", "--no-index", "-w",
                 str(Path(dest) / "wheel"), str(src)], "pip wheel")
    (wheel,) = (Path(dest) / "wheel").glob("*.whl")
    return wheel


def timed(fn):
    """(result, host seconds) of `fn()`, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def configs():
    return {"first": SlamConfig(capacity=CAP),
            "nearest": SlamConfig(capacity=CAP, association="nearest",
                                  use_pallas_association=True)}


def resident_runs():
    """RESIDENT_RUNS: name -> (configuration, block, REFERENCE key or None)."""
    return {"first": (SlamConfig(capacity=CAP), 16, "first"),
            "nearest": (SlamConfig(capacity=CAP, association="nearest"), 16, "nearest"),
            "I1_b16": (SlamConfig.improved(capacity=CAP, periodic_gn_every=16), 16, "I1_b16"),
            "mahalanobis": (SlamConfig.improved(capacity=CAP, association="mahalanobis",
                                                periodic_gn_every=0), 16, None),
            "midblock8": (SlamConfig.improved(capacity=CAP, periodic_gn_every=8), 32, None)}


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


def graph_metrics(track, scen, g) -> dict:
    """Graph-pose ATE over the graph's poses and the median map error of a
    graph, rounded to 6 places."""
    n = int(g.n_poses)
    lm = g.lm_xy[:int(g.n_landmarks)].cpu().numpy()
    return dict(
        ate_graph=round(ate(g.poses[:n, :2].cpu().numpy(), scen.gt_poses[:n, :2]), 6),
        map_err_median=round(float(np.median(np.linalg.norm(
            lm[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1))), 6))


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


def check_metrics(name: str, got: dict, want=None, atol=METRIC_ATOL_M) -> None:
    """`got` against `want` (REFERENCE[name] by default): integers exact,
    floats within `atol`."""
    for k, v in (REFERENCE[name] if want is None else want).items():
        if isinstance(v, int):
            ok = got[k] == v
        else:
            ok = abs(got[k] - v) <= atol
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


def compare_session(what, st_b, out_b, st_1, out_1, deferred=False):
    """A session of a batched run against its own single-session run:
    discrete outputs and state exact (edges up to n_obs), values within
    BATCHED_ATOL (the batched closure GN is full-capacity, its sums in
    another order). `deferred`: the batched run deferred its closure GN past
    the closure frame's outputs, whose cone packet then comes from the map
    before it and is left out."""
    keep = slice(None)
    if deferred:
        keep = ~out_1.loop_closed
    for f in dataclasses.fields(out_1):
        a, b = getattr(out_b, f.name), getattr(out_1, f.name)
        if f.name in ("cone_azimuth", "cone_distance"):
            a, b = a[keep], b[keep]
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


class Recorder:
    """Wraps a `Slam`'s `process_frame` to keep every keyframe's outputs
    (and, with `sync`, the host time of each call up to a device
    synchronize) and takes its published messages."""

    def __init__(self, slam, sync=False):
        self.outs, self.published, self.seconds = [], [], []
        inner = slam.process_frame

        def process_frame(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            if sync:
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
            self.outs.append(out)
            return out

        slam.process_frame = process_frame
        slam.publish = lambda *msg: self.published.append(msg)

    def stacked(self):
        """The outputs of every keyframe, stacked per field."""
        return {f.name: torch.stack([getattr(o, f.name) for o in self.outs]).cpu()
                for f in dataclasses.fields(self.outs[0])}


def service_config(name, **kw):
    return SlamConfig(capacity=CAP, time_between_keyframes_ms=SERVICE_KEYFRAME_MS,
                      **SERVICE_CONFIGS[name], **kw)


def service_replay(cfg, scen, device, sync=False):
    """The lap through `scenario_to_rec` and `SlamService.run_replay` on
    `device`: (service, Recorder)."""
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "lap.rec")
        scenario_to_rec(scen, rec, cfg)
        svc = SlamService(cfg, device=device)
        recorder = Recorder(svc.slam, sync)
        svc.run_replay(rec)
    return svc, recorder


def service_metrics(scen, slam, outs) -> dict:
    """The discrete outcome of a service run and its published ATE."""
    closes = np.flatnonzero(outs["loop_closed"].numpy())
    poses = outs["pose"].numpy()
    g = slam.state.graph
    return dict(keyframes=slam.keyframes_processed,
                closure_frame=int(closes[0]) if len(closes) else -1,
                n_landmarks=int(g.n_landmarks), n_obs=int(g.n_obs),
                sends=int(outs["send"].sum()),
                ate_published=ate(poses[:, :2], scen.gt_poses[:len(poses), :2]))


def compare_published(what, got, want, gps_ref):
    """Two runs' published message streams: the same messages in the same
    order, object ids, types and sender stamps exact; the published pose
    (its WGS84 fix projected back to metres) and the cone rows within
    POSE_ATOL, azimuths, in degrees, within 60 x POSE_ATOL. Sample stamps
    are not compared: a replay publishes a frame when the next frame's
    first cone closes it, after that frame's GPS fix."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} published messages, want {len(want)}")
    for (mg, _, sg), (mw, _, sw) in zip(got, want):
        if type(mg) is not type(mw) or sg != sw or getattr(mg, "objectId", 0) != \
                getattr(mw, "objectId", 0):
            raise AssertionError(f"{what}: published {mg} ({sg}), want {mw} ({sw})")
        if isinstance(mg, M.Geolocation):
            xy = [wgs84.to_cartesian(gps_ref, np.array([m.latitude, m.longitude]))
                  for m in (mg, mw)]
            vals = [(*xy[0], mg.heading), (*xy[1], mw.heading)]
            atol = POSE_ATOL
        elif isinstance(mg, M.ObjectDirection):
            vals, atol = [(mg.azimuthAngle,), (mw.azimuthAngle,)], 60 * POSE_ATOL
        elif isinstance(mg, M.ObjectDistance):
            vals, atol = [(mg.distance,), (mw.distance,)], POSE_ATOL
        else:
            vals, atol = [(mg.type,), (mw.type,)], 0
        if np.max(np.abs(np.subtract(*vals))) > atol:
            raise AssertionError(f"{what}: published {mg}, want {mw}")


def compare_outputs(what, got, want, atol=POSE_ATOL):
    """Two stacked per-keyframe outputs: discrete fields exact, values
    within `atol` (azimuths, in degrees, within 60 x `atol`)."""
    for k, b in want.items():
        a = got[k]
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: outputs.{k} differs")
        else:
            torch.testing.assert_close(a, b, rtol=0, msg=f"{what}: {k}",
                                       atol=atol * (60.0 if k == "cone_azimuth" else 1.0))


def ekf_accel(device):
    """BASELINE config 2 through the port's EKF on `device`: (ATE of the GPS
    fixes, ATE of the fused poses after 20 frames, fused poses [T, 3])."""
    scen = simulate(acceleration(), SimConfig(**EKF_ACCEL_SIM))
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    ekf = motion.ekf_init(f32(scen.gt_poses[0]), pos_std=1.0)
    fused = []
    for k in range(len(scen.times)):
        ekf = motion.ekf_predict(ekf, 0.05)
        ekf = motion.ekf_update_position(ekf, f32(scen.odom_poses[k, :2]), std=0.25)
        ekf = motion.ekf_update_heading(ekf, float(scen.odom_poses[k, 2]), std=0.02)
        ekf = motion.ekf_update_yaw_rate(ekf, float(scen.yaw_rates[k]), std=0.02)
        fused.append(ekf.x[:3])
    fused = torch.stack(fused).cpu().numpy()
    return (ate(scen.odom_poses[:, :2], scen.gt_poses[:, :2]),
            ate(fused[20:, :2], scen.gt_poses[20:, :2]), fused)


def ekf_skidpad(device):
    """The skidpad lap through `Slam(use_ekf_fusion=True)` on `device`:
    (metrics, Recorder)."""
    track = skidpad()
    scen = simulate(track, SimConfig(**EKF_SKIDPAD_SIM))
    slam = Slam(SlamConfig(capacity=EKF_SKIDPAD_CAP, use_ekf_fusion=True), device=device)
    recorder = Recorder(slam)
    slam.run_scenario(scen)
    outs = recorder.stacked()
    m = service_metrics(scen, slam, outs)
    lm, _ = slam.draw_cones()
    m["map_err_median"] = float(np.median(np.linalg.norm(
        lm[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1)))
    del m["keyframes"]
    return m, recorder


def feed(slam, scen, t):
    """Frame `t` of a scenario into a `Slam`, as `run_scenario` feeds it."""
    us = int(scen.times[t] * 1e6)
    slam.next_pose(_geo_from_local(slam._gps_ref, scen.odom_poses[t]), us)
    slam.next_yaw_rate(M.AngularVelocityReading(angularVelocityZ=float(scen.yaw_rates[t])), us)
    return slam.process_frame(scen.obs[t], scen.obs_valid[t], us)


def resume_run(device):
    """tests/test_runtime.py:163-204 on `device`: the skidpad lap with the
    EKF, uninterrupted, and stopped at half the lap with an open cone frame,
    through `save_checkpoint` / `load_checkpoint` and `snapshot_host` /
    `restore_host` into a fresh `Slam` that finishes it. Returns (k, T,
    uninterrupted Slam, its Recorder, resumed Slam, its Recorder of frames
    k..T-1)."""
    cfg = SlamConfig(use_ekf_fusion=True)
    scen = simulate(skidpad(), SimConfig(**RESUME_SIM))
    t, k = len(scen.times), len(scen.times) // 2
    gold = Slam(cfg, device=device)
    gold_rec = Recorder(gold)
    for i in range(t):
        feed(gold, scen, i)
    a = Slam(cfg, device=device)
    for i in range(k):
        feed(a, scen, i)
    a.next_cone(M.ObjectDirection(objectId=0, azimuthAngle=5.0), int(scen.times[k] * 1e6))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mid.npz")
        save_checkpoint(path, a.state, cfg, extra={"host": a.snapshot_host()})
        state, meta = load_checkpoint(path, cfg, device=device)
    b = Slam(cfg, device=device)
    b.state = state
    b.restore_host(meta["host"])
    if not (b._frame_open and torch.equal(b._ekf.x, a._ekf.x)
            and torch.equal(b._ekf.p, a._ekf.p)):
        raise AssertionError("resume: the open frame or the EKF state did not carry over")
    b._frame_open = False    # drop the partial frame, as the uninterrupted run never had it
    b_rec = Recorder(b)
    for i in range(k, t):
        feed(b, scen, i)
    return k, t, gold, gold_rec, b, b_rec


def vlp16_scenes():
    """bench.py's two vlp16_frontend scenes: name -> (points [cap, 3] f32,
    valid [cap], AttentionConfig), made as bench.py:987-1031 makes them."""
    vcfg = Vlp16SceneConfig(seed=3, points_per_cone=60)
    rng = np.random.default_rng(3)
    cone_xy = rng.uniform(-12, 12, (24, 2)).astype(np.float32)
    pts, _ = render_scene(cone_xy, np.ones(len(cone_xy), np.int32), vcfg)
    cones_roi = rng.uniform([1.0, -3.5], [11.0, 3.5], (12, 2))
    cloud, _ = decode_point_cloud_reading(scene_to_point_cloud_reading(
        cones_roi, Vlp16SceneConfig(seed=4, surround_range=30.0)))
    out = {}
    for name, p, cap, acfg in (
            ("dense", pts, 4096, AttentionConfig(sensor_height=vcfg.sensor_height,
                                                  ground_layer_z=-vcfg.sensor_height)),
            ("full_sweep", cloud, 32768, AttentionConfig(
                sensor_height=0.9, ground_layer_z=-0.9, inlier_found_threshold=1000,
                min_points=3))):
        buf = np.zeros((cap, 3), np.float32)
        n = min(len(p), cap)
        buf[:n] = p[:n]
        out[name] = (buf, np.arange(cap) < n, acfg)
    return out


def check_cones(what, got, want, atol=VLP16_ATOL):
    """detect_cones' (cones, valid, count) against wanted rows [k, 4]: the
    count exact, the valid rows within `atol`."""
    cones, ok, n = (x.cpu() for x in got)
    want = torch.as_tensor(want, dtype=torch.float32).cpu().reshape(-1, 4)
    if int(n) != len(want) or int(ok.sum()) != len(want):
        raise AssertionError(f"{what}: {int(n)} cones, want {len(want)}")
    err = float((cones[ok] - want).abs().max()) if len(want) else 0.0
    if err > atol:
        raise AssertionError(f"{what}: cone tuples {err:.3g} from the reference, atol {atol}")
    return err


def sweep_replay_rec(path, cfg):
    """tests/test_perception.py:325-358's recording: four full sweeps
    (seed 21, the surround-free raycaster) and GPS fixes 2 m apart."""
    scfg = Vlp16SceneConfig(seed=21, noise=0.005)
    cones = np.array(SWEEP_REPLAY_CONES)
    ref = np.array(cfg.gps_reference)
    with RecWriter(path) as w:
        for t in range(4):
            us = int(t * 0.5e6) + 1000
            pose = np.array([2.0 * t, 0.0, 0.0])
            latlon = wgs84.from_cartesian(ref, pose[:2])
            w.write_message(M.Geolocation(latitude=float(latlon[0]), longitude=float(latlon[1]),
                                          heading=0.0),
                            sample_us=us, sender_stamp=cfg.estimation_id)
            w.write_message(scene_to_point_cloud_reading(cones - (pose[:2] + [1.5, 0.0]), scfg),
                            sample_us=us, sender_stamp=42)
    return scfg


def sweep_replay(device):
    """The full-sweep recording through `SlamService(attention_cfg=...,
    host_prefilter=False, point_capacity=32768)` on `device`: (service,
    landmarks [n, 2], median distance of a landmark to its cone)."""
    cfg = SlamConfig(capacity=GraphCapacity(32, 32, 512), time_between_keyframes_ms=50.0)
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "sweeps.rec")
        scfg = sweep_replay_rec(rec, cfg)
        acfg = AttentionConfig(sensor_height=scfg.sensor_height,
                               ground_layer_z=-scfg.sensor_height, inlier_found_threshold=1000,
                               min_points=3, host_prefilter=False, point_capacity=32768)
        svc = SlamService(cfg, attention_cfg=acfg, lidar_sender_id=42, device=device)
        svc.run_replay(rec)
    lm, _ = svc.slam.draw_cones()
    d = np.linalg.norm(lm[:, None] - np.array(SWEEP_REPLAY_CONES)[None], axis=-1).min(axis=1)
    return svc, lm, float(np.median(d)) if len(d) else float("inf")


def profile_counts(fn):
    """(device busy ms, kernel launches, device-to-host copies) of one call
    of `fn` under torch.profiler: device time summed over kernels and
    copies. The profiler records the device activity alone, which costs far
    less than host ops too on a run of ~100,000 launches. The program's
    `slam.*` spans, which the device rows may show as annotations, are
    neither launches nor busy time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type.name == "CUDA" and not e.key.startswith("slam.")]
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


def assoc_mesh_inputs(device):
    """The pod-shape association world (ASSOC_SHAPES["pod"]) as the dense
    `associate` takes it: observations, types, validity, landmarks, types,
    validity and [M, 2, 2] inverse covariances; a tenth of each invalid."""
    n, m = ASSOC_SHAPES["pod"]
    oxy, ot, lxy, lt, packed = assoc_world(n, m, 0, device)
    g = torch.Generator().manual_seed(3)
    ov = (torch.rand(n, generator=g) > 0.1).to(device)
    lv = (torch.rand(m, generator=g) > 0.1).to(device)
    a, b, c = packed.unbind(-1)
    cov = torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)], -2)
    return oxy, ot, ov, lxy, lt, lv, cov


def assoc_mesh_call(fn, ins, mode, bug, *mesh):
    """`fn` (`associate` or `associate_sharded`) on `ins` in one of
    ASSOC_MESH_CASES' modes: the Euclidean gate 1.5 m, chi-square 9.21."""
    gate = 9.21 if mode == "mahalanobis" else 1.5
    return fn(*ins[:6], gate, *mesh, mode=mode,
              lm_cov_inv=ins[6] if mode == "mahalanobis" else None, type_signed_bug=bug)


def gloo_paths(mesh_e, mesh_s, work):
    """The mesh paths of phase `parallel`'s gloo world on the inputs in
    `work`: `distributed_optimize` and the map-sharded association over
    'edges', the fleet over 'sessions', the dedup over 'edges'."""
    from tpuslam_torch.parallel import associate_sharded, distributed_optimize, run_fleet_blocked
    from tpuslam_torch.parallel.fusion import dedup_labels
    d = distributed_optimize(work["graph"], work["gn_cfg"], mesh_e)
    ins = assoc_mesh_inputs("cuda")
    assoc = {f"{mode}{'_bug' if bug else ''}": assoc_mesh_call(associate_sharded, ins, mode, bug,
                                                                mesh_e)
             for mode, bug in ASSOC_MESH_CASES}
    st, outs, done = run_fleet_blocked(*work["fleet_in"], work["fleet_cfg"], mesh_s,
                                       block=BLOCK)
    labels = dedup_labels(*work["dedup_in"], mesh=mesh_e)
    return dict(distributed=(d.poses, d.lm_xy), assoc=assoc, fleet=(st, outs, done),
                labels=labels)


def _to(x, device):
    """Tensors of a nested result (states, outputs, tuples, dicts) moved."""
    if torch.is_tensor(x):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        moved = {f.name: _to(getattr(x, f.name), device) for f in dataclasses.fields(x)}
        changed = {k: v for k, v in moved.items() if v is not getattr(x, k)}
        return dataclasses.replace(x, **changed) if changed else x
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def spawn_world(rank_fn, nprocs: int, timeout_s: float, work, what: str):
    """A world of `nprocs` ranks spawned on this machine, each running
    `rank_fn(rank, port, workdir)` on `work` (saved to `workdir` on the
    host) and saving its result there; killed past `timeout_s` + 60 s.
    Returns (each rank's result on cuda, the wall time in s, spawn
    included)."""
    import shutil
    from tpuslam_torch.parallel.mesh import free_port
    workdir = tempfile.mkdtemp(prefix="chip_smoke_world_")
    try:
        torch.save(_to(work, "cpu"), os.path.join(workdir, "work.pt"))
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            rank_fn, args=(free_port(), workdir), nprocs=nprocs, join=False,
            start_method="spawn")
        deadline = t0 + timeout_s + 60.0
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"{what}: ranks ran past {timeout_s + 60} s")
        wall = time.perf_counter() - t0
        return [_to(torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False), "cuda")
                for r in range(nprocs)], wall
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def gloo_rank(rank, port, workdir):
    """One rank of phase `parallel`'s gloo world on cuda:0: the mesh paths
    of `gloo_paths` on the work `workdir` holds, its results and kernel
    launch counts saved there."""
    from tpuslam_torch.parallel.mesh import initialize_distributed, make_slam_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed("gloo", f"localhost:{port}", GLOO_RANKS, rank,
                           timeout_s=GLOO_TIMEOUT_S)
    try:
        work = _to(torch.load(os.path.join(workdir, "work.pt"), weights_only=False), "cuda")
        mesh_e = make_slam_mesh(1, GLOO_RANKS, device_type="cuda")
        mesh_s = make_slam_mesh(GLOO_RANKS, 1, device_type="cuda")
        A.launches = C.launches = 0
        out = gloo_paths(mesh_e, mesh_s, work)
        torch.cuda.synchronize()
        out["launches"] = {"assoc": A.launches, "cholesky": C.launches}
        out["on_cuda"] = all(t.device.type == "cuda" for t in (
            out["distributed"][0], out["labels"], out["fleet"][0].graph.poses))
    finally:
        torch.distributed.destroy_process_group()
    torch.save(_to(out, "cpu"), os.path.join(workdir, f"rank{rank}.pt"))


def chain_solve(g, cfg, mesh, solver):
    """One of CHAIN_SOLVERS on `g` over the chain `mesh`: hier at tray 2
    (tray 1 on a mesh of one), hier3 at the layout `chain_optimize` picks."""
    from tpuslam_torch.parallel import chain_optimize, chain_optimize_resident
    from tpuslam_torch.parallel.collectives import shard
    if solver == "resident":
        return chain_optimize_resident(g, cfg, mesh)
    tray = min(2, shard(mesh, "chain")[1]) if solver == "hier" else None
    return chain_optimize(g, cfg, mesh, solver=solver, tray=tray)


def chain_payload(g, cfg, mesh, solver):
    """(counted, analytic) bytes per rank of one iteration of `solver` on
    `g`, by kind: as the collectives count them (two iterations less one),
    and as `comm_model.tier_bytes_per_iteration` or the solver's
    `*_comm_bytes_per_iteration` give them (psum, and the gathered total
    over the ranks)."""
    from tpuslam_torch.parallel import comm_model, partition_chain_resident
    from tpuslam_torch.parallel.chain import default_tray, partition_chain
    from tpuslam_torch.parallel.collectives import shard
    from tpuslam_torch.parallel.hier import hier_comm_bytes_per_iteration, partition_chain_hier
    from tpuslam_torch.parallel.hier3 import (hier3_comm_bytes_per_iteration,
                                              partition_chain_hier3)
    from tpuslam_torch.parallel.instrument import collective_payload_bytes
    one, two = (collective_payload_bytes(chain_solve, g, dataclasses.replace(cfg, iterations=k),
                                         mesh, solver) for k in (1, 2))
    counted = {k: two[k]["bytes"] - one[k]["bytes"] for k in two if k != "total_bytes"}
    D = shard(mesh, "chain")[1]
    P, L = g.poses.shape[0], g.lm_xy.shape[0]
    if solver == "hier":
        a = hier_comm_bytes_per_iteration(partition_chain_hier(g, D, min(2, D)))
        levels = a["level1_tray_psum"] + a["level2_cross_psum"]
    elif solver == "hier3":
        a = hier3_comm_bytes_per_iteration(partition_chain_hier3(
            g, D, default_tray(D, cap=max(2, min(16, D // 2))), D))
        levels = a["level1_tray_psum"] + a["level2_pod_psum"] + a["level3_cross_psum"]
    else:
        shared_cap = {"replicated": 64, "dd": partition_chain(g, D).shared_cap,
                      "resident": partition_chain_resident(g, D).shared_cap}[solver]
        tier = {"replicated": "chain_replicated", "dd": "chain_dd",
                "resident": "chain_dd_resident"}[solver]
        m = comm_model.tier_bytes_per_iteration(tier, P=P, L=L, D=D, shared_cap=shared_cap)
        return counted, {"psum": m["payload_psum"], "all_gather": m["payload_gather"] // D}
    return counted, {"psum": levels + a["shared_hll_gl_psum"] + a["dl_shared_psum"],
                     "all_gather": 4}


def chain_paths(mesh, work):
    """Phase `chain`'s solves over the chain `mesh` on the graphs in
    `work`: every solver on each checked graph and on the FP32 chain graph,
    `fuse_sessions`' chain solvers, and the payload per iteration of each
    solver on the FP32 chain graph."""
    out = {"graphs": {}, "fuse_sessions": {}, "payload": {}}
    for name, g in {**work["graphs"], "synth": work["timed"]["synth"]}.items():
        cfg = work["cfg"][name]
        out["graphs"][name] = {s: chain_solve(g, cfg, mesh, s) for s in CHAIN_SOLVERS}
    st, gate, fcfg = work["sessions"], work["gate"], work["cfg"]["fused"]
    for solver in ("dd", "hier", "hier3"):
        f, rep = fuse_sessions(st.graph, cfg=fcfg, gate=gate, lm_info=st.lm_info_xy,
                               align=False, solver=solver, solve_mesh=mesh)
        out["fuse_sessions"][solver] = f
    for solver in CHAIN_SOLVERS:
        out["payload"][solver] = chain_payload(work["timed"]["synth"], work["cfg"]["synth"],
                                               mesh, solver)
    return out


def pose_gap(a, b) -> tuple:
    """(max |dx|, |dy| in m, max |dtheta| wrapped, in rad) between two pose
    arrays' rows."""
    a, b = a.double(), b.double()
    dth = torch.remainder(a[:, 2] - b[:, 2] + np.pi, 2 * np.pi) - np.pi
    return float((a[:, :2] - b[:, :2]).abs().max()), float(dth.abs().max())


def chain_rank(rank, port, workdir):
    """One rank of phase `chain`'s gloo world on cuda:0: `chain_paths` over
    a chain mesh of CHAIN_RANKS, each solve timed once more on the host
    clock, its results and kernel launch counts saved in `workdir`."""
    from tpuslam_torch.parallel.mesh import initialize_distributed, make_chain_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed("gloo", f"localhost:{port}", CHAIN_RANKS, rank,
                           timeout_s=CHAIN_TIMEOUT_S)
    try:
        work = _to(torch.load(os.path.join(workdir, "work.pt"), weights_only=False), "cuda")
        mesh = make_chain_mesh(CHAIN_RANKS, device_type="cuda")
        A.launches = C.launches = 0
        out = chain_paths(mesh, work)
        torch.cuda.synchronize()
        out["launches"] = {"assoc": A.launches, "cholesky": C.launches}
        out["ms"] = {}
        for name, g in work["timed"].items():
            for solver in CHAIN_SOLVERS:
                torch.distributed.barrier()
                t0 = time.perf_counter()
                chain_solve(g, work["cfg"][name], mesh, solver)
                torch.cuda.synchronize()
                out["ms"][f"{name}/{solver}"] = (time.perf_counter() - t0) * 1e3
        out["graphs"] = {k: {s: (r.poses, r.lm_xy) for s, r in v.items()}
                         for k, v in out["graphs"].items()}
        out["fuse_sessions"] = {k: (r.poses, r.lm_xy) for k, r in out["fuse_sessions"].items()}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(_to(out, "cpu"), os.path.join(workdir, f"rank{rank}.pt"))


def resident_paths(mesh, ins):
    """Phase `resident`'s passes over the ('map',) `mesh`: each of
    `resident_runs` through `run_pass_resident_online`, with the number of
    collectives this rank called in it; and the shapes of the landmark
    blocks `resident_online_core` returns for compat 'first'."""
    from tpuslam_torch.parallel import resident_online as RO
    from tpuslam_torch.parallel.collectives import counting
    out = {"runs": {}, "collectives": {}}
    for name, (cfg, block, _) in resident_runs().items():
        with counting() as rec:
            out["runs"][name] = RO.run_pass_resident_online(*ins, cfg, mesh, block=block)
        out["collectives"][name] = {k: v["count"] for k, v in rec.items()}
    cfg, dev = SlamConfig(capacity=CAP), ins[0].device
    o_p, v_p, p_p = blocked_mod._pad_inputs(*ins, cfg, 16)
    state = initial_state(dataclasses.replace(CAP, max_landmarks=1), dev)
    nc, _ = blocked_mod._pick_compact(v_p, state)
    *_, lx, lt, li, _, done = RO.resident_online_core(
        state, *RO.initial_shards(CAP.max_landmarks, mesh, device=dev), o_p, v_p, p_p, cfg,
        mesh, 16, compact_obs=nc)
    out["shards"] = ([tuple(x.shape) for x in (lx, lt, li)],
                     all(x.device == dev for x in (lx, lt, li)), done == o_p.shape[0])
    return out


def resident_rank(rank, port, workdir):
    """One rank of phase `resident`'s gloo world on cuda:0: `resident_paths`
    over a ('map',) mesh of RESIDENT_RANKS, its results and kernel launch
    counts saved in `workdir`."""
    from tpuslam_torch.parallel.mesh import initialize_distributed, make_map_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed("gloo", f"localhost:{port}", RESIDENT_RANKS, rank,
                           timeout_s=RESIDENT_TIMEOUT_S)
    try:
        ins = _to(torch.load(os.path.join(workdir, "work.pt"), weights_only=False), "cuda")
        A.launches = C.launches = 0
        out = resident_paths(make_map_mesh(RESIDENT_RANKS, device_type="cuda"), ins)
        torch.cuda.synchronize()
        out["launches"] = {"assoc": A.launches, "cholesky": C.launches}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(_to(out, "cpu"), os.path.join(workdir, f"rank{rank}.pt"))


def compare_resident(what, name, got, want):
    """A resident lap against the dense lap of its configuration, both on
    the card, by tests/test_resident_online.py's rules: the improved runs
    (RESIDENT_STRUCTURE) closed, landmark count exact, edges within 2,
    landmarks and published poses within RESIDENT_STRUCT_ATOL; the others
    with every decision (counts, flags, edges, landmark types, published
    discrete outputs) exact and values within RESIDENT_ATOL. Returns the
    largest value difference (m)."""
    (sa, oa), (sb, ob) = got, want
    ga, gb = sa.graph, sb.graph
    nl, n, npp = int(gb.n_landmarks), int(gb.n_obs), int(gb.n_poses)
    if name in RESIDENT_STRUCTURE:
        if not (bool(sa.loop_closure_complete) and bool(sb.loop_closure_complete)):
            raise AssertionError(f"{what}: the loop did not close")
        if int(ga.n_landmarks) != nl or abs(int(ga.n_obs) - n) > 2:
            raise AssertionError(f"{what}: {int(ga.n_landmarks)} landmarks and {int(ga.n_obs)} "
                                 f"edges, the dense lap {nl} and {n}")
        pairs, atol = ((ga.lm_xy[:nl], gb.lm_xy[:nl]), (oa.pose, ob.pose)), RESIDENT_STRUCT_ATOL
    else:
        for k in ("n_landmarks", "n_obs", "n_poses"):
            if int(getattr(ga, k)) != int(getattr(gb, k)):
                raise AssertionError(f"{what}: {k} {int(getattr(ga, k))}, dense "
                                     f"{int(getattr(gb, k))}")
        for k in ("loop_closure_complete", "current_cone_index"):
            if int(getattr(sa, k)) != int(getattr(sb, k)):
                raise AssertionError(f"{what}: {k} differs from the dense lap")
        same = (torch.equal(ga.obs_lm[:n], gb.obs_lm[:n])
                and torch.equal(ga.obs_pose[:n], gb.obs_pose[:n])
                and torch.equal(ga.lm_type[:nl], gb.lm_type[:nl])
                and all(torch.equal(getattr(oa, f), getattr(ob, f))
                        for f in ("send", "loop_closed", "n_landmarks", "cone_type")))
        if not same:
            raise AssertionError(f"{what}: a decision differs from the dense lap")
        pairs = ((ga.lm_xy[:nl], gb.lm_xy[:nl]), (ga.poses[:npp], gb.poses[:npp]),
                 (oa.pose, ob.pose), (oa.cone_azimuth, ob.cone_azimuth),
                 (oa.cone_distance, ob.cone_distance))
        atol = RESIDENT_ATOL
    err = max(float((a - b).abs().max()) for a, b in pairs)
    if not err <= atol:
        raise AssertionError(f"{what}: values {err:.3g} from the dense lap (atol {atol})")
    return err


def check_resident_counts(what, name, ref, metrics):
    """REFERENCE[ref]'s counts: closure frame and landmarks exact; edges,
    sends and the current cone exact for compat, edges within 2 for the
    improved runs (the structure rule)."""
    want = REFERENCE[ref]
    structure = name in RESIDENT_STRUCTURE
    keys = ("closure_frame", "n_landmarks") if structure else \
        ("closure_frame", "n_landmarks", "n_obs", "sends", "current_cone_index")
    bad = {k: (metrics[k], want[k]) for k in keys if metrics[k] != want[k]}
    if structure and abs(metrics["n_obs"] - want["n_obs"]) > 2:
        bad["n_obs"] = (metrics["n_obs"], want["n_obs"])
    if bad:
        raise AssertionError(f"{what}: (got, JAX package) {bad}")


def compare_mesh_lap(what, got, want):
    """A lap through the mesh-sharded map against the lap without it, both
    on the card: True when every discrete output and the edges are equal
    (then values within POSE_ATOL); else False, held to the cross-path
    contract (landmarks within CROSS_PATH_LANDMARKS, published poses within
    CROSS_PATH_POSE_M)."""
    (st_g, out_g), (st_w, out_w) = got, want
    n = int(st_w.graph.n_obs)
    same = all(torch.equal(getattr(out_g, f), getattr(out_w, f))
               for f in ("n_landmarks", "cone_type", "send", "loop_closed"))
    same = same and int(st_g.graph.n_obs) == n and torch.equal(st_g.graph.obs_lm[:n],
                                                               st_w.graph.obs_lm[:n])
    if same:
        for a, b, f in ((out_g.pose, out_w.pose, "published poses"),
                        (st_g.graph.poses, st_w.graph.poses, "graph poses"),
                        (st_g.graph.lm_xy, st_w.graph.lm_xy, "landmarks")):
            torch.testing.assert_close(a, b, atol=POSE_ATOL, rtol=0, msg=f"{what}: {f}")
        return True
    dl = abs(int(st_g.graph.n_landmarks) - int(st_w.graph.n_landmarks))
    dp = float(torch.linalg.norm(out_g.pose[:, :2] - out_w.pose[:, :2], dim=1).max())
    if dl > CROSS_PATH_LANDMARKS or dp > CROSS_PATH_POSE_M:
        raise AssertionError(f"{what}: landmarks differ by {dl}, published poses by {dp:.3g} m: "
                             "outside the cross-path contract")
    return False


class Smoke:
    def __init__(self):
        self.card = card()
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

    # -- after fusion
    def service(self):
        """The live service on the card: the bench lap replayed from a .rec
        through `SlamService.run_replay` in both SERVICE_CONFIGS, each held
        to SERVICE_REFERENCE and to the port's direct `Slam.run_scenario` on
        the card (every keyframe's outputs and every published message);
        with the kernel, one association launch per keyframe at the lap
        shape. Then the CTRV EKF (BASELINE config 2 and the skidpad lap
        through `Slam(use_ekf_fusion=True)`, held to EKF_REFERENCE) and a
        checkpoint resume."""
        kernel = keyframe_mod.associate_kernel
        shapes = []

        def recording_kernel(obs_xy, obs_type, lm_xy, *a, **kw):
            shapes.append((obs_xy.shape[-2], lm_xy.shape[-2]))
            return kernel(obs_xy, obs_type, lm_xy, *a, **kw)

        odom = self.scen.odom_poses
        guarded = int(np.sum((np.abs(odom[:, 0]) <= 200.0) & (np.abs(odom[:, 1]) <= 200.0)))
        for name in SERVICE_CONFIGS:
            cfg = service_config(name)
            shapes.clear()
            keyframe_mod.associate_kernel = recording_kernel
            A.launches = C.launches = 0
            try:
                svc, rec = service_replay(cfg, self.scen, "cuda")
                torch.cuda.synchronize()
            finally:
                keyframe_mod.associate_kernel = kernel
            counts = {"assoc": A.launches, "cholesky": C.launches}
            outs = rec.stacked()
            metrics = service_metrics(self.scen, svc.slam, outs)
            self.log(f"service {name}: replay of {len(self.scen.times)} frames, "
                     + json.dumps(metrics) + f", {len(rec.published)} messages published, "
                     f"launches {counts}")
            check_metrics(f"service {name}", metrics, SERVICE_REFERENCE)
            want = {"assoc": guarded if name == "nearest" else 0, "cholesky": 0}
            if counts != want or len(shapes) != want["assoc"] \
                    or set(shapes) - {ASSOC_SHAPES["lap"]}:
                raise AssertionError(f"service {name}: launches {counts}, shapes {set(shapes)}; "
                                     f"want {want} at {ASSOC_SHAPES['lap']}")
            if name == "nearest":
                self.kernels["assoc"].setdefault("launches_by_path", {})["service"] = \
                    counts["assoc"]
                self.log(f"service nearest: {counts['assoc']} assoc launches at N x M = "
                         f"{ASSOC_SHAPES['lap']}, one per keyframe")
            direct = Slam(cfg, device="cuda")
            drec = Recorder(direct)
            direct.run_scenario(self.scen)
            compare_outputs(f"service {name}: replay vs direct", outs, drec.stacked())
            compare_published(f"service {name}: replay vs direct", rec.published,
                              drec.published, direct._gps_ref)
            self.log(f"service {name}: equal to SERVICE_REFERENCE and to the direct "
                     f"Slam.run_scenario on the card (discrete outputs and the published "
                     f"messages' ids and types exact, values within {POSE_ATOL})")
        ate_gps, ate_ekf, _ = ekf_accel("cuda")
        got = dict(accel_ate_gps=ate_gps, accel_ate_ekf=ate_ekf)
        self.log("service ekf: acceleration straight at 20 Hz, " + json.dumps(got))
        check_metrics("ekf acceleration", got, {k: EKF_REFERENCE[k] for k in got})
        got, _ = ekf_skidpad("cuda")
        self.log("service ekf: skidpad lap through Slam(use_ekf_fusion=True), " + json.dumps(got))
        check_metrics("ekf skidpad", got, EKF_REFERENCE["skidpad"])
        self.resume()

    def resume(self):
        """Checkpoint resume on the card (`resume_run`): the resumed tail and
        final state held to the uninterrupted run, discrete exact, values
        within POSE_ATOL (the GN's sums are atomics)."""
        k, t, gold, gold_rec, b, b_rec = resume_run("cuda")
        tail = {f: v[k:] for f, v in gold_rec.stacked().items()}
        compare_outputs("resume", b_rec.stacked(), tail)
        gb, gg = b.state.graph, gold.state.graph
        for f in ("n_poses", "n_landmarks", "n_obs", "lm_type", "obs_lm", "obs_pose"):
            if not torch.equal(getattr(gb, f), getattr(gg, f)):
                raise AssertionError(f"resume: graph.{f} differs from the uninterrupted run")
        for f in ("poses", "lm_xy"):
            torch.testing.assert_close(getattr(gb, f), getattr(gg, f), atol=POSE_ATOL, rtol=0,
                                       msg=f"resume: graph.{f}")
        self.log(f"service resume: checkpoint at frame {k} of {t} with an open frame and the "
                 f"EKF; the resumed tail equals the uninterrupted run (discrete exact, values "
                 f"within {POSE_ATOL}), closure {bool(gold.loop_closure_complete)}")

    def lidar(self):
        """The lidar front-end on the card: bench.py's two scenes through
        `detect_cones` at its default seed, whose `ransac_triples` are
        VLP16_REFERENCE's (the JAX package's seed-0 triples), held to
        VLP16_REFERENCE and to the port's CPU run; then the full-sweep
        replay through the service, held to tests/test_perception.py:325's
        bounds."""
        for name, (pts, valid, acfg) in vlp16_scenes().items():
            want = VLP16_REFERENCE[name]
            if int(valid.sum()) != want["points"]:
                raise AssertionError(f"lidar {name}: {int(valid.sum())} points, want "
                                     f"{want['points']}")
            triples = ransac_triples(len(valid), acfg, 0, "cuda")
            if triples.tolist() != want["triples"]:
                raise AssertionError(f"lidar {name}: ransac_triples {triples.tolist()}, the "
                                     f"JAX package's {want['triples']}")
            p, v = torch.tensor(pts, device="cuda"), torch.tensor(valid, device="cuda")
            got = detect_cones(p, v, acfg)
            err = check_cones(f"lidar {name}", got, want["cones"])
            cones, ok, n = detect_cones(torch.tensor(pts), torch.tensor(valid), acfg)
            err_cpu = check_cones(f"lidar {name} vs the CPU run", got, cones[ok])
            self.log(f"lidar {name}: {int(valid.sum())} of {len(valid)} points, seed-0 "
                     f"triples equal to the JAX package's, {len(want['cones'])} cones as "
                     f"VLP16_REFERENCE (tuples within {err:.3g}, atol {VLP16_ATOL}), within "
                     f"{err_cpu:.3g} of the CPU run")
        svc, lm, med = sweep_replay("cuda")
        clouds = svc.metrics.counters["point_cloud_messages"]
        self.log(f"lidar sweep replay: {clouds} full sweeps through the service, "
                 f"{len(lm)} landmarks, median distance to a cone {med:.4f} m")
        if clouds != 4 or not 3 <= len(lm) <= len(SWEEP_REPLAY_CONES) + 1 or not med < 0.4:
            raise AssertionError("lidar sweep replay: outside tests/test_perception.py's bounds "
                                 "(4 sweeps, 3-6 landmarks, median < 0.4 m)")

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
        self.closure_precision(g, cfg, without)

    def closure_precision(self, g, cfg, want):
        """The closure GN under `GNConfig.matmul_precision` 'high' (TF32)
        and 'default' (torch's 'medium'; the JAX package calls it unsafe
        near closure-scale graphs), after one seeded matmul's error under
        each of torch's settings (what 'medium' runs on this card): each
        GN's largest deviation from the
        'highest' solve `want`, relative to the largest value, printed with
        its time beside 'highest'; 'high' within GN_PRECISION_RTOL. TF32 is
        off again after each call."""
        a, b = spd(1024, seed=1), spd(1024, seed=2)
        exact = a.double() @ b.double()
        for torch_prec in ("highest", "high", "medium"):
            with gn._matmul_precision(torch_prec):
                err = float((a @ b - exact).abs().max() / exact.abs().max())
            self.log(f"closure: one 1024^3 matmul under torch's '{torch_prec}' float32 "
                     f"precision: {err:.3g} relative from float64 [{self.card}]")
        ms = {"highest": statistics.median(
            cuda_ms(functools.partial(gn.optimize, g, cfg), reps=1) for _ in range(3))}
        for prec in ("high", "default"):
            pcfg = dataclasses.replace(cfg, matmul_precision=prec)
            got = gn.optimize(g, pcfg)
            torch.cuda.synchronize()
            if torch.backends.cuda.matmul.allow_tf32 or \
                    torch.get_float32_matmul_precision() != "highest":
                raise AssertionError(f"closure: TF32 left on after the '{prec}' GN")
            rel = max(float((got.poses - want.poses).abs().max() / want.poses.abs().max()),
                      float((got.lm_xy - want.lm_xy).abs().max() / want.lm_xy.abs().max()))
            ms[prec] = statistics.median(
                cuda_ms(functools.partial(gn.optimize, g, pcfg), reps=1) for _ in range(3))
            self.log(f"closure: matmul_precision '{prec}': max deviation from 'highest' "
                     f"{rel:.3g} relative (max|dpose| "
                     f"{float((got.poses - want.poses).abs().max()):.3g} m); median "
                     f"{ms[prec]:.2f} ms of 3 against {ms['highest']:.2f} ms for 'highest'; "
                     f"TF32 off again after it [{self.card}]")
            if prec == "high" and not rel <= GN_PRECISION_RTOL:
                raise AssertionError(f"closure: 'high' deviates {rel:.3g} relative from "
                                     f"'highest', over {GN_PRECISION_RTOL}")

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
    # -- after closure solve
    def parallel(self):
        """The multi-device tier on the card, each mesh path on a one-rank
        NCCL mesh and timed (CUDA events, median of 3; busy share, launches
        and reads from one profiled call): the per-frame batched engine at
        bench.py's 16 sessions (held to BATCHED_REFERENCE and to each
        session's own `run_sequence`); the fleet (held to
        `run_sequences_blocked_batched`); `distributed_optimize` through the
        Cholesky kernel at n = DISTRIBUTED_N (held to `gauss_newton.optimize`
        and DISTRIBUTED_REFERENCE); `multisession_optimize` on the 16
        sessions' graphs; the fusion with a mesh (held to FUSION_REFERENCE);
        the blocked lap with the mesh-sharded map (held to the lap without
        it). Then the same paths in a world of GLOO_RANKS gloo ranks on the
        card, held to the one-rank results. It runs after phase 6, whose
        kernel rows need exact profiler counts: after this phase's work the
        profiler has seen fewer kernel events than ran, so this phase times
        its kernels with CUDA events alone."""
        from tpuslam_torch.parallel.mesh import initialize_distributed, make_slam_mesh
        initialize_distributed("nccl")
        try:
            mesh = make_slam_mesh(1, 1, device_type="cuda")
            self.log(f"parallel: world of {torch.distributed.get_world_size()} NCCL rank, mesh "
                     f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}")
            self.par = {}
            for step in (self.parallel_batched, self.parallel_fleet, self.parallel_distributed,
                         self.parallel_multisession, self.parallel_fusion,
                         self.parallel_assoc_mesh, self.parallel_gloo):
                t0 = time.perf_counter()
                step(mesh)
                self.log(f"parallel: {step.__name__} in {time.perf_counter() - t0:.1f} s")
        finally:
            torch.distributed.destroy_process_group()

    def parallel_row(self, what: str, fn, phase: str = "parallel", frames=None) -> float:
        """One timed row of phase `parallel` (or `phase`): median of 3 calls
        (CUDA events; the caller's checked run was the warm-up), and one
        call under the profiler; its launches and reads also per keyframe
        when the call runs `frames` of them."""
        calls = sorted(cuda_ms(fn, reps=1, warmup=False) for _ in range(3))
        ms = calls[1]
        busy, kernels, reads = profile_counts(fn)
        per = (f" ({kernels / frames:.1f} and {reads / frames:.2f} per keyframe)"
               if frames else "")
        self.log(f"{phase} timing: {what}: median {ms:.2f} ms of 3 (min {calls[0]:.2f}, max "
                 f"{calls[2]:.2f}), device busy {busy:.2f} ms ({100 * busy / ms:.1f}%), "
                 f"{kernels} kernel launches, {reads} device-to-host reads{per} [{self.card}]")
        return ms

    def recording_assoc(self, shapes):
        """Swap in an association kernel wrapper that records each launch's
        (S, N, M) in `shapes`; returns the function that restores it."""
        kernel = keyframe_mod.associate_kernel

        def recording(obs_xy, obs_type, lm_xy, *a, **kw):
            shapes.append((*obs_xy.shape[:-1], lm_xy.shape[-2]))
            return kernel(obs_xy, obs_type, lm_xy, *a, **kw)
        keyframe_mod.associate_kernel = recording

        def restore():
            keyframe_mod.associate_kernel = kernel
        return restore

    def parallel_batched(self, mesh):
        """The per-frame batched engine (`run_passes_batched`) on bench.py's
        batched scenario in both configurations: each session's counts
        equal to BATCHED_REFERENCE, every session held to the blocked
        batched run of phase `batched`'s path and every PARALLEL_SINGLE_EVERY-th
        one to its own `run_sequence` on the card (discrete exact, values
        within BATCHED_ATOL, the closure frame's packet from the map before
        the deferred closure GN); with the kernel, one association launch
        per frame for all sessions at S x N x M = (16, 64, 256), then the
        kernel at that shape timed; and the launches per frame of the
        scan-form mapping step's per-session loop beside the batched step's
        on the first PARALLEL_SCAN_FRAMES frame(s)."""
        obs_n, valid_n, poses_n, t = batched_scenario(self.track, len(self.scen.times))
        obs, valid, poses = (torch.tensor(x, device="cuda") for x in (obs_n, valid_n, poses_n))
        S, N = obs.shape[0], obs.shape[2]
        cap = batched_cap(t)
        self.par.update(batched_in=(obs, valid, poses), t=t, cap=cap)
        paths = self.kernels["assoc"].setdefault("launches_by_path", {})
        shape = (S, N, cap.max_landmarks)
        for name, cfg in batched_configs(cap).items():
            shapes = []
            restore = self.recording_assoc(shapes)
            A.launches = C.launches = 0
            try:
                states, outs = run_passes_batched(obs, valid, poses, cfg, device="cuda")
                torch.cuda.synchronize()
            finally:
                restore()
            counts = {"assoc": A.launches, "cholesky": C.launches}
            metrics = [session_metrics(states, outs, s) for s in range(S)]
            for k, want in BATCHED_REFERENCE.items():
                got = [m[k] for m in metrics]
                if got != want:
                    raise AssertionError(f"per-frame batched {name}: {k} {got}, JAX package "
                                         f"{want}")
            want = {"assoc": t if name == "nearest" else 0, "cholesky": 0}
            if counts != want or len(shapes) != want["assoc"] or set(shapes) - {shape}:
                raise AssertionError(f"per-frame batched {name}: launches {counts} at "
                                     f"{set(shapes)}; want {want} at {shape}")
            blk_st, blk_outs = run_sequences_blocked_batched(
                initial_states(cap, S, "cuda"), obs, valid, poses, cfg, block=BLOCK)
            for s in range(S):
                compare_session(f"per-frame batched {name} session {s} vs blocked batched",
                                session_state(states, s), blocked_mod._take(outs, s),
                                session_state(blk_st, s), blocked_mod._take(blk_outs, s),
                                deferred=True)
            singles = list(range(0, S, PARALLEL_SINGLE_EVERY))
            for s in singles:
                one = run_sequence(initial_state(cap, "cuda"), obs[s], valid[s], poses[s], cfg)
                compare_session(f"per-frame batched {name} session {s}",
                                session_state(states, s), blocked_mod._take(outs, s), *one,
                                deferred=True)
            self.log(f"parallel: per-frame batched {name}: {S} sessions x {t} frames, capacity "
                     f"{cap}: counts equal to BATCHED_REFERENCE, every session to the blocked "
                     f"batched run and sessions {singles} to their own run_sequence (discrete "
                     f"exact, values within {BATCHED_ATOL}); launches {counts}"
                     + (f", one assoc launch per frame for all {S} sessions at S x N x M = "
                        f"{shape}" if want["assoc"] else ""))
            if name == "nearest":
                paths["per_frame_batched"] = counts["assoc"]
                self.assoc_shape_timing("per_frame_batched", shape, counts["assoc"])
            else:
                self.par["graphs"] = states.graph
            ms = self.parallel_row(
                f"run_passes_batched {name}, S={S}, {t} frames",
                lambda cfg=cfg: run_passes_batched(obs, valid, poses, cfg, device="cuda"))
            ms_b = self.parallel_row(
                f"run_sequences_blocked_batched {name}, S={S}, block {BLOCK}",
                lambda cfg=cfg: run_sequences_blocked_batched(
                    initial_states(cap, S, "cuda"), obs, valid, poses, cfg, block=BLOCK))
            self.log(f"parallel timing: {name}: per-frame batched {S * t / ms * 1e3:.1f} "
                     f"frames/s, blocked batched {S * t / ms_b * 1e3:.1f} frames/s "
                     f"({ms / ms_b:.1f}x the time) [{self.card}]")
        # the scan-form mapping step beside the vectorized one: one call
        # each (CUDA events; eager, so nothing to warm up), and one under the
        # profiler; the scan form steps every session's slots together
        k, first = PARALLEL_SCAN_FRAMES, batched_configs(cap)["first"]
        for what, cfg in (("vectorized", first),
                          ("scan form", dataclasses.replace(first, vectorized_mapping=False))):
            def run(cfg=cfg):
                return run_passes_batched(obs[:, :k], valid[:, :k], poses[:, :k], cfg,
                                          device="cuda")
            ms = cuda_ms(run, reps=1, warmup=False)
            busy, kernels, reads = profile_counts(run)
            self.log(f"parallel timing: per-frame batched first, {what} mapping step, S={S}, "
                     f"first {k} frame(s): {kernels / k:.1f} kernel launches, {reads / k:.1f} "
                     f"device-to-host reads and {ms / k:.2f} ms per frame of {S} sessions, "
                     f"device busy {busy:.2f} ms ({100 * busy / ms:.1f}%) [{self.card}]")
            if what == "scan form" and kernels / k >= SCAN_LAUNCHES_PER_FRAME:
                raise AssertionError(f"scan-form mapping step: {kernels / k:.0f} launches per "
                                     f"frame at S = {S}, not under {SCAN_LAUNCHES_PER_FRAME}")

    def assoc_shape_timing(self, key, shape, launches):
        """The association kernel at a path's (S, N, M) on S `assoc_world`s,
        beside its twin, into the `kernels` line's entry `key`."""
        S, n, m = shape
        worlds = [assoc_world(n, m, i) for i in range(S)]
        oxy, ot, lxy, lt, _ = (torch.stack([w[k] for w in worlds]) for k in range(5))
        run = functools.partial(A.associate_kernel, oxy, ot, lxy, lt, 1.44)
        nbytes = sum(x.numel() * x.element_size() for x in (oxy, ot, lxy, lt, *run()))
        r = dict(shape=list(shape), launches=launches,
                 ms=statistics.median(cuda_ms(run, reps=100) for _ in range(5)),
                 plain_ms=cuda_ms(functools.partial(A.associate_plain, oxy, ot, lxy, lt, 1.44),
                                  reps=50), library_ms=None)
        r["bound_ms"], r["bound_by"] = bound(S * assoc_flop(n, m, False), nbytes)
        self.kernels["assoc"][key] = r
        self.log(f"parallel timing: assoc {key} S={S} N={n} M={m}: per wrapper call "
                 f"{r['ms'] * 1e3:.2f} us, plain twin {r['plain_ms'] * 1e3:.1f} us, bound "
                 f"{r['bound_ms'] * 1e3:.4g} us ({r['bound_by']}) [{self.card}]")

    def parallel_fleet(self, mesh):
        """`run_fleet_blocked` over the mesh's 'sessions' axis on the same 16
        sessions at block BLOCK with the kernel: every frame done, held to
        `run_sequences_blocked_batched` (discrete exact, values within
        BATCHED_ATOL), one association launch per block at (16, 512, 256)."""
        from tpuslam_torch.parallel import run_fleet_blocked
        obs, valid, poses = self.par["batched_in"]
        cap, t = self.par["cap"], self.par["t"]
        S = obs.shape[0]
        cfg = batched_configs(cap)["nearest"]
        fleet_in = blocked_mod._pad_inputs(obs, valid, poses, cfg, BLOCK)
        nc, _ = blocked_mod._pick_compact(fleet_in[1], initial_states(cap, S, "cuda"))
        t_pad = fleet_in[0].shape[1]
        shapes = []
        restore = self.recording_assoc(shapes)
        A.launches = C.launches = 0
        try:
            st, outs, done = run_fleet_blocked(initial_states(cap, S, "cuda"), *fleet_in, cfg,
                                               mesh, block=BLOCK)
            torch.cuda.synchronize()
        finally:
            restore()
        counts = {"assoc": A.launches, "cholesky": C.launches}
        if done != [t_pad] * S:
            raise AssertionError(f"fleet: done_upto {done}, want {[t_pad] * S}")
        ref_st, ref_outs = run_sequences_blocked_batched(initial_states(cap, S, "cuda"), obs,
                                                         valid, poses, cfg, block=BLOCK)
        for s in range(S):
            compare_session(f"fleet session {s}", session_state(st, s),
                            blocked_mod._rows(blocked_mod._take(outs, s), 0, t),
                            session_state(ref_st, s), blocked_mod._take(ref_outs, s))
        kc = [session_metrics(st, outs, s)["closure_frame"] for s in range(S)]
        blocks = max(kc) // BLOCK + 1 + t_pad // BLOCK - min(kc) // BLOCK
        shape = (S, BLOCK * nc, cap.max_landmarks)
        if counts != {"assoc": blocks, "cholesky": 0} or set(shapes) != {shape}:
            raise AssertionError(f"fleet: launches {counts} at {set(shapes)}; want {blocks} "
                                 f"assoc launches at {shape}")
        self.kernels["assoc"]["launches_by_path"]["fleet"] = counts["assoc"]
        self.par.update(fleet_in=fleet_in, fleet_cfg=cfg, fleet=(st, outs, done))
        self.log(f"parallel: fleet: {S} sessions over 'sessions' at block {BLOCK} (compaction "
                 f"width {nc}), every frame done, equal to run_sequences_blocked_batched "
                 f"(discrete exact, values within {BATCHED_ATOL}); {blocks} assoc launches at "
                 f"S x N x M = {shape}")
        self.parallel_row(f"run_fleet_blocked nearest, S={S}, mesh {tuple(mesh.mesh.shape)}",
                          lambda: run_fleet_blocked(initial_states(cap, S, "cuda"), *fleet_in,
                                                    cfg, mesh, block=BLOCK))

    def parallel_distributed(self, mesh):
        """`distributed_optimize` on the graph the closure GN solves, through
        the Cholesky kernel: one launch per iteration at n = DISTRIBUTED_N,
        within POSE_ATOL of `gauss_newton.optimize` and DISTRIBUTED_REFERENCE
        within METRIC_ATOL_M; then the kernel at that size against its twin
        and `cholesky_ex`."""
        from tpuslam_torch.parallel import distributed_optimize
        g = self.closure_graph
        cfg = dataclasses.replace(_gn_config(configs()["first"]), use_cholesky_kernel=True)
        sizes, seen = [], []
        kernel = C.cholesky_kernel

        def recording(a):
            sizes.append(a.shape[-1])
            seen[:] = [a]
            return kernel(a)

        C.cholesky_kernel = recording
        A.launches = C.launches = 0
        try:
            d = distributed_optimize(g, cfg, mesh)
            torch.cuda.synchronize()
        finally:
            C.cholesky_kernel = kernel
        launches = C.launches
        if launches != cfg.iterations or set(sizes) != {DISTRIBUTED_N}:
            raise AssertionError(f"distributed: {launches} cholesky launches at {set(sizes)}, "
                                 f"want {cfg.iterations} at n = {DISTRIBUTED_N}")
        want = gn.optimize(g, _gn_config(configs()["first"]))
        torch.testing.assert_close(d.poses, want.poses, atol=POSE_ATOL, rtol=0)
        torch.testing.assert_close(d.lm_xy, want.lm_xy, atol=POSE_ATOL, rtol=0)
        got = graph_metrics(self.track, self.scen, d)
        check_metrics("distributed", got, DISTRIBUTED_REFERENCE)
        self.kernels["cholesky"]["launches_by_path"]["distributed"] = launches
        self.par.update(graph=g, gn_cfg=cfg, distributed=(d.poses, d.lm_xy))
        self.log(f"parallel: distributed_optimize: {launches} cholesky launches at n = "
                 f"{DISTRIBUTED_N}, within {POSE_ATOL} of gauss_newton.optimize "
                 f"(max|dpose| {float((d.poses - want.poses).abs().max()):.3g}); "
                 + json.dumps(got) + " as DISTRIBUTED_REFERENCE")
        self.parallel_row(f"distributed_optimize, n = {DISTRIBUTED_N}, {cfg.iterations} "
                          "iterations, Cholesky kernel",
                          lambda: distributed_optimize(g, cfg, mesh))
        s = seen[0]
        n = s.shape[-1]
        turns = [cuda_ms(f, reps=10) for f in (lambda: torch.linalg.cholesky_ex(s),
                                                lambda: C.cholesky_kernel(s),
                                                lambda: C.cholesky_kernel(s),
                                                lambda: torch.linalg.cholesky_ex(s))]
        plain = cuda_ms(lambda: C.cholesky_plain(s), reps=1)
        b_ms, b_by = bound(n ** 3 / 3, 2 * n * n * s.element_size())
        self.kernels["cholesky"]["distributed"] = dict(
            shape=[n, n], launches=launches, ms=(turns[1] + turns[2]) / 2, plain_ms=plain,
            library_ms=(turns[0] + turns[3]) / 2, bound_ms=b_ms, bound_by=b_by)
        self.log(f"parallel timing: cholesky at n = {n} (distributed_optimize's S): kernel "
                 f"{turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us per call, cholesky_ex "
                 f"{turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us, plain twin "
                 f"{plain * 1e3:.1f} us, bound {b_ms * 1e3:.3g} us ({b_by}) [{self.card}]")

    def parallel_multisession(self, mesh):
        """`multisession_optimize` on the 16 sessions' graphs after the
        per-frame batched pass (compat): within POSE_ATOL of the stacked
        `gauss_newton.optimize` at the same iterations, no kernel launched
        (the JAX package's multi-session solve takes the library)."""
        from tpuslam_torch.parallel import multisession_optimize
        stacked = self.par["graphs"]
        cfg = _gn_config(batched_configs(self.par["cap"])["first"])
        A.launches = C.launches = 0
        got = multisession_optimize(stacked, cfg, mesh)
        torch.cuda.synchronize()
        if C.launches:
            raise AssertionError(f"multisession: {C.launches} cholesky kernel launches")
        want = gn.optimize(stacked, dataclasses.replace(cfg, early_exit_tol=0.0))
        torch.testing.assert_close(got.poses, want.poses, atol=POSE_ATOL, rtol=0)
        torch.testing.assert_close(got.lm_xy, want.lm_xy, atol=POSE_ATOL, rtol=0)
        S, P = stacked.poses.shape[:2]
        self.log(f"parallel: multisession_optimize: {S} sessions, n = {3 * P} each, "
                 f"{cfg.iterations} iterations, within {POSE_ATOL} of the stacked optimize "
                 f"(max|dpose| {float((got.poses - want.poses).abs().max()):.3g})")
        self.parallel_row(f"multisession_optimize, S={S}, n = {3 * P}",
                          lambda: multisession_optimize(stacked, cfg, mesh))

    def parallel_fusion(self, mesh):
        """bench.py's fusion (phase `fusion`'s sessions, dense) through
        `fuse_sessions(mesh=...)`: the landmark-sharded dedup and the joint
        GN as `distributed_optimize` (n = 9216, `cholesky_ex`), both
        variants held to FUSION_REFERENCE (counts exact, map errors within
        METRIC_ATOL_M)."""
        cfg, run = self.fusion_run
        gcfg = fusion_gn_config(cfg)
        gate = cfg.same_cone_threshold
        st, st_d = run["states"], run["states_d"]

        def fuse():
            return fuse_sessions(st.graph, cfg=gcfg, gate=gate, lm_info=st.lm_info_xy,
                                 align=False, mesh=mesh)
        fused, rep = fuse()
        fused_d, rep_d = fuse_sessions(st_d.graph, cfg=gcfg, gate=2.0 * gate,
                                       lm_info=st_d.lm_info_xy, align=True, robust=True,
                                       mesh=mesh)
        r, r_d = fusion_report(rep), fusion_report(rep_d)
        got = dict(fused_landmarks=r["n_merged_landmarks"],
                   cross_session_merges=r["n_cross_session_merges"],
                   fused_landmarks_drifted=r_d["n_merged_landmarks"],
                   cross_session_merges_drifted=r_d["n_cross_session_merges"],
                   map_error_fused_m=map_error(self.track, fused),
                   map_error_fused_drifted_m=map_error(self.track, fused_d))
        check_fusion("mesh", got)
        g = st.graph
        valid = (torch.arange(g.lm_xy.shape[1], device="cuda")[None] < g.n_landmarks[:, None])
        self.par["dedup_in"] = (g.lm_xy.reshape(-1, 2), g.lm_type.reshape(-1),
                                valid.reshape(-1), gate)
        self.par["labels"] = rep["labels"]
        self.log("parallel: fuse_sessions(mesh): " + json.dumps(got)
                 + " as FUSION_REFERENCE (counts exact, map errors within "
                 f"{METRIC_ATOL_M} m)")
        self.parallel_row(f"fuse_sessions(mesh), {g.poses.shape[0]} sessions, joint GN "
                          f"n = {3 * fused.poses.shape[0]}", fuse)

    def parallel_assoc_mesh(self, mesh):
        """`run_sequence_blocked(..., assoc_mesh=mesh)` on the bench lap
        (ASSOC_MESH_RUNS): the kernel never launched, held to the lap
        without the mesh (discrete exact, values within POSE_ATOL, then the
        JAX package's numbers too) or, if a gate decision flipped, to the
        cross-path contract."""
        obs, valid, poses = inputs(self.scen, "cuda")
        for run, (cfg_name, block) in ASSOC_MESH_RUNS.items():
            cfg = {**configs(), **improved_configs()}[cfg_name]

            def lap(cfg=cfg, block=block, m=mesh):
                return run_sequence_blocked(initial_state(CAP, "cuda"), obs, valid, poses, cfg,
                                            block=block, assoc_mesh=m)
            A.launches = C.launches = 0
            got = lap()
            torch.cuda.synchronize()
            if A.launches:
                raise AssertionError(f"assoc_mesh {run}: {A.launches} assoc kernel launches")
            want = lap(m=None)
            exact = compare_mesh_lap(f"assoc_mesh {run}", got, want)
            metrics = lap_metrics(self.track, self.scen, *got)
            if exact:
                check_metrics(run, metrics)
            self.log(f"parallel: run_sequence_blocked {run} at block {block} with the "
                     f"mesh-sharded map: " + json.dumps(metrics) + (
                         f"; equal to the lap without the mesh (discrete exact, values within "
                         f"{POSE_ATOL}) and to the JAX package's numbers" if exact else
                         "; a gate decision differs from the lap without the mesh: within "
                         "the cross-path contract"))
            self.parallel_row(f"run_sequence_blocked {run}, block {block}, assoc_mesh", lap)
            if run == "first":
                # phase 6 times the I2 lap at block 16 without the mesh, and
                # the compat lap at block 32 only
                self.parallel_row(f"run_sequence_blocked {run}, block {block}, no mesh",
                                  functools.partial(lap, m=None))

    def parallel_gloo(self, mesh):
        """The mesh paths in a world of GLOO_RANKS gloo ranks on cuda:0,
        spawned here (the kernels already built): `distributed_optimize` and
        the map-sharded association (the pod map) over 'edges', the fleet
        over 'sessions', the dedup over 'edges'. Each rank's results are held
        to the one-rank run of the same paths: decisions exact, the GN
        within the JAX test's 5e-4, the fleet's values within BATCHED_ATOL."""
        from tpuslam_torch.parallel import associate_sharded
        from tpuslam_torch.ops.association import associate
        work = {k: self.par[k] for k in ("graph", "gn_cfg", "fleet_cfg", "dedup_in")}
        S = self.par["fleet_in"][0].shape[0]
        work["fleet_in"] = (initial_states(self.par["cap"], S, "cuda"), *self.par["fleet_in"])
        one = gloo_paths(mesh, mesh, work)
        torch.cuda.synchronize()
        dense = {f"{m}{'_bug' if b else ''}": assoc_mesh_call(associate, assoc_mesh_inputs("cuda"),
                                                               m, b)
                 for m, b in ASSOC_MESH_CASES}
        for k, (idx, matched, cost) in one["assoc"].items():
            if not (torch.equal(matched, dense[k][1])
                    and torch.equal(idx[matched], dense[k][0][matched])):
                raise AssertionError(f"gloo: one-rank associate_sharded {k} differs from the "
                                     "dense association")
        ranks, wall = spawn_world(gloo_rank, GLOO_RANKS, GLOO_TIMEOUT_S, work, "gloo world")
        one_st, one_outs, one_done = one["fleet"]
        for r, got in enumerate(ranks):
            what = f"gloo rank {r}"
            if not got["on_cuda"]:
                raise AssertionError(f"{what}: results not on the card")
            for a, b in zip(got["distributed"], one["distributed"]):
                torch.testing.assert_close(a, b, atol=5e-4, rtol=0, msg=f"{what}: distributed")
            for k, (idx, matched, cost) in got["assoc"].items():
                o_idx, o_matched, o_cost = one["assoc"][k]
                if not (torch.equal(matched, o_matched) and torch.equal(idx, o_idx)):
                    raise AssertionError(f"{what}: associate_sharded {k} decisions differ")
                torch.testing.assert_close(cost, o_cost, rtol=1e-6, atol=0, msg=f"{what}: {k}")
            st, outs, done = got["fleet"]
            if done != one_done:
                raise AssertionError(f"{what}: fleet done_upto {done}, one rank {one_done}")
            for s in range(S):
                compare_session(f"{what} fleet session {s}", session_state(st, s),
                                blocked_mod._take(outs, s), session_state(one_st, s),
                                blocked_mod._take(one_outs, s))
            if not torch.equal(got["labels"], one["labels"]):
                raise AssertionError(f"{what}: dedup labels differ")
            self.log(f"parallel: {what} of {GLOO_RANKS} (gloo on cuda:0): distributed_optimize "
                     f"over 'edges' within 5e-4 of one rank (max|dpose| "
                     f"{float((got['distributed'][0] - one['distributed'][0]).abs().max()):.3g}), "
                     f"associate_sharded {list(got['assoc'])} at {ASSOC_SHAPES['pod']} exact, "
                     f"the fleet over 'sessions' ({S // GLOO_RANKS} sessions per rank) equal "
                     f"(discrete exact, values within {BATCHED_ATOL}), dedup labels exact; "
                     f"kernel launches {got['launches']}")
        self.log(f"parallel: gloo world of {GLOO_RANKS} ranks on cuda:0 in {wall:.1f} s "
                 f"(spawn included)")

    # -- after parallel
    def chain(self):
        """The pose-chain solvers (CHAIN_SOLVERS) on bench_scaling.py's chain
        graph (`chain_synth`) and on the fusion's joint graph (phase
        `fusion`'s dense sessions merged, n = 9216), and `fuse_sessions`'
        chain solvers on those sessions: first on a one-rank NCCL chain mesh
        (every partitioner takes one shard), each solve held to the
        single-device `gauss_newton.optimize` (CHAIN_ATOL) and timed, no
        kernel launched, its payload per iteration counted against the
        analytic one; then in a world of CHAIN_RANKS gloo ranks on cuda:0."""
        from tpuslam_torch.parallel.mesh import initialize_distributed, make_chain_mesh
        cfg, run = self.fusion_run
        st, gate = run["states"], cfg.same_cone_threshold
        fused, _ = fuse_sessions(st.graph, cfg=None, gate=gate, lm_info=st.lm_info_xy,
                                 align=False)
        fcfg = dataclasses.replace(fusion_gn_config(cfg), iterations=CHAIN_ITERATIONS,
                                   early_exit_tol=0.0)
        synth = chain_synth(CHAIN_SYNTH, CHAIN_SYNTH)
        synth64 = dataclasses.replace(synth, **{f.name: getattr(synth, f.name).double()
                                                for f in dataclasses.fields(synth)
                                                if getattr(synth, f.name).is_floating_point()})
        scfg = gn.GNConfig(iterations=CHAIN_ITERATIONS)
        work = dict(graphs={"synth64": synth64, "fused": fused},
                    timed={"synth": synth, "fused": fused},
                    cfg={"synth64": scfg, "synth": scfg, "fused": fcfg}, sessions=st, gate=gate)
        ref = {name: gn.optimize(g, work["cfg"][name]) for name, g in work["graphs"].items()}
        ref["auto"] = fuse_sessions(st.graph, cfg=fcfg, gate=gate, lm_info=st.lm_info_xy,
                                    align=False)[0]
        for name, g in work["timed"].items():
            self.log(f"chain: graph {name}: {int(g.n_poses)} poses, {int(g.n_landmarks)} "
                     f"landmarks, {int(g.n_obs)} edges, {work['cfg'][name].iterations} "
                     f"iterations; the single-device GN in "
                     f"{cuda_ms(functools.partial(gn.optimize, g, work['cfg'][name]), 1):.2f} ms "
                     f"[{self.card}]")
        dx, dth = pose_gap(gn.optimize(synth, scfg).poses, ref["synth64"].poses)
        self.log(f"chain: synth in FP32: the single-device GN ends {dx:.4g} m / {dth:.4g} rad "
                 "from the float64 one (the graph's FP32 conditioning)")
        initialize_distributed("nccl")
        try:
            mesh = make_chain_mesh(1, device_type="cuda")
            A.launches = C.launches = 0
            one = chain_paths(mesh, work)
            torch.cuda.synchronize()
            launches = {"assoc": A.launches, "cholesky": C.launches}
            self.check_chain("one NCCL rank", {k: {s: (r.poses, r.lm_xy) for s, r in v.items()}
                                               for k, v in one["graphs"].items()},
                             {k: (r.poses, r.lm_xy) for k, r in one["fuse_sessions"].items()},
                             work, ref, launches)
            for name, g in work["timed"].items():
                for solver in CHAIN_SOLVERS:
                    ms = self.parallel_row(
                        f"{solver} on {name}, D = 1, {work['cfg'][name].iterations} iterations",
                        functools.partial(chain_solve, g, work["cfg"][name], mesh, solver),
                        phase="chain")
                    self.log(f"chain timing: {solver} on {name}, D = 1: {ms:.2f} ms per solve "
                             f"[{self.card}]")
            self.log_payload("one NCCL rank, D = 1", one["payload"])
        finally:
            torch.distributed.destroy_process_group()
        self.chain_gloo(work, ref)
        self.log("chain: scaling efficiency across cards is not measured: the run has one "
                 "card, NCCL puts no two ranks on one card, and the gloo world on cuda:0 "
                 "shows that the solvers are right, not how they scale")

    def check_chain(self, what, graphs, fused_solvers, work, ref, launches):
        """Each solve against the single-device GN on its graph's active rows
        (CHAIN_ATOL), `fuse_sessions`' chain solvers against solver='auto',
        and no kernel launched."""
        if any(launches.values()):
            raise AssertionError(f"chain {what}: kernel launches {launches}; the chain solvers "
                                 "factor with cholesky_ex")
        dev = {}
        for name, res in graphs.items():
            if name == "synth":
                # FP32 on the ill-conditioned chain graph: reported against
                # the float64 single-device solve, not held
                n_p = int(work["timed"]["synth"].n_poses)
                dev.update({f"synth FP32/{s} (m, rad)": pose_gap(p[:n_p],
                                                                 ref["synth64"].poses[:n_p])
                            for s, (p, lm) in res.items()})
                continue
            g = work["graphs"][name]
            n_p, n_l = int(g.n_poses), int(g.n_landmarks)
            for solver, (p, lm) in res.items():
                atol = CHAIN_ATOL[name][solver]
                torch.testing.assert_close(p[:n_p], ref[name].poses[:n_p], atol=atol, rtol=0,
                                           msg=f"chain {what}: {solver} on {name}: poses")
                torch.testing.assert_close(lm[:n_l], ref[name].lm_xy[:n_l], atol=atol, rtol=0,
                                           msg=f"chain {what}: {solver} on {name}: landmarks")
                dev[f"{name}/{solver}"] = float((p[:n_p] - ref[name].poses[:n_p]).abs().max())
        g = work["graphs"]["fused"]
        n_p, n_l = int(g.n_poses), int(g.n_landmarks)
        for solver, (p, lm) in fused_solvers.items():
            atol = CHAIN_ATOL["fuse_sessions"]
            torch.testing.assert_close(p[:n_p], ref["auto"].poses[:n_p], atol=atol, rtol=0,
                                       msg=f"chain {what}: fuse_sessions({solver}): poses")
            torch.testing.assert_close(lm[:n_l], ref["auto"].lm_xy[:n_l], atol=atol, rtol=0,
                                       msg=f"chain {what}: fuse_sessions({solver}): landmarks")
            dev[f"fuse_sessions/{solver}"] = float(
                (p[:n_p] - ref["auto"].poses[:n_p]).abs().max())
        self.log(f"chain: {what}: every solve within CHAIN_ATOL of the single-device GN "
                 f"(fuse_sessions' solvers of solver='auto'); max|dpose| "
                 + json.dumps({k: [float(f"{x:.3g}") for x in v] if isinstance(v, tuple)
                               else float(f"{v:.3g}") for k, v in dev.items()})
                 + f"; kernel launches {launches}")

    def log_payload(self, what, payload):
        """Each solver's counted payload per iteration beside the analytic."""
        for solver, (counted, analytic) in payload.items():
            self.log(f"chain payload: {what}, {solver} on synth: counted per iteration "
                     + json.dumps(counted) + "; analytic psum " + json.dumps(analytic["psum"])
                     + ", all_gather per rank " + json.dumps(analytic["all_gather"]))
            if counted.get("psum") != analytic["psum"] or \
                    counted.get("all_gather") != analytic["all_gather"]:
                raise AssertionError(f"chain payload {what} {solver}: counted {counted}, "
                                     f"analytic {analytic}")

    def chain_gloo(self, work, ref):
        """CHAIN_RANKS gloo ranks on cuda:0 (spawned; the kernels built):
        `chain_paths` over a chain mesh of CHAIN_RANKS, each rank's results
        held to the single-device references, its solves timed on the host
        clock, its payloads per iteration against the analytic ones."""
        ranks, wall = spawn_world(chain_rank, CHAIN_RANKS, CHAIN_TIMEOUT_S, work,
                                  "chain gloo world")
        for r, got in enumerate(ranks):
            what = f"gloo rank {r} of {CHAIN_RANKS}"
            self.check_chain(what, got["graphs"], got["fuse_sessions"], work, ref,
                             got["launches"])
            self.log_payload(f"{what}, D = {CHAIN_RANKS}", got["payload"])
            self.log(f"chain timing: {what} (host clock, one solve each after the checked "
                     "ones; 4 ranks share cuda:0 and reduce through the host): "
                     + json.dumps({k: round(v, 2) for k, v in got["ms"].items()})
                     + f" ms [{self.card}]")
        self.log(f"chain: gloo world of {CHAIN_RANKS} ranks on cuda:0 in {wall:.1f} s (spawn "
                 "included)")

    # -- after chain
    def resident(self):
        """The map-resident online pass (`resident_runs`) on the bench lap:
        the dense `run_pass_blocked` of each configuration on the card, then
        the resident pass on a one-rank NCCL ('map',) mesh, held to it
        (`compare_resident`) and to REFERENCE's counts, no kernel launched,
        the returned blocks of Lb rows, each run's collectives per keyframe;
        the RESIDENT_TIMED laps timed beside their dense ones (CUDA events,
        median of 3 after the checked run; one profiled call each). Then
        the same passes in a world of RESIDENT_RANKS gloo ranks on cuda:0."""
        from tpuslam_torch.parallel.mesh import initialize_distributed, make_map_mesh
        from tpuslam_torch.parallel.resident_online import run_pass_resident_online
        ins = inputs(self.scen, "cuda")
        t = ins[0].shape[0]
        t0 = time.perf_counter()
        dense = {name: run_pass_blocked(*ins, cfg, block=block)
                 for name, (cfg, block, _) in resident_runs().items()}
        self.log(f"resident: the dense laps in {time.perf_counter() - t0:.1f} s")
        initialize_distributed("nccl")
        try:
            mesh = make_map_mesh(1, device_type="cuda")
            A.launches = C.launches = 0
            t0 = time.perf_counter()
            one = resident_paths(mesh, ins)
            torch.cuda.synchronize()
            self.log(f"resident: the resident laps on one NCCL rank in "
                     f"{time.perf_counter() - t0:.1f} s")
            launches = {"assoc": A.launches, "cholesky": C.launches}
            self.check_resident("one NCCL rank", one, dense, launches, CAP.max_landmarks)
            for name, calls in one["collectives"].items():
                self.log(f"resident: {name}: {sum(calls.values()) / t:.3f} collectives per "
                         "keyframe on one NCCL rank " + json.dumps(calls))
            for name in RESIDENT_TIMED:
                cfg, block, _ = resident_runs()[name]
                ms = self.parallel_row(
                    f"resident {name}, block {block}, D = 1",
                    functools.partial(run_pass_resident_online, *ins, cfg, mesh, block=block),
                    phase="resident", frames=t)
                dense_ms = self.parallel_row(
                    f"dense blocked {name}, block {block}",
                    functools.partial(run_pass_blocked, *ins, cfg, block=block),
                    phase="resident", frames=t)
                self.log(f"resident timing: {name} at block {block}: {ms:.2f} ms per lap on one "
                         f"NCCL rank against {dense_ms:.2f} ms dense ({ms / dense_ms:.2f}x) "
                         f"[{self.card}]")
        finally:
            torch.distributed.destroy_process_group()
        self.resident_gloo(ins, one)

    def check_resident(self, what, got, dense, launches, lb):
        """Each resident lap against the dense lap and REFERENCE's counts;
        no kernel launched; the core's blocks of `lb` rows on the card."""
        if any(launches.values()):
            raise AssertionError(f"resident {what}: kernel launches {launches}")
        shapes, on_cuda, complete = got["shards"]
        if shapes != [(lb, 2), (lb,), (lb, 3)] or not on_cuda or not complete:
            raise AssertionError(f"resident {what}: blocks {shapes} on the card {on_cuda}, "
                                 f"complete {complete}; want {lb} rows")
        for name, (cfg, block, ref) in resident_runs().items():
            err = compare_resident(f"resident {what} {name}", name, got["runs"][name],
                                   dense[name])
            metrics = lap_metrics(self.track, self.scen, *got["runs"][name])
            if ref is not None:
                check_resident_counts(f"resident {what} {name}", name, ref, metrics)
            self.log(f"resident: {what}, {name} at block {block}: " + json.dumps(metrics)
                     + f"; held to the dense lap (max value difference {err:.3g})"
                     + (f" and to REFERENCE[{ref!r}]'s counts" if ref else "")
                     + f"; blocks of {lb} rows; kernel launches {launches}")

    def resident_gloo(self, ins, one):
        """RESIDENT_RANKS gloo ranks on cuda:0 (spawned; the kernels built):
        `resident_paths` over a ('map',) mesh of RESIDENT_RANKS, every
        rank's laps held to the one-rank laps by the same rules, its blocks
        of CAP.max_landmarks / RESIDENT_RANKS rows."""
        ranks, wall = spawn_world(resident_rank, RESIDENT_RANKS, RESIDENT_TIMEOUT_S, ins,
                                  "resident gloo world")
        for r, got in enumerate(ranks):
            self.check_resident(f"gloo rank {r} of {RESIDENT_RANKS}", got, one["runs"],
                                got["launches"], CAP.max_landmarks // RESIDENT_RANKS)
            if got["collectives"] != one["collectives"]:
                self.log(f"resident: gloo rank {r}: collectives {got['collectives']} against "
                         f"one rank's {one['collectives']}")
        self.log(f"resident: gloo world of {RESIDENT_RANKS} ranks on cuda:0 in {wall:.1f} s "
                 f"(spawn included) [{self.card}]")

    # -- after resident
    def cli(self):
        """The port's CLI in this process on the card (see the module
        docstring): every command's output held to a reference, the sim
        runs timed beside their direct laps, no kernel launched."""
        from tpuslam_torch.entry import dryrun_multichip, entry
        from tpuslam_torch.io import envelope as E
        from tpuslam_torch.io import proto
        from tpuslam_torch.native import codec as native_codec
        from tpuslam_torch.parallel.mesh import initialize_distributed, make_map_mesh
        from tpuslam_torch.parallel.resident_online import run_pass_resident_online
        if torch.distributed.is_initialized():
            raise AssertionError("cli: a process group is left from an earlier phase")
        A.launches = C.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            rec = os.path.join(tmp, "skidpad.rec")
            sk, sk_wall = cli_json(["sim", "skidpad", "--rec-out", rec])
            sk_cpu, _ = cli_json(["--device", "cpu", "sim", "skidpad"])
            check_cli("sim skidpad", sk, sk_cpu, ("frames", "loop_closed", "landmarks"),
                      ("ate_published_m", "ate_odometry_m"))
            self.log(f"cli: sim skidpad: {json.dumps(sk)}; held to the CPU run; "
                     f"{sk_wall:.2f} s in all")

            # trackdrive through the three pipelines, and the same laps direct
            track = trackdrive(seed=0)
            scen = simulate(track, CLI_SIM)
            ins = inputs(scen, "cuda")
            cfg = SlamConfig()
            sims = {}
            for pipe, extra in (("live", []), ("blocked", ["--block", str(CLI_BLOCK)]),
                                ("resident", ["--block", str(CLI_BLOCK), "--map-shards", "1"])):
                sims[pipe] = cli_json(["sim", "trackdrive", "--pipeline", pipe, *extra])
            live = sims["live"][0]
            if not live["loop_closed"]:
                raise AssertionError(f"cli: sim trackdrive live did not close the loop: {live}")
            for pipe in ("blocked", "resident"):
                check_cli(f"sim trackdrive {pipe}", sims[pipe][0], live,
                          ("frames", "loop_closed", "landmarks"), ("ate_published_m",))
            _, live_s = timed(lambda: Slam(cfg, device="cuda").run_scenario(scen))

            def blocked():
                return run_pass_blocked(*ins, cfg, block=CLI_BLOCK)
            _, blocked_first = timed(blocked)
            _, blocked_s = timed(blocked)
            initialize_distributed("nccl")
            try:
                mesh = make_map_mesh(1, device_type="cuda")

                def resident():
                    return run_pass_resident_online(*ins, cfg, mesh, block=CLI_BLOCK)
                _, resident_first = timed(resident)
                _, resident_s = timed(resident)
            finally:
                torch.distributed.destroy_process_group()
            t = len(scen.times)
            direct = {"live": (live_s, live_s), "blocked": (blocked_s, blocked_first + blocked_s),
                      "resident": (resident_s, resident_first + resident_s)}
            for pipe, (res, wall) in sims.items():
                lap_s, both_s = direct[pipe]
                self.log(f"cli timing: sim trackdrive --pipeline {pipe} ({t} frames): the CLI "
                         f"reports {json.dumps(res)}, {wall:.3f} s for the whole command; "
                         f"the direct lap {t / lap_s:.1f} frames/s ({lap_s * 1e3:.2f} ms), "
                         f"{both_s:.3f} s with its warm-up run [{self.card}]")

            # replay with a checkpoint, which loads
            ck = os.path.join(tmp, "replay.npz")
            out, _, wall = cli_call(["replay", rec, "--timeBetweenKeyframes", "100",
                                     "--checkpoint", ck])
            snap = json.loads(out)
            state, _ = load_checkpoint(ck, device="cuda")
            if not (snap["gauges"]["loop_closed"] is True
                    and int(state.graph.n_landmarks) == snap["gauges"]["landmarks"] > 20):
                raise AssertionError(f"cli replay: gauges {snap['gauges']}, checkpoint "
                                     f"{int(state.graph.n_landmarks)} landmarks")
            self.log(f"cli: replay --checkpoint: {snap['gauges']['landmarks']} landmarks, loop "
                     f"closed, {snap['counters']}; the checkpoint loads on the card ({wall:.2f} s)")

            # export and msc
            n_env = len(list(E.iterate_envelopes(open(rec, "rb").read())))
            for fmt, typ in (("jsonl", "1134"), ("csv", "1116")):
                path = os.path.join(tmp, f"export.{fmt}")
                _, err, _ = cli_call(["export", rec, "--format", fmt, "--type", typ,
                                      "--out", path])
                lines = open(path).read().strip().splitlines()
                if not lines:
                    raise AssertionError(f"cli export {fmt}: empty ({err.strip()})")
                self.log(f"cli: export {fmt} --type {typ}: {len(lines)} lines of {n_env} "
                         f"envelopes ({err.strip()})")
            out, _, _ = cli_call(["msc", "--out", os.path.join(tmp, "gen.py")])
            src = open(os.path.join(tmp, "gen.py")).read()
            if "from tpuslam_torch.io import messages as _M" not in src:
                raise AssertionError("cli msc: the module does not import the port's messages")
            self.log(f"cli: msc: {out.strip()}")

            # fuse, held to the CPU run
            fz, fz_wall = cli_json(CLI_FUSE)
            fz_cpu, fz_cpu_wall = cli_json(["--device", "cpu", *CLI_FUSE])
            check_cli("fuse", fz, fz_cpu, [k for k in fz_cpu
                                           if k not in ("fuse_seconds", "map_error_m")],
                      ("map_error_m",))
            self.log(f"cli: fuse: {json.dumps(fz)}; held to the CPU run (its fusion "
                     f"{fz_cpu['fuse_seconds']} s); {fz_wall:.2f} s in all on the card, "
                     f"{fz_cpu_wall:.2f} s on the CPU [{self.card}]")

            # the native codec, built here with g++
            buf = open(rec, "rb").read()
            if not native_codec.available():
                raise AssertionError("cli: the native codec did not build")
            got = [proto.encode(proto.decode(M.Envelope, buf[o:o + n]))
                   for o, n in native_codec.scan_frames(buf)]
            if got != [proto.encode(e) for e in E.iterate_envelopes(buf)]:
                raise AssertionError("cli: the native scan differs from Python's framing")
            self.log(f"cli: native codec built; its scan of the recording equals Python's "
                     f"framing ({len(got)} envelopes)")

            # a trace of one blocked lap, in a fresh process: the profiler
            # has dropped kernel events after the long profiles of phase 6
            tr = traced_blocked_lap_in_child(os.path.join(tmp, "trace"))
            if tr["kernels"] < 1 or tr["stages"] < 1:
                raise AssertionError(f"cli trace: {tr}")
            self.log(f"cli: trace_session around one blocked lap (a fresh process, "
                     f"{tr['wall_s']:.1f} s): {tr['kernels']} CUDA kernel events, "
                     f"{tr['events']} events, {tr['bytes']} bytes")

        # the entry points
        fn, args = entry()
        st_g, out_g = fn(*args)
        fn_c, args_c = entry("cpu")
        st_c, out_c = fn_c(*args_c)
        err = max(float((getattr(st_g.graph, f.name).cpu().float()
                         - getattr(st_c.graph, f.name).float()).abs().max())
                  for f in dataclasses.fields(st_g.graph))
        err = max(err, float((out_g.pose.cpu() - out_c.pose).abs().max()))
        if err > POSE_ATOL:
            raise AssertionError(f"cli: entry() on the card differs from the CPU by {err}")
        initialize_distributed("nccl")
        try:
            dry = dryrun_multichip(1)
        finally:
            torch.distributed.destroy_process_group()
        self.log(f"cli: entry() within {err:.3g} of the CPU; dryrun_multichip(1) on one NCCL "
                 f"rank: {json.dumps(dry)}")
        launches = {"assoc": A.launches, "cholesky": C.launches}
        if any(launches.values()):
            raise AssertionError(f"cli: kernel launches {launches}: hold them to their twins")
        self.log(f"cli: kernel launches {launches}")

    def deploy(self):
        """The deployment surface on the card (see the module docstring):
        the multi-process smoke and its death case, the chain script, the
        installed copy. No kernel is launched in this process."""
        from tpuslam_torch.deploy import multihost_smoke as MS
        from tpuslam_torch.parallel.chain import partition_chain
        from tpuslam_torch.scripts import bench_chain_solvers as BCS
        if torch.distributed.is_initialized():
            raise AssertionError("deploy: a process group is left from an earlier phase")
        A.launches = C.launches = 0
        for n in DEPLOY_PROCS:
            r = MS.run_group(n, "cuda", timeout_s=DEPLOY_GROUP_TIMEOUT_S,
                             pg_timeout_s=DEPLOY_PG_TIMEOUT_S)
            want = "nccl" if n <= torch.cuda.device_count() else "gloo"
            if not r["ok"] or r["backend"] != [want]:
                raise AssertionError(f"deploy: the smoke of {n} rank(s), {want} wanted: "
                                     f"{json.dumps(r)}")
            ws = r["workers"]
            gn_err = max(w["max_abs_err_vs_single_device"] for w in ws)
            fleet_err = max(w["fleet_max_abs_err"] for w in ws)
            self.log(f"deploy: multi-process smoke, {n} rank(s), {want}: every rank ok and "
                     f"fleet_blocked_ok; GN within {gn_err:.3g} of the single-device solve, "
                     f"fleet within {fleet_err:.3g} (atol {MS.SMOKE_ATOL}); {r['seconds']:.1f} s "
                     f"with the spawn [{self.card}]")
        d = MS.run_death_case(max(DEPLOY_PROCS), "cuda",
                              survivor_timeout_s=DEPLOY_SURVIVOR_TIMEOUT_S,
                              pg_timeout_s=DEPLOY_PG_TIMEOUT_S)
        if not (d["ok"] and d["no_hang"]):
            raise AssertionError(f"deploy: the death case: {json.dumps(d)}")
        self.log(f"deploy: death case, {d['procs']} ranks, the last SIGKILLed once up: "
                 f"survivor codes {d['survivor_rcs']}, running at the kill "
                 f"{d['running_at_kill']}, out {d['survivors_left_s']:.2f} s after it, no hang; "
                 f"{d['seconds']:.1f} s in all")

        t0 = time.perf_counter()
        rows = BCS.main(["--sizes", DEPLOY_CHAIN_SIZES])
        if torch.distributed.is_initialized():
            raise AssertionError("deploy: bench_chain_solvers left its process group")
        for row in rows:
            want = partition_chain(chain_synth(row["poses"], row["landmarks"], "cpu"), 1).n_shared
            times = (row["replicated_ms"], row["dd_ms"], row["speedup"])
            if row["n_shared"] != want or not all(np.isfinite(t) and t > 0 for t in times):
                raise AssertionError(f"deploy: bench_chain_solvers row {row}, n_shared {want} "
                                     "on the CPU")
            self.log(f"deploy: bench_chain_solvers, one NCCL rank: {json.dumps(row)} "
                     f"[{self.card}]")
        self.log(f"deploy: bench_chain_solvers in {time.perf_counter() - t0:.1f} s; each "
                 "n_shared equal to the CPU plan's")

        self.installed_copy()
        launches = {"assoc": A.launches, "cholesky": C.launches}
        if any(launches.values()):
            raise AssertionError(f"deploy: kernel launches in this process {launches}")

    def installed_copy(self):
        """The wheel of the tree installed with --target into a temporary
        directory; in a fresh process with that directory as its only path
        to the package (run from outside the checkout), `_build.build_all()`
        with nvcc, then one association launch at the lap shape held
        bit-equal to its twin and one Cholesky at DEPLOY_CHOL_N held to its
        twin within phase 2's tolerance."""
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            wheel = tree_wheel(tmp)
            inst = os.path.join(tmp, "installed")
            run_checked([*PIP, "install", "--no-deps", "--no-index", "--target", inst,
                         str(wheel)], "pip install --target")
            n, m = ASSOC_SHAPES["lap"]
            inputs = os.path.join(tmp, "inputs.pt")
            torch.save(dict(assoc=[x.cpu() for x in assoc_world(n, m, 0)[:4]], gate2=1.44,
                            chol=spd(DEPLOY_CHOL_N).cpu(), atol=CHOL_ATOL, rtol=CHOL_RTOL),
                       inputs)
            installed_s = time.perf_counter() - t0
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            env["PYTHONPATH"] = inst
            done = run_checked([sys.executable, "-c", INSTALLED_CHECK, inst, inputs],
                               "the installed copy", cwd=tmp, env=env, timeout=600)
            r = json.loads(done.stdout.strip().splitlines()[-1])
        if not (r["package"].startswith(inst) and all(p.startswith(inst) for p in r["libs"])):
            raise AssertionError(f"deploy: the installed copy imported or built outside "
                                 f"{inst}: {r}")
        if not (r["assoc_equal"] and r["chol_close"] and not r["imported"]
                and r["launches"] == {"assoc": 1, "cholesky": 1}):
            raise AssertionError(f"deploy: the installed copy's kernels: {r}")
        self.log(f"deploy: the installed copy (wheel built and installed with --target in "
                 f"{installed_s:.1f} s): both kernels built by nvcc from it in "
                 f"{r['build_s']:.1f} s; assoc N={n} M={m} bit-equal to its twin "
                 f"({r['assoc_matched']} matched), {r['assoc_ms'] * 1e3:.2f} us per wrapper "
                 f"call; cholesky n={DEPLOY_CHOL_N} max|kernel - plain| = {r['chol_err']:.3g} "
                 f"(atol {CHOL_ATOL}, rtol {CHOL_RTOL}), {r['chol_ms'] * 1e3:.1f} us per "
                 f"call; one launch each [{self.card}]")
        self.log(f"deploy: the installed copy in {time.perf_counter() - t0:.1f} s in all")

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
        self.fusion_kernel_timing()
        self.lap_profile(obs, valid, poses, lap_ms)
        self.batched_timing()
        self.fusion_timing()
        self.service_timing()
        for k in self.kernels.values():
            self.log(f"timing: {k['name']} per wrapper call {k['ms'] * 1e3:.1f} us, device "
                     f"{k['device_ms'] * 1e3:.2f} us per launch, plain twin "
                     f"{k['plain_ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.4g} us "
                     f"({k['bound_by']}) [{self.card}]")
        self.log(f"timing: cholesky n={n}: kernel {turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us, "
                 f"torch.linalg.cholesky_ex {turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us "
                 f"(in turns: library, kernel, kernel, library) [{self.card}]")

    def service_timing(self):
        """The live path's rows: the bench-lap replay through the service in
        both SERVICE_CONFIGS, ms per keyframe (host clock around each
        `process_frame` up to a synchronize; median and p99) and, from one
        replay profiled on the device, launches and device-to-host reads per
        keyframe, beside the direct per-frame laps that `lap_profile` logs;
        one EKF predict plus the updates of a GPS and of an
        IMU message; `detect_cones` at bench.py's two scenes (CUDA events,
        median of 3 runs of 10 sweeps after a warm-up), beside the sensor's
        10 Hz."""
        for name in SERVICE_CONFIGS:
            t0 = time.perf_counter()
            cfg = service_config(name)
            svc, rec = service_replay(cfg, self.scen, "cuda", sync=True)
            ms = np.array(rec.seconds) * 1e3
            t = len(ms)
            busy, kernels, reads = profile_counts(
                functools.partial(service_replay, cfg, self.scen, "cuda"))
            self.log(f"timing: service replay {name}: {t} keyframes, median "
                     f"{np.median(ms):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms, max "
                     f"{ms.max():.3f} ms per keyframe (process_frame to a synchronize), "
                     f"{kernels / t:.1f} kernel launches and {reads / t:.2f} device-to-host reads "
                     f"per keyframe, device busy {busy:.1f} ms; the direct per-frame lap of "
                     f"this call is the '{name}' row above [{self.card}] "
                     f"({time.perf_counter() - t0:.1f} s)")
        ekf = motion.ekf_init(torch.zeros(3, device="cuda"))
        xy = torch.zeros(2, device="cuda")
        messages = {
            "GPS (predict, position, heading)": lambda: motion.ekf_update_heading(
                motion.ekf_update_position(motion.ekf_predict(ekf, 0.05), xy, std=0.15), 0.0),
            "IMU (predict, yaw rate)": lambda: motion.ekf_update_yaw_rate(
                motion.ekf_predict(ekf, 0.05), 0.1),
        }
        for what, fn in messages.items():
            fn()
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) / 200 * 1e6)
            busy, kernels, reads = profile_counts(fn)
            self.log(f"timing: ekf {what}: {statistics.median(runs):.1f} us per message (host "
                     f"clock, median of 5 x 200, min {min(runs):.1f}), {kernels} kernel "
                     f"launches, {reads} device-to-host reads, device busy {busy * 1e3:.1f} us "
                     f"[{self.card}]")
        for name, (pts, valid, acfg) in vlp16_scenes().items():
            p, v = torch.tensor(pts, device="cuda"), torch.tensor(valid, device="cuda")
            fn = functools.partial(detect_cones, p, v, acfg)
            torch.cuda.reset_peak_memory_stats()
            fn()
            peak = torch.cuda.max_memory_allocated() / 2**20
            ms = statistics.median(cuda_ms(fn, reps=10, warmup=False) for _ in range(3))
            busy, kernels, reads = profile_counts(fn)
            provider = "grid" if len(valid) > acfg.dense_max_points else "dense"
            self.log(f"timing: detect_cones {name} ({int(valid.sum())} of {len(valid)} points, "
                     f"{acfg.clustering} -> {provider}): {ms:.3f} ms per sweep = {1e3 / ms:.1f} sweeps/s "
                     f"({1e3 / ms / VLP16_RATE_HZ:.1f}x the sensor's {VLP16_RATE_HZ:g} Hz), device "
                     f"busy {busy:.3f} ms ({100 * busy / ms:.1f}%), {kernels} kernel launches and "
                     f"{reads} device-to-host reads per sweep, peak memory {peak:.0f} MiB "
                     f"[{self.card}]")

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
        `fuse_sessions(align=True, robust=True)` alone."""
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
    def fusion_kernel_timing(self):
        """The association kernel's Mahalanobis form at ASSOC_FUSION's shapes
        beside its twin, with its bound, into the `kernels` line's "fusion";
        before the long profiled passes of `lap_profile`, `batched_timing` and
        `fusion_timing`: after them, in one run, the profiler delivered 20 of
        a window's 50 kernel events, three windows in a row."""
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
              smoke.blocked, smoke.improved, smoke.batched, smoke.fusion, smoke.service,
              smoke.lidar, smoke.closure_solve, smoke.timing, smoke.parallel, smoke.chain,
              smoke.resident, smoke.cli, smoke.deploy)
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
