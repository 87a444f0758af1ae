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
               association kernel bit-equal at ASSOC_CHECKS (the lap,
               blocked and pod shapes, ragged sizes, ties) and in its
               masked form;
  3. compat  — the per-frame engine (`run_pass`) in the reference-compat
               configuration ('first' association, plain PyTorch) on the
               trackdrive bench scenario, held to the JAX package's numbers;
  4. kernel association — the same lap with association='nearest' through
               the association kernel, held to the JAX package's numbers
               and to a CPU run of the port;
  5. closure solve — `gauss_newton.optimize` on the graph the closure GN
               solves, through the Cholesky kernel and through
               `torch.linalg.cholesky_ex`, and the kernel's factor of the
               solve's ill-conditioned matrix held to a float64 factor;
  6. timing  — frames/s of phases 3 and 4 and their kernel launches per
               keyframe; each kernel's time per wrapper call beside its
               twin's and the library call's (CUDA events, in turns), its
               device time per launch (torch.profiler) and its bound from
               this run's shapes, the association kernel at each of
               ASSOC_SHAPES.
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
from tpuslam_torch.frontend.keyframe import _gn_config
from tpuslam_torch.frontend.pipeline import run_pass
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, ate, simulate, trackdrive

# The bench scenario (bench.py:34-38) and capacity (bench.py:152-153).
SIM = dict(laps=1.4, keyframe_dt=0.1, speed=8.0, max_range=20.0, seed=12)
CAP = GraphCapacity(512, 256, 8192)
CLOSURE_FRAME = 212         # the graph after frame CLOSURE_FRAME - 1 is the one the closure GN solves
CLOSURE_N = 768             # 3 x the 256-pose bucket covering it

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
}
METRIC_ATOL_M = 1e-3        # ATE / map-error tolerance against the JAX numbers
POSE_ATOL = 1e-3            # GPU vs CPU port, and kernel vs library GN solve
CHOL_ATOL, CHOL_RTOL, CHOL_RECON_ATOL = 5e-4, 1e-3, 5e-3
LAPS_TIMED = 5              # the lap rate is the median of this many laps (host-bound, noisy)
# H100 SXM peaks for the bound (NVIDIA's data sheet, at 700 W): FP32 outside
# the tensor cores, and HBM3
PEAK_FP32_FLOP_S, PEAK_HBM_BYTE_S = 67e12, 3.35e12
# (N observations, M landmarks) of the association kernel: the per-frame lap
# (the observation and landmark capacities), the blocked pipeline's launch
# (tpuslam/frontend/blocked.py:495-499, block 32 x 64 observations) and the
# pod-scale map the TPU kernel was built for (scripts/exp_block_provider.py:104-110)
ASSOC_SHAPES = {"lap": (64, 256), "blocked": (2048, 256), "pod": (512, 4096)}
# the cluster sizes `--assoc-plans` times at each shape
ASSOC_PLANS = (1, 2, 4, 8)


def configs():
    return {"first": SlamConfig(capacity=CAP),
            "nearest": SlamConfig(capacity=CAP, association="nearest",
                                  use_pallas_association=True)}


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
                + [(64, 256, 3, True), (2048, 256, 3, True), (512, 4096, 4, True)])


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
        self.closure_s = None

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
        self.kernels["assoc"]["launches"] = counts["assoc"]
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

    # -- 5
    def closure_solve(self):
        obs, valid, poses = inputs(self.scen, "cuda")
        state, _ = run_pass(obs[:CLOSURE_FRAME], valid[:CLOSURE_FRAME],
                            poses[:CLOSURE_FRAME], configs()["first"])
        g = state.graph
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
        self.closure_accuracy(self.closure_s)

    def closure_accuracy(self, s):
        """The closure's S is ill-conditioned in its last pose rows, where FP32
        factors in different summation orders differ by more than the twin
        tolerance of phase 2. So on S each FP32 factor (kernel,
        `torch.linalg.cholesky_ex`, plain twin) is held to the float64 one.
        The kernel must be as close to it as the farther of the two
        references, and its backward error |LL^T - S| must stay within the
        bound every FP32 Cholesky meets whatever its summation order,
        gamma_{n+1} |L| |L^T| elementwise (Higham, Accuracy and Stability of
        Numerical Algorithms, Thm 10.3)."""
        n = s.shape[0]
        s64 = s.double()
        exact = torch.linalg.cholesky(s64)
        u = 2.0 ** -24
        gamma = (n + 1) * u / (1 - (n + 1) * u)
        factors = {"kernel": C.cholesky_kernel(s), "cholesky_ex": torch.linalg.cholesky_ex(s).L,
                   "twin": C.cholesky_plain(s)}
        gap, ratio = {}, {}
        for name, f in factors.items():
            l = f.double()
            resid = (l @ l.T - s64).abs()
            gap[name] = float((l - exact).abs().max())
            ratio[name] = float((resid / (l.abs() @ l.abs().T).clamp_min(1e-300)).max())
            self.log(f"closure: S by {name}: max|L - L_float64| {gap[name]:.4g}, "
                     f"max|LL^T - S| {float(resid.max()):.4g}, backward error / gamma_(n+1) "
                     f"{ratio[name] / gamma:.4g}")
        self.log(f"closure: S in float64: condition number {float(torch.linalg.cond(s64)):.3g}, "
                 f"smallest pivot {float(exact.diagonal().min()):.3g}; max|kernel - twin| "
                 f"{float((factors['kernel'] - factors['twin']).abs().max()):.3g}")
        if gap["kernel"] > max(gap["cholesky_ex"], gap["twin"]):
            raise AssertionError(f"closure: the kernel's factor of S is farther from float64 "
                                 f"than both references: {gap}")
        if ratio["kernel"] > gamma:
            raise AssertionError(f"closure: the kernel's backward error on S is "
                                 f"{ratio['kernel'] / gamma:.3g} x gamma_(n+1)")

    # -- 6
    def timing(self):
        obs, valid, poses = inputs(self.scen, "cuda")
        t = obs.shape[0]
        lap_ms = {}
        for name, cfg in configs().items():
            lap = functools.partial(run_pass, obs, valid, poses, cfg)
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
        self.lap_profile(obs, valid, poses, lap_ms)
        for k in self.kernels.values():
            self.log(f"timing: {k['name']} per wrapper call {k['ms'] * 1e3:.1f} us, device "
                     f"{k['device_ms'] * 1e3:.2f} us per launch, plain twin "
                     f"{k['plain_ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.4g} us "
                     f"({k['bound_by']}) [{self.card}]")
        self.log(f"timing: cholesky n={n}: kernel {turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us, "
                 f"torch.linalg.cholesky_ex {turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us "
                 f"(in turns: library, kernel, kernel, library) [{self.card}]")

    def assoc_timing(self):
        """The association kernel at each of ASSOC_SHAPES, Euclidean and
        Mahalanobis: time per wrapper call (CUDA events over 100 back-to-back
        calls, median of 5 such runs: the host is noisy), device time per
        launch (profiler), the plain twin's time and the bound. The lap's
        Euclidean shape fills the `kernels` line."""
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
        k.update({f: k["shapes"]["lap"][f]
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
                functools.partial(A._load().tpuslam_assoc, *[0] * 9, 0, m, 1.44,
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
        launched the kernel exactly once."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        for e in found if rows else ():
            self.log(f"timing: {name} device row {e.key[:70]!r}: {e.count / reps:g} per call, "
                     f"{e.self_device_time_total / e.count:.2f} us each [{self.card}]")
        kernel = [e for e in found if symbol in e.key]
        if [e.count for e in kernel] != [reps]:
            raise AssertionError(f"{name}: want one kernel launch per call, profiler rows "
                                 f"{[(e.key, e.count) for e in kernel]}")
        return kernel[0].self_device_time_total / reps / 1e3

    def lap_profile(self, obs, valid, poses, lap_ms):
        """Device-busy share of each lap, from one lap under torch.profiler:
        device time summed over kernels and copies, against the unprofiled
        lap time; plus kernel launches and device-to-host reads per frame."""
        from torch.profiler import ProfilerActivity, profile
        t = obs.shape[0]
        for name, cfg in configs().items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_pass(obs, valid, poses, cfg)
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            busy = sum(e.self_device_time_total for e in dev) / 1e3
            if busy == 0.0:
                self.log(f"timing: {name} lap device busy share: not measured "
                         "(the profiler saw no device time)")
                continue
            kernels = sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset")))
            reads = sum(e.count for e in dev if e.key.startswith("Memcpy DtoH"))
            self.log(f"timing: {name} lap device busy {busy:.1f} ms of {lap_ms[name]:.1f} ms "
                     f"({100 * busy / lap_ms[name]:.1f}%), {kernels / t:.1f} kernel launches "
                     f"and {reads / t:.2f} device-to-host reads per frame [{self.card}]")


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
    phases = (smoke.build, smoke.kernels_vs_plain, smoke.compat,
              smoke.kernel_association, smoke.closure_solve, smoke.timing)
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
