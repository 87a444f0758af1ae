#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tpuslam_torch`) once on one GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with exit code 1:
  1. build   — compile both CUDA kernels with nvcc (sm_90a), in parallel;
  2. kernels — each kernel against its plain PyTorch twin on the card;
  3. compat  — the per-frame engine (`run_pass`) in the reference-compat
               configuration ('first' association, plain PyTorch) on the
               trackdrive bench scenario, held to the JAX package's numbers;
  4. kernel association — the same lap with association='nearest' through
               the association kernel, held to the JAX package's numbers
               and to a CPU run of the port;
  5. closure solve — `gauss_newton.optimize` on the graph the closure GN
               solves, through the Cholesky kernel and through
               `torch.linalg.cholesky_ex`;
  6. timing  — frames/s of phases 3 and 4 and each kernel's time beside its
               twin's, with CUDA events.
It prints a `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Without a
CUDA device it fails before any phase. It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from tpuslam.sim import SimConfig, simulate, trackdrive
from tpuslam.sim.simulator import ate
from tpuslam_torch import _build
from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.keyframe import _gn_config
from tpuslam_torch.frontend.pipeline import run_pass
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.runtime.config import SlamConfig

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


def assoc_world(n, m, seed):
    """Inputs made as tests/test_pallas_kernels.py makes them, with random
    SPD inverse covariances packed (a, b, c)."""
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
    return [torch.tensor(x, device="cuda") for x in (obs_xy, obs_type, lm_xy, lm_type, cov)]


def spd(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    m = rng.normal(0, 1, (n, n)).astype(np.float32)
    return torch.tensor(m @ m.T / n + np.eye(n, dtype=np.float32) * 2.0, device="cuda")


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
        for n, m, seed in ((64, 256, 0), (61, 2000, 5)):
            for mahal in (False, True):
                oxy, ot, lxy, lt, cov = assoc_world(n, m, seed)
                gate2 = 9.21 if mahal else 1.44
                got = A.associate_kernel(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahal)
                want = A.associate_plain(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahal)
                for g_, w_, what in zip(got, want, ("idx", "matched", "cost")):
                    if not torch.equal(g_, w_):
                        raise AssertionError(f"assoc N={n} M={m} mahalanobis={mahal}: "
                                             f"{what} differs from the plain twin")
                err = max(err, float((got[2] - want[2]).abs().max()))
                self.log(f"kernels: assoc N={n} M={m} mahalanobis={mahal}: bit-equal to "
                         f"the plain twin ({int(got[1].sum())} matched)")
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
        s = self.closure_s
        got, want = C.cholesky_kernel(s), C.cholesky_plain(s)
        torch.testing.assert_close(got, want, atol=CHOL_ATOL, rtol=CHOL_RTOL)
        e = float((got - want).abs().max())
        self.kernels["cholesky"]["max_abs_err"] = max(self.kernels["cholesky"]["max_abs_err"], e)
        self.log(f"closure: kernel vs plain twin on the closure's S: max abs err {e:.3g}")

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
        oxy, ot, lxy, lt, cov = assoc_world(64, 256, 0)
        k = self.kernels["assoc"]
        k["ms"] = cuda_ms(lambda: A.associate_kernel(oxy, ot, lxy, lt, 1.44), reps=200)
        k["plain_ms"] = cuda_ms(lambda: A.associate_plain(oxy, ot, lxy, lt, 1.44), reps=200)
        s = self.closure_s
        k = self.kernels["cholesky"]
        k["ms"] = cuda_ms(lambda: C.cholesky_kernel(s), reps=20)
        k["plain_ms"] = cuda_ms(lambda: C.cholesky_plain(s), reps=3)
        k_lib = cuda_ms(lambda: torch.linalg.cholesky_ex(s), reps=20)
        self.cholesky_profile(s)
        self.lap_profile(obs, valid, poses, lap_ms)
        for k in self.kernels.values():
            self.log(f"timing: {k['name']} kernel {k['ms'] * 1e3:.1f} us, plain twin "
                     f"{k['plain_ms'] * 1e3:.1f} us [{self.card}]")
        self.log(f"timing: torch.linalg.cholesky_ex n={s.shape[0]} {k_lib * 1e3:.1f} us "
                 f"[{self.card}]")

    def cholesky_profile(self, s, reps: int = 5):
        """Device time of each CUDA kernel the Cholesky wrapper launches, per
        launch and per factorization of `s`, from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                C.cholesky_kernel(s)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type.name != "CUDA" or e.key.startswith(("Memcpy", "Memset")):
                continue
            name = e.key.split("::")[-1].split("(")[0]   # "(anonymous namespace)::panel_kernel(...)"
            self.log(f"timing: cholesky n={s.shape[0]} {name}: {e.count // reps} launches "
                     f"per factorization, {e.self_device_time_total / e.count:.1f} us each, "
                     f"{e.self_device_time_total / reps:.1f} us per factorization "
                     f"[{self.card}]")

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
    for phase in (smoke.build, smoke.kernels_vs_plain, smoke.compat,
                  smoke.kernel_association, smoke.closure_solve, smoke.timing):
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
