"""Time the replicated against the domain-decomposition chain solve on the
port (counterpart of the JAX package's `scripts/bench_chain_solvers.py`).

At what graph scale does the DD solve (communication O(L + m^2)) beat the
replicated one (communication O(P*L) and a redundant O((3P)^3)
factorization on every rank)? For each size the script builds the circular
track of `synth`, plans the DD partition once, and times `chain_optimize`
with solver='replicated' and 'dd' (4 GN iterations) after one warm-up call
each: CUDA events on the card, the host clock on the CPU. It prints the
card's name and power limit (on the card), then one JSON row per size:
poses, landmarks, n_shared, replicated_ms, dd_ms, speedup.

The world is the caller's process group, or the one `torchrun` describes
(e.g. `torchrun --nproc-per-node 8` on a host with eight cards, NCCL), or
else a world of one rank made here and destroyed before the script returns
(`parallel.mesh.process_group`). On one card a world of several ranks runs
gloo, which reduces through the host: its times show that the solvers are
right, not how they scale. The communication volumes are analytic
(`parallel.comm_model`).

    python -m tpuslam_torch.scripts.bench_chain_solvers [--sizes 256,1024,2048]
        [--reps 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity, empty_graph
from tpuslam_torch.parallel.chain import chain_optimize, partition_chain
from tpuslam_torch.parallel.mesh import make_chain_mesh, process_group

ITERATIONS = 4


def synth(n_poses: int, n_lm: int, device="cuda"):
    """Circular track: `n_poses` keyframes and `n_lm` cones, each pose
    observing its 6 nearest cones; the JAX script's draws from
    `default_rng(0)`, in numpy; capacity (n_poses, n_lm, 8 n_poses)."""
    cap = GraphCapacity(max_poses=n_poses, max_landmarks=n_lm, max_obs=n_poses * 8)
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    poses = np.stack([40 * np.cos(t), 40 * np.sin(t), t + np.pi / 2], -1)
    tl = np.linspace(0, 2 * np.pi, n_lm, endpoint=False)
    lm = np.stack([45 * np.cos(tl), 45 * np.sin(tl)], -1)
    odo = np.zeros((n_poses, 3), np.float32)
    for k in range(1, n_poses):
        d = poses[k, :2] - poses[k - 1, :2]
        c, s = np.cos(poses[k - 1, 2]), np.sin(poses[k - 1, 2])
        odo[k] = [c * d[0] + s * d[1], -s * d[0] + c * d[1], poses[k, 2] - poses[k - 1, 2]]
    obs_p, obs_l, obs_xy = [], [], []
    for k in range(n_poses):
        d2 = ((lm - poses[k, :2]) ** 2).sum(1)
        for j in np.argsort(d2)[:6]:
            dd = lm[j] - poses[k, :2]
            c, s = np.cos(poses[k, 2]), np.sin(poses[k, 2])
            obs_p.append(k)
            obs_l.append(j)
            obs_xy.append([c * dd[0] + s * dd[1] + rng.normal(0, .05),
                           -s * dd[0] + c * dd[1] + rng.normal(0, .05)])
    n_obs, pad = len(obs_p), cap.max_obs - len(obs_p)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    return dataclasses.replace(
        empty_graph(cap, device),
        poses=t(poses + rng.normal(0, .1, poses.shape)), lm_xy=t(lm + rng.normal(0, .2, lm.shape)),
        odo_meas=t(odo), obs_pose=t(np.pad(obs_p, (0, pad)), torch.int32),
        obs_lm=t(np.pad(obs_l, (0, pad)), torch.int32),
        obs_xy=t(np.pad(obs_xy, ((0, pad), (0, 0)))), n_poses=t(n_poses, torch.int32),
        n_landmarks=t(n_lm, torch.int32), n_obs=t(n_obs, torch.int32))


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms per call of `fn` over `reps` calls after one warm-up call:
    CUDA events on a CUDA device, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description="replicated vs DD chain solve on the port")
    ap.add_argument("--sizes", default="256,1024,2048")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (the default; fails without one) or the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")
    rows = []
    with process_group(args.device) as world:
        dev = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
               else torch.device("cpu"))
        lead = dist.get_rank() == 0
        if lead and dev.type == "cuda":
            print(card(), flush=True)
        mesh = make_chain_mesh(world, device_type=dev.type)
        cfg = gn.GNConfig(iterations=ITERATIONS)
        for n in (int(s) for s in args.sizes.split(",")):
            g = synth(n, n, dev)
            plan = partition_chain(g, world)
            row = {"poses": n, "landmarks": n, "n_shared": plan.n_shared}
            for name, kw in (("replicated", {}), ("dd", {"plan": plan})):
                row[name + "_ms"] = time_ms(
                    functools.partial(chain_optimize, g, cfg, mesh, solver=name, **kw),
                    args.reps, dev)
            row["speedup"] = row["replicated_ms"] / row["dd_ms"]
            if lead:
                print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
