"""Multi-process smoke of the port: multi-session GN and the fleet across
real process boundaries (counterpart of the JAX package's
`deploy/multihost_smoke.py`).

One OS process per rank, one `torch.distributed` world:

  - each worker joins the world through `parallel.mesh.initialize_distributed`
    with a collective timeout, passes one all-reduce and prints that it is
    up, with the backend it took;
  - a ('sessions', 'edges') mesh of (world, 1) spans every process, and
    `multisession_optimize` solves SESSIONS_PER_PROC sessions per rank (the
    JAX smoke's devices per process): its gather crosses the processes;
  - every worker holds the gathered poses within SMOKE_ATOL of its own
    single-device `gauss_newton.optimize` of each session;
  - then the fleet: `run_fleet_blocked` on sessions of one cone per frame,
    held within SMOKE_ATOL to the unsharded `blocked_core_batched`, every
    frame done.

Backend: NCCL for `--device cuda` when the world has a card for each rank
(NCCL refuses two ranks on one card), else gloo with the tensors still on
cuda:<rank % cards>; `--device cpu` takes gloo on the CPU. Each worker
prints its choice; nothing falls back quietly.

The launcher spawns each group of `--procs` on a fresh localhost port and
waits with a timeout. `--death` adds the failure case: the last rank is
SIGKILLed (its exact PID) once it is up and every rank is inside its
collectives; the survivors must exit, with a nonzero code, within the
survivor timeout rather than hang.

    python -m tpuslam_torch.deploy.multihost_smoke --device cpu   # 2 ranks on the CPU
    python -m tpuslam_torch.deploy.multihost_smoke --procs 1,2 --death   # on the card
    # the ranks by hand, or one per host (MASTER_ADDR: rank 0's host):
    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 \\
        python -m tpuslam_torch.deploy.multihost_smoke --proc 0   # and --proc 1
    # or under torchrun, which sets RANK: every process it starts is a worker
    torchrun --nnodes 2 --nproc-per-node 1 --rdzv-backend c10d \\
        --rdzv-endpoint HOST:29500 -m tpuslam_torch.deploy.multihost_smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

MODULE = "tpuslam_torch.deploy.multihost_smoke"
ROOT = str(Path(__file__).resolve().parents[2])   # the directory holding the package
SESSIONS_PER_PROC = 2       # the JAX smoke's TPUSLAM_SMOKE_DEVS
SMOKE_ATOL = 1e-4
GN_ITERATIONS = 3
FLEET_B, FLEET_T, FLEET_N = 4, 8, 8
PG_TIMEOUT_S = 60.0         # each collective's wait in a worker
GROUP_TIMEOUT_S = 600.0
SURVIVOR_TIMEOUT_S = 90.0
SETTLE_S = 0.5              # after the victim is up, before the kill


def _wrap(theta):
    """`se2.wrap_angle` of a float64 angle with the JAX function's roundings
    on numpy input: pi - theta in float64, the floor-mod and pi - it in
    float32."""
    x = (np.pi - np.asarray(theta)).astype(np.float32)
    return np.float32(np.pi) - np.mod(x, np.float32(2 * np.pi))


def _rotate_in(angle, dx, dy):
    """(c dx + s dy, -s dx + c dy) in float32 for c, s of `angle`: the body
    frame of a float64 offset, the JAX SE(2) functions' roundings (the
    offset taken in float64, then float32)."""
    import torch
    a, u, v = (torch.tensor(np.float32(x)) for x in (angle, dx, dy))
    c, s = torch.cos(a), torch.sin(a)
    return c * u + s * v, -s * u + c * v


def build_session(cap, seed: int, device="cuda"):
    """bench_scaling.py's `_build_session` on the port: a circle of
    `cap.max_poses // 2` noisy poses (radius 30 m) with their odometry,
    `cap.max_landmarks // 2` cones on a radius of 33 m, and an edge from
    every pose to each cone within 15 m, up to `cap.max_obs - 1` edges. The
    JAX function hands float64 numpy arrays to `se2`, so its differences are
    float64 and the rest float32; this one takes the same roundings on the
    CPU (`_wrap`, `_rotate_in`) and moves the graph to `device`, so every
    rank builds the same graph."""
    import torch

    from tpuslam_torch.backend import graph as G

    def f32(*x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=torch.float32).reshape(-1)
    rng = np.random.default_rng(seed)
    n_p, n_l = cap.max_poses // 2, cap.max_landmarks // 2
    g = G.empty_graph(cap, "cpu")
    t = np.linspace(0, 2 * np.pi, n_p, endpoint=False)
    poses = np.stack([30 * np.cos(t), 30 * np.sin(t), _wrap(t + np.pi / 2)], 1)
    lms = np.stack([33 * np.cos(t[:n_l] * (n_p / n_l)), 33 * np.sin(t[:n_l] * (n_p / n_l))], 1)
    prev = None
    for p in poses:
        p = p + rng.normal(0, 0.1, 3)
        if prev is None:
            meas = f32(0, 0, 0)
        else:
            x, y = _rotate_in(prev[2], p[0] - prev[0], p[1] - prev[1])
            meas = f32(x, y, _wrap(p[2] - prev[2]))
        g = G.add_pose(g, f32(*p), meas)
        prev = p
    for lm in lms:
        g = G.add_landmark(g, f32(*lm), torch.tensor(1, dtype=torch.int32))
    e = 0
    for i in range(n_p):
        for j in range(n_l):
            if e >= cap.max_obs - 1:
                break
            if np.linalg.norm(lms[j] - poses[i, :2]) < 15.0:
                body = _rotate_in(poses[i, 2], lms[j, 0] - poses[i, 0], lms[j, 1] - poses[i, 1])
                g = G.add_observation(g, i, j, torch.stack(body))
                e += 1
    return dataclasses.replace(g, **{f.name: getattr(g, f.name).to(device)
                                     for f in dataclasses.fields(g)})


def fleet_inputs(n_sessions: int):
    """The JAX smoke's fleet: `n_sessions` sessions of FLEET_T frames, one
    cone 10 m ahead in each (range noise from `default_rng(7)`), driving
    1 m per frame. Returns numpy (obs, valid, poses)."""
    rng = np.random.default_rng(7)
    obs = np.zeros((n_sessions, FLEET_T, FLEET_N, 4), np.float32)
    obs[:, :, 0] = np.asarray([10.0, 0.0, 5.0, 1.0])
    obs[:, :, 0, 0] += rng.normal(0, 0.2, (n_sessions, FLEET_T)).astype(np.float32)
    valid = np.zeros((n_sessions, FLEET_T, FLEET_N), bool)
    valid[:, :, 0] = True
    path = np.stack([np.arange(FLEET_T, dtype=np.float32), np.zeros(FLEET_T),
                     np.zeros(FLEET_T)], -1)
    return obs, valid, np.broadcast_to(path, (n_sessions, FLEET_T, 3)).astype(np.float32)


def smoke(n_procs: int, device) -> dict:
    """The smoke's two checks on this rank (see the module docstring)."""
    import torch

    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.frontend.blocked import blocked_core_batched
    from tpuslam_torch.parallel import make_slam_mesh, multisession_optimize, run_fleet_blocked
    from tpuslam_torch.parallel.batch import initial_states
    from tpuslam_torch.parallel.multisession import stack_graphs
    from tpuslam_torch.runtime.config import SlamConfig

    n_global = n_procs * SESSIONS_PER_PROC
    cfg = gn.GNConfig(iterations=GN_ITERATIONS)
    graphs = [build_session(GraphCapacity(max_poses=64, max_landmarks=32, max_obs=512), s,
                            device) for s in range(n_global)]
    mesh = make_slam_mesh(n_procs, 1, device_type=device.type)
    got = multisession_optimize(stack_graphs(graphs), cfg, mesh).poses
    want = torch.stack([gn.optimize(g, cfg).poses for g in graphs])
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, atol=SMOKE_ATOL))

    cap = GraphCapacity(max_poses=16, max_landmarks=16, max_obs=FLEET_B * FLEET_N + 8)
    scfg = SlamConfig(capacity=cap, max_obs_per_frame=FLEET_N)
    ins = [torch.as_tensor(a, device=device) for a in fleet_inputs(n_global)]
    st, _, done = run_fleet_blocked(initial_states(cap, n_global, device), *ins, scfg, mesh,
                                    block=FLEET_B)
    ref, _, _ = blocked_core_batched(initial_states(cap, n_global, device), *ins, scfg, FLEET_B)
    fleet_err = float((st.graph.poses - ref.graph.poses).abs().max())
    fleet_ok = bool(torch.allclose(st.graph.poses, ref.graph.poses, atol=SMOKE_ATOL)) \
        and done == [FLEET_T] * n_global
    return {"devices": n_procs, "sessions": n_global, "max_abs_err_vs_single_device": err,
            "ok": ok, "fleet_max_abs_err": fleet_err, "fleet_blocked_ok": fleet_ok}


def _say(record: dict) -> None:
    """One JSON line in one write, so that the lines of ranks sharing a
    stream do not interleave."""
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def worker(rank: int, n_procs: int, addr: str | None, device: str, death: bool,
           pg_timeout_s: float) -> int:
    """One rank: join the world, say so, then run the smoke (or, under
    `death`, collectives until a peer dies). Prints one JSON line; exits 0
    only if both checks hold and neither `jax` nor `tpuslam` was imported."""
    import torch
    import torch.distributed as dist

    from tpuslam_torch.parallel.mesh import backend_for, initialize_distributed
    if device == "cuda" and not torch.cuda.is_available():
        print("multihost_smoke: --device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    backend = backend_for(device, n_procs)
    initialize_distributed(backend, addr, n_procs, rank, timeout_s=pg_timeout_s)
    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device("cpu"))
    beat = torch.ones(1, device=dev)
    dist.all_reduce(beat)          # every rank is in the group
    _say({"proc": rank, "up": True, "backend": backend, "device": str(dev)})
    if death:
        try:
            while True:            # until a peer dies
                dist.all_reduce(beat)
        except RuntimeError as e:  # the collective's error names the lost peer
            _say({"proc": rank, "peer_lost": str(e).splitlines()[0][:300]})
            return 1
    try:
        res = smoke(n_procs, dev)
    finally:
        dist.destroy_process_group()
    leaked = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "tpuslam"})
    _say({"proc": rank, **res, "backend": backend, "device": str(dev), "imported": leaked})
    return 0 if res["ok"] and res["fleet_blocked_ok"] and not leaked else 1


class _Worker:
    """A spawned rank whose stdout is echoed and its JSON lines kept."""

    _print = threading.Lock()

    def __init__(self, argv, env):
        self.proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, text=True)
        self.records: list[dict] = []
        self.up = threading.Event()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._print:
                print(line, end="", flush=True)
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            self.records.append(rec)
            if rec.get("up"):
                self.up.set()

    def wait(self, deadline: float):
        """The exit code, or "hung" (killed) past `deadline` (perf_counter)."""
        try:
            rc = self.proc.wait(timeout=max(0.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = "hung"
        self.reader.join(timeout=5)
        if not self.reader.is_alive():
            self.proc.stdout.close()
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _spawn(n_procs: int, device: str, death: bool, pg_timeout_s: float) -> list[_Worker]:
    """`n_procs` workers on a fresh localhost port, each told its rank and
    the world as torchrun tells it (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), the package's root on their PYTHONPATH."""
    from tpuslam_torch.parallel.mesh import free_port
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(n_procs),
           "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    argv = [sys.executable, "-m", MODULE, "--device", device, "--pg-timeout", str(pg_timeout_s),
            *(["--death"] if death else [])]
    return [_Worker(argv, {**env, "RANK": str(i)}) for i in range(n_procs)]


def run_group(n_procs: int, device: str = "cuda", timeout_s: float = GROUP_TIMEOUT_S,
              pg_timeout_s: float = PG_TIMEOUT_S) -> dict:
    """One group of `n_procs` workers, waited for up to `timeout_s`."""
    t0 = time.perf_counter()
    workers = _spawn(n_procs, device, False, pg_timeout_s)
    try:
        rcs = [w.wait(t0 + timeout_s) for w in workers]
    finally:
        for w in workers:
            w.kill()
    results = [r for w in workers for r in w.records if "ok" in r]
    ok = (rcs == [0] * n_procs and len(results) == n_procs
          and all(r["ok"] and r["fleet_blocked_ok"] for r in results))
    return {"procs": n_procs, "return_codes": rcs,
            "backend": sorted({r["backend"] for r in results}), "workers": results,
            "seconds": time.perf_counter() - t0, "ok": ok}


def run_death_case(n_procs: int, device: str = "cuda", up_timeout_s: float = 120.0,
                   survivor_timeout_s: float = SURVIVOR_TIMEOUT_S,
                   pg_timeout_s: float = PG_TIMEOUT_S) -> dict:
    """Failure injection: SIGKILL the last rank (its exact PID) once it has
    said it is up and every rank loops in collectives; the survivors must
    exit, nonzero, within `survivor_timeout_s` of the kill."""
    t0 = time.perf_counter()
    workers = _spawn(n_procs, device, True, pg_timeout_s)
    victim, survivors = workers[-1], workers[:-1]
    try:
        if not victim.up.wait(up_timeout_s):
            return {"procs": n_procs, "death": "rank -1 SIGKILL", "no_hang": False, "ok": False,
                    "error": f"the last rank was not up within {up_timeout_s} s"}
        time.sleep(SETTLE_S)
        running = [w.proc.poll() is None for w in survivors]
        victim.proc.kill()
        victim.proc.wait()
        t_kill = time.perf_counter()
        rcs = [w.wait(t_kill + survivor_timeout_s) for w in survivors]
        left_s = time.perf_counter() - t_kill
    finally:
        for w in workers:
            w.kill()
    no_hang = all(isinstance(rc, int) for rc in rcs)
    return {"procs": n_procs, "death": "rank -1 SIGKILL", "survivor_rcs": rcs,
            "running_at_kill": running, "no_hang": no_hang,
            "survivors_left_s": left_s, "seconds": time.perf_counter() - t0,
            "ok": no_hang and all(rc != 0 for rc in rcs) and all(running)}


def launcher(proc_counts, death: bool, device: str = "cuda",
             pg_timeout_s: float = PG_TIMEOUT_S) -> int:
    results = [run_group(n, device, pg_timeout_s=pg_timeout_s) for n in proc_counts]
    if death:
        results.append(run_death_case(max(proc_counts), device, pg_timeout_s=pg_timeout_s))
    print(json.dumps({"launcher": "done", "groups": results}), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-process smoke of the port")
    ap.add_argument("--proc", type=int, default=None,
                    help="run as this rank (WORLD_SIZE, MASTER_ADDR and MASTER_PORT from the "
                         "environment); also implied by RANK, as torchrun sets it")
    ap.add_argument("--procs", default="2",
                    help="comma list of process counts to sweep (e.g. 2,4,8)")
    ap.add_argument("--death", action="store_true",
                    help="add the process-death injection case")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--pg-timeout", type=float, default=PG_TIMEOUT_S,
                    help="seconds each collective of a worker may wait")
    args = ap.parse_args(argv)
    if args.proc is not None or "RANK" in os.environ:
        env = os.environ
        rank = args.proc if args.proc is not None else int(env["RANK"])
        n = int(env.get("WORLD_SIZE", 1))
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}" if n > 1 else None
        return worker(rank, n, addr, args.device, args.death, args.pg_timeout)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("multihost_smoke: --device cuda: no CUDA device is available "
                  "(pass --device cpu)", file=sys.stderr)
            return 2
    return launcher([int(x) for x in args.procs.split(",")], args.death, args.device,
                    args.pg_timeout)


if __name__ == "__main__":
    sys.exit(main())
