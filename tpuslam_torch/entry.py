"""Entry points of the port (counterpart of `__graft_entry__.py`):
one keyframe update on a device, and a dry run of every multi-device tier
over a world of ranks.

    python -m tpuslam_torch.entry          # entry() on the card, then
                                           # dryrun_multichip(1) on one
                                           # NCCL rank

`entry(device)` returns `(fn, args)`: `fn(*args)` is one `perform_keyframe`
at the JAX package's tiny capacity and inputs. `dryrun_multichip(n)` runs
each tier of the JAX package's dry run (multi-session GN, the fleet's
blocked pass, the fusion on a mesh, the DD / resident / 'hier' / 'hier3'
chain solves, the map-resident online pass) over the caller's world of n
ranks, each held to its single-device counterpart with the JAX package's
bounds; with no world it spawns one of n gloo ranks. The JAX package's
virtual CPU mesh (`_force_virtual_cpu_mesh`) has no counterpart: a world of
gloo ranks takes its place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend import graph as G
from tpuslam_torch.core.slam import checked_device
from tpuslam_torch.frontend.keyframe import perform_keyframe
from tpuslam_torch.frontend.state import initial_state
from tpuslam_torch.geometry import se2
from tpuslam_torch.runtime.config import SlamConfig

__all__ = ["entry", "dryrun_multichip"]

FUSION_ATOL = 1e-3      # the fusion on a mesh against the single-device one
CHAIN_ATOL = 5e-3       # each chain solver against the single-device GN
ONLINE_ATOL = 2e-3      # the resident online pass against the dense one
WORLD_TIMEOUT_S = 300.0


def entry(device="cuda"):
    """(fn, example_args): one SLAM keyframe update (association + graph
    growth + conditional GN + egress) on `device`."""
    device = checked_device(device)
    cfg = SlamConfig(capacity=G.GraphCapacity(max_poses=256, max_landmarks=128, max_obs=4096))
    state = initial_state(cfg.capacity, device)
    obs = torch.zeros((cfg.max_obs_per_frame, 4), dtype=torch.float32, device=device)
    obs[0] = torch.tensor([10.0, 0.0, 5.0, 1.0])
    valid = torch.zeros((cfg.max_obs_per_frame,), dtype=torch.bool, device=device)
    valid[0] = True
    pose = torch.zeros((3,), dtype=torch.float32, device=device)

    def fn(state, obs, valid, pose):
        return perform_keyframe(state, obs, valid, pose, cfg)

    return fn, (state, obs, valid, pose)


def _f32(x, device="cpu"):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _between(a, b) -> np.ndarray:
    """`se2.between` in float32 (as the JAX package computes it)."""
    return se2.between(_f32(a), _f32(b)).numpy()


def _to_body(pose, xy) -> np.ndarray:
    return se2.transform_to_body(_f32(pose), _f32(xy)).numpy()


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _tiny_session_graph(cap, seed, device):
    rng = np.random.default_rng(seed)
    g = G.empty_graph(cap, device)
    prev = None
    poses = []
    for k in range(6):
        p = np.array([2.0 * k, 0.1 * k, 0.05 * k]) + rng.normal(0, 0.05, 3)
        meas = np.zeros(3) if prev is None else _between(prev, p)
        g = G.add_pose(g, _f32(p, device), _f32(meas, device))
        poses.append(p)
        prev = p
    for j in range(4):
        lm = np.array([3.0 * j + 1.0, 2.5]) + rng.normal(0, 0.05, 2)
        g = G.add_landmark(g, _f32(lm, device), _i32(1, device))
        for i, p in enumerate(poses):
            body = _to_body(p, lm) + rng.normal(0, 0.02, 2)
            g = G.add_observation(g, _i32(i, device), _i32(j, device), _f32(body, device))
    return g


def _chain_graph(n_devices, device):
    ccap = G.GraphCapacity(max_poses=4 * n_devices, max_landmarks=16, max_obs=8 * n_devices)
    cg = G.empty_graph(ccap, device)
    prev = None
    rng = np.random.default_rng(3)
    for k in range(4 * n_devices):
        p = np.array([1.0 * k, 0.05 * k, 0.0]) + rng.normal(0, 0.02, 3)
        meas = np.zeros(3) if prev is None else _between(prev, p)
        cg = G.add_pose(cg, _f32(p, device), _f32(meas, device))
        prev = p
    for j in range(8):
        lm = np.array([j * n_devices * 0.5, 2.0])
        cg = G.add_landmark(cg, _f32(lm, device), _i32(1, device))
        for i in (min(j * n_devices // 2, 4 * n_devices - 2),
                  min(j * n_devices // 2 + 1, 4 * n_devices - 1)):
            body = np.array([lm[0] - 1.0 * i, 2.0 - 0.05 * i])
            cg = G.add_observation(cg, _i32(i, device), _i32(j, device), _f32(body, device))
    return cg


def _check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _gap(a, b) -> float:
    return float((a - b).abs().max())


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Every multi-device tier over a world of `n_devices` ranks, each held
    to its single-device counterpart. Every rank of the world calls it. With
    no process group it spawns a world of `n_devices` gloo ranks that run it
    and returns rank 0's result. Returns each tier's deviation from its
    reference; raises AssertionError when one is past its bound."""
    if not dist.is_initialized():
        return _spawn(n_devices, device)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                         f"{dist.get_world_size()} ranks")
    from tpuslam_torch.frontend.blocked import run_pass_blocked
    from tpuslam_torch.parallel import (
        chain_optimize, chain_optimize_resident, fusion, make_chain_mesh, make_map_mesh,
        make_slam_mesh, multisession_optimize, run_fleet_blocked, stack_graphs,
    )
    from tpuslam_torch.parallel import resident_online as RO
    from tpuslam_torch.parallel.batch import initial_states
    from tpuslam_torch.parallel.chain import default_tray, partition_chain
    from tpuslam_torch.parallel.resident import partition_chain_resident

    device = checked_device(device)
    kind = device.type
    out = {}

    # multi-session GN over a ('sessions', 'edges') mesh
    n_sessions = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_edges = n_devices // n_sessions
    mesh = make_slam_mesh(n_sessions=n_sessions, n_edge_shards=n_edges, device_type=kind)
    cap = G.GraphCapacity(max_poses=8, max_landmarks=8, max_obs=8 * max(n_edges, 1))
    stacked = stack_graphs([_tiny_session_graph(cap, s, device) for s in range(2 * n_sessions)])
    ms = multisession_optimize(stacked, gn.GNConfig(iterations=2), mesh)
    _check(bool(torch.isfinite(ms.poses).all()), "dryrun produced non-finite poses")
    _check(bool(torch.isfinite(ms.lm_xy).all()), "dryrun produced non-finite landmarks")

    # fleet tier: one tiny blocked pass per session, sessions over the ranks
    fleet_mesh = make_slam_mesh(n_sessions=n_devices, n_edge_shards=1, device_type=kind)
    B, T, N = 4, 8, 8
    scfg = SlamConfig(capacity=G.GraphCapacity(max_poses=16, max_landmarks=16,
                                               max_obs=B * N + 8), max_obs_per_frame=N)
    obs = torch.zeros((n_devices, T, N, 4), dtype=torch.float32, device=device)
    obs[:, :, 0] = torch.tensor([10.0, 0.0, 5.0, 1.0], device=device)
    valid = torch.zeros((n_devices, T, N), dtype=torch.bool, device=device)
    valid[:, :, 0] = True
    path = torch.stack([torch.arange(T, dtype=torch.float32), torch.zeros(T), torch.zeros(T)], -1)
    poses = path.to(device).expand(n_devices, T, 3).contiguous()
    _, _, fdone = run_fleet_blocked(initial_states(scfg.capacity, n_devices, device), obs, valid,
                                    poses, scfg, fleet_mesh, block=B)
    _check(all(d == T for d in fdone), f"fleet blocked pass did not complete: {fdone}")

    # fusion tier: landmark-sharded dedup + edge-sharded joint GN over every
    # rank, against the single-device fusion
    fuse_mesh = make_slam_mesh(n_sessions=1, n_edge_shards=n_devices, device_type=kind)
    stacked = stack_graphs([_tiny_session_graph(cap, s, device) for s in range(4)])
    fcfg = gn.GNConfig(iterations=2)
    fused, _ = fusion.fuse_sessions(stacked, cfg=fcfg, gate=1.2, mesh=fuse_mesh)
    golden, _ = fusion.fuse_sessions(stacked, cfg=fcfg, gate=1.2)
    _check(int(fused.n_landmarks) == int(golden.n_landmarks),
           f"fused landmarks {int(fused.n_landmarks)} != {int(golden.n_landmarks)}")
    _check(bool(torch.isfinite(fused.poses).all()), "fused poses not finite")
    npo = int(golden.n_poses)
    out["fusion"] = _gap(fused.poses[:npo], golden.poses[:npo])
    _check(out["fusion"] < FUSION_ATOL,
           f"fused mesh result deviates from golden by {out['fusion']}")

    # chain tier: DD, resident, 'hier' and 'hier3' against the single-device GN
    chain_mesh = make_chain_mesh(n_devices, device_type=kind)
    cg = _chain_graph(n_devices, device)
    ccfg = gn.GNConfig(iterations=2)
    np_c = 4 * n_devices
    single = gn.optimize(cg, ccfg)
    dd = chain_optimize(cg, ccfg, chain_mesh, solver="dd", plan=partition_chain(cg, n_devices))
    out["dd"] = _gap(dd.poses[:np_c], single.poses[:np_c])
    _check(out["dd"] < CHAIN_ATOL, f"DD chain solve deviates from single-device by {out['dd']}")
    rplan = partition_chain_resident(cg, n_devices)
    res = chain_optimize_resident(cg, ccfg, chain_mesh, plan=rplan)
    out["resident"] = (_gap(res.poses[:np_c], single.poses[:np_c]),
                       _gap(res.lm_xy[:8], single.lm_xy[:8]))
    _check(max(out["resident"]) < CHAIN_ATOL,
           f"resident DD deviates from single-device by {out['resident']}")
    tray = default_tray(n_devices, cap=max(2, n_devices // 2))
    hier = chain_optimize(cg, ccfg, chain_mesh, solver="hier", tray=tray)
    out["hier"] = (_gap(hier.poses[:np_c], single.poses[:np_c]),
                   _gap(hier.lm_xy[:8], single.lm_xy[:8]),
                   _gap(hier.poses[:np_c], dd.poses[:np_c]))
    _check(max(out["hier"]) < CHAIN_ATOL,
           f"hier (tray={tray}) deviates from single-device / DD by {out['hier']}")
    if n_devices % 4 == 0:
        pod3 = n_devices // 2
        tray3 = max(t for t in range(1, pod3 // 2 + 1) if pod3 % t == 0)
        h3 = chain_optimize(cg, ccfg, chain_mesh, solver="hier3", tray=tray3, pod=pod3)
        out["hier3"] = (_gap(h3.poses[:np_c], single.poses[:np_c]),
                        _gap(h3.lm_xy[:8], single.lm_xy[:8]))
        _check(max(out["hier3"]) < CHAIN_ATOL,
               f"hier3 (tray={tray3}, pod={pod3}) deviates by {out['hier3']}")

    # the map-resident online pass against the dense blocked pass: counts,
    # edges and sends exact, estimates within ONLINE_ATOL
    ro_cfg = SlamConfig(capacity=G.GraphCapacity(max_poses=16, max_landmarks=2 * n_devices,
                                                 max_obs=4 * N + 8), max_obs_per_frame=N)
    ro_state, ro_outs = RO.run_pass_resident_online(obs[0], valid[0], poses[0], ro_cfg,
                                                    make_map_mesh(n_devices, device_type=kind),
                                                    block=4)
    d_state, d_outs = run_pass_blocked(obs[0], valid[0], poses[0], ro_cfg, block=4)
    rg, dg = ro_state.graph, d_state.graph
    _check(int(rg.n_poses) == T, f"resident online pass made {int(rg.n_poses)} poses of {T}")
    for f in ("n_landmarks", "n_obs"):
        _check(int(getattr(rg, f)) == int(getattr(dg, f)),
               f"resident online {f} {int(getattr(rg, f))} != dense {int(getattr(dg, f))}")
    _check(bool(ro_state.loop_closure_complete) == bool(d_state.loop_closure_complete),
           "resident online closure differs from the dense pass")
    n_e = int(dg.n_obs)
    _check(torch.equal(rg.obs_lm[:n_e], dg.obs_lm[:n_e])
           and torch.equal(rg.obs_pose[:n_e], dg.obs_pose[:n_e]),
           "resident online edges differ from the dense pass")
    _check(torch.equal(ro_outs.send, d_outs.send), "resident online sends differ")
    out["resident_online"] = _gap(ro_outs.pose, d_outs.pose)
    _check(out["resident_online"] < ONLINE_ATOL,
           f"resident-online pass deviates from the dense oracle by {out['resident_online']}")
    return out


def _rank(rank, n, port, device, box):
    from tpuslam_torch.parallel.mesh import initialize_distributed
    initialize_distributed("gloo", f"localhost:{port}", n, rank, timeout_s=WORLD_TIMEOUT_S)
    try:
        got = dryrun_multichip(n, device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        box.put(got)


def _spawn(n: int, device) -> dict:
    """A world of `n` gloo ranks (spawned, a free localhost port) that runs
    the dry run; rank 0's result."""
    import torch.multiprocessing as mp
    from tpuslam_torch.parallel.mesh import free_port
    ctx = mp.get_context("spawn")
    box = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(n, free_port(), str(device), box), nprocs=n, join=True,
                       start_method="spawn")
    return box.get()


def main() -> int:
    from tpuslam_torch.parallel.mesh import initialize_distributed
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry() ok")
    initialize_distributed("nccl")
    try:
        print("dryrun_multichip ok", dryrun_multichip(1))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
