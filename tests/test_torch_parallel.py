"""The port's multi-device tier (`tpuslam_torch.parallel`: `mesh`,
`collectives`, `distributed`, `multisession`, `fleet`, `map_blocks`, the
fusion's mesh path, and `assoc_mesh` through the pipelines) against the JAX
package's, on the CPU.

One world of 4 gloo ranks (a module-scoped fixture: spawned processes, a
free localhost port, `device_type="cpu"`) runs every port case at the mesh
shapes 1x4, 2x2 and 4x1 where the case's sizes divide, each rank with the
same global inputs, and hands numpy results back; the ranks of a mesh must
return the same. The port's single-device references run on rank 0 alone. The JAX package runs in this process on conftest's 8 CPU
devices, on the meshes tests/test_parallel.py and tests/test_fusion.py
build. Each case mirrors its JAX test and keeps its tolerance: decisions
(indices, matched masks, labels, counts, closure) exact; GN results within
5e-4 (the multi-process smoke: 1e-4); the fleet's values within 2e-4.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SHAPES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
RANK_TIMEOUT_S = 120.0
WORLD_DEADLINE_S = 400.0
GN_ATOL, SMOKE_ATOL, FLEET_ATOL = 5e-4, 1e-4, 2e-4
# the port against the JAX package after a closure GN: the pipeline tests'
# contract (tests/test_torch_pipeline.py), the batched path's 2e-3
PIPELINE_ATOL, BATCHED_ATOL = 1e-3, 2e-3
FLEET_S, FLEET_B = 8, 8
SMOKE_B, SMOKE_T, SMOKE_N = 4, 8, 8
ASSOC_N, ASSOC_M = 48, 512
ASSOC_CASES = (("first", 3.0, False, False), ("first", 3.0, False, True),
               ("nearest", 3.0, False, False), ("mahalanobis", 9.21, True, False))
LIVE_CONFIGS = ("first", "nearest", "mahalanobis")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's work in this process on one thread, as each rank's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the port side: what each rank of the gloo world runs

def _port_cfg(name, cap):
    from tpuslam_torch.runtime.config import SlamConfig
    if name == "first":
        return SlamConfig(capacity=cap)
    if name == "nearest":
        return SlamConfig(capacity=cap, association="nearest", reference_compat=False,
                          localizer_type_bug=False)
    return SlamConfig.improved(capacity=cap, periodic_gn_every=0, association="mahalanobis")


def _fleet_inputs():
    from tpuslam_torch.sim import SimConfig, simulate, trackdrive
    scens = [simulate(trackdrive(seed=11), SimConfig(laps=1.2, keyframe_dt=0.2, speed=8.0,
                                                     max_range=20.0, seed=40 + s))
             for s in range(FLEET_S)]
    t = min(len(sc.times) for sc in scens)
    t -= t % FLEET_B
    return (np.stack([sc.obs[:t] for sc in scens]).astype(np.float32),
            np.stack([sc.obs_valid[:t] for sc in scens]),
            np.stack([sc.odom_poses[:t] for sc in scens]).astype(np.float32))


def _smoke_fleet_inputs(n):
    """deploy/multihost_smoke.py's fleet: one cone per frame, T frames."""
    rng = np.random.default_rng(7)
    obs = np.zeros((n, SMOKE_T, SMOKE_N, 4), np.float32)
    obs[:, :, 0] = np.asarray([10.0, 0.0, 5.0, 1.0])
    obs[:, :, 0, 0] += rng.normal(0, 0.2, (n, SMOKE_T)).astype(np.float32)
    valid = np.zeros((n, SMOKE_T, SMOKE_N), bool)
    valid[:, :, 0] = True
    path = np.stack([np.arange(SMOKE_T, dtype=np.float32), np.zeros(SMOKE_T),
                     np.zeros(SMOKE_T)], -1)
    return obs, valid, np.broadcast_to(path, (n, SMOKE_T, 3)).copy().astype(np.float32)


def _assoc_inputs():
    rng = np.random.default_rng(7)
    n, m = ASSOC_N, ASSOC_M
    obs_xy = rng.normal(0, 20, (n, 2)).astype(np.float32)
    obs_type = rng.integers(1, 5, n).astype(np.int32)
    obs_valid = rng.random(n) < 0.85
    lm_xy = rng.normal(0, 20, (m, 2)).astype(np.float32)
    lm_type = rng.integers(1, 5, m).astype(np.int32)
    lm_valid = rng.random(m) < 0.9
    cov = rng.normal(0, 0.3, (m, 2, 2))
    cov = cov @ cov.transpose(0, 2, 1) + np.eye(2)[None]
    return obs_xy, obs_type, obs_valid, lm_xy, lm_type, lm_valid, \
        np.linalg.inv(cov).astype(np.float32)


def _live_scenario():
    from tpuslam_torch.sim import SimConfig, simulate, trackdrive
    return simulate(trackdrive(seed=7), SimConfig(laps=1.2, keyframe_dt=0.25, seed=3))


def _fusion_sessions(cap):
    """tests/test_fusion.py's `session_pack`: 4 compat sessions of the
    trackdrive lap, run by the port."""
    from tpuslam_torch.frontend.pipeline import run_sequence
    from tpuslam_torch.frontend.state import initial_state
    from tpuslam_torch.parallel.multisession import stack_graphs
    from tpuslam_torch.runtime.config import SlamConfig
    from tpuslam_torch.sim import SimConfig, simulate, trackdrive
    graphs = []
    for s in range(4):
        scen = simulate(trackdrive(seed=11), SimConfig(laps=1.2, keyframe_dt=0.25, speed=8.0,
                                                       max_range=20.0, seed=100 + s))
        st, _ = run_sequence(initial_state(cap, "cpu"), torch.tensor(scen.obs, dtype=torch.float32),
                             torch.tensor(scen.obs_valid), torch.tensor(scen.odom_poses,
                                                                        dtype=torch.float32),
                             SlamConfig(capacity=cap))
        graphs.append(st.graph)
    return stack_graphs(graphs)


def _np(x):
    if torch.is_tensor(x):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _rank_cases(inputs):
    """Every port case on this rank: a dict of numpy results."""
    import dataclasses

    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.frontend.blocked import blocked_core_batched, run_sequence_blocked
    from tpuslam_torch.frontend.pipeline import run_sequence
    from tpuslam_torch.frontend.state import graph_from_numpy, initial_state, state_to_numpy
    from tpuslam_torch.ops.association import associate
    from tpuslam_torch.parallel import (
        associate_sharded, distributed_optimize, fuse_sessions, make_slam_mesh,
        multisession_optimize, run_fleet_blocked, stack_graphs,
    )
    from tpuslam_torch.parallel import collectives as C
    from tpuslam_torch.parallel.batch import initial_states
    from tpuslam_torch.parallel.fusion import dedup_labels
    from tpuslam_torch.runtime.config import SlamConfig

    rank = dist.get_rank()
    # the single-device references run on rank 0 alone; every rank runs
    # every mesh case
    lead = rank == 0
    out = {}
    meshes = {k: make_slam_mesh(*v, device_type="cpu") for k, v in SHAPES.items()}
    default = make_slam_mesh(2, device_type="cpu")
    partial = make_slam_mesh(1, 2, device_type="cpu")
    try:
        make_slam_mesh(3, device_type="cpu")
        bad = None
    except ValueError as e:
        bad = str(e)
    out["mesh"] = dict(
        shapes={k: (m.mesh.tolist(), m.mesh_dim_names, m.get_coordinate())
                for k, m in meshes.items()},
        default=default.mesh.tolist(), partial=partial.get_coordinate(), bad=bad)

    # the collectives on the 2x2 mesh
    m22 = meshes["2x2"]
    x = torch.tensor([float(rank), -float(rank), 0.5])
    out["collectives"] = dict(
        psum=_np(C.psum(x, m22, "edges")),
        psum_list=_np(C.psum([x, 2 * x[:2]], m22, "sessions")),
        pmin=_np(C.pmin(x, m22, "sessions")),
        gather=_np(C.all_gather(torch.tensor([[rank, 10 * rank]], dtype=torch.int32),
                                m22, "edges")),
        gather_bool=_np(C.all_gather(torch.tensor([rank % 2 == 0]), m22, "sessions")),
        gather_sum=_np(C._gather_by_sum(torch.tensor([[-0.0, rank + 0.25]]),
                                        m22.get_group("edges"), *C.shard(m22, "edges"))))

    cfg = gn.GNConfig(iterations=5)
    worlds = [graph_from_numpy(d, "cpu") for d in inputs["world_graphs"]]
    g0 = worlds[0]
    res = {}
    if lead:
        d = gn.optimize(g0, cfg)
        res["single"] = _np((d.poses, d.lm_xy))
    for k, m in meshes.items():
        d = distributed_optimize(g0, cfg, m)
        res[k] = _np((d.poses, d.lm_xy))
    k_cfg = dataclasses.replace(cfg, use_cholesky_kernel=True)
    d = distributed_optimize(g0, k_cfg, meshes["1x4"])
    res["1x4_kernel_flag"] = _np((d.poses, d.lm_xy))
    if partial.get_coordinate() is not None:
        d = distributed_optimize(g0, cfg, partial)
        res["partial"] = _np((d.poses, d.lm_xy))
    else:
        try:
            distributed_optimize(g0, cfg, partial)
            res["partial"] = None
        except ValueError as e:
            res["partial"] = str(e)
    out["distributed"] = res

    stacked = stack_graphs(worlds)
    res = {"single": [_np((d.poses, d.lm_xy)) for d in (gn.optimize(g, cfg) for g in worlds)]
           if lead else None}
    for k, m in meshes.items():
        o = multisession_optimize(stacked, cfg, m)
        res[k] = _np((o.poses, o.lm_xy))
    out["multisession"] = res

    two = stack_graphs(worlds[:2])
    res = {"before": [float(gn.chi2(g, cfg)) for g in worlds[:2]]}
    for k in ("1x4", "2x2"):
        o = multisession_optimize(two, cfg, meshes[k])
        res[k] = dict(poses=_np(o.poses), lm_xy=_np(o.lm_xy), after=[
            float(gn.chi2(dataclasses.replace(worlds[s], poses=o.poses[s], lm_xy=o.lm_xy[s]),
                          cfg)) for s in range(2)])
    out["chi2"] = res

    # the multi-process smoke (deploy/multihost_smoke.py) as one 4-rank world
    scfg3 = gn.GNConfig(iterations=3)
    smoke = [graph_from_numpy(d, "cpu") for d in inputs["smoke_graphs"]]
    o = multisession_optimize(stack_graphs(smoke), scfg3, meshes["4x1"])
    fo, fv, fp = (torch.tensor(a) for a in _smoke_fleet_inputs(WORLD))
    fcap = GraphCapacity(16, 16, SMOKE_B * SMOKE_N + 8)
    fcfg = SlamConfig(capacity=fcap, max_obs_per_frame=SMOKE_N)
    fst, _, fdone = run_fleet_blocked(initial_states(fcap, WORLD, "cpu"), fo, fv, fp, fcfg,
                                      meshes["4x1"], block=SMOKE_B)
    out["smoke"] = dict(poses=_np(o.poses), fleet_poses=_np(fst.graph.poses),
                        fleet_done=fdone)
    if lead:
        ref, _, _ = blocked_core_batched(initial_states(fcap, WORLD, "cpu"), fo, fv, fp, fcfg,
                                         SMOKE_B)
        out["smoke"].update(single=[_np(gn.optimize(g, scfg3).poses) for g in smoke],
                            fleet_ref=_np(ref.graph.poses))

    # the fleet: bench-track sessions, sessions sharded at 1, 2 and 4
    ob, vb, pb = (torch.tensor(a) for a in _fleet_inputs())
    fcap = GraphCapacity(max(64, ob.shape[1]), 128, 2048)
    fcfg = SlamConfig(capacity=fcap)
    res = {}
    if lead:
        ref = blocked_core_batched(initial_states(fcap, FLEET_S, "cpu"), ob, vb, pb, fcfg,
                                   FLEET_B)
        res["unsharded"] = (state_to_numpy(ref[0]), _np(dataclasses.asdict(ref[1])), ref[2])
    for k, m in meshes.items():
        st, outs, done = run_fleet_blocked(initial_states(fcap, FLEET_S, "cpu"), ob, vb, pb,
                                           fcfg, m, block=FLEET_B)
        res[k] = (state_to_numpy(st), _np(dataclasses.asdict(outs)), done)
    out["fleet"] = res

    # the map-sharded association
    a = [torch.tensor(v) for v in _assoc_inputs()]
    res = {}
    for mode, gate, use_cov, bug in ASSOC_CASES:
        ci = a[6] if use_cov else None
        key = f"{mode}{'_bug' if bug else ''}"
        res[key] = {"dense": _np(associate(*a[:6], gate, mode=mode, lm_cov_inv=ci,
                                           type_signed_bug=bug))}
        for k, m in meshes.items():
            res[key][k] = _np(associate_sharded(*a[:6], gate, m, mode=mode, lm_cov_inv=ci,
                                                type_signed_bug=bug))
        # batched over a leading session axis: each row as its own call
        two_obs = [torch.stack([v, v.flip(0)]) for v in a[:3]]
        two_lm = [torch.stack([v, v]) for v in a[3:6]]
        ci2 = None if ci is None else torch.stack([ci, ci])
        res[key]["batched"] = _np(associate_sharded(*two_obs, *two_lm, gate, meshes["2x2"],
                                                    mode=mode, lm_cov_inv=ci2,
                                                    type_signed_bug=bug))
    out["assoc"] = res

    # the live pipeline with the map-sharded association
    scen = _live_scenario()
    lcap = GraphCapacity(128, 128, 2048)
    ins = (torch.tensor(scen.obs, dtype=torch.float32), torch.tensor(scen.obs_valid),
           torch.tensor(scen.odom_poses, dtype=torch.float32))
    res = {}
    for name in LIVE_CONFIGS:
        lcfg = _port_cfg(name, lcap)
        res[name] = {}
        if lead:
            st, outs = run_sequence(initial_state(lcap, "cpu"), *ins, lcfg)
            res[name]["dense"] = (state_to_numpy(st), _np(dataclasses.asdict(outs)))
        for k, m in meshes.items():
            st, outs = run_sequence(initial_state(lcap, "cpu"), *ins, lcfg, assoc_mesh=m)
            res[name][k] = (state_to_numpy(st), _np(dataclasses.asdict(outs)))
    bcfg = _port_cfg("first", lcap)
    res["blocked"] = {}
    if lead:
        st, outs = run_sequence_blocked(initial_state(lcap, "cpu"), *ins, bcfg, block=8)
        res["blocked"]["dense"] = (state_to_numpy(st), _np(dataclasses.asdict(outs)))
    for k, m in meshes.items():
        st, outs = run_sequence_blocked(initial_state(lcap, "cpu"), *ins, bcfg, block=8,
                                        assoc_mesh=m)
        res["blocked"][k] = (state_to_numpy(st), _np(dataclasses.asdict(outs)))
    out["live"] = res

    # the fusion: landmark-sharded dedup and the distributed joint GN
    # the sessions are run on rank 0 and handed to the others
    box = [_fusion_sessions(GraphCapacity(128, 128, 2048)) if lead else None]
    dist.broadcast_object_list(box, src=0)
    stacked = box[0]
    gcfg = gn.GNConfig(iterations=4)
    gate = SlamConfig().same_cone_threshold
    raw = (stacked.lm_xy.reshape(-1, 2), stacked.lm_type.reshape(-1),
           (torch.arange(128)[None, :] < stacked.n_landmarks[:, None]).reshape(-1), gate)
    res = {}
    if lead:
        golden, rep = fuse_sessions(stacked, cfg=gcfg, gate=gate)
        res = {"stacked": {f.name: _np(getattr(stacked, f.name))
                           for f in dataclasses.fields(stacked)},
               "golden": (_np(golden.poses), _np(golden.lm_xy), int(golden.n_poses),
                          int(golden.n_landmarks), _np(rep["labels"])),
               "dedup": _np(dedup_labels(*raw))}
    for k, m in meshes.items():
        fused, rep_m = fuse_sessions(stacked, cfg=gcfg, gate=gate, mesh=m)
        res[k] = (_np(fused.poses), _np(fused.lm_xy), int(fused.n_poses),
                  int(fused.n_landmarks), _np(rep_m["labels"]), _np(dedup_labels(*raw, mesh=m)))
    out["fusion"] = res
    return out


def _rank_main(rank, world, port, out_dir):
    from tpuslam_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    initialize_distributed("gloo", f"localhost:{port}", world, rank, timeout_s=RANK_TIMEOUT_S)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    try:
        out = _rank_cases(inputs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the JAX side, in this process

def _jgraph_np(g):
    import dataclasses
    return {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)}


def _jax_world_graphs():
    from tests.test_parallel import _world
    return [_world(seed=s) for s in range(4)]


def _jax_smoke_graphs():
    from bench_scaling import _build_session
    from tpuslam.backend.graph import GraphCapacity as JCap
    return [_build_session(JCap(64, 32, 512), s) for s in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo world, started on first use: a function that waits for it
    and returns each rank's results."""
    out_dir = str(tmp_path_factory.mktemp("gloo_world"))
    inputs = dict(world_graphs=[_jgraph_np(g) for g in _jax_world_graphs()],
                  smoke_graphs=[_jgraph_np(g) for g in _jax_smoke_graphs()])
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    from tpuslam_torch.parallel.mesh import free_port
    ctx = mp.start_processes(_rank_main, args=(WORLD, free_port(), out_dir), nprocs=WORLD,
                             join=False, start_method="spawn")
    box = []

    def results():
        if not box:
            deadline = time.monotonic() + WORLD_DEADLINE_S
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"the gloo world ran past {WORLD_DEADLINE_S} s")
            for r in range(WORLD):
                with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                    box.append(pickle.load(f))
        return box

    yield results
    if not box:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def jax_refs(world):
    """The JAX package's results of the cases that need no port output,
    computed while the world runs."""
    import jax
    import jax.numpy as jnp
    from tpuslam.backend import gauss_newton as jgn
    from tpuslam.ops.association import associate as jassociate
    from tpuslam.parallel import (
        associate_sharded as jassociate_sharded, distributed_optimize as jdistributed,
        make_slam_mesh as jmesh, multisession_optimize as jmultisession,
        stack_graphs as jstack,
    )
    from tpuslam.parallel.batch import initial_states as jinitial_states
    from tpuslam.parallel.fleet import run_fleet_blocked as jfleet
    from tpuslam.frontend.blocked import blocked_core_batched as jblocked_batched
    from tpuslam.frontend.pipeline import run_sequence as jrun_sequence
    from tpuslam.frontend.state import initial_state as jinitial_state
    from tpuslam.backend.graph import GraphCapacity as JCap
    from tpuslam.runtime.config import SlamConfig as JCfg

    refs = {}
    cfg = jgn.GNConfig(iterations=5)
    graphs = _jax_world_graphs()
    d = jdistributed(graphs[0], cfg, jmesh(n_sessions=1, n_edge_shards=8))
    refs["distributed"] = (np.asarray(d.poses), np.asarray(d.lm_xy))
    o = jmultisession(jstack(graphs), cfg, jmesh(n_sessions=4, n_edge_shards=2))
    refs["multisession"] = (np.asarray(o.poses), np.asarray(o.lm_xy))
    o = jmultisession(jstack(graphs[:2]), cfg, jmesh(n_sessions=2, n_edge_shards=4))
    refs["chi2"] = (np.asarray(o.poses), np.asarray(o.lm_xy))
    refs["smoke"] = [np.asarray(jgn.optimize(g, jgn.GNConfig(iterations=3)).poses)
                     for g in _jax_smoke_graphs()]
    fo, fv, fp = (jnp.asarray(a) for a in _smoke_fleet_inputs(WORLD))
    fcap = JCap(16, 16, SMOKE_B * SMOKE_N + 8)
    ref, _, _ = jblocked_batched(jinitial_states(fcap, WORLD), fo, fv, fp,
                                 JCfg(capacity=fcap, max_obs_per_frame=SMOKE_N), SMOKE_B)
    refs["smoke_fleet"] = np.asarray(ref.graph.poses)

    ob, vb, pb = (jnp.asarray(a) for a in _fleet_inputs())
    fcap = JCap(max(64, ob.shape[1]), 128, 2048)
    st, outs, done = jfleet(jinitial_states(fcap, FLEET_S), ob, vb, pb, JCfg(capacity=fcap),
                            jmesh(n_sessions=8, n_edge_shards=1), block=FLEET_B)
    refs["fleet"] = (jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, outs),
                     np.asarray(done))

    a = [jnp.asarray(v) for v in _assoc_inputs()]
    amesh = jmesh(n_sessions=1, n_edge_shards=8)
    refs["assoc"] = {}
    for mode, gate, use_cov, bug in ASSOC_CASES:
        ci = a[6] if use_cov else None
        key = f"{mode}{'_bug' if bug else ''}"
        refs["assoc"][key] = (
            [np.asarray(x) for x in jassociate(*a[:6], gate, mode=mode, lm_cov_inv=ci,
                                               type_signed_bug=bug)],
            [np.asarray(x) for x in jassociate_sharded(*a[:6], gate, amesh, mode=mode,
                                                       lm_cov_inv=ci, type_signed_bug=bug)])

    scen = _live_scenario()
    lcap = JCap(128, 128, 2048)
    ins = (jnp.asarray(scen.obs, jnp.float32), jnp.asarray(scen.obs_valid),
           jnp.asarray(scen.odom_poses, jnp.float32))
    refs["live"] = {}
    for name in LIVE_CONFIGS:
        if name == "first":
            jc = JCfg(capacity=lcap)
        elif name == "nearest":
            jc = JCfg(capacity=lcap, association="nearest", reference_compat=False,
                      localizer_type_bug=False)
        else:
            jc = JCfg.improved(capacity=lcap, periodic_gn_every=0, association="mahalanobis")
        st, outs = jrun_sequence(jinitial_state(lcap), *ins, jc, assoc_mesh=amesh)
        refs["live"][name] = (jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, outs))
    refs["gt"] = scen.gt_poses
    return refs


@pytest.fixture(scope="module")
def port(world, jax_refs):
    """Each rank's results, waited for after the JAX references."""
    return world()


def _ranks(port, key):
    """Every rank's result of case `key`."""
    return [r[key] for r in port]


def _same(a, b, path=""):
    """Exact equality of two nested results."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# --------------------------------------------------------------------------
# tests/test_parallel.py and tests/test_fusion.py, mirrored

def test_mesh_shapes(port):
    """tests/test_parallel.py::test_mesh_shapes: the axes and the row-major
    layout of each shape; the default edge count; a mesh that does not
    divide the world refused; ranks past a mesh hold no coordinate."""
    import jax
    from tpuslam.parallel import make_slam_mesh as jmesh
    jm = jmesh(n_sessions=2)
    assert jm.axis_names == ("sessions", "edges") and jm.devices.shape == (2, 4)
    res = _ranks(port, "mesh")
    for r, got in enumerate(res):
        for k, (s, e) in SHAPES.items():
            grid, names, coord = got["shapes"][k]
            assert names == ("sessions", "edges")
            assert np.array_equal(grid, np.arange(WORLD).reshape(s, e))
            assert tuple(coord) == (r // e, r % e)
        assert got["default"] == [[0, 1], [2, 3]]
        assert got["partial"] == ((0, r) if r < 2 else None)
        assert "does not divide" in got["bad"] or "not divisible" in got["bad"]
    assert len(jax.devices()) == 8


def test_collectives(port):
    """psum, pmin and the gathers (native and as a sum of zero-padded
    buffers) on the 2x2 mesh, against numpy."""
    for r, got in enumerate(_ranks(port, "collectives")):
        s, e = divmod(r, 2)
        row = [2 * s, 2 * s + 1]
        col = [e, 2 + e]
        np.testing.assert_array_equal(got["psum"], [sum(row), -sum(row), 1.0])
        np.testing.assert_array_equal(got["psum_list"][0], [sum(col), -sum(col), 1.0])
        np.testing.assert_array_equal(got["psum_list"][1], [2 * sum(col), -2 * sum(col)])
        np.testing.assert_array_equal(got["pmin"], [min(col), -max(col), 0.5])
        np.testing.assert_array_equal(got["gather"], [[q, 10 * q] for q in row])
        np.testing.assert_array_equal(got["gather_bool"], [q % 2 == 0 for q in col])
        want = np.array([[-0.0, q + 0.25] for q in row], np.float32)
        assert got["gather_sum"].tobytes() == want.tobytes()


def test_distributed_matches_single_device(port, jax_refs):
    """tests/test_parallel.py::test_distributed_matches_single_device at
    each shape: within 5e-4 of the port's single-device `optimize` and of
    the JAX package's `distributed_optimize` (1x8); through the Cholesky
    flag (its plain twin on the CPU) too. Ranks past a 1x2 mesh raise."""
    jp, jl = jax_refs["distributed"]
    res = _ranks(port, "distributed")
    sp, sl = res[0]["single"]
    for r, got in enumerate(res):
        for k in (*SHAPES, "1x4_kernel_flag"):
            p, lm = got[k]
            np.testing.assert_allclose(p, sp, atol=GN_ATOL, err_msg=k)
            np.testing.assert_allclose(lm, sl, atol=GN_ATOL, err_msg=k)
            np.testing.assert_allclose(p, jp, atol=GN_ATOL, err_msg=k)
            np.testing.assert_allclose(lm, jl, atol=GN_ATOL, err_msg=k)
            _same(got[k], res[0][k], f"rank {r} {k}")
        if r < 2:
            np.testing.assert_allclose(got["partial"][0], sp, atol=GN_ATOL)
        else:
            assert "outside the mesh" in got["partial"]


def test_multisession_matches_sequential(port, jax_refs):
    """tests/test_parallel.py::test_multisession_matches_sequential at each
    shape: every session within 5e-4 of its own `optimize` and of the JAX
    package's `multisession_optimize` (4x2)."""
    jp, jl = jax_refs["multisession"]
    res = _ranks(port, "multisession")
    for r, got in enumerate(res):
        for k in SHAPES:
            p, lm = got[k]
            for s, (sp, sl) in enumerate(res[0]["single"]):
                np.testing.assert_allclose(p[s], sp, atol=GN_ATOL, err_msg=f"{k} session {s}")
                np.testing.assert_allclose(lm[s], sl, atol=GN_ATOL, err_msg=f"{k} session {s}")
            np.testing.assert_allclose(p, jp, atol=GN_ATOL, err_msg=k)
            np.testing.assert_allclose(lm, jl, atol=GN_ATOL, err_msg=k)
            _same(got[k], res[0][k], f"rank {r} {k}")


def test_multisession_improves_chi2(port, jax_refs):
    """tests/test_parallel.py::test_multisession_improves_chi2 at the shapes
    whose 'sessions' axis divides two sessions; the result within 5e-4 of
    the JAX package's (2x4)."""
    jp, jl = jax_refs["chi2"]
    for got in _ranks(port, "chi2"):
        for k in ("1x4", "2x2"):
            for s in range(2):
                assert got[k]["after"][s] < got["before"][s], (k, s)
            np.testing.assert_allclose(got[k]["poses"], jp, atol=GN_ATOL, err_msg=k)
            np.testing.assert_allclose(got[k]["lm_xy"], jl, atol=GN_ATOL, err_msg=k)


def test_multihost_distributed_gn_smoke(port, jax_refs):
    """tests/test_parallel.py::test_multihost_distributed_gn_smoke as one
    4-rank world: `multisession_optimize` with a session on each rank (the
    reduction and the gather cross the processes) within 1e-4 of each
    session's single-device `optimize` (the port's and the JAX package's),
    and the fleet of deploy/multihost_smoke.py within 1e-4 of the unsharded
    batched core, every frame done."""
    res = _ranks(port, "smoke")
    for got in res:
        for s in range(WORLD):
            np.testing.assert_allclose(got["poses"][s], res[0]["single"][s], atol=SMOKE_ATOL)
            np.testing.assert_allclose(got["poses"][s], jax_refs["smoke"][s], atol=SMOKE_ATOL)
        np.testing.assert_allclose(got["fleet_poses"], res[0]["fleet_ref"], atol=SMOKE_ATOL)
        np.testing.assert_allclose(got["fleet_poses"], jax_refs["smoke_fleet"], atol=SMOKE_ATOL)
        assert got["fleet_done"] == [SMOKE_T] * WORLD


def _compare_tree(got, want, atol, what):
    """Nested numpy results: integers and bools exact, floats within atol."""
    if isinstance(want, dict):
        for k in want:
            _compare_tree(got[k], want[k], atol, f"{what}.{k}")
        return
    a, b = np.asarray(got), np.asarray(want)
    if b.dtype.kind in "fc":
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _jax_state_dict(st):
    import dataclasses
    d = {f.name: getattr(st, f.name) for f in dataclasses.fields(st) if f.name != "graph"}
    d["graph"] = {f.name: getattr(st.graph, f.name) for f in dataclasses.fields(st.graph)}
    return d


def test_fleet_blocked_matches_unsharded(port, jax_refs):
    """tests/test_parallel.py::test_fleet_blocked_matches_unsharded with the
    sessions sharded 1, 2 and 4 ways: decisions exact and values within
    2e-4 of the unsharded `blocked_core_batched`, and within the batched
    path's 2e-3 of the JAX package's fleet (8x1)."""
    import dataclasses
    jst, jouts, jdone = jax_refs["fleet"]
    jst = _jax_state_dict(jst)
    jouts = {f.name: getattr(jouts, f.name) for f in dataclasses.fields(jouts)}
    res = _ranks(port, "fleet")
    ref = res[0]["unsharded"]
    for got in res:
        for k in SHAPES:
            st, outs, done = got[k]
            assert done == ref[2] == [int(x) for x in jdone], k
            _compare_tree(st, ref[0], FLEET_ATOL, f"{k} state")
            _compare_tree(outs, ref[1], FLEET_ATOL, f"{k} outputs")
            _compare_tree(st, jst, BATCHED_ATOL, f"{k} state vs JAX")
            _compare_tree(outs, jouts, BATCHED_ATOL, f"{k} outputs vs JAX")


def test_map_sharded_association_matches_single(port, jax_refs):
    """tests/test_parallel.py::test_map_sharded_association_matches_single
    with the map over 4, 2 and 1 shards: matched masks exact, indices exact
    where matched, costs within 1e-6 relative, against the port's dense
    `associate` and both of the JAX package's; a leading session axis
    equals its rows' calls."""
    for got in _ranks(port, "assoc"):
        for mode, _gate, _cov, bug in ASSOC_CASES:
            key = f"{mode}{'_bug' if bug else ''}"
            dense = got[key]["dense"]
            jdense, jsharded = jax_refs["assoc"][key]
            m = dense[1]
            for want in (jdense, jsharded):
                np.testing.assert_array_equal(m, want[1], err_msg=key)
                np.testing.assert_array_equal(dense[0][m], want[0][m], err_msg=key)
            for k in SHAPES:
                idx, matched, cost = got[key][k]
                np.testing.assert_array_equal(matched, m, err_msg=f"{key} {k}")
                np.testing.assert_array_equal(idx[m], dense[0][m], err_msg=f"{key} {k}")
                np.testing.assert_array_equal(idx[~m], 0, err_msg=f"{key} {k}")
                np.testing.assert_allclose(cost[m], dense[2][m], rtol=1e-6, err_msg=key)
                np.testing.assert_allclose(cost[m], jsharded[2][m], rtol=1e-6, err_msg=key)
                assert np.all(cost[~m] == np.float32(1e30))
            b_idx, b_matched, b_cost = got[key]["batched"]
            np.testing.assert_array_equal(b_matched[0], m, err_msg=key)
            np.testing.assert_array_equal(b_idx[0], got[key]["2x2"][0], err_msg=key)
            np.testing.assert_array_equal(b_idx[1], got[key]["2x2"][0][::-1], err_msg=key)
            np.testing.assert_array_equal(b_cost[1], got[key]["2x2"][2][::-1], err_msg=key)


def test_live_pipeline_with_sharded_association_matches_dense(port, jax_refs):
    """tests/test_parallel.py::test_live_pipeline_with_sharded_association_
    matches_dense at each shape, per frame (and compat through the blocked
    pipeline): landmark and edge counts, edges and closure exact, poses
    within 1e-5 of the dense run; published poses within 1e-5, but for the
    Mahalanobis localizer refine, whose indexed semantics are held to ATE
    within 0.01 m of the dense run. Every run is held to the JAX package's
    run with its 1x8 mesh: decisions exact, values within the pipeline
    tests' 1e-3."""
    from tpuslam.sim.simulator import ate
    gt = jax_refs["gt"]
    res = _ranks(port, "live")
    for r, got in enumerate(res):
        for name in (*LIVE_CONFIGS, "blocked"):
            dst, dout = res[0][name]["dense"]
            for k in SHAPES:
                st, out = got[name][k]
                g, dg = st["graph"], dst["graph"]
                assert int(g["n_landmarks"]) == int(dg["n_landmarks"]), (name, k)
                assert int(g["n_obs"]) == int(dg["n_obs"]), (name, k)
                assert bool(st["loop_closure_complete"]) == bool(dst["loop_closure_complete"])
                np.testing.assert_array_equal(g["obs_lm"], dg["obs_lm"], err_msg=name)
                np.testing.assert_allclose(g["poses"], dg["poses"], atol=1e-5, rtol=0,
                                           err_msg=f"{name} {k}")
                if name == "mahalanobis":
                    a_s = ate(out["pose"][:, :2], gt[:len(out["pose"]), :2])
                    a_d = ate(dout["pose"][:, :2], gt[:len(dout["pose"]), :2])
                    assert abs(a_s - a_d) < 0.01, (a_s, a_d)
                else:
                    np.testing.assert_allclose(out["pose"], dout["pose"], atol=1e-5, rtol=0,
                                               err_msg=f"{name} {k}")
                if name != "blocked":
                    jst, jout = jax_refs["live"][name]
                    jg = jst.graph
                    assert int(g["n_landmarks"]) == int(jg.n_landmarks), (name, k)
                    np.testing.assert_array_equal(g["obs_lm"], jg.obs_lm, err_msg=name)
                    np.testing.assert_array_equal(out["send"], jout.send, err_msg=name)
                    np.testing.assert_array_equal(out["cone_type"], jout.cone_type,
                                                  err_msg=name)
                    np.testing.assert_allclose(g["poses"], jg.poses, atol=PIPELINE_ATOL,
                                               rtol=0, err_msg=f"{name} {k} vs JAX")
                    np.testing.assert_allclose(out["pose"], jout.pose, atol=PIPELINE_ATOL,
                                               rtol=0, err_msg=f"{name} {k} vs JAX")
                _same(got[name][k], res[0][name][k], f"rank {r} {name} {k}")


def test_fusion_sharded_matches_single_device_golden(port):
    """tests/test_fusion.py::test_fusion_sharded_matches_single_device_
    golden at each shape: labels and the fused landmark count exact (and
    `dedup_labels(mesh=)` alone), optimized values within 5e-4 of the
    port's single-device fusion and of the JAX package's mesh fusion (1x8)
    of the same sessions."""
    import jax.numpy as jnp
    from tpuslam.backend import gauss_newton as jgn
    from tpuslam.backend.graph import FactorGraph as JGraph
    from tpuslam.parallel import fusion as jfusion
    from tpuslam.parallel import make_slam_mesh as jmesh
    res = _ranks(port, "fusion")
    stacked = JGraph(**{k: jnp.asarray(v) for k, v in res[0]["stacked"].items()})
    from tpuslam.runtime.config import SlamConfig as JCfg
    jfused, jrep = jfusion.fuse_sessions(stacked, cfg=jgn.GNConfig(iterations=4),
                                         gate=JCfg().same_cone_threshold,
                                         mesh=jmesh(n_sessions=1, n_edge_shards=8))
    gp, gl, npo, nl, labels = res[0]["golden"]
    np.testing.assert_array_equal(labels, np.asarray(jrep["labels"]))
    assert nl == int(jfused.n_landmarks) and npo == int(jfused.n_poses)
    for got in res:
        for k in SHAPES:
            p, lm, npo_k, nl_k, labels_k, dedup = got[k]
            np.testing.assert_array_equal(labels_k, labels, err_msg=k)
            np.testing.assert_array_equal(dedup, res[0]["dedup"], err_msg=k)
            assert (npo_k, nl_k) == (npo, nl)
            np.testing.assert_allclose(p[:npo], gp[:npo], atol=GN_ATOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(lm[:nl], gl[:nl], atol=GN_ATOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(p[:npo], np.asarray(jfused.poses)[:npo], atol=GN_ATOL,
                                       rtol=0, err_msg=k)
            np.testing.assert_allclose(lm[:nl], np.asarray(jfused.lm_xy)[:nl], atol=GN_ATOL,
                                       rtol=0, err_msg=k)


def test_distributed_reference_constant():
    """chip_smoke.DISTRIBUTED_REFERENCE: the JAX package's
    `distributed_optimize` (1x2 mesh) of the graph the closure GN solves on
    the bench lap (the port's CPU run of its first CLOSURE_FRAME frames,
    handed over through numpy), `chip_smoke.graph_metrics` of the result
    within 1e-6 of the constant (rounded to 6 places); the port's own
    `distributed_optimize` of the graph on a one-rank gloo mesh in this
    process within METRIC_ATOL_M."""
    import dataclasses

    import jax.numpy as jnp

    import chip_smoke
    from tpuslam.backend import gauss_newton as jgn
    from tpuslam.backend.graph import FactorGraph as JGraph
    from tpuslam.parallel import distributed_optimize as jdistributed
    from tpuslam.parallel import make_slam_mesh as jmesh
    from tpuslam_torch.frontend.keyframe import _gn_config
    from tpuslam_torch.frontend.pipeline import run_pass
    from tpuslam_torch.parallel import distributed_optimize, make_slam_mesh
    from tpuslam_torch.parallel.mesh import initialize_distributed
    track, scen = chip_smoke.scenario()
    k = chip_smoke.CLOSURE_FRAME
    obs, valid, poses = chip_smoke.inputs(scen, "cpu")
    g = run_pass(obs[:k], valid[:k], poses[:k], chip_smoke.configs()["first"])[0].graph
    assert 3 * g.poses.shape[0] == chip_smoke.DISTRIBUTED_N
    cfg = _gn_config(chip_smoke.configs()["first"])
    jcfg = jgn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info, iterations=cfg.iterations)
    jg = JGraph(**{f.name: jnp.asarray(getattr(g, f.name).numpy()) for f in dataclasses.fields(g)})
    jd = jdistributed(jg, jcfg, jmesh(n_sessions=1, n_edge_shards=2))
    want = chip_smoke.graph_metrics(track, scen, dataclasses.replace(
        g, poses=torch.tensor(np.asarray(jd.poses)), lm_xy=torch.tensor(np.asarray(jd.lm_xy))))
    chip_smoke.check_metrics("distributed", want, chip_smoke.DISTRIBUTED_REFERENCE, atol=1e-6)
    initialize_distributed("gloo")
    d = distributed_optimize(g, cfg, make_slam_mesh(1, 1, device_type="cpu"))
    chip_smoke.check_metrics("distributed", chip_smoke.graph_metrics(track, scen, d), want)
