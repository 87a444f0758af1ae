"""The port's pose-chain solvers (`tpuslam_torch.parallel`: `chain`,
`resident`, `hier`, `hier3`, `instrument`, `comm_model`, and
`fuse_sessions`' chain solvers) against the JAX package's, on the CPU.

One world of 8 gloo ranks (a module-scoped fixture: spawned processes, one
thread each, a free localhost port, `device_type="cpu"`) runs every port
case on a ('chain',) mesh of 8, each rank with the same global inputs, and
hands numpy results back; the ranks must return the same. The JAX package's
layouts need 8 shards (hier3's tray 2 / pod 4, hier's trays 2 and 4), and
the JAX package runs in this process on conftest's 8 CPU devices on the
same meshes; the graphs are built once here, by the JAX package, and handed
to the ranks. The port's single-device references run on rank 0 alone.
Each case mirrors its JAX test and keeps its tolerance: the single-device
GN within 5e-4 (2e-3 at trackdrive scale, 5e-3 for hier/hier3 and 2e-3
against the flat resident solve, 3e-3 / 1e-2 for the fused graph, 1e-2 for
the fusion's solver registry); resident against DD within 1e-4. Every plan
equals the JAX package's field for field; the payloads the port's
collectives count in one iteration (`instrument.collective_payload_bytes`
over two iterations less one) equal what the JAX package's jaxpr walker
counts for the same step, kind by kind, and the analytic
`*_comm_bytes_per_iteration` / `comm_model` figures.

The same world runs the map-resident online pass (`parallel.resident_online`)
on ('map',) meshes over the first 1, 2, 4 and 8 ranks, on a small trackdrive
lap (tests/test_instrument.py:200-210's), against the port's dense
`run_pass_blocked` (rank 0) and the JAX package's resident pass on its
8-device mesh (this process), with tests/test_resident_online.py's rules.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
RANK_TIMEOUT_S = 120.0
WORLD_DEADLINE_S = 400.0
GN_ATOL, TRACK_ATOL, RESIDENT_DD_ATOL = 5e-4, 2e-3, 1e-4
HIER_SINGLE_ATOL, HIER_FLAT_ATOL = 5e-3, 2e-3
FUSED_RESIDENT_ATOL, FUSED_HIER_ATOL, REGISTRY_ATOL = 3e-3, 1e-2, 1e-2
# the port's solve against the JAX package's same solve: two f32 solvers
# whose sums run in other orders
JAX_ATOL = 1e-3
SOLVERS = (("dd", None), ("hier", 2), ("hier", None), ("hier3", None))
# the resident online pass (tests/test_resident_online.py): name -> (config,
# block); compat and Mahalanobis are held to the dense pass by `_ro_compare`
# within RO_ATOL, the improved ones by `_ro_structure` within RO_STRUCT_ATOL
RO_CONFIGS = {"first": ({}, 16), "nearest": (dict(association="nearest"), 16),
              "mahalanobis": (dict(improved=True, association="mahalanobis",
                                   periodic_gn_every=0), 16),
              "improved": (dict(improved=True, periodic_gn_every=16), 16),
              "midblock": (dict(improved=True, periodic_gn_every=8), 32)}
RO_STRUCTURE = ("improved", "midblock")
RO_ATOL, RO_STRUCT_ATOL = 2e-3, 5e-2
RO_MESHES = (1, 2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if torch.is_tensor(x):
        return x.cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


# --------------------------------------------------------------------------
# the port side: what each rank of the gloo world runs

def _gp(g):
    return (_np(g.poses), _np(g.lm_xy))


def _per_iteration(run, *args, **kw):
    """The payload of one iteration: `run(iterations=2)` less `run(1)`."""
    from tpuslam_torch.parallel.instrument import collective_payload_bytes
    one, two = (collective_payload_bytes(run, k, *args, **kw) for k in (1, 2))
    return {k: {f: two[k][f] - one.get(k, {}).get(f, 0) for f in ("count", "bytes")}
            for k in two if k != "total_bytes"}


def _rank_cases(inputs):
    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.frontend.state import graph_from_numpy
    from tpuslam_torch.parallel import chain_optimize, chain_optimize_resident
    from tpuslam_torch.parallel import collectives as C
    from tpuslam_torch.parallel import fusion
    from tpuslam_torch.parallel.chain import partition_chain, partition_edges_by_pose_block
    from tpuslam_torch.parallel.hier import chain_optimize_hier, partition_chain_hier
    from tpuslam_torch.parallel.hier3 import chain_optimize_hier3, partition_chain_hier3
    from tpuslam_torch.parallel.mesh import make_chain_mesh
    from tpuslam_torch.parallel.multisession import stack_graphs
    from tpuslam_torch.parallel.resident import partition_chain_resident

    lead = dist.get_rank() == 0
    mesh = make_chain_mesh(WORLD, device_type="cpu")
    G = {k: graph_from_numpy(v, "cpu") for k, v in inputs["graphs"].items()}
    out = {}

    # the collectives of the chain solvers: the ring shift and grouped sums
    me = torch.tensor([float(dist.get_rank())])
    ring = [(i, (i + 1) % WORLD) for i in range(WORLD)]
    out["collectives"] = dict(
        ring=_np(C.ppermute(me, mesh, "chain", ring)),
        partial=_np(C.ppermute(me, mesh, "chain", [(3, 5)])),
        trays=_np(C.psum(me, mesh, "chain", groups=[[0, 1], [2, 3], [4, 5], [6, 7]])),
        pods=_np(C.psum([me, 2 * me], mesh, "chain", groups=[[0, 1, 2, 3], [4, 5, 6, 7]])))

    cfg = gn.GNConfig(iterations=5)
    g = G["world"]
    res = {"plan": _np(partition_chain(g, WORLD)),
           "resident_plan": _np(partition_chain_resident(g, WORLD))}
    if lead:
        res["single"] = _gp(gn.optimize(g, cfg))
    res["replicated"] = _gp(chain_optimize(g, cfg, mesh))
    res["dd"] = _gp(chain_optimize(g, cfg, mesh, solver="dd"))
    res["resident"] = _gp(chain_optimize_resident(g, cfg, mesh,
                                                  plan=partition_chain_resident(g, WORLD)))
    g3 = G["world3"]
    res["dd3"] = _gp(chain_optimize(g3, cfg, mesh, solver="dd"))
    res["resident3"] = _gp(chain_optimize_resident(g3, cfg, mesh))
    out["world"] = res

    gt, tcfg = G["track"], gn.GNConfig(iterations=4)
    plan, rplan = partition_chain(gt, WORLD), partition_chain_resident(gt, WORLD)
    from tpuslam_torch.parallel.resident import resident_comm_bytes_per_iteration
    res = {"plan": _np(plan), "resident_plan": _np(rplan),
           "comm": resident_comm_bytes_per_iteration(rplan),
           "dd": _gp(chain_optimize(gt, tcfg, mesh, solver="dd")),
           "resident": _gp(chain_optimize_resident(gt, tcfg, mesh, plan=rplan))}
    if lead:
        res["single"] = _gp(gn.optimize(gt, tcfg))
    out["track"] = res

    gh, hcfg = G["hier"], gn.GNConfig(iterations=3)
    res = {"resident": _gp(chain_optimize_resident(gh, hcfg, mesh))}
    for tray in (2, 4):
        hp = partition_chain_hier(gh, WORLD, tray)
        res[f"plan{tray}"] = _np(hp)
        res[f"hier{tray}"] = _gp(chain_optimize_hier(gh, hcfg, mesh, tray, plan=hp))
    h3 = partition_chain_hier3(gh, WORLD, tray=2, pod=4)
    res["plan3"] = _np(h3)
    res["hier3"] = _gp(chain_optimize_hier3(gh, hcfg, mesh, tray=2, pod=4, plan=h3))
    if lead:
        res["single"] = _gp(gn.optimize(gh, hcfg))
    out["hier"] = res

    # payloads per iteration, on the JAX tests' graphs
    gi = G["instrument"]
    one = gn.GNConfig(iterations=1)

    def iters(k):
        return dataclasses.replace(one, iterations=k)
    g2, counts = partition_edges_by_pose_block(gi, WORLD)
    iplan, irplan = partition_chain(gi, WORLD), partition_chain_resident(gi, WORLD)
    hp4, hp3 = partition_chain_hier(gh, WORLD, 4), partition_chain_hier3(gh, WORLD, 2, 4)
    out["payload"] = dict(
        replicated=_per_iteration(lambda k: chain_optimize(g2, iters(k), mesh, counts)),
        dd=_per_iteration(lambda k: chain_optimize(gi, iters(k), mesh, solver="dd",
                                                   plan=iplan)),
        resident=_per_iteration(lambda k: chain_optimize_resident(gi, iters(k), mesh,
                                                                  plan=irplan)),
        hier=_per_iteration(lambda k: chain_optimize_hier(gh, iters(k), mesh, 4, plan=hp4)),
        hier3=_per_iteration(lambda k: chain_optimize_hier3(gh, iters(k), mesh, 2, 4,
                                                            plan=hp3)),
        shared_cap=(iplan.shared_cap, irplan.shared_cap))

    gf = G["fused"]
    fcfg = gn.GNConfig(odo_info=inputs["odo_info"], lm_info=inputs["lm_info"], iterations=4,
                       fix_first_poses=0, fix_first_landmarks=0)
    fplan = partition_chain_resident(gf, WORLD)
    res = {"plan": _np(fplan),
           "resident": _gp(chain_optimize_resident(gf, fcfg, mesh, plan=fplan))}
    for tray in (2, 4):
        res[f"hier{tray}"] = _gp(chain_optimize_hier(gf, fcfg, mesh, tray=tray))
    if lead:
        res["single"] = _gp(gn.optimize(gf, fcfg))
    out["fused"] = res

    stacked = stack_graphs([graph_from_numpy(d, "cpu") for d in inputs["pack"]])
    rcfg = gn.GNConfig(odo_info=inputs["pack_odo_info"], lm_info=inputs["pack_lm_info"],
                       iterations=3)
    res = {}
    if lead:
        base, rep = fusion.fuse_sessions(stacked, cfg=rcfg, gate=inputs["gate"], align=False)
        res["auto"] = (_gp(base), int(base.n_poses), int(base.n_landmarks), rep["solver"])
    for solver, tray in SOLVERS:
        o, rep = fusion.fuse_sessions(stacked, cfg=rcfg, gate=inputs["gate"], align=False,
                                      solver=solver, tray=tray, solve_mesh=mesh)
        res[f"{solver}/{tray}"] = (_gp(o), rep["solver"])
    out["registry"] = res
    return out


def _ro_config(name, dims, **kw):
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.runtime.config import SlamConfig
    opts, block = RO_CONFIGS[name]
    opts = {**opts, **kw}
    make = SlamConfig.improved if opts.pop("improved", False) else SlamConfig
    return make(capacity=GraphCapacity(*dims), **opts), block


def _ro_np(run):
    from tpuslam_torch.frontend.state import state_to_numpy
    st, outs = run
    return state_to_numpy(st), _np(dataclasses.asdict(outs))


def _resident_online_cases(ro):
    """The resident online pass on ('map',) meshes of 1, 2, 4 and 8 ranks
    (every rank makes every mesh; a rank past one runs nothing on it).
    Returns (results every rank holds alike, results per mesh size of the
    ranks in it)."""
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.frontend.blocked import _pad_inputs, _pick_compact, run_pass_blocked
    from tpuslam_torch.frontend.state import initial_state
    from tpuslam_torch.parallel import resident_online as RO
    from tpuslam_torch.parallel import collectives as C
    from tpuslam_torch.parallel.mesh import make_map_mesh

    rank = dist.get_rank()
    meshes = {d: make_map_mesh(d, device_type="cpu") for d in RO_MESHES}
    ins = [torch.from_numpy(ro[k]) for k in ("obs", "valid", "poses")]
    dims = ro["dims"]
    res = {"d8": {}, "single": {"dense": {}, "d1": {}}}
    for name in RO_CONFIGS:
        cfg, block = _ro_config(name, dims)
        res["d8"][name] = _ro_np(RO.run_pass_resident_online(*ins, cfg, meshes[8], block=block))
        if rank == 0:
            res["single"]["dense"][name] = _ro_np(run_pass_blocked(*ins, cfg, block=block))
            res["single"]["d1"][name] = _ro_np(RO.run_pass_resident_online(*ins, cfg, meshes[1],
                                                                           block=block))

    # a fallback mid-lap: a landmark capacity of 64 for a lap of ~110
    small = (dims[0], 64, dims[2])
    cfg, block = _ro_config("first", small)
    res["fallback"] = _ro_np(RO.run_pass_resident_online(*ins, cfg, meshes[8], block=block))
    if rank == 0:
        res["single"]["fallback"] = _ro_np(run_pass_blocked(*ins, cfg, block=block))
    # 24 slots per rank: a sharded map of 192 > max_landmarks
    cfg, block = _ro_config("first", dims)
    res["lm_per_device"] = _ro_np(RO.run_pass_resident_online(*ins, cfg, meshes[8], block=block,
                                                              lm_per_device=24))
    try:
        RO.run_pass_resident_online(*ins, _ro_config("first", (dims[0], 100, dims[2]))[0],
                                    meshes[8], block=block)
        res["refuse_l_mod_d"] = None
    except ValueError as e:
        res["refuse_l_mod_d"] = str(e)
    try:
        make_map_mesh(8, device_type="cuda")
        res["cuda_refused"] = None
    except RuntimeError as e:
        res["cuda_refused"] = str(e)
    # the branch-agreement rule: agreed flags come back, differing ones
    # raise on every rank
    res["agreed"] = RO._agreed([torch.tensor([3, 1]), torch.tensor(7)], meshes[8], "map")
    try:
        RO._agreed([torch.tensor(rank % 2)], meshes[8], "map")
        res["disagreed"] = None
    except RuntimeError as e:
        res["disagreed"] = str(e)

    # per mesh size: compat 'first' through the pass, and the core's payload
    # and shard shapes
    per_d = {}
    o_p, v_p, p_p = _pad_inputs(*ins, cfg, block)
    nc, _ = _pick_compact(v_p, initial_state(GraphCapacity(*dims), "cpu"))
    for d in (2, 4, 8):
        if rank >= d:
            continue
        mesh = meshes[d]
        state = initial_state(GraphCapacity(dims[0], 1, dims[2]), "cpu")
        with C.counting() as rec:
            st, lx, lt, li, outs, done = RO.resident_online_core(
                state, *RO.initial_shards(dims[1], mesh), o_p, v_p, p_p, cfg, mesh, block,
                compact_obs=nc)
        per_d[d] = dict(
            run=_ro_np(RO.run_pass_resident_online(*ins, cfg, mesh, block=block)),
            payload={k: dict(v) for k, v in rec.items()},
            shapes=[tuple(x.shape) for x in (lx, lt, li, st.graph.lm_xy, st.lm_info_xy)],
            done=(done, o_p.shape[0]))
    return res, per_d


def _rank_main(rank, world, port, out_dir):
    from tpuslam_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    initialize_distributed("gloo", f"localhost:{port}", world, rank, timeout_s=RANK_TIMEOUT_S)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    try:
        out = _rank_cases(inputs)
        out["ro"], out["ro_d"] = _resident_online_cases(inputs["ro"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the JAX side, in this process

def _jnp(g):
    return {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)}


def _jax_graphs():
    """The JAX tests' graphs, built by the JAX package."""
    import jax.numpy as jnp
    from tests.test_fusion import _improved_sessions, _sessions
    from tests.test_hier import _chain_world as hier_world
    from tests.test_instrument import _chain_world as instrument_world
    from tests.test_parallel import _world
    from tpuslam.backend.graph import GraphCapacity
    from tpuslam.frontend.pipeline import run_sequence
    from tpuslam.frontend.state import initial_state
    from tpuslam.parallel import fusion as jfusion
    from tpuslam.parallel.multisession import stack_graphs as jstack
    from tpuslam.runtime.config import SlamConfig
    from tpuslam.sim import SimConfig, simulate, trackdrive

    cap = GraphCapacity(max_poses=128, max_landmarks=128, max_obs=2048)
    scen = simulate(trackdrive(seed=5), SimConfig(laps=1.1, keyframe_dt=0.25, seed=9))
    st, _ = run_sequence(initial_state(cap), jnp.asarray(scen.obs, jnp.float32),
                         jnp.asarray(scen.obs_valid),
                         jnp.asarray(scen.odom_poses, jnp.float32), SlamConfig(capacity=cap))
    icfg = SlamConfig.improved(capacity=cap, association="mahalanobis", periodic_gn_every=0)
    states, iscens = _improved_sessions(4, cap, icfg)
    fused, _ = jfusion.fuse_sessions(jstack([s.graph for s in states]), cfg=None,
                                     gate=icfg.same_cone_threshold,
                                     lm_info=jnp.stack([s.lm_info_xy for s in states]),
                                     align=False)
    pcfg = SlamConfig(capacity=cap)
    pack, _ = _sessions(4, cap, pcfg)
    graphs = dict(world=_world(), world3=_world(seed=3, n_poses=16, n_lm=8), track=st.graph,
                  hier=hier_world(), instrument=instrument_world(), fused=fused)
    return graphs, dict(pack=pack, pcfg=pcfg, icfg=icfg, states=states,
                        track_xy=iscens[0].track.cones_xy, ro=_ro_scenario())


def _ro_scenario():
    """tests/test_instrument.py:200-210's lap: trackdrive(seed=11), 1.2
    laps at keyframe_dt 0.2, cut to a multiple of 16 frames, capacity
    (max(64, T), 128, 2048)."""
    from tpuslam.sim import SimConfig, simulate, trackdrive
    scen = simulate(trackdrive(seed=11), SimConfig(laps=1.2, keyframe_dt=0.2, speed=8.0,
                                                   max_range=20.0, seed=60))
    T = len(scen.times) - len(scen.times) % 16
    return dict(obs=scen.obs[:T].astype(np.float32), valid=scen.obs_valid[:T].copy(),
                poses=scen.odom_poses[:T].astype(np.float32), dims=(max(64, T), 128, 2048))


@pytest.fixture(scope="module")
def built():
    return _jax_graphs()


@pytest.fixture(scope="module")
def world(tmp_path_factory, built):
    """The gloo world of 8, started once the graphs are built: a function
    that waits for it and returns each rank's results."""
    graphs, extra = built
    out_dir = str(tmp_path_factory.mktemp("chain_world"))
    icfg, pcfg = extra["icfg"], extra["pcfg"]
    inputs = dict(graphs={k: _jnp(g) for k, g in graphs.items()},
                  pack=[_jnp(g) for g in extra["pack"]], gate=pcfg.same_cone_threshold,
                  odo_info=icfg.odo_info, lm_info=icfg.lm_info,
                  pack_odo_info=pcfg.odo_info, pack_lm_info=pcfg.lm_info, ro=extra["ro"])
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
def jax_refs(world, built):
    """The JAX package's solves, plans and counted payloads on the 8-device
    chain mesh, computed while the world runs."""
    from tpuslam.backend import gauss_newton as jgn
    from tpuslam.parallel import chain_optimize as jchain
    from tpuslam.parallel import chain_optimize_resident as jresident
    from tpuslam.parallel import fusion as jfusion
    from tpuslam.parallel import make_chain_mesh as jmesh
    from tpuslam.parallel.chain import (chain_gn_step, chain_gn_step_dd, partition_chain,
                                        partition_edges_by_pose_block)
    from tpuslam.parallel.hier import (chain_gn_step_dd_hier, chain_optimize_hier,
                                       partition_chain_hier)
    from tpuslam.parallel.hier3 import (chain_gn_step_dd_hier3, chain_optimize_hier3,
                                        partition_chain_hier3)
    from tpuslam.parallel.instrument import collective_payload_bytes
    from tpuslam.parallel.multisession import stack_graphs as jstack
    from tpuslam.parallel.resident import (chain_gn_step_dd_resident,
                                           partition_chain_resident)

    graphs, extra = built
    mesh = jmesh(8)

    def gp(g):
        return (np.asarray(g.poses), np.asarray(g.lm_xy))
    refs = {}
    g, cfg = graphs["world"], jgn.GNConfig(iterations=5)
    refs["world"] = dict(
        plan=_jplan(partition_chain(g, 8)), resident_plan=_jplan(partition_chain_resident(g, 8)),
        replicated=gp(jchain(g, cfg, mesh)), dd=gp(jchain(g, cfg, mesh, solver="dd")),
        resident=gp(jresident(g, cfg, mesh)))
    g = graphs["track"]
    refs["track"] = dict(plan=_jplan(partition_chain(g, 8)),
                         resident_plan=_jplan(partition_chain_resident(g, 8)),
                         dd=gp(jchain(g, jgn.GNConfig(iterations=4), mesh, solver="dd")))
    g, hcfg = graphs["hier"], jgn.GNConfig(iterations=3)
    res = {}
    for tray in (2, 4):
        hp = partition_chain_hier(g, 8, tray)
        res[f"plan{tray}"] = _jplan(hp)
        res[f"hier{tray}"] = gp(chain_optimize_hier(g, hcfg, mesh, tray, plan=hp))
    h3 = partition_chain_hier3(g, 8, tray=2, pod=4)
    res["plan3"] = _jplan(h3)
    res["hier3"] = gp(chain_optimize_hier3(g, hcfg, mesh, tray=2, pod=4, plan=h3))
    refs["hier"] = res

    one = jgn.GNConfig(iterations=1)
    gi = graphs["instrument"]
    g2, counts = partition_edges_by_pose_block(gi, 8)
    iplan, rp = partition_chain(gi, 8), partition_chain_resident(gi, 8)
    hp4, hp3 = partition_chain_hier(g, 8, 4), partition_chain_hier3(g, 8, tray=2, pod=4)

    def resident_step(step, plan, gg):
        rp_ = getattr(plan, "rplan", plan)
        L = gg.capacity.max_landmarks
        gid = rp_.lm_local_gid
        lm_loc = gg.lm_xy[np.clip(np.asarray(gid), 0, L - 1)].reshape(-1, 2)
        sh = rp_.shared_idx
        lm_shared = gg.lm_xy[np.clip(np.asarray(sh), 0, L - 1)]
        g2_ = rp_.graph
        return collective_payload_bytes(
            lambda p_, ll, ls: step(p_, g2_.odo_meas, g2_.odo_w, g2_.prior_pose,
                                    g2_.prior_info, ll, gid.reshape(-1), ls, sh, plan, one,
                                    mesh, gg.n_poses, gg.n_landmarks),
            g2_.poses, lm_loc, lm_shared)
    refs["payload"] = dict(
        replicated=collective_payload_bytes(lambda gg: chain_gn_step(gg, counts, one, mesh), g2),
        dd=collective_payload_bytes(lambda gg: chain_gn_step_dd(gg, iplan, one, mesh), gi),
        resident=resident_step(chain_gn_step_dd_resident, rp, gi),
        hier=resident_step(chain_gn_step_dd_hier, hp4, g),
        hier3=resident_step(chain_gn_step_dd_hier3, hp3, g))

    g = graphs["fused"]
    icfg = extra["icfg"]
    fcfg = jgn.GNConfig(odo_info=icfg.odo_info, lm_info=icfg.lm_info, iterations=4,
                        fix_first_poses=0, fix_first_landmarks=0)
    refs["fused"] = dict(plan=_jplan(partition_chain_resident(g, 8)),
                         resident=gp(jresident(g, fcfg, mesh)),
                         **{f"hier{t}": gp(chain_optimize_hier(g, fcfg, mesh, tray=t))
                            for t in (2, 4)})
    pcfg = extra["pcfg"]
    rcfg = jgn.GNConfig(odo_info=pcfg.odo_info, lm_info=pcfg.lm_info, iterations=3)
    stacked = jstack(extra["pack"])
    refs["registry"] = {
        f"{s}/{t}": gp(jfusion.fuse_sessions(stacked, cfg=rcfg, gate=pcfg.same_cone_threshold,
                                             align=False, solver=s, tray=t,
                                             solve_mesh=mesh)[0])
        for s, t in SOLVERS}
    refs["ro"] = _jax_resident_online(extra["ro"])
    return refs


def _jax_resident_online(ro):
    """The JAX package's resident pass of each of RO_CONFIGS on its
    8-device ('map',) mesh, as numpy (state, outputs)."""
    import jax
    import jax.numpy as jnp
    from tpuslam.backend.graph import GraphCapacity
    from tpuslam.parallel import resident_online as JRO
    from tpuslam.runtime.config import SlamConfig
    mesh = jax.make_mesh((8,), ("map",))
    ins = (jnp.asarray(ro["obs"]), jnp.asarray(ro["valid"]), jnp.asarray(ro["poses"]))
    out = {}
    for name, (opts, block) in RO_CONFIGS.items():
        opts = dict(opts)
        make = SlamConfig.improved if opts.pop("improved", False) else SlamConfig
        st, outs = JRO.run_pass_resident_online(
            *ins, make(capacity=GraphCapacity(*ro["dims"]), **opts), mesh, block=block)
        state = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)
                 if f.name != "graph"}
        state["graph"] = _jnp(st.graph)
        out[name] = (state, {f.name: np.asarray(getattr(outs, f.name))
                             for f in dataclasses.fields(outs)})
    return out


def _jplan(plan):
    """A JAX plan's fields as numpy (the nested plan and graph as dicts)."""
    if dataclasses.is_dataclass(plan):
        return {f.name: _jplan(getattr(plan, f.name)) for f in dataclasses.fields(plan)}
    return plan if isinstance(plan, int) else np.asarray(plan)


@pytest.fixture(scope="module")
def port(world, jax_refs):
    """Each rank's results, waited for after the JAX references."""
    return world()


def _same(a, b, path=""):
    """Exact equality of two nested results (field for field)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _agree(port, key):
    """Every rank's result of case `key`, checked equal across ranks but
    for the single-device references rank 0 alone makes; rank 0's."""
    res = [r[key] for r in port]
    for r in res[1:]:
        _same({k: v for k, v in r.items() if k not in ("single", "auto")},
              {k: v for k, v in res[0].items() if k not in ("single", "auto")}, key)
    return res[0]


def _close(got, want, atol, what, n=None):
    for i, (a, b) in enumerate(zip(got, want)):
        cut = slice(None) if n is None else slice(0, n[i])
        np.testing.assert_allclose(a[cut], b[cut], atol=atol, rtol=0, err_msg=f"{what}[{i}]")


# --------------------------------------------------------------------------
# tests/test_parallel.py, tests/test_hier.py, tests/test_fusion.py and
# tests/test_instrument.py, mirrored

def test_chain_collectives(port):
    """`ppermute` around the ring and to one rank (the others get zeros);
    `psum` within trays of 2 and pods of 4 (JAX's `axis_index_groups`)."""
    for r, got in enumerate(r["collectives"] for r in port):
        assert got["ring"][0] == (r - 1) % WORLD
        assert got["partial"][0] == (3.0 if r == 5 else 0.0)
        pair = r - r % 2
        assert got["trays"][0] == pair + pair + 1
        quad = range(r - r % 4, r - r % 4 + 4)
        assert got["pods"][0][0] == sum(quad) and got["pods"][1][0] == 2 * sum(quad)


def test_chain_parallel_matches_single_device(port, jax_refs):
    """tests/test_parallel.py:93 and :326: the replicated and DD solves
    within 5e-4 of the single-device GN, and of the JAX package's same
    solves on its 8-device mesh; the plans equal the JAX package's."""
    got, want = _agree(port, "world"), jax_refs["world"]
    single = port[0]["world"]["single"]
    for solver in ("replicated", "dd", "resident"):
        _close(got[solver], single, GN_ATOL, solver)
        _close(got[solver], want[solver], JAX_ATOL, f"{solver} vs jax")
    _same(got["plan"], want["plan"], "plan")
    _same(got["resident_plan"], want["resident_plan"], "resident_plan")


def test_chain_partitioner_rejects_overflow(built):
    """tests/test_parallel.py:107: a block past its 64/32 = 2-edge budget
    raises, on the host with no world."""
    import jax.numpy as jnp

    from tpuslam.backend import graph as JG
    from tpuslam_torch.frontend.state import graph_from_numpy
    from tpuslam_torch.parallel import partition_edges_by_pose_block
    g = built[0]["world"]
    for _ in range(4):
        g = JG.add_observation(g, jnp.int32(0), jnp.int32(1), jnp.zeros(2, jnp.float32))
    with pytest.raises(ValueError, match="per-block"):
        partition_edges_by_pose_block(graph_from_numpy(_jnp(g), "cpu"), 32)


def test_chain_dd_trackdrive_scale(port, jax_refs, built):
    """tests/test_parallel.py:342 and :400 at trackdrive scale: DD and the
    resident solve within 2e-3 of the single-device GN; shared landmarks
    exist but are a minority; the resident table is smaller than the map,
    and its comm accounting below the replicated path's."""
    got, want = _agree(port, "track"), jax_refs["track"]
    g = built[0]["track"]
    n = (int(g.n_poses), int(g.n_landmarks))
    single = port[0]["track"]["single"]
    _close(got["dd"], single, TRACK_ATOL, "dd", n)
    _close(got["resident"], single, TRACK_ATOL, "resident", n)
    _close(got["dd"], want["dd"], JAX_ATOL, "dd vs jax", n)
    _same(got["plan"], want["plan"], "plan")
    _same(got["resident_plan"], want["resident_plan"], "resident_plan")
    n_shared = got["plan"]["n_shared"]
    assert 0 < n_shared < n[1]
    rp = got["resident_plan"]
    assert rp["n_shared"] < n[1] * 0.6, (rp["n_shared"], n[1])
    assert rp["lb"] + rp["shared_cap"] < g.capacity.max_landmarks
    comm = got["comm"]
    assert comm["total"] < comm["replicated_path_total_for_comparison"]


def test_resident_dd_matches_replicated_dd(port):
    """tests/test_parallel.py:378 and :444: the resident layout equals the
    replicated-landmark DD solve within 1e-4."""
    got = _agree(port, "world")
    _close(got["resident3"], got["dd3"], RESIDENT_DD_ATOL, "seed 3")
    _close(got["resident"], got["dd"], RESIDENT_DD_ATOL, "seed 0")


@pytest.mark.parametrize("tray", [2, 4])
def test_hier_matches_flat_and_single(port, jax_refs, built, tray):
    """tests/test_hier.py:56: the two-level solve within 5e-3 of the
    single-device GN and 2e-3 of the flat resident solve; its plan equals
    the JAX package's, with tray-local and cross-tray shared landmarks."""
    got, want = _agree(port, "hier"), jax_refs["hier"]
    g = built[0]["hier"]
    n = (int(g.n_poses), int(g.n_landmarks))
    plan = got[f"plan{tray}"]
    _same(plan, want[f"plan{tray}"], f"plan{tray}")
    lt = plan["lm_tray"]
    assert (lt == plan["n_tray"]).sum() >= 1
    assert ((lt >= 0) & (lt < plan["n_tray"])).sum() >= 1
    h = got[f"hier{tray}"]
    _close(h, port[0]["hier"]["single"], HIER_SINGLE_ATOL, "single", n)
    _close(h, got["resident"], HIER_FLAT_ATOL, "flat", n)
    _close(h, want[f"hier{tray}"], JAX_ATOL, "jax", n)


def test_hier3_matches_flat_and_single(port, jax_refs, built):
    """tests/test_hier.py:126: tray 2 / pod 4 over 8 ranks (4 trays, 2
    pods), tray-local and pod-local shared landmarks exercised; within 5e-3
    of the single-device GN, 2e-3 of the flat resident solve."""
    got, want = _agree(port, "hier"), jax_refs["hier"]
    g = built[0]["hier"]
    n = (int(g.n_poses), int(g.n_landmarks))
    plan = got["plan3"]
    _same(plan, want["plan3"], "plan3")
    lt, lp = plan["lm_tray"], plan["lm_pod"]
    assert ((lt >= 0) & (lt < plan["n_tray"])).sum() >= 1
    assert ((lt == plan["n_tray"]) & (lp < plan["n_pod"]) & (lp >= 0)).sum() >= 1
    _close(got["hier3"], port[0]["hier"]["single"], HIER_SINGLE_ATOL, "single", n)
    _close(got["hier3"], got["resident"], HIER_FLAT_ATOL, "flat", n)
    _close(got["hier3"], want["hier3"], JAX_ATOL, "jax", n)


def test_hier_level2_smaller_than_flat_interface(port):
    """tests/test_hier.py:82: the cross-tray system is under half the flat
    interface; what the port's collectives count in one iteration of the
    tray-4 solve equals the analytic per-iteration psum exactly."""
    from tpuslam_torch.frontend.state import graph_from_numpy
    from tpuslam_torch.parallel.hier import hier_comm_bytes_per_iteration, partition_chain_hier
    from tpuslam_torch.parallel.resident import resident_comm_bytes_per_iteration
    from tests.test_hier import _chain_world
    hplan = partition_chain_hier(graph_from_numpy(_jnp(_chain_world()), "cpu"), 8, 4)
    flat = resident_comm_bytes_per_iteration(hplan.rplan)
    hier = hier_comm_bytes_per_iteration(hplan)
    assert hier["level2_cross_psum"] < 0.5 * flat["interface_psum"]
    meas = _agree(port, "payload")["hier"]
    assert meas["psum"]["bytes"] == (hier["level1_tray_psum"] + hier["level2_cross_psum"]
                                     + hier["shared_hll_gl_psum"] + hier["dl_shared_psum"])
    assert abs(meas["ppermute"]["bytes"] - hier["pose_halo_ppermute"]) \
        <= 0.5 * hier["pose_halo_ppermute"] + 64


def test_hier3_level3_smaller_than_level2():
    """tests/test_hier.py:158 on the port's `comm_model`, with the JAX
    package's default links passed in: the level payloads shrink level over
    level, the predicted weak efficiencies equal the JAX package's, and the
    three-level one clears 0.70 where the two-level one does not."""
    from tpuslam.parallel import comm_model as jcm
    from tpuslam_torch.parallel import comm_model as cm
    v = cm.hier3_bytes_per_iteration(1024, 16, 256, shared_per_boundary=5.0)
    assert v["mk3"] < 0.3 * v["ms2"] < 0.3 * v["ms1"]
    assert v["payload_psum_l2"] < v["payload_psum_l1"]
    j = jcm.CommModel()
    mdl = cm.CommModel(link_bw_bytes_per_s=j.ici_bw_bytes_per_s,
                       link_latency_s=j.collective_latency_s,
                       cross_bw_bytes_per_s=j.dcn_bw_bytes_per_s,
                       cross_latency_s=j.dcn_latency_s, domain_size=8)
    e = {}
    for tier in ("chain_dd_hier3", "chain_dd_hier", "chain_dd_resident"):
        e[tier] = cm.predict_efficiency_weak(tier, 0.0238 / 8, 1024, tray=16,
                                             shared_per_boundary=5.0, iterations=4, model=mdl)
        assert e[tier] == jcm.predict_efficiency_weak(tier, 0.0238 / 8, 1024, tray=16,
                                                      shared_per_boundary=5.0, iterations=4)
    assert e["chain_dd_hier3"] >= 0.70 > e["chain_dd_hier"]
    for tier in ("distributed", "chain_replicated", "chain_dd", "chain_dd_resident"):
        assert cm.tier_bytes_per_iteration(tier, P=64, L=64, D=8, shared_cap=32) == \
            jcm.tier_bytes_per_iteration(tier, P=64, L=64, D=8, shared_cap=32)
        assert cm.predict_times(tier, 1e-3, 8, P=64, L=64, model=mdl) == \
            jcm.predict_times(tier, 1e-3, 8, P=64, L=64)
    with pytest.raises(TypeError):
        cm.CommModel()


def test_hier3_payload_instrumented(port):
    """tests/test_hier.py:187: one iteration of the three-level solve moves
    the analytic psum payload, exactly."""
    from tpuslam_torch.frontend.state import graph_from_numpy
    from tpuslam_torch.parallel.hier3 import (hier3_comm_bytes_per_iteration,
                                              partition_chain_hier3)
    from tests.test_hier import _chain_world
    hplan = partition_chain_hier3(graph_from_numpy(_jnp(_chain_world()), "cpu"), 8, 2, 4)
    ana = hier3_comm_bytes_per_iteration(hplan)
    meas = _agree(port, "payload")["hier3"]
    assert meas["psum"]["bytes"] == (ana["level1_tray_psum"] + ana["level2_pod_psum"]
                                     + ana["level3_cross_psum"] + ana["shared_hll_gl_psum"]
                                     + ana["dl_shared_psum"])
    assert abs(meas["ppermute"]["bytes"] - ana["pose_halo_ppermute"]) \
        <= 0.5 * ana["pose_halo_ppermute"] + 64


# psum calls per iteration: the port sums a list of tensors in one call,
# where the JAX package's jaxpr holds one psum per tensor
PSUM_CALLS = {"replicated": 1, "dd": 3, "resident": 2, "hier": 4, "hier3": 5}


@pytest.mark.parametrize("tier", ["replicated", "dd", "resident", "hier", "hier3"])
def test_counted_payload_equals_jax_walker(port, jax_refs, tier):
    """tests/test_instrument.py:123-185: per iteration, the port's counted
    collectives move the bytes the JAX package's jaxpr walker counts on the
    same step, kind by kind, with as many gathers and ring shifts (the psums
    as `PSUM_CALLS`, one call per summed list); for the chain tiers they
    equal `comm_model.tier_bytes_per_iteration` too (psum exactly; the
    gather's total, per rank times 8; nothing of size L in the resident
    tier)."""
    from tpuslam_torch.parallel.comm_model import tier_bytes_per_iteration
    got = _agree(port, "payload")
    want = {k: v for k, v in jax_refs["payload"][tier].items() if isinstance(v, dict)}
    assert got[tier].keys() == want.keys()
    for kind, w in want.items():
        assert got[tier][kind]["bytes"] == w["bytes"], (kind, got[tier], want)
        calls = PSUM_CALLS[tier] if kind == "psum" else w["count"]
        assert got[tier][kind]["count"] == calls, (kind, got[tier], want)
    L, cap = 64, got["shared_cap"]
    model = {"replicated": ("chain_replicated", 0), "dd": ("chain_dd", cap[0]),
             "resident": ("chain_dd_resident", cap[1])}.get(tier)
    if model is None:
        return
    m = tier_bytes_per_iteration(model[0], P=64, L=L, D=8, shared_cap=model[1])
    assert got[tier]["psum"]["bytes"] == m["payload_psum"]
    assert got[tier]["all_gather"]["bytes"] * 8 == m["payload_gather"]
    if tier == "resident":
        assert got[tier]["psum"]["bytes"] < 0.2 * (L * 8) * 4 + m["payload_psum"]


def test_fused_graph_resident_dd_joint_optimize(port, jax_refs, built):
    """tests/test_fusion.py:364: the fused fleet graph through the resident
    DD solve within 3e-3 of the single-device joint GN, its map no worse
    than the best session's (+5e-3); the plan equals the JAX package's."""
    from tests.test_fusion import _map_err
    got, want = _agree(port, "fused"), jax_refs["fused"]
    g = built[0]["fused"]
    n = (int(g.n_poses), int(g.n_landmarks))
    _same(got["plan"], want["plan"], "plan")
    _close(got["resident"], port[0]["fused"]["single"], FUSED_RESIDENT_ATOL, "single", n)
    _close(got["resident"], want["resident"], JAX_ATOL, "jax", n)
    track_xy = built[1]["track_xy"]
    errs = [_map_err(st.graph.lm_xy, st.graph.n_landmarks, track_xy)
            for st in built[1]["states"]]
    assert _map_err(got["resident"][1], n[1], track_xy) <= min(errs) + 5e-3


@pytest.mark.parametrize("tray", [2, 4])
def test_fused_graph_hier_joint_optimize(port, jax_refs, built, tray):
    """tests/test_fusion.py:406: the fused graph through the two-level
    solve within 1e-2 of the single-device joint GN, the map no worse than
    the best session's (+5e-3)."""
    from tests.test_fusion import _map_err
    got, want = _agree(port, "fused"), jax_refs["fused"]
    g = built[0]["fused"]
    n = (int(g.n_poses), int(g.n_landmarks))
    _close(got[f"hier{tray}"], port[0]["fused"]["single"], FUSED_HIER_ATOL, "single", n)
    _close(got[f"hier{tray}"], want[f"hier{tray}"], JAX_ATOL, "jax", n)
    track_xy = built[1]["track_xy"]
    errs = [_map_err(st.graph.lm_xy, st.graph.n_landmarks, track_xy)
            for st in built[1]["states"]]
    assert _map_err(got[f"hier{tray}"][1], n[1], track_xy) <= min(errs) + 5e-3


def test_fuse_sessions_solver_registry(port, jax_refs):
    """tests/test_fusion.py:448, the solver half: `fuse_sessions(solver=
    'dd' | 'hier' | 'hier3')` over the chain mesh within 1e-2 of
    solver='auto', and of the JAX package's same call."""
    got = _agree(port, "registry")
    (base, npo, nl, solver) = port[0]["registry"]["auto"]
    assert solver == "auto"
    for key in (f"{s}/{t}" for s, t in SOLVERS):
        out, rep_solver = got[key]
        assert rep_solver == key.split("/")[0]
        _close(out, base, REGISTRY_ATOL, key, (npo, nl))
        _close(out, jax_refs["registry"][key], JAX_ATOL, f"{key} vs jax", (npo, nl))


# --------------------------------------------------------------------------
# tests/test_resident_online.py and tests/test_instrument.py:187-248, the
# port's resident online pass

def _ro_compare(got, want, atol, what):
    """tests/test_resident_online.py's `_compare`: the decision sequence
    (counts, flags, edges, landmark types, published discrete outputs)
    exact; estimates within `atol`."""
    (sa, oa), (sb, ob) = got, want
    ga, gb = sa["graph"], sb["graph"]
    for k in ("n_landmarks", "n_obs", "n_poses"):
        assert int(ga[k]) == int(gb[k]), (what, k, ga[k], gb[k])
    for k in ("loop_closure_complete", "current_cone_index"):
        assert int(sa[k]) == int(sb[k]), (what, k)
    n, nl, npp = int(gb["n_obs"]), int(gb["n_landmarks"]), int(gb["n_poses"])
    for k in ("obs_lm", "obs_pose"):
        np.testing.assert_array_equal(ga[k][:n], gb[k][:n], err_msg=f"{what} {k}")
    np.testing.assert_array_equal(ga["lm_type"][:nl], gb["lm_type"][:nl], err_msg=f"{what} type")
    np.testing.assert_allclose(ga["lm_xy"][:nl], gb["lm_xy"][:nl], atol=atol, rtol=0,
                               err_msg=f"{what} lm_xy")
    np.testing.assert_allclose(ga["poses"][:npp], gb["poses"][:npp], atol=atol, rtol=0,
                               err_msg=f"{what} poses")
    for f in ("pose", "cone_azimuth", "cone_distance"):
        np.testing.assert_allclose(oa[f], ob[f], atol=atol, rtol=0, err_msg=f"{what} out.{f}")
    for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
        np.testing.assert_array_equal(oa[f], ob[f], err_msg=f"{what} out.{f}")


def _ro_structure(got, want, what):
    """tests/test_resident_online.py's rule for the improved mode, whose
    periodic refinement feeds refined maps back into later gating: both
    closed, landmark count exact, edges within 2, landmarks and published
    poses within 5e-2."""
    (sa, oa), (sb, ob) = got, want
    assert bool(sa["loop_closure_complete"]) and bool(sb["loop_closure_complete"]), what
    nl = int(sb["graph"]["n_landmarks"])
    assert int(sa["graph"]["n_landmarks"]) == nl, what
    assert abs(int(sa["graph"]["n_obs"]) - int(sb["graph"]["n_obs"])) <= 2, what
    np.testing.assert_allclose(sa["graph"]["lm_xy"][:nl], sb["graph"]["lm_xy"][:nl],
                               atol=RO_STRUCT_ATOL, rtol=0, err_msg=f"{what} lm_xy")
    np.testing.assert_allclose(oa["pose"], ob["pose"], atol=RO_STRUCT_ATOL, rtol=0,
                               err_msg=f"{what} out.pose")


def _ro_hold(name, got, want, what, atol=RO_ATOL):
    if name in RO_STRUCTURE:
        _ro_structure(got, want, what)
    else:
        _ro_compare(got, want, atol, what)


def _ro_per_d(port, d):
    """The per-mesh-size results of the ranks in the mesh of `d`, checked
    equal across them; rank 0's."""
    res = [r["ro_d"][d] for r in port[:d]]
    for r in res[1:]:
        _same(r, res[0], f"ro d={d}")
    assert all(d not in r["ro_d"] for r in port[d:])
    return res[0]


@pytest.mark.parametrize("name", list(RO_CONFIGS))
def test_resident_online_matches_dense_and_jax(port, jax_refs, name):
    """tests/test_resident_online.py:84-177 at D = 8 on the small lap (which
    closes its loop): the port's resident pass against its dense
    `run_pass_blocked` at the same block (compat and Mahalanobis: the
    decision sequence exact, values within 2e-3; improved and mid-block:
    the structure rule), against the JAX package's resident pass (the same
    decisions and values within 1e-3; the improved ones by the structure
    rule), and at D = 1 against the dense pass by the same rules."""
    got = _agree(port, "ro")["d8"][name]
    single = port[0]["ro"]["single"]
    dense = single["dense"][name]
    assert bool(dense[0]["loop_closure_complete"]), "the lap must close its loop"
    _ro_hold(name, got, dense, f"{name} D=8 vs dense")
    _ro_hold(name, got, jax_refs["ro"][name], f"{name} D=8 vs jax", atol=JAX_ATOL)
    _ro_hold(name, single["d1"][name], dense, f"{name} D=1 vs dense")


@pytest.mark.parametrize("d", [2, 4])
def test_resident_online_equal_across_mesh_sizes(port, d):
    """Compat 'first' over meshes of 2 and 4 ranks against the mesh of 8,
    under the dense comparison's rules (the psum'd sums differ in order)."""
    got = _ro_per_d(port, d)["run"]
    _ro_compare(got, _ro_per_d(port, 8)["run"], RO_ATOL, f"D={d} vs D=8")
    _ro_compare(got, _agree(port, "ro")["d8"]["first"], RO_ATOL, f"D={d} vs run at D=8")


def test_resident_online_payload_d_invariant(port):
    """tests/test_instrument.py:187-233: the collectives one rank calls in
    `resident_online_core` (compat 'first', the small lap), counted by the
    port's wrappers, are the same at D = 2, 4 and 8, kind by kind, in calls
    and bytes (the association gates [BN, L/D] locally and reduces [BN]
    keys; the solves sum capacity-sized reduced systems; the GNs' trip
    counts agree), and nothing O(L) is gathered. The JAX test's second half
    (`while_mult`, the walker's loop multiplier) has no counterpart: the
    port counts the iterations that ran."""
    per_d = {d: _ro_per_d(port, d)["payload"] for d in (2, 4, 8)}
    assert per_d[2] == per_d[4] == per_d[8], per_d
    p = per_d[2]
    assert p.get("all_gather", {"bytes": 0})["bytes"] < 128 * 8
    assert sum(p[k]["bytes"] for k in ("psum", "pmin", "pmax")) > 0
    assert all(p[k]["count"] > 0 for k in ("psum", "pmin", "pmax"))


def test_resident_online_map_is_physically_sharded(port):
    """tests/test_resident_online.py:119-142: `resident_online_core` takes
    and returns this rank's Lb = L / D landmark rows (lm_xy, lm_type,
    lm_info) at every mesh size, its state holds the one dummy landmark row
    it came with, and the pass completes in the blocks."""
    for d in (2, 4, 8):
        r = _ro_per_d(port, d)
        lb = 128 // d
        assert r["shapes"] == [(lb, 2), (lb,), (lb, 3), (1, 2), (1, 3)], (d, r["shapes"])
        assert r["done"][0] == r["done"][1]


def test_resident_online_fallback_and_lm_per_device(port):
    """A landmark capacity of 64 for a lap of ~110: the blocks fall back
    mid-lap and the per-frame path finishes on the gathered map, equal to
    the dense pass's completion; with `lm_per_device=24` (a sharded map of
    192 slots past `max_landmarks`) the pass equals the dense one and the
    state's map is cut to `max_landmarks`. A capacity of 100 over 8 ranks
    without `lm_per_device` is refused."""
    got = _agree(port, "ro")
    single = port[0]["ro"]["single"]
    assert int(got["fallback"][0]["graph"]["n_landmarks"]) == 64
    _ro_compare(got["fallback"], single["fallback"], RO_ATOL, "fallback")
    _ro_compare(got["lm_per_device"], single["dense"]["first"], RO_ATOL, "lm_per_device")
    assert got["lm_per_device"][0]["graph"]["lm_xy"].shape == (128, 2)
    assert "not divisible" in got["refuse_l_mod_d"]


def test_resident_online_branch_agreement(port):
    """Every host branch of the pass reads flags every rank agrees on:
    `_agreed` returns them when the ranks agree and raises on every rank
    (instead of letting one leave a loop the others stay in) when not."""
    for r in port:
        assert r["ro"]["agreed"] == [3, 1, 7]
        assert "disagree" in r["ro"]["disagreed"]


def test_resident_online_cuda_mesh_without_a_card_raises(port):
    """No fallback hides the device: a ('map',) mesh asked for on 'cuda'
    raises on a machine without a card, on every rank."""
    for r in port:
        assert "no CUDA device" in r["ro"]["cuda_refused"]


def test_resident_online_rejects_unsupported():
    """tests/test_resident_online.py:147-157, with no world: the
    association kernel and a full-batch periodic GN are refused, and so is a
    periodic GN whose boundaries are neither block ends nor dividing the
    block."""
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.parallel.resident_online import run_pass_resident_online
    from tpuslam_torch.runtime.config import SlamConfig
    cap = GraphCapacity(64, 128, 2048)
    obs, valid, poses = torch.zeros(16, 8, 4), torch.zeros(16, 8, dtype=torch.bool), \
        torch.zeros(16, 3)
    for cfg, block in ((SlamConfig(capacity=cap, use_pallas_association=True,
                                   association="nearest"), 16),
                       (SlamConfig.improved(capacity=cap, periodic_gn_every=16,
                                            periodic_gn_window=0), 16),
                       (SlamConfig.improved(capacity=cap, periodic_gn_every=24), 16)):
        with pytest.raises(ValueError, match="unsupported config"):
            run_pass_resident_online(obs, valid, poses, cfg, None, block=block)
