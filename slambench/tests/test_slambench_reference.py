"""The plain reference agrees with the port's CPU path on a tiny fleet and a
tiny fusion, and its Gauss-Newton with the program's NumPy-free textbook
problem on a graph small enough to solve by hand."""
import dataclasses

import numpy as np
import pytest
import torch

from slambench.reference import fusion as ref_fusion
from slambench.reference import gauss_newton as ref_gn
from slambench.reference import replay
from slambench.run import lookup
from slambench.tests.conftest import REPO, TINY_FUSION, TINY_REPLAY
from slambench.traffic import generate


@pytest.mark.parametrize("change", [{}, {"association": "first", "use_pallas_association": False}],
                         ids=["cell", "first_dense"])
def test_replay_reference_agrees_with_the_port(change):
    """The cell's configuration, and the reference's own 'first' association
    on the dense path (a configuration a later change may add as a file)."""
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.frontend.blocked import run_sequences_blocked_batched
    from tpuslam_torch.parallel.batch import initial_states
    from tpuslam_torch.runtime.config import SlamConfig
    _, _, config, _ = lookup(REPO, "trackdrive_fleet.s64")
    config = dict(config, slam=dict(config["slam"], **change))
    d = generate.sessions(dict(TINY_REPLAY, sessions=3), 77)
    cap = GraphCapacity(*config["capacity"])
    st, outs = run_sequences_blocked_batched(
        initial_states(cap, 3, "cpu"), *(torch.from_numpy(d[k]) for k in ("obs", "valid", "poses")),
        SlamConfig(capacity=cap, **config["slam"]), block=config["block"])
    sem = replay.Semantics.from_config(config["slam"], config["capacity"])
    g = st.graph
    for s in range(3):
        prog = dict(out_pose=outs.pose[s].numpy(), az=outs.cone_azimuth[s].numpy(),
                    dist=outs.cone_distance[s].numpy(), ctype=outs.cone_type[s].numpy(),
                    send=outs.send[s].numpy(), closed=outs.loop_closed[s].numpy(),
                    n_lm=outs.n_landmarks[s].numpy(), poses=g.poses[s].numpy(),
                    lm=g.lm_xy[s].numpy(), lt=g.lm_type[s].numpy(), e_pose=g.obs_pose[s].numpy(),
                    e_lm=g.obs_lm[s].numpy(), e_xy=g.obs_xy[s].numpy(), n_p=int(g.n_poses[s]),
                    n_l=int(g.n_landmarks[s]), n_e=int(g.n_obs[s]))
        v = replay.judge_session(sem, d["obs"][s], d["valid"][s], d["poses"][s], prog)
        assert v.wrong == 0, v.first_wrong
        assert v.map_gap_m < 1e-4 and v.heading_gap_rad < 1e-4
        assert prog["closed"].sum() == 1            # the session closed its loop
        ref = replay.run_session(sem, d["obs"][s], d["valid"][s], d["poses"][s])
        assert (ref["n_p"], ref["n_l"], ref["n_e"]) == (prog["n_p"], prog["n_l"], prog["n_e"])


def test_fusion_reference_agrees_with_the_port():
    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.backend.graph import FactorGraph
    from tpuslam_torch.parallel.fusion import fuse_sessions
    _, _, config, _ = lookup(REPO, "fusion.gps8")
    graphs = generate.session_graphs(dict(TINY_FUSION, sessions=3), 78, config["capacity"])[0]
    ints = ("n_poses", "n_landmarks", "n_obs", "lm_type", "obs_pose", "obs_lm")
    st = FactorGraph(**{f.name: torch.as_tensor(np.stack([np.asarray(g[f.name]) for g in graphs]))
                        .to(torch.int32 if f.name in ints else torch.float32)
                        for f in dataclasses.fields(FactorGraph)})
    info = torch.as_tensor(np.stack([g["lm_info"] for g in graphs]))
    fused, rep = fuse_sessions(st, cfg=gn.GNConfig(**config["fusion_gn"]), gate=1.2,
                               lm_info=info, align=False)
    c = config["fusion_gn"]
    prob = ref_gn.Problem(c["odo_info"], c["lm_info"], c["iterations"], c["fix_first_poses"],
                          c["fix_first_landmarks"], c["early_exit_tol"])
    ref = ref_fusion.Reference(graphs, 1.2, prob)
    n, m = int(fused.n_poses), int(fused.n_landmarks)
    prog = dict(labels=rep["labels"].numpy(), n_merged=m,
                cross=int(rep["n_cross_session_merges"]), lm_type=fused.lm_type[:m].numpy(),
                poses=fused.poses[:n].numpy(), lm=fused.lm_xy[:m].numpy())
    v = ref_fusion.Verdict()
    ref_fusion.judge(ref, prog, v)
    assert v.wrong == 0 and v.adopted == 0, v.first_wrong
    assert v.map_gap_m < 1e-4 and v.heading_gap_rad < 1e-4 and ref.fused(0.0).cross > 0


def test_fusion_judge_compares_an_adopted_tie_with_its_own_map():
    """A map whose dedup matches only the gate moved by a tie is held to the
    reference map of that gate: its values are compared, not waved through."""
    _, _, config, _ = lookup(REPO, "fusion.gps8")
    graphs = generate.session_graphs(dict(TINY_FUSION, sessions=2), 79, config["capacity"])[0]
    c = config["fusion_gn"]
    prob = ref_gn.Problem(c["odo_info"], c["lm_info"], c["iterations"], c["fix_first_poses"],
                          c["fix_first_landmarks"], c["early_exit_tol"])
    ref = ref_fusion.Reference(graphs, 1.2, prob)
    # a tie of the reference's own making: the gate moved to just past a pair's distance
    f, poses, lm = ref.map(0.0)
    tie = ref_fusion.Reference(graphs, 1.2, prob)
    tie._fused[ref_fusion.EPS_D2] = ref_fusion.fuse(graphs, 0.3)
    alt, alt_poses, alt_lm = tie.map(ref_fusion.EPS_D2)
    assert alt.n_merged != f.n_merged
    prog = dict(labels=alt.labels, n_merged=alt.n_merged, cross=alt.cross, lm_type=alt.lm_type,
                poses=alt_poses.copy(), lm=alt_lm.copy())
    v = ref_fusion.Verdict()
    ref_fusion.judge(tie, prog, v)
    assert (v.wrong, v.adopted, v.map_gap_m, v.heading_gap_rad) == (0, 1, 0.0, 0.0)
    prog["poses"][-1, 2] += 0.01
    prog["lm"][0] += 0.02
    v = ref_fusion.Verdict()
    ref_fusion.judge(tie, prog, v)
    assert v.adopted == 1 and v.wrong == 0
    assert abs(v.heading_gap_rad - 0.01) < 1e-9 and abs(v.map_gap_m - 0.02) < 1e-9


def test_gauss_newton_solves_a_chain_exactly():
    # three poses, one landmark seen from each: odometry and sightings agree
    # on a consistent world, so the solution is that world from any start
    truth = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.1], [2.0, 0.2, 0.2]])
    lm = np.array([[1.5, 2.0]])
    c, s = np.cos(truth[:, 2]), np.sin(truth[:, 2])
    d = lm[0] - truth[:, :2]
    z = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], -1)
    from slambench.reference.geometry import between
    odo = np.zeros((3, 3))
    odo[1:] = between(truth[:-1], truth[1:])
    g = dict(poses=truth + [[0, 0, 0], [0.1, -0.1, 0.02], [-0.1, 0.1, -0.03]], odo=odo,
             odo_w=np.ones(3), lm=lm + [[0.2, -0.1]], e_pose=np.arange(3), e_lm=np.zeros(3, int),
             e_xy=z, prior_pose=np.zeros((3, 3)), prior_info=np.zeros((3, 2)))
    poses, got, _ = ref_gn.optimize(g, ref_gn.Problem(5.0, 0.01, 20, 1, 0, 1e-12))
    assert np.allclose(poses, truth, atol=1e-9) and np.allclose(got, lm, atol=1e-9)
