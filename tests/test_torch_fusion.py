"""The port's cross-session fusion (`tpuslam_torch.parallel.fusion`) against
the JAX package's (`tpuslam.parallel.fusion`).

Each single-device test of tests/test_fusion.py is mirrored: the same
inputs, made from the same seeds, go through both packages. The sessions
are run once by the port's `run_sequence` and handed to both fusions
through numpy. The port must equal the JAX package: labels, merge counts,
`n_align_matched` and the remapped edges exactly; transforms and fused
values within 1e-5 (1e-4 after the joint GN), plus 3 float32 ulps of
their magnitude (information-weighted merges: 5e-4, their float32
rounding); map errors within
`chip_smoke.METRIC_ATOL_M`. Each case also keeps its own assertion from
tests/test_fusion.py, on the port's result. The chain-solver paths run
here on a one-rank chain mesh and are held to the JAX package's by
tests/test_torch_chain.py; the mesh path by tests/test_torch_parallel.py.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpuslam.backend import gauss_newton as jgn
from tpuslam.backend.graph import FactorGraph as JGraph
from tpuslam.parallel import fusion as jfusion
from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import (
    GraphCapacity, add_landmark, add_observation, add_pose, empty_graph,
)
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import initial_state
from tpuslam_torch.parallel import fusion
from tpuslam_torch.parallel.multisession import stack_graphs
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, simulate, trackdrive

CAP = GraphCapacity(max_poses=128, max_landmarks=128, max_obs=2048)
VALUE_ATOL, GN_ATOL = 1e-5, 1e-4
# fused values also get 4e-7 of their magnitude (3 float32 ulps): the
# transforms are within VALUE_ATOL of the JAX package's, the two packages'
# ICP sums round differently, and the maps lie up to ~65 m out
VALUE_RTOL = 4e-7
# an information-weighted merge solves a 2x2 system per landmark in float32
# whose cancellation leaves each package up to ~2e-4 m from the float64
# merge on the same inputs (test_info_weighted_merge_is_float32_rounding)
INFO_MERGE_ATOL = 5e-4
DRIFT = ((0.0, 0.0, 0.0), (0.5, -0.4, 0.03), (-0.4, 0.3, -0.02))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _scenario(s):
    return simulate(trackdrive(seed=11), SimConfig(laps=1.2, keyframe_dt=0.25, speed=8.0,
                                                   max_range=20.0, seed=100 + s))


@functools.lru_cache(maxsize=None)
def _session(s, cfg_name, offset=(0.0, 0.0, 0.0)):
    """(graph, lm_info_xy) of session s of tests/test_fusion.py's `_sessions`
    / `_improved_sessions`, run by the port, its odometry rigidly moved by
    `offset` as there."""
    cfg = _cfg(cfg_name)
    scen = _scenario(s)
    poses = np.asarray(scen.odom_poses, np.float32)
    tx, ty, th = offset
    c, si = np.cos(th), np.sin(th)
    xy = poses[:, :2] @ np.array([[c, si], [-si, c]], np.float32)
    poses = np.stack([xy[:, 0] + tx, xy[:, 1] + ty, poses[:, 2] + th], -1).astype(np.float32)
    st, _ = run_sequence(initial_state(CAP, "cpu"), torch.tensor(scen.obs, dtype=torch.float32),
                         torch.tensor(scen.obs_valid), torch.tensor(poses), cfg)
    return st.graph, st.lm_info_xy


def _cfg(name):
    if name == "compat":
        return SlamConfig(capacity=CAP)
    if name == "improved":
        return SlamConfig.improved(capacity=CAP, periodic_gn_every=0)
    return SlamConfig.improved(capacity=CAP, association="mahalanobis", periodic_gn_every=0)


def _sessions(n, cfg_name, offsets=None):
    """(stacked graph, lm_info [S, L, 3]) of n sessions."""
    runs = [_session(s, cfg_name, offsets[s] if offsets else (0.0, 0.0, 0.0)) for s in range(n)]
    return stack_graphs([r[0] for r in runs]), torch.stack([r[1] for r in runs])


def _jgraph(g):
    return JGraph(**{f.name: jnp.asarray(getattr(g, f.name).numpy())
                     for f in dataclasses.fields(g)})


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _gn_cfgs(**kw):
    return jgn.GNConfig(**kw), gn.GNConfig(**kw)


def _improved_gn(cfg_name):
    cfg = _cfg(cfg_name)
    return _gn_cfgs(odo_info=cfg.odo_info, lm_info=cfg.lm_info, iterations=5,
                    fix_first_poses=0, fix_first_landmarks=0)


def _map_err(lm_xy, n):
    lm = _np(lm_xy)[:int(n)]
    track_xy = _scenario(0).track.cones_xy
    return float(np.median(np.linalg.norm(lm[:, None, :] - track_xy[None], axis=-1).min(axis=1)))


def _assert_fused(got, want, atol, what=""):
    """The port's fused graph against the JAX package's: counts, types and
    edges exact, values within `atol`, the map error within METRIC_ATOL_M."""
    for f in ("n_poses", "n_landmarks", "n_obs", "lm_type", "obs_pose", "obs_lm"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)),
                                      err_msg=f"{what} {f}")
    for f in ("odo_w", "odo_meas", "obs_xy", "prior_pose", "prior_info"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)),
                                   rtol=VALUE_RTOL, atol=VALUE_ATOL, err_msg=f"{what} {f}")
    for f in ("poses", "lm_xy"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)),
                                   rtol=VALUE_RTOL, atol=atol, err_msg=f"{what} {f}")
    assert abs(_map_err(got.lm_xy, got.n_landmarks) - _map_err(want.lm_xy, want.n_landmarks)) \
        <= chip_smoke.METRIC_ATOL_M, what


def _assert_report(got, want):
    """Counts, labels and matches exact, transforms within VALUE_ATOL. The
    anchor's match count is its registration onto itself, which the JAX
    package reports from rounding noise (its transform drifts by ~1e-9 rad
    where the port's stays exactly 0, and a trimmed registration then keeps
    a different share of the pairs, all at distance ~0): it is not held."""
    for k in ("n_merged_landmarks", "n_cross_session_merges", "labels"):
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    if "n_align_matched" in want:
        np.testing.assert_array_equal(_np(got["n_align_matched"])[1:],
                                      _np(want["n_align_matched"])[1:], err_msg="n_align_matched")
    if "tforms" in want:
        np.testing.assert_allclose(_np(got["tforms"]), _np(want["tforms"]), rtol=0,
                                   atol=VALUE_ATOL)


def _fuse_both(stacked, lm_info=None, gn_kw=None, **kw):
    """`fuse_sessions` of both packages on the same stacked graph; each
    report checked against the other."""
    jcfg, cfg = gn_kw if gn_kw else (None, None)
    want = jfusion.fuse_sessions(_jgraph(stacked), cfg=jcfg,
                                 lm_info=None if lm_info is None else jnp.asarray(lm_info.numpy()),
                                 **kw)
    got = fusion.fuse_sessions(stacked, cfg=cfg, lm_info=lm_info, **kw)
    _assert_report(got[1], want[1])
    atol = VALUE_ATOL if cfg is None else GN_ATOL
    _assert_fused(got[0], want[0], atol if lm_info is None else max(atol, INFO_MERGE_ATOL))
    assert got[1]["solver"] == want[1]["solver"]
    return got


def _rand_landmarks(rng, n, spread=20.0):
    xy = rng.uniform(-spread, spread, (n, 2)).astype(np.float32)
    t = rng.integers(1, 4, n).astype(np.int32)
    return xy, t


def _se2_both(src, st, sv, dst, dt, dv, **kw):
    want = jfusion.estimate_se2(*(jnp.asarray(x) for x in (src, st, sv, dst, dt, dv)), **kw)
    got = fusion.estimate_se2(*(torch.tensor(x) for x in (src, st, sv, dst, dt, dv)), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=VALUE_ATOL)
    assert int(got[1]) == int(want[1])
    return got


def _offset_points(dst_xy, true_t, th, rng, noise=0.02):
    c, s = np.cos(-th), np.sin(-th)
    shifted = dst_xy - true_t[:2]
    src = np.stack([c * shifted[:, 0] - s * shifted[:, 1],
                    s * shifted[:, 0] + c * shifted[:, 1]], -1)
    return src + rng.normal(0, noise, src.shape)


def test_estimate_se2_recovers_transform():
    rng = np.random.default_rng(0)
    dst_xy, types = _rand_landmarks(rng, 60)
    true_t = np.array([1.5, -2.0, 0.3], np.float32)
    src = _offset_points(dst_xy, true_t, 0.3, rng).astype(np.float32)
    valid = np.ones(60, bool)
    t, n = _se2_both(src, types, valid, dst_xy, types, valid, gate=3.0, iters=10)
    assert int(n) >= 55
    np.testing.assert_allclose(t.numpy(), true_t, atol=0.02)


def test_estimate_se2_too_few_matches_is_identity():
    rng = np.random.default_rng(1)
    a_xy, a_t = _rand_landmarks(rng, 8)
    b_xy, b_t = _rand_landmarks(rng, 8, spread=500.0)
    valid = np.ones(8, bool)
    t, n = _se2_both(a_xy, a_t, valid, b_xy, b_t, valid, gate=1.0)
    assert int(n) < 3
    np.testing.assert_array_equal(t.numpy(), np.zeros(3))


def test_estimate_se2_trimmed_rejects_outliers():
    rng = np.random.default_rng(5)
    dst_xy, types = _rand_landmarks(rng, 80)
    true_t = np.array([1.0, -1.5, 0.2], np.float32)
    src = _offset_points(dst_xy, true_t, 0.2, rng)
    bad = rng.choice(80, 20, replace=False)
    src[bad] += rng.normal(0, 1.5, (20, 2))
    src = src.astype(np.float32)
    valid = np.ones(80, bool)
    t_plain, _ = _se2_both(src, types, valid, dst_xy, types, valid, gate=3.0, iters=10)
    t_trim, _ = _se2_both(src, types, valid, dst_xy, types, valid, gate=3.0, iters=10,
                          trim=0.75)
    err_plain = float(np.linalg.norm(t_plain.numpy() - true_t))
    err_trim = float(np.linalg.norm(t_trim.numpy() - true_t))
    assert err_trim < 0.05, (err_trim, err_plain)
    assert err_trim <= err_plain, (err_trim, err_plain)


def test_fuse_merges_cross_session_landmarks():
    stacked, _ = _sessions(4, "compat")
    fused, report = _fuse_both(stacked, gate=1.2)
    n_per = stacked.n_landmarks.tolist()
    n_fused = int(fused.n_landmarks)
    assert n_fused < sum(n_per) * 0.45
    assert n_fused >= max(n_per) * 0.8
    assert int(report["n_cross_session_merges"]) > 0.5 * n_fused
    n_poses = stacked.n_poses.tolist()
    assert int(fused.n_poses) == sum(n_poses)
    odo_w = fused.odo_w.numpy()
    for o in np.cumsum([0] + n_poses[:-1]):
        assert odo_w[o] == 0.0
    assert odo_w[1:n_poses[0]].min() == 1.0
    assert int(fused.n_obs) == int(stacked.n_obs.sum())
    assert fusion.fusion_report(report) == {
        "n_merged_landmarks": n_fused,
        "n_cross_session_merges": int(report["n_cross_session_merges"])}


def _session_errs(stacked):
    return [_map_err(stacked.lm_xy[s], stacked.n_landmarks[s]) for s in range(len(stacked.n_poses))]


def test_fused_joint_optimize_beats_independent_maps():
    stacked, _ = _sessions(4, "compat")
    fused, _ = _fuse_both(stacked, gate=1.2, gn_kw=_gn_cfgs(iterations=5))
    assert bool(torch.all(torch.isfinite(fused.poses)))
    err_fused = _map_err(fused.lm_xy, fused.n_landmarks)
    assert err_fused <= np.mean(_session_errs(stacked)) + 0.02
    assert err_fused < 0.8


def test_fused_joint_optimize_improved_weights():
    stacked, _ = _sessions(4, "improved")
    fused, _ = _fuse_both(stacked, gate=1.2, gn_kw=_improved_gn("improved"))
    err_fused = _map_err(fused.lm_xy, fused.n_landmarks)
    assert err_fused < np.mean(_session_errs(stacked))
    assert err_fused < 0.25


def test_align_to_anchor_registers_offset_sessions():
    offs = ((0.0, 0.0, 0.0), (0.8, -0.5, 0.04))
    stacked, _ = _sessions(2, "compat", offs)
    want = jfusion.align_to_anchor(_jgraph(stacked), gate=2.0, iters=12)
    moved, tforms, n_matched = fusion.align_to_anchor(stacked, gate=2.0, iters=12)
    np.testing.assert_allclose(tforms.numpy(), np.asarray(want[1]), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_array_equal(n_matched.numpy(), np.asarray(want[2]))
    for f in ("poses", "lm_xy", "prior_pose"):
        np.testing.assert_allclose(getattr(moved, f).numpy(), np.asarray(getattr(want[0], f)),
                                   rtol=VALUE_RTOL, atol=VALUE_ATOL, err_msg=f)
    assert int(n_matched[1]) > 20
    lm0 = moved.lm_xy[0].numpy()[:int(moved.n_landmarks[0])]
    lm1 = moved.lm_xy[1].numpy()[:int(moved.n_landmarks[1])]
    d = np.linalg.norm(lm1[:, None] - lm0[None], axis=-1).min(axis=1)
    assert np.median(d) < 0.35
    want_f = jfusion.fuse_graphs(want[0], gate=1.2)
    fused, report = fusion.fuse_graphs(moved, gate=1.2)
    _assert_report(report, want_f[1])
    _assert_fused(fused, want_f[0], VALUE_ATOL)
    assert int(fused.n_landmarks) < int(stacked.n_landmarks.sum()) * 0.7


def test_align_consensus_round_matches_jax():
    """`align_consensus_round` (reached through `fuse_sessions`'s
    `consensus_rounds`) on the drifted improved sessions."""
    stacked, lm_info = _sessions(3, "mahalanobis", DRIFT)
    aligned, _, _ = fusion.align_to_anchor(stacked, gate=2.0)
    want = jfusion.align_consensus_round(_jgraph(aligned), gate=2.0, trim=0.75)
    moved, tforms, n_matched = fusion.align_consensus_round(aligned, gate=2.0, trim=0.75)
    np.testing.assert_allclose(tforms.numpy(), np.asarray(want[1]), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_array_equal(n_matched.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(moved.lm_xy.numpy(), np.asarray(want[0].lm_xy),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    _fuse_both(stacked, lm_info, gate=2.0, robust=True, consensus_rounds=2)


def test_fused_boundary_edge_carries_no_information():
    stacked, _ = _sessions(2, "compat")
    fused, _ = fusion.fuse_graphs(stacked, gate=1.2)
    want, _ = jfusion.fuse_graphs(_jgraph(stacked), gate=1.2)
    _assert_fused(fused, want, VALUE_ATOL)
    _, h_off, _ = gn.assemble_odometry(fused, gn.GNConfig())
    b = int(stacked.n_poses[0])
    np.testing.assert_array_equal(h_off[b].numpy(), np.zeros((3, 3)))


def test_fused_full_lap_beats_best_session():
    stacked, lm_info = _sessions(4, "mahalanobis")
    fused, _ = _fuse_both(stacked, lm_info, gate=1.2, align=False,
                          gn_kw=_improved_gn("mahalanobis"))
    err_fused = _map_err(fused.lm_xy, fused.n_landmarks)
    errs = _session_errs(stacked)
    assert err_fused <= min(errs) + 1e-3, (err_fused, errs)


def test_fusion_info_weighted_merge_beats_count_weighted():
    stacked, lm_info = _sessions(3, "mahalanobis")
    f_cnt, _ = _fuse_both(stacked, gate=1.2)
    f_inf, _ = _fuse_both(stacked, lm_info, gate=1.2)
    e_cnt = _map_err(f_cnt.lm_xy, f_cnt.n_landmarks)
    e_inf = _map_err(f_inf.lm_xy, f_inf.n_landmarks)
    assert e_inf <= e_cnt + 5e-3, (e_inf, e_cnt)


def test_fusion_mixed_info_fallback_weights_consistently():
    cap = GraphCapacity(max_poses=4, max_landmarks=4, max_obs=16)

    def one_session(x, n_obs):
        g = empty_graph(cap, "cpu")
        g = add_pose(g, torch.zeros(3), torch.zeros(3))
        g = add_landmark(g, torch.tensor([x, 0.0]), torch.tensor(1, dtype=torch.int32))
        for _ in range(n_obs):
            g = add_observation(g, torch.tensor(0, dtype=torch.int32),
                                torch.tensor(0, dtype=torch.int32), torch.tensor([x, 0.0]))
        return g

    stacked = stack_graphs([one_session(0.0, 5), one_session(1.0, 5)])
    lm_info = torch.zeros((2, cap.max_landmarks, 3))
    lm_info[0, 0] = torch.tensor([100.0, 0.0, 100.0])
    fused, report = fusion.fuse_graphs(stacked, gate=1.2, lm_info=lm_info)
    want = jfusion.fuse_graphs(_jgraph(stacked), gate=1.2, lm_info=jnp.asarray(lm_info.numpy()))
    _assert_report(report, want[1])
    _assert_fused(fused, want[0], VALUE_ATOL)
    assert int(fused.n_landmarks) == 1
    x = float(fused.lm_xy[0, 0])
    assert abs(x - 0.5) < 0.05, x


def test_fusion_with_drifted_sessions_recovers():
    stacked, lm_info = _sessions(3, "mahalanobis", DRIFT)
    fused, report = _fuse_both(stacked, lm_info, gate=2.0, gn_kw=_improved_gn("mahalanobis"))
    assert int(report["n_align_matched"][1]) > 20
    assert int(report["n_align_matched"][2]) > 20
    err_fused = _map_err(fused.lm_xy, fused.n_landmarks)
    err0 = _map_err(stacked.lm_xy[0], stacked.n_landmarks[0])
    assert err_fused < max(2.0 * err0, 0.15), (err_fused, err0)


def test_fusion_robust_trim_beats_plain_on_drift():
    stacked, lm_info = _sessions(3, "mahalanobis", DRIFT)
    plain, _ = _fuse_both(stacked, lm_info, gate=2.0, gn_kw=_improved_gn("mahalanobis"))
    robust, rep = _fuse_both(stacked, lm_info, gate=2.0, robust=True,
                             gn_kw=_improved_gn("mahalanobis"))
    assert int(rep["n_align_matched"][1]) > 15
    e_plain = _map_err(plain.lm_xy, plain.n_landmarks)
    e_rob = _map_err(robust.lm_xy, robust.n_landmarks)
    assert e_rob <= e_plain + 2e-3, (e_rob, e_plain)


def test_fuse_sessions_solvers_mesh_and_unknown_refusal():
    """tests/test_fusion.py:448: an unknown solver is a `ValueError` in
    both packages; the chain solvers 'dd', 'hier' and 'hier3' (refused by
    name until they were ported) run on a one-rank gloo chain mesh, each
    within 1e-2 of solver='auto' (the JAX test's bound; the 8-rank cases
    are in tests/test_torch_chain.py). The mesh path runs: on a one-rank
    gloo mesh its labels equal the dense dedup's and its joint GN
    (`distributed_optimize`) the single-device fusion's within 5e-4
    (tests/test_fusion.py:168's bound)."""
    stacked, _ = _sessions(2, "compat")
    cfg = gn.GNConfig(iterations=3)
    with pytest.raises(ValueError, match="unknown fusion solver"):
        fusion.fuse_sessions(stacked, cfg=cfg, solver="nope")
    with pytest.raises(ValueError, match="unknown fusion solver"):
        jfusion.fuse_sessions(_jgraph(stacked), cfg=jgn.GNConfig(iterations=3), solver="nope")
    from tpuslam_torch.parallel.mesh import initialize_distributed, make_chain_mesh, make_slam_mesh
    made = initialize_distributed("gloo")
    try:
        want, rep_w = fusion.fuse_sessions(stacked, cfg=cfg, align=False)
        n_p, n_l = int(want.n_poses), int(want.n_landmarks)
        chain = make_chain_mesh(device_type="cpu")
        for solver in ("dd", "hier", "hier3"):
            got, rep = fusion.fuse_sessions(stacked, cfg=cfg, solver=solver, align=False,
                                            solve_mesh=chain)
            assert rep["solver"] == solver and torch.equal(rep["labels"], rep_w["labels"])
            torch.testing.assert_close(got.poses[:n_p], want.poses[:n_p], atol=1e-2, rtol=0)
            torch.testing.assert_close(got.lm_xy[:n_l], want.lm_xy[:n_l], atol=1e-2, rtol=0)
        mesh = make_slam_mesh(1, 1, device_type="cpu")
        got, rep = fusion.fuse_sessions(stacked, cfg=cfg, mesh=mesh)
        want, rep_w = fusion.fuse_sessions(stacked, cfg=cfg)
        assert torch.equal(rep["labels"], rep_w["labels"])
        assert int(got.n_landmarks) == int(want.n_landmarks)
        torch.testing.assert_close(got.poses, want.poses, atol=5e-4, rtol=0)
        torch.testing.assert_close(got.lm_xy, want.lm_xy, atol=5e-4, rtol=0)
        valid = torch.ones(CAP.max_landmarks, dtype=torch.bool)
        assert torch.equal(
            fusion.dedup_labels(stacked.lm_xy[0], stacked.lm_type[0], valid, 1.2, mesh=mesh),
            fusion.dedup_labels(stacked.lm_xy[0], stacked.lm_type[0], valid, 1.2))
    finally:
        if made:        # the next test file in this worker gets no world
            torch.distributed.destroy_process_group()


def test_session_obs_counts_and_stack_graphs_match_jax():
    """The merge weights (`bincount`, exact integers) and `stack_graphs`
    against the JAX package's (one-hot matmul, `jax.tree.map` stack)."""
    from tpuslam.parallel.multisession import stack_graphs as jax_stack_graphs
    graphs = [_session(s, "compat")[0] for s in range(3)]
    stacked = stack_graphs(graphs)
    jstacked = jax_stack_graphs([_jgraph(g) for g in graphs])
    for f in dataclasses.fields(stacked):
        np.testing.assert_array_equal(getattr(stacked, f.name).numpy(),
                                      np.asarray(getattr(jstacked, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(fusion._session_obs_counts(stacked).numpy(),
                                  np.asarray(jfusion._session_obs_counts(jstacked)))


def test_info_weighted_merge_is_float32_rounding():
    """The information-weighted merge on identical aligned inputs: the
    port's positions are no farther from the same merge in float64 than the
    JAX package's are (with 1e-5 to spare), which is why its positions are
    held to INFO_MERGE_ATOL."""
    stacked, lm_info = _sessions(3, "mahalanobis", DRIFT)
    moved, _, _ = fusion.align_to_anchor(stacked, gate=2.0, trim=0.75)
    got, _ = fusion.fuse_graphs(moved, 2.0, lm_info=lm_info)
    want, _ = jfusion.fuse_graphs(_jgraph(moved), 2.0, lm_info=jnp.asarray(lm_info.numpy()))
    exact, _ = fusion.fuse_graphs(
        dataclasses.replace(moved, **{f.name: getattr(moved, f.name).double()
                                      for f in dataclasses.fields(moved)
                                      if getattr(moved, f.name).is_floating_point()}),
        2.0, lm_info=lm_info.double())
    n = int(got.n_landmarks)
    ref = exact.lm_xy.numpy()[:n]
    err_port = np.abs(got.lm_xy.numpy()[:n] - ref).max()
    err_jax = np.abs(np.asarray(want.lm_xy)[:n] - ref).max()
    assert err_port <= err_jax + 1e-5, (err_port, err_jax)
    assert max(err_port, err_jax) <= INFO_MERGE_ATOL / 2, (err_port, err_jax)
