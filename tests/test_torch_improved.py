"""The port's improved mode and scan-form mapping step against the JAX
package: GPS/heading priors, Mahalanobis gating (dense and through the
association kernel, its plain twin here), the localizer and publish
refines, the fixed-lag periodic GN, on the per-frame engine and the
blocked pipeline.

Tolerances: the information and gating helpers rtol 1e-6; the refines atol
1e-5; whole runs hold discrete outputs and state exact (edge rows up to
`n_obs`), the information rows within 1e-6 of their largest entry (f32
sums, with cancellation in the off-diagonal term), and every other value
within 1e-4 up to the loop closure: the periodic GN runs before it, so the
GN-free 1e-5 of tests/test_torch_pipeline.py does not apply; after the
closure GN, whose early exit may stop the two after different iteration
counts, 1e-3 as there. Cone-packet azimuths are in degrees: 60x. On the
bench lap the runs are also held to the numbers chip_smoke.py holds the
GPU to (`chip_smoke.REFERENCE`), which these tests recompute with JAX.
Each port path is held to the JAX path of the same form and block: the
JAX package's own paths differ from each other (dense and kernel
Mahalanobis costs round differently; a blocked run gates against the
information at block start).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_pipeline import DEG_PER_UNIT, POST_ATOL, _assert_same, _closure, _np_tree
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.frontend import keyframe as jkf
from tpuslam.frontend.blocked import run_sequence_blocked as jax_run_sequence_blocked
from tpuslam.frontend.pipeline import run_sequence as jax_run_sequence
from tpuslam.frontend.state import initial_state as jax_initial_state
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import keyframe as tkf
from tpuslam_torch.frontend.blocked import run_sequence_blocked
from tpuslam_torch.frontend.keyframe import _gn_config
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import initial_state, state_from_numpy, state_to_numpy
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, ate, simulate, skidpad, trackdrive

RTOL, REFINE_ATOL, RUN_ATOL = 1e-6, 1e-5, 1e-4
VARIANTS = {"improved": {}, "mahalanobis": dict(association="mahalanobis"),
            "mahalanobis_kernel": dict(association="mahalanobis", use_pallas_association=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


# ---- the information and gating helpers

def _info_rows(m, seed):
    """Packed SPD information rows, the last quarter zero (no information)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(5.0, 500.0, m)
    c = rng.uniform(5.0, 500.0, m)
    b = rng.uniform(-0.5, 0.5, m) * np.sqrt(a * c)
    info = np.stack([a, b, c], axis=1).astype(np.float32)
    info[3 * m // 4:] = 0.0
    return info


def test_obs_information_matches_jax():
    """Per frame (one pose) and per block (a pose per observation), with
    observations on top of the pose (the range clamp) and far out."""
    rng = np.random.default_rng(0)
    cfg, jcfg = SlamConfig(), JCfg()
    pose = np.array([3.0, -2.0, 0.7], np.float32)
    glob = (pose[:2] + rng.normal(0, 12.0, (64, 2))).astype(np.float32)
    glob[0] = pose[:2]
    poses = rng.normal(0, 5.0, (64, 3)).astype(np.float32)
    _rel(tkf._obs_information(torch.tensor(glob), torch.tensor(pose), None, cfg),
         jkf._obs_information(jnp.asarray(glob), jnp.asarray(pose), None, jcfg))
    _rel(tkf._obs_information(torch.tensor(glob), torch.tensor(poses), None, cfg),
         jax.vmap(lambda gl, po: jkf._obs_information(gl, po, None, jcfg))(
             jnp.asarray(glob), jnp.asarray(poses)))


def test_innovation_info_and_mahal_packed_match_jax():
    info = _info_rows(256, 1)
    cfg, jcfg = SlamConfig(), JCfg()
    _rel(tkf._innovation_info(torch.tensor(info), cfg),
         jkf._innovation_info(jnp.asarray(info), jcfg))
    _rel(tkf._mahal_packed(torch.tensor(info), cfg), jkf._mahal_packed(jnp.asarray(info), jcfg))


@pytest.mark.parametrize("association", ["nearest", "mahalanobis"])
def test_gate_cost_matches_jax(association):
    rng = np.random.default_rng(2)
    lm = rng.uniform(-20, 20, (256, 2)).astype(np.float32)
    glob = (lm[rng.integers(0, 256, 64)] + rng.normal(0, 0.5, (64, 2))).astype(np.float32)
    info = _info_rows(256, 3)
    diff = glob[:, None, :] - lm[None, :, :]
    d2 = np.sum(diff * diff, axis=-1)
    got, gate = tkf._gate_cost(torch.tensor(diff), torch.tensor(d2), torch.tensor(info),
                               SlamConfig(association=association))
    want, jgate = jkf._gate_cost(jnp.asarray(diff), jnp.asarray(d2), jnp.asarray(info),
                                 JCfg(association=association))
    assert gate == jgate
    _rel(got, want)


def test_obs_information_geometry():
    """As tests/test_improved_mode.py: strong along the range ray
    (1/sigma_r^2), weak across it (1/(d sigma_az)^2)."""
    cfg = SlamConfig()
    pose = torch.zeros(3)
    ir = 1.0 / cfg.obs_noise_std ** 2
    it = 1.0 / (10.0 * np.radians(cfg.obs_noise_az_deg)) ** 2
    a, b, c = tkf._obs_information(torch.tensor([10.0, 0.0]), pose, 10.0, cfg).numpy()
    np.testing.assert_allclose([a, c], [ir, it], rtol=1e-5)
    np.testing.assert_allclose(b, 0.0, atol=1e-6)
    a2, _, c2 = tkf._obs_information(torch.tensor([0.0, 10.0]), pose, 10.0, cfg).numpy()
    np.testing.assert_allclose([a2, c2], [it, ir], rtol=1e-5)


# ---- the refines

def _refine_inputs(n_matched, seed, b=None):
    """A pose near the truth, 16 landmark rows of which `n_matched` are
    matched, and their body-frame measurements from the true pose; with
    `b`, a batch of b such frames."""
    rng = np.random.default_rng(seed)
    shape = () if b is None else (b,)
    truth = rng.normal(0, 5.0, shape + (3,))
    pose = truth + rng.normal(0, [0.2, 0.2, 0.03], shape + (3,))
    lm = truth[..., None, :2] + rng.uniform(-15, 15, shape + (16, 2))
    c, s = np.cos(truth[..., 2])[..., None], np.sin(truth[..., 2])[..., None]
    d = lm - truth[..., None, :2]
    meas = np.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], -1)
    meas += rng.normal(0, 0.05, meas.shape)
    matched = np.zeros(shape + (16,), bool)
    matched[..., :n_matched] = True
    return [x.astype(np.float32) if x.dtype != bool else x for x in (pose, lm, matched, meas)]


@pytest.mark.parametrize("n_matched", [0, 1, 2, 9])
def test_pose_refine_rows_matches_jax(n_matched):
    """With fewer than two matched rows the pose comes back unchanged."""
    ins = _refine_inputs(n_matched, 4)
    got = tkf._pose_refine_rows(*map(torch.tensor, ins))
    want = jkf._pose_refine_rows(*map(jnp.asarray, ins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REFINE_ATOL, rtol=0)
    if n_matched < 2:
        assert torch.equal(got, torch.tensor(ins[0]))


@pytest.mark.parametrize("n_matched", [0, 1, 9])
def test_publish_refine_matches_jax(n_matched):
    """No match: the measured pose back."""
    ins = _refine_inputs(n_matched, 5)
    got = tkf._publish_refine(*map(torch.tensor, ins), SlamConfig.improved())
    want = jkf._publish_refine(*map(jnp.asarray, ins), JCfg.improved())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REFINE_ATOL, rtol=0)


def test_refines_batched_equal_single():
    """The blocked path refines a block of frames at once; each frame's
    result is bit-equal to the refine of that frame alone, padded to 64
    rows as the per-frame path's observation slots are."""
    pose, lm, matched, meas = map(torch.tensor, _refine_inputs(5, 6, b=8))
    cfg = SlamConfig.improved()
    batched = (tkf._pose_refine_rows(pose, lm, matched, meas),
               tkf._publish_refine(pose, lm, matched, meas, cfg))

    def pad(x):
        return torch.cat([x, x.new_zeros((48,) + tuple(x.shape[1:]))])

    for f in range(8):
        single = (tkf._pose_refine_rows(pose[f], pad(lm[f]), pad(matched[f]), pad(meas[f])),
                  tkf._publish_refine(pose[f], pad(lm[f]), pad(matched[f]), pad(meas[f]), cfg))
        for got, want in zip(batched, single):
            assert torch.equal(got[f], want), f


# ---- whole runs, per frame

def _mahal_scenario():
    """tests/test_blocked_equivalence.py's `_mahal_scenario` (the scenario
    tests/test_improved_mode.py validates Mahalanobis on)."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=1))
    return scen, (128, 128, 4096)


def _frames(scen):
    return (scen.obs.astype(np.float32), scen.obs_valid, scen.odom_poses.astype(np.float32))


def _jax(frames, cfg, block=None):
    ins = tuple(jnp.asarray(x) for x in frames)
    st = jax_initial_state(cfg.capacity)
    st, out = (jax_run_sequence(st, *ins, cfg) if block is None
               else jax_run_sequence_blocked(st, *ins, cfg, block=block))
    return _np_tree(st), _np_tree(out)


def _port(frames, cfg, block=None):
    ins = tuple(torch.tensor(x) for x in frames)
    st = initial_state(cfg.capacity, "cpu")
    return (run_sequence(st, *ins, cfg) if block is None
            else run_sequence_blocked(st, *ins, cfg, block=block))


def _assert_run_close(port, want):
    """Port (state, outputs) against the JAX package's, as numpy trees, with
    the tolerances of the module docstring."""
    (ps, po), (js, jo) = port, want
    closure = _closure(jo)
    for k, w in jo.items():
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(po[k], w, err_msg=k)
            continue
        scale = DEG_PER_UNIT if k == "cone_azimuth" else 1.0
        np.testing.assert_allclose(po[k][:closure], w[:closure], atol=RUN_ATOL * scale, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(po[k][closure:], w[closure:], atol=POST_ATOL * scale,
                                   rtol=0, err_msg=k)
    n = int(js["graph"]["n_obs"])

    def same(p, j, path):
        for k, w in j.items():
            got = p[k]
            if isinstance(w, dict):
                same(got, w, path + k + ".")
                continue
            if k in ("obs_pose", "obs_lm", "obs_xy"):
                got, w = got[:n], w[:n]
            assert got.dtype == w.dtype, path + k
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(got, w, err_msg=path + k)
            elif k == "lm_info_xy":
                np.testing.assert_allclose(got, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                           err_msg=path + k)
            else:
                atol = RUN_ATOL if k in ("odo_meas", "obs_xy", "prior_pose") else POST_ATOL
                np.testing.assert_allclose(got, w, atol=atol, rtol=0, err_msg=path + k)
    same(ps, js, "")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mahal_scenario_per_frame_matches_jax(variant):
    """`improved()`, its dense Mahalanobis variant and its Mahalanobis +
    kernel variant, per frame, on the skidpad scenario."""
    scen, cap = _mahal_scenario()
    want = _jax(_frames(scen), JCfg.improved(capacity=JCap(*cap), **VARIANTS[variant]))
    st, out = _port(_frames(scen),
                    SlamConfig.improved(capacity=GraphCapacity(*cap), **VARIANTS[variant]))
    assert bool(st.loop_closure_complete)
    _assert_run_close((state_to_numpy(st), _np_tree(out)), want)


def test_mahalanobis_pipeline_end_to_end():
    """As tests/test_improved_mode.py: the information accumulates
    positive definite with every observation, and the trajectory is no
    worse than the Euclidean gate's."""
    scen, cap = _mahal_scenario()
    t = len(scen.times)
    runs = {a: _port(_frames(scen), SlamConfig(capacity=GraphCapacity(*cap), association=a))
            for a in ("nearest", "mahalanobis")}
    st_m, out_m = runs["mahalanobis"]
    assert bool(st_m.loop_closure_complete)
    n_lm = int(st_m.graph.n_landmarks)
    assert n_lm > 10
    info = st_m.lm_info_xy[:n_lm].numpy()
    assert (info[:, 0] > 0).all() and (info[:, 2] > 0).all()
    assert (info[:, 0] * info[:, 2] - info[:, 1] ** 2 > 0).all()
    assert info[:, 0].max() > 2 / 0.3 ** 2
    ate_m = ate(out_m.pose.numpy()[:, :2], scen.gt_poses[:t, :2])
    ate_n = ate(runs["nearest"][1].pose.numpy()[:, :2], scen.gt_poses[:t, :2])
    assert ate_m <= ate_n * 1.2


def test_improved_beats_reference_accuracy():
    """As tests/test_improved_mode.py: after a final GN the improved mode's
    trajectory beats raw odometry, its map is within 0.1 m median, and its
    heading error is no worse."""
    track = trackdrive(seed=6)
    scen = simulate(track, SimConfig(laps=1.25, seed=8, max_range=20.0))
    t = len(scen.times)
    cfg = SlamConfig.improved(capacity=GraphCapacity(128, 160, 4096))
    st, _ = _port(_frames(scen), cfg)
    g = gn.optimize(st.graph, _gn_config(cfg))
    est = g.poses.numpy()[:t]
    assert ate(est[:, :2], scen.gt_poses[:t, :2]) < 0.85 * ate(scen.odom_poses[:t, :2],
                                                               scen.gt_poses[:t, :2])
    lm = g.lm_xy.numpy()[:int(g.n_landmarks)]
    assert np.median(np.linalg.norm(lm[:, None] - track.cones_xy[None], axis=-1).min(1)) < 0.1

    def rms_heading(h):
        e = h - scen.gt_poses[:t, 2]
        return np.sqrt(np.mean(np.arctan2(np.sin(e), np.cos(e)) ** 2))
    assert rms_heading(est[:, 2]) <= rms_heading(scen.odom_poses[:t, 2]) * 1.05


def test_prior_factors_anchor_without_gauge():
    """As tests/test_improved_mode.py: with priors and no gauge clamping the
    GN converges and the first pose moves, staying near its prior."""
    scen = simulate(trackdrive(seed=6), SimConfig(laps=0.5, seed=9, max_range=20.0))
    cfg = SlamConfig.improved(capacity=GraphCapacity(64, 128, 2048), periodic_gn_every=0)
    st, _ = _port(_frames(scen), cfg)
    g = gn.optimize(st.graph, _gn_config(cfg))
    before, after = st.graph.poses.numpy(), g.poses.numpy()
    assert np.all(np.isfinite(after))
    assert not np.allclose(after[0], before[0])
    assert np.linalg.norm(after[0, :2] - before[0, :2]) < 1.0


# ---- the bench lap: every path chip_smoke.py's phase `improved` drives

IMPROVED_RUNS = {"I1": ("I1", None), "I1_b16": ("I1", 16), "I1_b32": ("I1", 32),
                 "I2": ("I2", None), "I2_b16": ("I2", 16)}


@functools.lru_cache(maxsize=None)
def _bench():
    track, scen = chip_smoke.scenario()
    return track, scen, tuple(dataclasses.astuple(chip_smoke.CAP))


@pytest.mark.parametrize("run", list(IMPROVED_RUNS))
def test_bench_lap_matches_jax_and_pins_smoke_constants(run):
    """Each path of chip_smoke.py's phase `improved` against the JAX
    package's same path and block, and both against the numbers the phase
    holds the GPU to."""
    name, block = IMPROVED_RUNS[run]
    track, scen, cap = _bench()
    jcfg = JCfg.improved(capacity=JCap(*cap), **chip_smoke.IMPROVED[name])
    want = _jax(_frames(scen), jcfg, block)
    st, out = _port(_frames(scen), chip_smoke.improved_configs()[name], block)
    _assert_run_close((state_to_numpy(st), _np_tree(out)), want)
    jax_state = state_from_numpy(want[0], "cpu")
    jax_out = dataclasses.replace(out, **{k: torch.tensor(v) for k, v in want[1].items()})
    for metrics, atol in ((chip_smoke.lap_metrics(track, scen, jax_state, jax_out), 1e-6),
                          (chip_smoke.lap_metrics(track, scen, st, out),
                           chip_smoke.METRIC_ATOL_M)):
        for k, v in chip_smoke.REFERENCE[run].items():
            if isinstance(v, int):
                assert metrics[k] == v, (k, metrics[k], v)
            else:
                assert abs(metrics[k] - v) <= atol, (k, metrics[k], v)


# ---- the scan-form mapping step (vectorized_mapping=False)

SCAN_CAP = GraphCapacity(128, 96, 2048)


def _duplicated_frame0():
    """tests/test_vectorized_equivalence.py's in-frame duplicates: every
    observation of frame 0 detected twice, with jitter."""
    scen = simulate(skidpad(), SimConfig(laps=0.2, seed=23))
    obs, valid = scen.obs.copy(), scen.obs_valid.copy()
    n = int(valid[0].sum())
    rng = np.random.default_rng(0)
    for i in range(min(n, obs.shape[1] - n)):
        obs[0, n + i] = obs[0, i] + rng.normal(0, [0.2, 0.0, 0.02, 0.0])
        valid[0, n + i] = True
    scen.obs, scen.obs_valid = obs, valid
    return scen


SCAN_CASES = {
    "skidpad": lambda: (simulate(skidpad(), SimConfig(laps=1.3, seed=21)), SCAN_CAP),
    "trackdrive": lambda: (simulate(trackdrive(seed=3), SimConfig(laps=1.2, seed=22,
                                                                   max_range=20.0)),
                           GraphCapacity(128, 160, 4096)),
    "duplicates": lambda: (_duplicated_frame0(), SCAN_CAP),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_form_equals_vectorized(case):
    """tests/test_vectorized_equivalence.py on the port: the vectorized
    mapping step reproduces the sequential one."""
    scen, cap = SCAN_CASES[case]()
    a, _ = _port(_frames(scen), SlamConfig(capacity=cap))
    b, _ = _port(_frames(scen), SlamConfig(capacity=cap, vectorized_mapping=False))
    ga, gb = a.graph, b.graph
    for f in ("n_landmarks", "n_poses", "n_obs"):
        assert int(getattr(ga, f)) == int(getattr(gb, f)), f
    n_lm, n_obs = int(ga.n_landmarks), int(ga.n_obs)
    np.testing.assert_allclose(ga.lm_xy[:n_lm].numpy(), gb.lm_xy[:n_lm].numpy(), atol=1e-4)
    assert torch.equal(ga.lm_type[:n_lm], gb.lm_type[:n_lm])
    assert torch.equal(ga.obs_pose[:n_obs], gb.obs_pose[:n_obs])
    assert torch.equal(ga.obs_lm[:n_obs], gb.obs_lm[:n_obs])
    np.testing.assert_allclose(ga.obs_xy[:n_obs].numpy(), gb.obs_xy[:n_obs].numpy(), atol=1e-5)
    assert int(a.current_cone_index) == int(b.current_cone_index)
    assert bool(a.loop_closure_complete) == bool(b.loop_closure_complete)
    if case == "skidpad":
        assert bool(a.loop_closure_complete)
    if case == "duplicates":
        assert n_obs > n_lm


@pytest.mark.parametrize("improved", [False, True], ids=["compat", "improved"])
def test_scan_form_matches_jax(improved):
    """The port's scan-form step against the JAX package's on the skidpad
    lap, in the reference-compat configuration and in the improved mode
    without the publish refine (which needs the vectorized step)."""
    scen, cap = SCAN_CASES["skidpad"]()
    kw = dict(vectorized_mapping=False)
    jcap, tcap = JCap(*dataclasses.astuple(cap)), cap
    if improved:
        jcfg = JCfg.improved(capacity=jcap, mapping_publish_refine=False, **kw)
        cfg = SlamConfig.improved(capacity=tcap, mapping_publish_refine=False, **kw)
    else:
        jcfg, cfg = JCfg(capacity=jcap, **kw), SlamConfig(capacity=tcap, **kw)
    want = _jax(_frames(scen), jcfg)
    st, out = _port(_frames(scen), cfg)
    _assert_same((state_to_numpy(st), _np_tree(out)), want, _closure(want[1]))


@pytest.mark.parametrize("kw,match", [
    (dict(association="mahalanobis"), "vectorized_mapping"),
    (dict(association="nearest", mapping_publish_refine=True), "mapping_publish_refine")])
def test_scan_form_refusals(kw, match):
    """As the JAX package: Mahalanobis gating and the publish refine need
    the vectorized step, per frame and blocked."""
    cap = GraphCapacity(8, 8, 32)
    cfg = SlamConfig(capacity=cap, vectorized_mapping=False, **kw)
    with pytest.raises(ValueError, match=match):
        tkf.perform_keyframe(initial_state(cap, "cpu"), torch.zeros(4, 4),
                             torch.zeros(4, dtype=torch.bool), torch.zeros(3), cfg)
    with pytest.raises(ValueError, match="vectorized mapping"):
        run_sequence_blocked(initial_state(cap, "cpu"), torch.zeros(2, 4, 4),
                             torch.zeros(2, 4, dtype=torch.bool), torch.zeros(2, 3), cfg)
