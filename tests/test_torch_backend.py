"""The port's factor graph, residuals and Gauss-Newton against the JAX
package (atol 1e-4, f32 with sums in another order; the fixed-lag window
GN atol 1e-5) and against the float64 NumPy golden solver, as
tests/test_backend.py holds the JAX package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_backend import CAP as WORLD_CAP
from tests.test_backend import _as_factor_graph, _as_golden, _build_world, _window_oracle_step
from tests.test_parallel import CFG as JAX_CFG
from tests.test_parallel import _world
from tpuslam.backend import gauss_newton as jgn
from tpuslam.backend import golden
from tpuslam.backend import graph as JG
from tpuslam.backend import residuals as jres
from tpuslam_torch.backend import gauss_newton as tgn
from tpuslam_torch.backend import graph as TG
from tpuslam_torch.backend import residuals as tres
from tpuslam_torch.frontend.state import graph_from_numpy, graph_to_numpy
from tpuslam_torch.geometry import se2

ATOL = 1e-4


@pytest.fixture(scope="module")
def world():
    """tests/test_parallel.py's graph (seed 9, as the JAX package's kernel
    GN test uses it), built once."""
    return _world(seed=9)


def _np_fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _port(g):
    return graph_from_numpy(_np_fields(g), "cpu")


def _cfg(jcfg):
    return tgn.GNConfig(**dataclasses.asdict(jcfg))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_residuals_match_jax():
    rng = np.random.default_rng(1)
    pi, pj, m = (rng.normal(0, 2, (32, 3)).astype(np.float32) for _ in range(3))
    for got, want in zip(tres.odometry_residuals(*map(torch.tensor, (pi, pj, m))),
                         jres.odometry_residuals(*map(jnp.asarray, (pi, pj, m)))):
        _close(got, want, 1e-5)
    lm, z = (rng.normal(0, 5, (32, 2)).astype(np.float32) for _ in range(2))
    for got, want in zip(tres.landmark_residuals(*map(torch.tensor, (pi, lm, z))),
                         jres.landmark_residuals(*map(jnp.asarray, (pi, lm, z)))):
        _close(got, want, 1e-5)


def test_graph_updates_match_jax():
    """add_pose/add_landmark/add_observation, masked and saturating."""
    cap = (3, 2, 3)
    jg, tg = JG.empty_graph(JG.GraphCapacity(*cap)), TG.empty_graph(TG.GraphCapacity(*cap), "cpu")
    rng = np.random.default_rng(2)
    for k in range(4):                       # one past capacity
        p, o = rng.normal(0, 1, 3).astype(np.float32), rng.normal(0, 1, 3).astype(np.float32)
        info = (2.0, 3.0) if k == 1 else None
        jg = JG.add_pose(jg, jnp.asarray(p), jnp.asarray(o), prior_info=info)
        tg = TG.add_pose(tg, torch.tensor(p), torch.tensor(o), prior_info=info)
    for k, en in enumerate([True, False, True, True]):
        xy = rng.normal(0, 1, 2).astype(np.float32)
        jg = JG.add_landmark(jg, jnp.asarray(xy), jnp.int32(k + 1), enable=en)
        tg = TG.add_landmark(tg, torch.tensor(xy), torch.tensor(k + 1, dtype=torch.int32),
                             enable=en)
        jg = JG.add_observation(jg, jnp.int32(k), jnp.int32(k), jnp.asarray(xy), enable=en)
        tg = TG.add_observation(tg, torch.tensor(k, dtype=torch.int32),
                                torch.tensor(k, dtype=torch.int32), torch.tensor(xy),
                                enable=torch.tensor(en))
    want, got = _np_fields(jg), graph_to_numpy(tg)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    np.testing.assert_array_equal(tg.pose_valid.numpy(), np.asarray(jg.pose_valid))
    np.testing.assert_array_equal(tg.lm_valid.numpy(), np.asarray(jg.lm_valid))
    np.testing.assert_array_equal(tg.obs_valid.numpy(), np.asarray(jg.obs_valid))
    assert tg.capacity == TG.GraphCapacity(*cap)


def test_assemble_and_chi2_match_jax(world):
    jg = world
    tg, cfg = _port(jg), _cfg(JAX_CFG)
    want = jax.jit(jgn.assemble, static_argnums=1)(jg, JAX_CFG)
    for got, want in zip(tgn.assemble(tg, cfg), want):
        _close(got, want)
    _close(tgn.chi2(tg, cfg), jgn.chi2(jg, JAX_CFG), atol=1e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_schur_solve_split_matches_jax(world, use_kernel):
    jg = world

    @jax.jit
    def system(g):
        return jgn._apply_gauge(g, JAX_CFG, *jgn.assemble(g, JAX_CFG))

    hpp, w, hll, gp, gl = system(jg)
    want = jax.jit(jgn.schur_solve_split, static_argnums=6)(
        hpp, w[:, 0::2], w[:, 1::2], hll, gp, gl, use_kernel)
    t = [torch.tensor(np.asarray(x)) for x in (hpp, w, hll, gp, gl)]
    got = tgn.schur_solve_split(t[0], t[1][:, 0::2], t[1][:, 1::2], *t[2:],
                                use_cholesky_kernel=use_kernel)
    for g, w_ in zip(got, want):
        _close(g, w_)
    for g, w_ in zip(tgn.schur_solve(*t, use_cholesky_kernel=use_kernel), want):
        _close(g, w_)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gn_step_and_optimize_match_jax(world, use_kernel):
    jg = world
    jcfg = dataclasses.replace(JAX_CFG, use_cholesky_kernel=use_kernel)
    tg, cfg = _port(jg), _cfg(jcfg)
    step, want = tgn.gn_step(tg, cfg), jgn.gn_step(jg, jcfg)
    _close(step.poses, want.poses)
    _close(step.lm_xy, want.lm_xy)
    got, want = tgn.optimize(tg, cfg), jgn.optimize(jg, jcfg)
    _close(got.poses, want.poses)
    _close(got.lm_xy, want.lm_xy)
    assert tgn.optimize(tg, cfg, enable=torch.tensor(False)) is tg


def test_optimize_matches_golden():
    """The port's Schur GN against the independent float64 dense solver."""
    poses, lms, obs = _build_world()
    g = TG.empty_graph(TG.GraphCapacity(64, 32, 256), "cpu")
    prev = None
    for p in poses:
        p = torch.tensor(p, dtype=torch.float32)
        g = TG.add_pose(g, p, torch.zeros(3) if prev is None else se2.between(prev, p))
        prev = p
    for row in lms:
        g = TG.add_landmark(g, torch.tensor(row, dtype=torch.float32),
                            torch.tensor(1, dtype=torch.int32))
    for i, j, z in obs:
        g = TG.add_observation(g, torch.tensor(i, dtype=torch.int32),
                               torch.tensor(j, dtype=torch.int32),
                               torch.tensor(z, dtype=torch.float32))
    cfg = tgn.GNConfig(iterations=10)
    chi_before = float(tgn.chi2(g, cfg))
    out = tgn.optimize(g, cfg)
    assert float(tgn.chi2(out, cfg)) < chi_before * 0.5
    gg = _as_golden(poses, lms, obs)
    golden.golden_optimize(gg, iterations=10)
    got = out.poses.numpy()[:len(poses)]
    want = np.stack(gg.poses)
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=2e-3)
    ang = np.abs((got[:, 2] - want[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    assert ang.max() < 2e-3
    np.testing.assert_allclose(out.lm_xy.numpy()[:len(lms)], np.stack(gg.landmarks), atol=2e-3)
    # gauge-fixed vertices and padding rows untouched
    np.testing.assert_array_equal(out.poses[:2].numpy(), g.poses[:2].numpy())
    np.testing.assert_array_equal(out.lm_xy[:2].numpy(), g.lm_xy[:2].numpy())
    np.testing.assert_array_equal(out.poses[len(poses):].numpy(), 0.0)


WINDOW_ATOL = 1e-5


@pytest.fixture(scope="module")
def window_world():
    """tests/test_backend.py's 12-pose world (noise 0.3) with GPS/heading
    priors on every other pose, as a JAX graph."""
    poses, lms, obs = _build_world(n_poses=12, noise=0.3)
    g = _as_factor_graph(poses, lms, obs)
    info = np.zeros((WORLD_CAP.max_poses, 2), np.float32)
    info[:12:2] = (40.0, 300.0)
    prior = np.asarray(g.poses) + np.random.default_rng(4).normal(0, 0.1, (WORLD_CAP.max_poses, 3))
    return dataclasses.replace(g, prior_pose=jnp.asarray(prior, jnp.float32),
                               prior_info=jnp.asarray(info))


def _anchor_kw(**kw):
    """`kw` (int32 scalars) as JAX arrays and as tensors."""
    jkw = {k: jnp.int32(v) for k, v in kw.items()}
    tkw = {k: torch.tensor(v, dtype=torch.int32) for k, v in kw.items()}
    return jkw, tkw


@pytest.mark.parametrize("landmarks", [True, False])
@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("anchor", [None, (9, 60)], ids=["head", "end"])
@pytest.mark.parametrize("window,edge_window", [(6, 128), (16, 64)])
def test_window_gn_step_matches_jax(window_world, landmarks, prior, anchor, window,
                                    edge_window):
    """One fixed-lag iteration, map free or fixed, with and without the
    marginal landmark prior (centred away from the estimate), anchored at the
    graph head or at a past pose / edge count."""
    jg = window_world
    jcfg = jgn.GNConfig(iterations=1, fix_first_poses=0, fix_first_landmarks=1)
    tg, cfg = _port(jg), _cfg(jcfg)
    kw = {} if anchor is None else dict(end=anchor[0], end_obs=anchor[1])
    jkw, tkw = _anchor_kw(**kw)
    jprior = tprior = None
    if prior:
        shift = np.random.default_rng(5).normal(0, 0.2, np.asarray(jg.lm_xy).shape)
        jprior = jg.lm_xy + jnp.asarray(shift, jnp.float32)
        tprior = torch.tensor(np.asarray(jprior))
    want = jgn.window_gn_step(jg, jcfg, window, edge_window, landmarks=landmarks,
                              lm_prior=jprior, **jkw)
    got = tgn.window_gn_step(tg, cfg, window, edge_window, landmarks=landmarks,
                             lm_prior=tprior, **tkw)
    _close(got.poses, want.poses, WINDOW_ATOL)
    _close(got.lm_xy, want.lm_xy, WINDOW_ATOL)
    for f in ("odo_meas", "obs_xy", "prior_pose", "n_poses", "n_obs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("landmarks", [True, False])
@pytest.mark.parametrize("anchor", [None, (10, 70)], ids=["head", "end"])
def test_optimize_window_matches_jax(window_world, landmarks, anchor):
    """The loop with its early exit, the landmark prior centred at the entry
    map; `enable=False` is an exact identity on both sides."""
    jg = window_world
    jcfg = jgn.GNConfig(iterations=3, early_exit_tol=1e-4)
    tg, cfg = _port(jg), _cfg(jcfg)
    kw = {} if anchor is None else dict(end=anchor[0], end_obs=anchor[1])
    jkw, tkw = _anchor_kw(**kw)
    want = jgn.optimize_window(jg, jcfg, 6, 128, landmarks=landmarks, **jkw)
    got = tgn.optimize_window(tg, cfg, 6, 128, landmarks=landmarks, **tkw)
    _close(got.poses, want.poses, WINDOW_ATOL)
    _close(got.lm_xy, want.lm_xy, WINDOW_ATOL)
    off = tgn.optimize_window(tg, cfg, 6, 128, enable=torch.tensor(False),
                              landmarks=landmarks, **tkw)
    assert off is tg
    joff = jgn.optimize_window(jg, jcfg, 6, 128, enable=jnp.asarray(False),
                               landmarks=landmarks, **jkw)
    np.testing.assert_array_equal(np.asarray(joff.poses), tg.poses.numpy())


# mirrors of tests/test_backend.py's fixed-lag tests, on the port

@pytest.mark.parametrize("window,n_poses", [(8, 12), (16, 12), (4, 12)])
def test_window_gn_matches_numpy_oracle(window, n_poses):
    """One pose-only window step against the float64 NumPy assembly of
    tests/test_backend.py."""
    poses, lms, obs = _build_world(n_poses=n_poses)
    jg = _as_factor_graph(poses, lms, obs)
    jcfg = dataclasses.replace(jgn.GNConfig(iterations=1), early_exit_tol=0.0)
    got = tgn.window_gn_step(_port(jg), _cfg(jcfg), window, 128, landmarks=False).poses
    want = _window_oracle_step(jg, jcfg, window, 128)
    np.testing.assert_allclose(got.numpy()[:n_poses], want[:n_poses], rtol=1e-4, atol=1e-4)


def _noisy_world():
    poses, lms, obs = _build_world(n_poses=12, noise=0.3)
    return _port(_as_factor_graph(poses, lms, obs)), len(lms)


def test_window_gn_invariants():
    """Pre-window poses, padding and (pose-only) the map stay bit-equal;
    chi2 falls; enable=False is the identity."""
    g, _ = _noisy_world()
    cfg = tgn.GNConfig(iterations=3)
    out = tgn.optimize_window(g, cfg, 6, 128, landmarks=False)
    assert torch.equal(out.lm_xy, g.lm_xy)
    assert torch.equal(out.poses[:6], g.poses[:6]) and torch.equal(out.poses[12:], g.poses[12:])
    assert float(tgn.chi2(out, cfg)) < float(tgn.chi2(g, cfg))
    assert tgn.optimize_window(g, cfg, 6, 128, enable=torch.tensor(False)) is g


def test_window_gn_free_map_mode():
    """landmarks=True lowers chi2 at least as far as pose-only; clamped and
    padding landmarks stay bit-equal; an observed landmark moves."""
    g, n_lm = _noisy_world()
    cfg = tgn.GNConfig(iterations=3)
    out_p = tgn.optimize_window(g, cfg, 6, 128, landmarks=False)
    out_f = tgn.optimize_window(g, cfg, 6, 128, landmarks=True)
    c0, cp, cf = (float(tgn.chi2(x, cfg)) for x in (g, out_p, out_f))
    assert cf < c0 and cf <= cp + 1e-6, (c0, cp, cf)
    assert torch.equal(out_f.lm_xy[:2], g.lm_xy[:2])
    assert torch.equal(out_f.lm_xy[n_lm:], g.lm_xy[n_lm:])
    assert float((out_f.lm_xy[2:n_lm] - g.lm_xy[2:n_lm]).abs().max()) > 1e-6


def test_window_gn_marginal_prior_restores():
    """Every pose clamped: the landmark converges to the information-weighted
    mean of the marginalized prior (n_out edges, at the entry estimate A)
    and the in-window measurements (n_in edges implying B)."""
    n_poses, n_out, n_in, W = 12, 6, 3, 4
    a = np.array([3.0, -1.0], np.float32)
    b = np.array([4.0, 0.5], np.float32)
    poses = np.random.default_rng(7).normal(0, 2.0, (n_poses, 3)).astype(np.float32)
    g = TG.empty_graph(TG.GraphCapacity(64, 32, 256), "cpu")
    prev = None
    for p in poses:
        p = torch.tensor(p)
        g = TG.add_pose(g, p, torch.zeros(3) if prev is None else se2.between(prev, p))
        prev = p
    g = TG.add_landmark(g, torch.tensor(a), torch.tensor(1, dtype=torch.int32))

    def observe(g, k, target):
        z = se2.transform_to_body(torch.tensor(poses[k]), torch.tensor(target))
        return TG.add_observation(g, torch.tensor(k, dtype=torch.int32),
                                  torch.tensor(0, dtype=torch.int32), z)

    for e in range(n_out):
        g = observe(g, e % 4, a)
    for e in range(n_in):
        g = observe(g, n_poses - 1 - (e % W), b)
    cfg = tgn.GNConfig(iterations=10, fix_first_poses=n_poses, fix_first_landmarks=0)
    got = tgn.optimize_window(g, cfg, W, n_in).lm_xy[0].numpy()
    np.testing.assert_allclose(got, (n_out * a + n_in * b) / (n_out + n_in), atol=1e-4)
    assert np.linalg.norm(got - b) > 0.3


def test_window_gn_gps_prior_anchoring():
    """A window over the whole unclamped chain pulls poses toward strong
    GPS/heading priors."""
    poses, lms, obs = _build_world(n_poses=10, noise=0.4, seed=9)
    g = _port(_as_factor_graph(poses, lms, obs))
    info = g.prior_info.clone()
    info[:10] = torch.tensor([50.0, 20.0])
    g = dataclasses.replace(g, prior_pose=g.poses, prior_info=info)
    moved = g.poses.clone()
    moved[:10, :2] += 0.3
    out = tgn.optimize_window(dataclasses.replace(g, poses=moved),
                              tgn.GNConfig(iterations=5, fix_first_poses=0), 16, 256)
    before = torch.linalg.norm((moved - g.prior_pose)[:10, :2], dim=1)
    after = torch.linalg.norm((out.poses - g.prior_pose)[:10, :2], dim=1)
    assert float(after.max()) < float(before.max()) * 0.5


def test_window_gn_refuses_a_window_past_the_capacity():
    g, _ = _noisy_world()
    with pytest.raises(ValueError, match="capacity"):
        tgn.window_gn_step(g, tgn.GNConfig(), 65, 128)
    with pytest.raises(ValueError, match="capacity"):
        tgn.window_gn_step(g, tgn.GNConfig(), 8, 257)
