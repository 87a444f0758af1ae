"""The port's factor graph, residuals and Gauss-Newton against the JAX
package (atol 1e-4, f32 with sums in another order) and against the float64
NumPy golden solver, as tests/test_backend.py holds the JAX package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_backend import _as_golden, _build_world
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
