"""Port geometry (SE(2) and the spherical observation model) against the JAX
package on the same numpy inputs, atol 1e-5 in f32, with the reference's
quirky constants and with the clean ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry import se2 as jse2
from tpuslam.geometry import spherical as jsph
from tpuslam_torch.geometry import se2 as tse2
from tpuslam_torch.geometry import spherical as tsph

ATOL = 1e-5
RTOL = 1e-6   # one f32 ulp of the degree-valued azimuths (up to ~360)


def _poses(rng, n=64):
    p = rng.normal(0, 5, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-3 * np.pi, 3 * np.pi, n)   # exercise the wrap
    return p


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["compose", "between"])
def test_se2_binary(name):
    rng = np.random.default_rng(1)
    a, b = _poses(rng), _poses(rng)
    _close(getattr(tse2, name)(torch.tensor(a), torch.tensor(b)),
           getattr(jse2, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["wrap_angle", "inverse", "exp", "log"])
def test_se2_unary(name):
    rng = np.random.default_rng(2)
    p = _poses(rng)
    p[:8, 2] = [0.0, 1e-7, -1e-7, np.pi, -np.pi, 2 * np.pi, -2.5, 5e-7]  # small-angle branches
    x = p[:, 2] if name == "wrap_angle" else p
    _close(getattr(tse2, name)(torch.tensor(x)), getattr(jse2, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["transform_to_world", "transform_to_body"])
def test_se2_points(name):
    rng = np.random.default_rng(3)
    p = _poses(rng)
    pts = rng.normal(0, 10, (64, 2)).astype(np.float32)
    _close(getattr(tse2, name)(torch.tensor(p), torch.tensor(pts)),
           getattr(jse2, name)(jnp.asarray(p), jnp.asarray(pts)))


def _obs(rng, n=64):
    az = rng.uniform(-60, 60, n).astype(np.float32)
    zen = rng.uniform(-5, 5, n).astype(np.float32)
    dist = rng.uniform(1, 25, n).astype(np.float32)
    typ = rng.integers(1, 5, n).astype(np.float32)
    return np.stack([az, zen, dist, typ], axis=1)


@pytest.mark.parametrize("ref", [True, False])
def test_spherical_model(ref):
    rng = np.random.default_rng(4)
    ob = _obs(rng)
    t, j = torch.tensor(ob), jnp.asarray(ob)
    for got, want in zip(tsph.lidar_to_cog(t[:, 0], t[:, 2], 1.5, ref),
                         jsph.lidar_to_cog(j[:, 0], j[:, 2], 1.5, ref)):
        _close(got, want)
    _close(tsph.spherical_to_cartesian(t[:, 0], t[:, 1], t[:, 2], 1.5, ref),
           jsph.spherical_to_cartesian(j[:, 0], j[:, 1], j[:, 2], 1.5, ref))
    pose = _poses(rng, 1)[0]
    _close(tsph.cones_to_global(torch.tensor(pose), t, 1.5, ref),
           jsph.cones_to_global(jnp.asarray(pose), j, 1.5, ref))
    _close(tsph.cone_to_global(torch.tensor(pose), t[:, 0], t[:, 1], t[:, 2], 1.5, ref),
           jsph.cone_to_global(jnp.asarray(pose), j[:, 0], j[:, 1], j[:, 2], 1.5, ref))
    xy = rng.normal(0, 20, (64, 2)).astype(np.float32)
    for got, want in zip(tsph.global_to_body_spherical(torch.tensor(pose), torch.tensor(xy), ref),
                         jsph.global_to_body_spherical(jnp.asarray(pose), jnp.asarray(xy), ref)):
        _close(got, want)
