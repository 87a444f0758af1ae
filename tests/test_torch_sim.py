"""The port's own copies of the JAX package's numpy-only modules
(`tpuslam_torch.compat`, `tpuslam_torch.sim`) against the originals: equal
constants and quirk transforms, and bit-equal simulated scenarios."""
import numpy as np
import pytest

from tpuslam import compat as jcompat
from tpuslam import sim as jsim
from tpuslam.sim.simulator import ate as jate
from tpuslam_torch import compat
from tpuslam_torch import sim

CONSTANTS = sorted(k for k in vars(jcompat) if k.isupper() and not k.startswith("_"))

SCENARIOS = {
    # the bench lap (bench.py:34-38) and the skidpad lap of the pipeline tests
    "bench": (lambda m: m.trackdrive(seed=11),
              dict(laps=1.4, keyframe_dt=0.1, speed=8.0, max_range=20.0, seed=12)),
    "skidpad": (lambda m: m.skidpad(), dict(laps=1.3, seed=2)),
    "acceleration": (lambda m: m.acceleration(), dict(laps=1.0, seed=4)),
}
ARRAYS = ("obs", "obs_valid", "odom_poses", "gt_poses", "times", "yaw_rates")


def test_compat_has_every_constant():
    assert CONSTANTS
    assert CONSTANTS == sorted(k for k in vars(compat) if k.isupper() and not k.startswith("_"))


@pytest.mark.parametrize("name", CONSTANTS)
def test_compat_constant_equal(name):
    got, want = getattr(compat, name), getattr(jcompat, name)
    assert type(got) is type(want) and got == want


def test_compat_quirk_transforms_equal():
    rng = np.random.default_rng(0)
    heading = rng.uniform(-7.0, 7.0, 257)
    cone = rng.uniform(-40.0, 40.0, (257, 2))
    pose = np.concatenate([rng.uniform(-40.0, 40.0, (257, 2)), heading[:, None]], axis=1)
    np.testing.assert_array_equal(compat.remap_north_heading(heading),
                                  jcompat.remap_north_heading(heading))
    np.testing.assert_array_equal(compat.outbound_azimuth_deg(cone, pose),
                                  jcompat.outbound_azimuth_deg(cone, pose))


def _both(name):
    track_of, kw = SCENARIOS[name]
    t_port, t_jax = track_of(sim), track_of(jsim)
    return (t_port, sim.simulate(t_port, sim.SimConfig(**kw)),
            t_jax, jsim.simulate(t_jax, jsim.SimConfig(**kw)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulate_bit_equal(name):
    t_port, s_port, t_jax, s_jax = _both(name)
    for f in ("cones_xy", "cones_type", "centerline", "headings", "arclength"):
        np.testing.assert_array_equal(getattr(t_port, f), getattr(t_jax, f), err_msg=f)
    assert (t_port.name, t_port.closed) == (t_jax.name, t_jax.closed)
    for f in ARRAYS:
        got, want = getattr(s_port, f), getattr(s_jax, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert s_port.meta == s_jax.meta


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ate_agrees(name):
    _, s_port, _, s_jax = _both(name)
    rng = np.random.default_rng(1)
    est = s_jax.gt_poses[:, :2] + rng.normal(0, 0.2, s_jax.gt_poses[:, :2].shape)
    assert sim.ate(est, s_port.gt_poses[:, :2]) == jate(est, s_jax.gt_poses[:, :2])
    assert sim.ate(s_port.odom_poses[:, :2], s_port.gt_poses[:, :2]) == \
        jate(s_jax.odom_poses[:, :2], s_jax.gt_poses[:, :2])
