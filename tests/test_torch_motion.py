"""The port's motion models (`tpuslam_torch.frontend.motion`) and WGS84
projection (`tpuslam_torch.geometry.wgs84`) against the JAX package's, and
tests/test_motion.py's cases on the port.

Tolerances: the EKF is float32 in both packages; sequences of predicts and
Joseph-form updates (whose 1x1 / 2x2 innovation inverses the port takes in
closed form, the JAX package by `jnp.linalg.inv`) stay within 1e-5 of the
JAX package's state and covariance. The float64 numpy projections are
copies and equal bit for bit; the float32 torch forward projections are
held to the JAX package's jnp forms at float32 rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuslam.frontend import motion as jmotion
from tpuslam.geometry import wgs84 as jwgs84
from tpuslam.sim import SimConfig, acceleration, simulate
from tpuslam.sim.simulator import ate
from tpuslam_torch.frontend import motion
from tpuslam_torch.geometry import wgs84

EKF_ATOL = 1e-5
REF = (57.714787, 11.948313)


def t32(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_compat_heading_correction():
    pose = t32([1.0, 2.0, 0.5])
    out = motion.compat_heading_correction(pose, 0.2, 0.5)
    np.testing.assert_allclose(out.numpy(), [1.0, 2.0, 0.5 - 0.1], atol=1e-6)
    for dt in (1.5, 0.0):
        np.testing.assert_allclose(motion.compat_heading_correction(pose, 0.2, dt).numpy(),
                                   pose.numpy(), atol=1e-6)
    for dt in (0.5, 1.5, 0.0, 0.999):
        np.testing.assert_array_equal(
            motion.compat_heading_correction(pose, 0.2, dt).numpy(),
            np.asarray(jmotion.compat_heading_correction(jnp.asarray(pose.numpy()), 0.2, dt)))


def test_ekf_converges_on_circular_motion():
    rng = np.random.default_rng(0)
    dt, v, w = 0.05, 8.0, 0.4
    ekf = motion.ekf_init(t32([0.0, 0.0, np.pi / 2]))
    errs = []
    th = np.pi / 2
    x = np.array([0.0, 0.0])
    for k in range(200):
        x = x + v * dt * np.array([np.cos(th), np.sin(th)])
        th += w * dt
        ekf = motion.ekf_predict(ekf, dt)
        if k % 2 == 0:
            ekf = motion.ekf_update_position(ekf, t32(x + rng.normal(0, 0.15, 2)), std=0.15)
        ekf = motion.ekf_update_yaw_rate(ekf, w + rng.normal(0, 0.02), std=0.02)
        if k % 10 == 0:
            ekf = motion.ekf_update_heading(ekf, th + rng.normal(0, 0.05), std=0.05)
        errs.append(np.linalg.norm(ekf.x[:2].numpy() - x))
    assert np.mean(errs[100:]) < 0.15
    assert abs(float(ekf.x[3]) - v) < 1.0
    assert abs(float(ekf.x[4]) - w) < 0.05


def test_ekf_covariance_stays_spd():
    ekf = motion.ekf_init()
    for _ in range(50):
        ekf = motion.ekf_predict(ekf, 0.1)
        ekf = motion.ekf_update_position(ekf, t32([1.0, 2.0]))
    p = ekf.p.numpy()
    np.testing.assert_allclose(p, p.T, atol=1e-4)
    assert np.all(np.linalg.eigvalsh(p) > 0)
    assert ekf.x.dtype == ekf.p.dtype == torch.float32


def test_acceleration_config_ekf_fusion_stress():
    """BASELINE config 2 on the port: EKF-fused odometry at 20 Hz denoises
    GPS for the keyframe engine."""
    scen = simulate(acceleration(), SimConfig(laps=0.95, keyframe_dt=0.05, speed=10.0,
                                              gps_noise=0.25, seed=44))
    ekf = motion.ekf_init(t32(scen.gt_poses[0]), pos_std=1.0)
    fused = []
    for k in range(len(scen.times)):
        ekf = motion.ekf_predict(ekf, 0.05)
        ekf = motion.ekf_update_position(ekf, t32(scen.odom_poses[k, :2]), std=0.25)
        ekf = motion.ekf_update_heading(ekf, float(scen.odom_poses[k, 2]), std=0.02)
        ekf = motion.ekf_update_yaw_rate(ekf, float(scen.yaw_rates[k]), std=0.02)
        fused.append(ekf.x[:3].numpy())
    fused = np.stack(fused)
    ate_gps = ate(scen.odom_poses[:, :2], scen.gt_poses[:, :2])
    ate_ekf = ate(fused[20:, :2], scen.gt_poses[20:, :2])
    assert ate_ekf < 0.75 * ate_gps, (ate_ekf, ate_gps)


def test_orchestrator_ekf_fusion_end_to_end():
    """The port's Slam with use_ekf_fusion processes a skidpad lap and
    closes the loop (tests/test_motion.py:80-96)."""
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.core.slam import Slam
    from tpuslam_torch.runtime.config import SlamConfig
    from tpuslam_torch.sim import SimConfig as PSimConfig, simulate as psimulate, skidpad
    track = skidpad()
    scen = psimulate(track, PSimConfig(laps=1.3, seed=51, keyframe_dt=0.1))
    slam = Slam(SlamConfig(capacity=GraphCapacity(128, 64, 2048), use_ekf_fusion=True),
                device="cpu")
    slam.run_scenario(scen)
    assert slam.loop_closure_complete
    lm, _ = slam.draw_cones()
    d = np.linalg.norm(lm[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1)
    assert np.median(d) < 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ekf_sequence_matches_jax(seed):
    """A random sequence of predicts (random dt) and the three updates, from
    a random start, through both packages: state and covariance within
    EKF_ATOL after every step."""
    rng = np.random.default_rng(seed)
    pose = rng.normal(0, 5, 3).astype(np.float32)
    j = jmotion.ekf_init(jnp.asarray(pose), pos_std=2.0, heading_std=0.3)
    p = motion.ekf_init(torch.tensor(pose), pos_std=2.0, heading_std=0.3)
    for step in range(120):
        kind = rng.integers(0, 4)
        if kind == 0:
            dt = float(rng.uniform(0.001, 0.2))
            j, p = jmotion.ekf_predict(j, dt), motion.ekf_predict(p, dt)
        elif kind == 1:
            xy = (p.x[:2].numpy() + rng.normal(0, 0.5, 2)).astype(np.float32)
            std = float(rng.uniform(0.1, 1.0))
            j = jmotion.ekf_update_position(j, jnp.asarray(xy), std=std)
            p = motion.ekf_update_position(p, torch.tensor(xy), std=std)
        elif kind == 2:
            h = float(rng.uniform(-4, 4))
            j, p = jmotion.ekf_update_heading(j, h), motion.ekf_update_heading(p, h)
        else:
            w = float(rng.normal(0, 0.5))
            j, p = jmotion.ekf_update_yaw_rate(j, w), motion.ekf_update_yaw_rate(p, w)
        np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), atol=EKF_ATOL, rtol=0,
                                   err_msg=f"x after step {step}")
        np.testing.assert_allclose(p.p.numpy(), np.asarray(j.p), atol=EKF_ATOL, rtol=1e-5,
                                   err_msg=f"p after step {step}")


def _geodetic(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([REF[0] + rng.uniform(-0.01, 0.01, n), REF[1] + rng.uniform(-0.01, 0.01, n)],
                    axis=-1)


def test_wgs84_host_functions_equal_jax():
    pos = _geodetic(0, 64)
    np.testing.assert_array_equal(wgs84.to_cartesian(REF, pos), jwgs84.to_cartesian(REF, pos))
    xy = wgs84.to_cartesian(REF, pos)
    for p, want in zip(xy[:8], pos[:8]):
        np.testing.assert_array_equal(wgs84.from_cartesian(REF, p), jwgs84.from_cartesian(REF, p))
        np.testing.assert_allclose(wgs84.from_cartesian(REF, p), want, atol=1e-10, rtol=0)
    for p in xy[:3]:
        np.testing.assert_array_equal(wgs84.from_cartesian_compat(REF, p),
                                      jwgs84.from_cartesian_compat(REF, p))
    # the equator branch
    eq = np.array([[0.0, 11.95], [1e-12, 11.9]])
    np.testing.assert_array_equal(wgs84.to_cartesian((0.0, 11.948313), eq),
                                  jwgs84.to_cartesian((0.0, 11.948313), eq))


def test_wgs84_torch_forward_matches_jax():
    pos = _geodetic(1, 64)
    want = np.asarray(jwgs84.to_cartesian_jnp(jnp.asarray(REF, jnp.float32),
                                              jnp.asarray(pos, jnp.float32)))
    got = wgs84.to_cartesian_torch(torch.tensor(REF, dtype=torch.float32),
                                   torch.tensor(pos, dtype=torch.float32)).numpy()
    assert got.dtype == np.float32
    # f32 evaluates the meridional arc at ~6.4e6 m scale: a few f32 ulps there
    np.testing.assert_allclose(got, want, atol=2.0, rtol=0)
    exact = wgs84.to_cartesian(REF, pos)
    assert np.abs(got - exact).max() < 2.0


def test_local_projector_matches_jax_and_float64():
    pos = _geodetic(2, 256)
    d = (pos - np.asarray(REF)).astype(np.float32)
    want = np.asarray(jwgs84.local_projector(REF)(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1])))
    got = wgs84.local_projector(REF)(torch.tensor(d[:, 0]), torch.tensor(d[:, 1])).numpy()
    # the two libraries' float32 sin / cos differ in the last bit, which the
    # 6.4e6 m radius turns into millimetres
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    # against the float64 projection of the same (float32-rounded) offsets,
    # a kilometre from the reference: no farther than the JAX package's
    exact = wgs84.to_cartesian(REF, np.asarray(REF) + d.astype(np.float64))
    assert np.abs(got - exact).max() <= np.abs(want - exact).max() + 1e-2
