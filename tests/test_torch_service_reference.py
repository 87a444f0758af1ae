"""The constants `chip_smoke.py` holds the live service and the lidar
front-end to on the GPU, recomputed on the CPU with the JAX package (the
reference) and with the port:

- SERVICE_REFERENCE: the bench lap written as a .rec by each package's
  `scenario_to_rec` and replayed through its `SlamService`, in both
  SERVICE_CONFIGS (the JAX package runs its Pallas kernel in interpret
  mode). The port's replay equals its direct `Slam.run_scenario` bit for
  bit, every keyframe's outputs and every published message.
- EKF_REFERENCE: BASELINE config 2 through each package's EKF, and the
  skidpad lap through `Slam(use_ekf_fusion=True)`.
- VLP16_REFERENCE: bench.py's two vlp16_frontend scenes through the JAX
  package's `detect_cones` with its seed-0 triples (which the constants
  hold), and through the port's at its default seed, whose `ransac_triples`
  are the same.

Tolerances: counts exact; the JAX numbers within 1e-6 of the constants
(rounded to 6 places), the port's within METRIC_ATOL_M (ATEs, map error)
and VLP16_ATOL (cone tuples), as on the card.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.core.slam import Slam as JSlam
from tpuslam.frontend import motion as jmotion
from tpuslam.perception import AttentionConfig as JAttentionConfig, detect_cones as jdetect
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam.runtime.service import SlamService as JService, scenario_to_rec as jscenario_to_rec
from tpuslam.sim import SimConfig, acceleration, simulate, skidpad
from tpuslam.sim.simulator import ate
from tpuslam_torch.perception.attention import detect_cones, ransac_triples

JAX_ATOL = 1e-6


def check(got, want, atol):
    chip_smoke.check_metrics("reference", got, want, atol)


class _JaxRecorder:
    """The JAX package's `Slam`, recorded as `chip_smoke.Recorder` records
    the port's."""

    def __init__(self, slam):
        self.outs = []
        inner = slam.process_frame

        def process_frame(*a, **kw):
            out = inner(*a, **kw)
            self.outs.append(out)
            return out

        slam.process_frame = process_frame

    def stacked(self):
        return {k: torch.tensor(np.stack([np.asarray(getattr(o, k)) for o in self.outs]))
                for k in ("pose", "send", "loop_closed")}


@pytest.mark.parametrize("name", list(chip_smoke.SERVICE_CONFIGS))
def test_service_reference(tmp_path, name):
    _, scen = chip_smoke.scenario()
    cfg = JCfg(capacity=JCap(*dataclasses.astuple(chip_smoke.CAP)),
               time_between_keyframes_ms=chip_smoke.SERVICE_KEYFRAME_MS,
               **chip_smoke.SERVICE_CONFIGS[name])
    rec = str(tmp_path / "lap.rec")
    jscenario_to_rec(scen, rec, cfg)
    svc = JService(cfg)
    recorder = _JaxRecorder(svc.slam)
    svc.run_replay(rec)
    check(chip_smoke.service_metrics(scen, svc.slam, recorder.stacked()),
          chip_smoke.SERVICE_REFERENCE, JAX_ATOL)

    psvc, prec = chip_smoke.service_replay(chip_smoke.service_config(name), scen, "cpu")
    outs = prec.stacked()
    check(chip_smoke.service_metrics(scen, psvc.slam, outs), chip_smoke.SERVICE_REFERENCE,
          chip_smoke.METRIC_ATOL_M)
    direct = chip_smoke.Slam(chip_smoke.service_config(name), device="cpu")
    drec = chip_smoke.Recorder(direct)
    direct.run_scenario(scen)
    chip_smoke.compare_outputs("replay vs direct", outs, drec.stacked(), atol=0.0)
    chip_smoke.compare_published("replay vs direct", prec.published, drec.published,
                                 direct._gps_ref)
    assert [m[0] for m in prec.published] == [m[0] for m in drec.published]


def test_ekf_reference():
    ref = chip_smoke.EKF_REFERENCE
    scen = simulate(acceleration(), SimConfig(**chip_smoke.EKF_ACCEL_SIM))
    ekf = jmotion.ekf_init(jnp.asarray(scen.gt_poses[0]), pos_std=1.0)
    fused = []
    for k in range(len(scen.times)):
        ekf = jmotion.ekf_predict(ekf, 0.05)
        ekf = jmotion.ekf_update_position(ekf, jnp.asarray(scen.odom_poses[k, :2]), std=0.25)
        ekf = jmotion.ekf_update_heading(ekf, float(scen.odom_poses[k, 2]), std=0.02)
        ekf = jmotion.ekf_update_yaw_rate(ekf, float(scen.yaw_rates[k]), std=0.02)
        fused.append(np.asarray(ekf.x[:3]))
    fused = np.stack(fused)
    want = {k: ref[k] for k in ("accel_ate_gps", "accel_ate_ekf")}
    check(dict(accel_ate_gps=ate(scen.odom_poses[:, :2], scen.gt_poses[:, :2]),
               accel_ate_ekf=ate(fused[20:, :2], scen.gt_poses[20:, :2])), want, JAX_ATOL)
    ate_gps, ate_ekf, port_fused = chip_smoke.ekf_accel("cpu")
    check(dict(accel_ate_gps=ate_gps, accel_ate_ekf=ate_ekf), want, chip_smoke.METRIC_ATOL_M)
    np.testing.assert_allclose(port_fused, fused, atol=1e-5, rtol=0)

    track = skidpad()
    scen = simulate(track, SimConfig(**chip_smoke.EKF_SKIDPAD_SIM))
    cap = chip_smoke.EKF_SKIDPAD_CAP
    slam = JSlam(JCfg(capacity=JCap(cap.max_poses, cap.max_landmarks, cap.max_obs),
                      use_ekf_fusion=True))
    recorder = _JaxRecorder(slam)
    slam.run_scenario(scen)
    got = chip_smoke.service_metrics(scen, slam, recorder.stacked())
    lm, _ = slam.draw_cones()
    got["map_err_median"] = float(np.median(np.linalg.norm(
        lm[:, None, :] - track.cones_xy[None], axis=-1).min(axis=1)))
    check(got, ref["skidpad"], JAX_ATOL)
    check(chip_smoke.ekf_skidpad("cpu")[0], ref["skidpad"], chip_smoke.METRIC_ATOL_M)


@pytest.mark.parametrize("name", list(chip_smoke.VLP16_REFERENCE))
def test_vlp16_reference(name):
    pts, valid, acfg = chip_smoke.vlp16_scenes()[name]
    want = chip_smoke.VLP16_REFERENCE[name]
    assert int(valid.sum()) == want["points"]
    jcfg = JAttentionConfig(**{k: getattr(acfg, k) for k in acfg.__dataclass_fields__})
    triples = np.asarray(jax.random.randint(jax.random.PRNGKey(0),
                                            (jcfg.ransac_iterations, 3), 0, len(pts)))
    assert triples.tolist() == want["triples"]
    cones, ok, n = jdetect(jnp.asarray(pts), jnp.asarray(valid), jcfg, seed=0)
    chip_smoke.check_cones(f"{name}: JAX", (torch.tensor(np.asarray(x)) for x in (cones, ok, n)),
                           want["cones"], atol=JAX_ATOL)
    assert ransac_triples(len(pts), acfg, 0, "cpu").tolist() == want["triples"]
    got = detect_cones(torch.tensor(pts), torch.tensor(valid), acfg)
    chip_smoke.check_cones(f"{name}: port", got, want["cones"])
