"""`chip_smoke.FUSION_REFERENCE` recomputed: bench.py's fusion section
(`chip_smoke.fusion_scenario`, 8 improved-mode sessions at block 16, the
drifted variant, `fuse_sessions`) at its full size through the JAX package
(the Pallas kernel in interpret mode for the kernel configuration) and
through the port on the CPU, in both configurations of `chip_smoke.py`'s
phase `fusion`. The discrete half (each session's closure frame, landmark
and edge counts, the fused landmark and cross-session merge counts) must
equal the constant exactly: tier-1 recomputes it with the port in both
configurations and with the JAX package in bench.py's dense one. The map
errors need bench.py's joint GN over the fused graph, a reduced system of
n = 9216 (~40 s per fusion for the JAX package on the CPU), so that half,
which also recomputes the discrete half with the JAX package's kernel
configuration, is marked `slow`: tier-1 deselects it, and it runs with
`python -m pytest -m slow tests/test_torch_fusion_reference.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpuslam.backend import gauss_newton as jgn
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.frontend import blocked as jblocked
from tpuslam.parallel import fusion as jfusion
from tpuslam.parallel.batch import initial_states as jax_initial_states
from tpuslam.runtime.config import SlamConfig as JCfg

DISCRETE = ("closure_frame", "n_landmarks", "n_obs", "fused_landmarks", "cross_session_merges",
            "drifted", "fused_landmarks_drifted", "cross_session_merges_drifted")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs():
    track = chip_smoke.trackdrive(seed=11)
    obs, valid, poses, t = chip_smoke.fusion_scenario(track)
    return track, (obs, valid, poses), chip_smoke.drifted_poses(poses), t


def _jax_flow(track, cfg, ins, poses_d, joint_gn):
    """bench.py:663-800 on the JAX package, in the layout of FUSION_REFERENCE."""
    c = cfg.capacity
    jcfg = JCfg.improved(capacity=JCap(c.max_poses, c.max_landmarks, c.max_obs),
                         association="mahalanobis", periodic_gn_every=16,
                         use_pallas_association=cfg.use_pallas_association)
    g = chip_smoke.fusion_gn_config(cfg)
    fcfg = jgn.GNConfig(odo_info=g.odo_info, lm_info=g.lm_info, iterations=g.iterations,
                        fix_first_poses=0, fix_first_landmarks=0, solve_bucket_step=0,
                        edge_bucket_step=0, early_exit_tol=g.early_exit_tol) if joint_gn else None
    S = ins[0].shape[0]
    obs, valid, poses = (jnp.asarray(x) for x in ins)
    sts, outs, done = jblocked.blocked_core_batched(jax_initial_states(jcfg.capacity, S), obs,
                                                    valid, poses, jcfg, chip_smoke.FUSION_BLOCK)
    assert np.asarray(done).tolist() == [obs.shape[1]] * S
    gate = jcfg.same_cone_threshold
    fused, rep = jfusion.fuse_sessions(sts.graph, cfg=fcfg, gate=gate, lm_info=sts.lm_info_xy,
                                       align=False)
    sts_d, outs_d = jblocked.run_sequences_blocked_batched(
        jax_initial_states(jcfg.capacity, S), obs, valid, jnp.asarray(poses_d), jcfg,
        chip_smoke.FUSION_BLOCK)
    fused_d, rep_d = jfusion.fuse_sessions(sts_d.graph, cfg=fcfg, gate=2.0 * gate,
                                           lm_info=sts_d.lm_info_xy, align=True, robust=True)

    def per_session(st, out):
        closes = [np.flatnonzero(lc) for lc in np.asarray(out.loop_closed)]
        return dict(closure_frame=[int(x[0]) if len(x) else -1 for x in closes],
                    n_landmarks=np.asarray(st.graph.n_landmarks).tolist(),
                    n_obs=np.asarray(st.graph.n_obs).tolist())

    def map_error(f):
        lm = np.asarray(f.lm_xy)[:int(f.n_landmarks)]
        return float(np.median(np.linalg.norm(lm[:, None, :] - track.cones_xy[None],
                                              axis=-1).min(axis=1)))

    got = dict(per_session(sts, outs), fused_landmarks=int(fused.n_landmarks),
               cross_session_merges=int(rep["n_cross_session_merges"]),
               drifted=per_session(sts_d, outs_d), fused_landmarks_drifted=int(fused_d.n_landmarks),
               cross_session_merges_drifted=int(rep_d["n_cross_session_merges"]))
    if joint_gn:
        got.update(map_error_fused_m=map_error(fused), map_error_fused_drifted_m=map_error(fused_d))
    return got


def _run(name, joint_gn, package):
    """The flow's numbers from `package` ("jax" or "port")."""
    track, ins, poses_d, t = _inputs()
    cfg = chip_smoke.fusion_configs(chip_smoke.fusion_cap(t))[name]
    if package == "jax":
        return _jax_flow(track, cfg, ins, poses_d, joint_gn)
    return chip_smoke.fusion_flow(track, cfg, [torch.tensor(x) for x in ins],
                                  torch.tensor(poses_d), joint_gn=joint_gn)["metrics"]


@pytest.mark.parametrize("name,package", [("dense", "jax"), ("dense", "port"),
                                          ("kernel", "port")])
def test_fusion_reference(name, package):
    """The discrete half, from each package. The JAX package's kernel
    configuration (the Pallas kernel in interpret mode, the same numbers on
    this data) is recomputed in the `slow` half, to keep tier-1 short."""
    ref = {k: chip_smoke.FUSION_REFERENCE[k] for k in DISCRETE}
    assert _run(name, False, package) == ref


@pytest.mark.slow
@pytest.mark.parametrize("name", list(chip_smoke.FUSION_CONFIGS))
def test_fusion_reference_map_error(name):
    """The map errors after the joint GN, from both packages; and the
    discrete half again, from both."""
    want, port = _run(name, True, "jax"), _run(name, True, "port")
    ref = {k: chip_smoke.FUSION_REFERENCE[k] for k in DISCRETE}
    assert {k: want[k] for k in DISCRETE} == ref
    assert {k: port[k] for k in DISCRETE} == ref
    for k in ("map_error_fused_m", "map_error_fused_drifted_m"):
        assert abs(want[k] - chip_smoke.FUSION_REFERENCE[k]) <= 1e-6, (k, want[k])
        assert abs(port[k] - want[k]) <= chip_smoke.METRIC_ATOL_M, (k, port[k], want[k])
    chip_smoke.check_fusion(name, port)
