"""The port's per-frame engine (`run_sequence` / `run_pass`) against the JAX
package on the same inputs: the skidpad scenario of
tests/test_pallas_kernels.py and the trackdrive bench scenario that
chip_smoke.py drives on the GPU, in the reference-compat configuration
('first' association) and with association='nearest' through the
association kernel (the JAX side runs its Pallas kernel in interpret mode).

Tolerances: discrete outputs and state (association decisions, landmark
count/order/types, edge list, current-cone index, closure frame, sends,
cone-packet types) are exact. Continuous values are f32 computed by two
libraries: 1e-5 up to the loop closure; after it, the closure GN's early
exit (tol 1e-4) may stop the two after different iteration counts on a
borderline step, so 1e-3. Cone-packet azimuths are in degrees and turn a
heading difference into degrees, so they get 60x those bounds.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.frontend.pipeline import run_sequence as jax_run_sequence
from tpuslam.frontend.state import initial_state as jax_initial_state
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam.sim import SimConfig, simulate, skidpad
from tpuslam.sim.golden_frontend import GoldenSlam
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.pipeline import run_pass, run_sequence
from tpuslam_torch.frontend.state import state_from_numpy, state_to_numpy
from tpuslam_torch.runtime.config import SlamConfig

PRE_ATOL, POST_ATOL = 1e-5, 1e-3
DEG_PER_UNIT = 60.0   # azimuth tolerance per unit of pose tolerance (~180/pi)
HANDOFF_FRAME = 100


def _np_tree(x):
    return {f.name: _np_tree(getattr(x, f.name)) if dataclasses.is_dataclass(getattr(x, f.name))
            else np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _configs(cap, name):
    kw = {} if name == "first" else dict(association="nearest", use_pallas_association=True)
    return JCfg(capacity=JCap(*cap), **kw), SlamConfig(capacity=GraphCapacity(*cap), **kw)


@functools.lru_cache(maxsize=None)
def _scenario(which):
    if which == "skidpad":
        return None, simulate(skidpad(), SimConfig(laps=1.3, seed=2)), (128, 128, 4096)
    track, scen = chip_smoke.scenario()
    return track, scen, tuple(dataclasses.astuple(chip_smoke.CAP))


def _frames(scen, lo=0, hi=None):
    return scen.obs[lo:hi], scen.obs_valid[lo:hi], scen.odom_poses[lo:hi]


def _jax_run(cfg, frames, state=None):
    obs, valid, poses = frames
    state = jax_initial_state(cfg.capacity) if state is None else state
    st, out = jax_run_sequence(state, jnp.asarray(obs, jnp.float32), jnp.asarray(valid),
                               jnp.asarray(poses, jnp.float32), cfg)
    return st, out


@functools.lru_cache(maxsize=None)
def _jax_lap(which, name):
    _, scen, cap = _scenario(which)
    st, out = _jax_run(_configs(cap, name)[0], _frames(scen))
    return _np_tree(st), _np_tree(out)


def _port_run(cfg, frames, state=None):
    obs, valid, poses = (torch.tensor(np.asarray(x, np.float32)) for x in frames)
    valid = valid.bool()
    if state is None:
        st, out = run_pass(obs, valid, poses, cfg)
    else:
        st, out = run_sequence(state, obs, valid, poses, cfg)
    return st, out


def _assert_same(port, want, closure):
    """Port (state, outputs) against the JAX package's, both as numpy trees;
    `closure` is the index of the first output frame at or after the loop
    closure."""
    (ps, po), (js, jo) = port, want
    for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
        np.testing.assert_array_equal(po[f], jo[f], err_msg=f)
    for f in ("pose", "cone_distance", "cone_azimuth"):
        scale = DEG_PER_UNIT if f == "cone_azimuth" else 1.0
        np.testing.assert_allclose(po[f][:closure], jo[f][:closure], atol=PRE_ATOL * scale,
                                   rtol=0, err_msg=f)
        np.testing.assert_allclose(po[f][closure:], jo[f][closure:], atol=POST_ATOL * scale,
                                   rtol=0, err_msg=f)

    def same_tree(p, j, path):
        for k, w in j.items():
            got = p[k]
            if isinstance(w, dict):
                same_tree(got, w, path + k + ".")
                continue
            assert got.dtype == w.dtype, path + k
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(got, w, err_msg=path + k)
            else:
                atol = PRE_ATOL if k in ("odo_meas", "obs_xy", "prior_pose") else POST_ATOL
                np.testing.assert_allclose(got, w, atol=atol, rtol=0, err_msg=path + k)
    same_tree(ps, js, "")


def _closure(out):
    hits = np.flatnonzero(out["loop_closed"])
    return int(hits[0]) if len(hits) else len(out["loop_closed"])


def _check_lap(which, name):
    _, scen, cap = _scenario(which)
    want = _jax_lap(which, name)
    st, out = _port_run(_configs(cap, name)[1], _frames(scen))
    _assert_same((state_to_numpy(st), _np_tree(out)), want, _closure(want[1]))
    return st, out


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_skidpad_matches_jax(name):
    st, _ = _check_lap("skidpad", name)
    assert bool(st.loop_closure_complete)


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_trackdrive_matches_jax_and_pins_smoke_constants(name):
    """The bench lap: the port equals the JAX package, and both give the
    numbers chip_smoke.py holds the GPU run to."""
    track, scen, _ = _scenario("trackdrive")
    st, out = _check_lap("trackdrive", name)
    js, jo = _jax_lap("trackdrive", name)
    jax_state = state_from_numpy(js, "cpu")
    jax_out = dataclasses.replace(out, **{k: torch.tensor(v) for k, v in jo.items()})
    want = chip_smoke.REFERENCE[name]
    for metrics, atol in ((chip_smoke.lap_metrics(track, scen, jax_state, jax_out), 1e-6),
                          (chip_smoke.lap_metrics(track, scen, st, out),
                           chip_smoke.METRIC_ATOL_M)):
        for k, v in want.items():
            if isinstance(v, int):
                assert metrics[k] == v, (k, metrics[k], v)
            else:
                assert abs(metrics[k] - v) <= atol, (k, metrics[k], v)


def test_state_handoff_from_jax_at_frame_100():
    """The JAX package runs the first 100 frames; its state crosses over
    through numpy and the port finishes the lap — ending where the JAX
    package's own full lap ends."""
    _, scen, cap = _scenario("trackdrive")
    jcfg, cfg = _configs(cap, "first")
    jst, _ = _jax_run(jcfg, _frames(scen, 0, HANDOFF_FRAME))
    handed = _np_tree(jst)
    state = state_from_numpy(handed, "cpu")
    assert _np_equal(state_to_numpy(state), handed)
    st, out = _port_run(cfg, _frames(scen, HANDOFF_FRAME), state)
    js, jo = _jax_lap("trackdrive", "first")
    tail = {k: v[HANDOFF_FRAME:] for k, v in jo.items()}
    _assert_same((state_to_numpy(st), _np_tree(out)), (js, tail), _closure(tail))


def test_zero_frames_matches_jax():
    """T = 0: the state comes back unchanged and every output has a leading
    axis of 0, with the JAX package's dtypes and trailing shapes."""
    _, scen, cap = _scenario("skidpad")
    jcfg, cfg = _configs(cap, "first")
    js, jo = _jax_run(jcfg, _frames(scen, 0, 0))
    st, out = _port_run(cfg, _frames(scen, 0, 0))
    assert _np_equal(state_to_numpy(st), _np_tree(js))
    got, want = _np_tree(out), _np_tree(jo)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, (k, got[k], w)


def _np_equal(a, b):
    """Same keys, dtypes and values, nested."""
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(_np_equal(a[k], b[k]) for k in b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_mapping_matches_golden_frontend():
    """As tests/test_compat_oracle.py holds the JAX engine: the port against
    the NumPy golden frontend that mirrors the reference control flow."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=7))
    cfg = SlamConfig(capacity=GraphCapacity(128, 64, 2048))
    gold = GoldenSlam(same_cone_threshold=cfg.same_cone_threshold,
                      cone_mapping_threshold=cfg.cone_mapping_threshold,
                      loop_radius=cfg.loop_closure_radius,
                      loop_min_index=cfg.loop_closure_min_index,
                      gn_iterations=cfg.gn_iterations)
    for t in range(len(scen.times)):
        gold.process_frame(scen.obs[t], scen.obs_valid[t], scen.odom_poses[t])
    st, _ = _port_run(cfg, _frames(scen))
    assert bool(st.loop_closure_complete) == gold.loop_closure_complete
    g = st.graph
    n = int(g.n_landmarks)
    assert n == len(gold.graph.landmarks)
    np.testing.assert_allclose(g.lm_xy[:n].numpy(), gold.landmarks, atol=2e-2)
    np.testing.assert_array_equal(g.lm_type[:n].numpy(), np.array(gold.map_type))
    assert int(st.current_cone_index) == gold.current_cone_index
    poses = g.poses[:int(g.n_poses)].numpy()
    np.testing.assert_allclose(poses[:, :2], np.stack(gold.graph.poses)[:, :2], atol=2e-2)
