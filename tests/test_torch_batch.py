"""The port's per-frame batched engine (`tpuslam_torch.parallel.batch`:
`run_sequences_batched`, `run_passes_batched`) against the port's own
per-session `run_sequence` and the JAX package's batched engine, on the CPU.

Mirrors tests/test_parallel.py::test_batched_sessions_match_sequential and
::test_batched_sessions_improved_windowed_gn with their tolerances (1e-5
against the per-session runs; the closure frame's published pose under
`mapping_publish_refine` within 0.3, the JAX package's documented one-frame
deviation, every other frame within 2e-5), and holds the port to the JAX
package's batched run: decisions exact, values within the pipeline tests'
1e-3 (sums in another order after the closure GN).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.parallel.batch import initial_states as jinitial_states
from tpuslam.parallel.batch import run_sequences_batched as jrun_batched
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.keyframe import perform_keyframe
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import initial_state, session_state, state_to_numpy
from tpuslam_torch.parallel.batch import initial_states, run_passes_batched, run_sequences_batched
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, simulate, skidpad

CAP = (64, 128, 2048)
SEQ_ATOL, REFINE_ATOL, DEVIATION_M = 1e-5, 2e-5, 0.3
JAX_ATOL = 1e-3
# the configurations tests/test_parallel.py runs, held to the JAX package's
# batched run too; the others to the port's per-session runs
MIRRORED = ("compat", "improved")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seeds=(1, 2)):
    scens = [simulate(skidpad(), SimConfig(laps=1.1, keyframe_dt=0.25, seed=s)) for s in seeds]
    t = min(len(sc.times) for sc in scens)
    return (np.stack([sc.obs[:t] for sc in scens]).astype(np.float32),
            np.stack([sc.obs_valid[:t] for sc in scens]),
            np.stack([sc.odom_poses[:t] for sc in scens]).astype(np.float32))


def _cfgs(name):
    if name == "compat":
        return SlamConfig(capacity=GraphCapacity(*CAP)), JCfg(capacity=JCap(*CAP))
    if name == "improved":
        return (SlamConfig.improved(capacity=GraphCapacity(*CAP)),
                JCfg.improved(capacity=JCap(*CAP)))
    if name == "nearest_kernel":
        kw = dict(association="nearest", use_pallas_association=True)
        return SlamConfig(capacity=GraphCapacity(*CAP), **kw), JCfg(capacity=JCap(*CAP), **kw)
    if name == "full_batch_periodic":
        kw = dict(periodic_gn_every=4, periodic_gn_window=0)
        return (SlamConfig.improved(capacity=GraphCapacity(*CAP), **kw),
                JCfg.improved(capacity=JCap(*CAP), **kw))
    kw = dict(vectorized_mapping=False)
    return SlamConfig(capacity=GraphCapacity(*CAP), **kw), JCfg(capacity=JCap(*CAP), **kw)


def _port(cfg, ins):
    return run_sequences_batched(initial_states(cfg.capacity, ins[0].shape[0], "cpu"),
                                 *(torch.tensor(x) for x in ins), cfg)


def _np_tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _edges_to_n_obs(state):
    """A state dict with each session's edge rows cut at its n_obs: past it
    the per-frame step leaves the rows it dropped, the blocks none."""
    g = state["graph"]
    n = np.asarray(g["n_obs"]).reshape(-1)
    for k in ("obs_pose", "obs_lm", "obs_xy"):
        x = g[k].reshape(len(n), *g[k].shape[-(2 if k == "obs_xy" else 1):])
        g[k] = [x[s, :n[s]] for s in range(len(n))]
    return state


def _assert_like(got, want, atol, what):
    if isinstance(want, list):
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_like({"x": a}, {"x": b}, atol, f"{what}[{i}]")
        return
    for k, w in want.items():
        if isinstance(w, (dict, list)):
            _assert_like(got[k], w, atol, f"{what}.{k}")
        elif w.dtype.kind in "fc":
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what}.{k}")


@pytest.mark.parametrize("name", ["compat", "nearest_kernel", "scan_form"])
def test_batched_sessions_match_sequential(name):
    """tests/test_parallel.py::test_batched_sessions_match_sequential: each
    session's published poses and landmarks within 1e-5 of its own
    `run_sequence`, closure and landmark count equal; and, for the JAX
    test's configuration, the whole run equal to the JAX package's batched
    run (decisions exact, values 1e-3). The kernel configuration gates
    through the association kernel's plain twin here; the scan-form
    mapping step steps the sessions together."""
    cfg, jcfg = _cfgs(name)
    ins = _inputs()
    fin, outs = _port(cfg, ins)
    for s in range(2):
        st, out1 = run_sequence(initial_state(cfg.capacity, "cpu"),
                                *(torch.tensor(x[s]) for x in ins), cfg)
        np.testing.assert_allclose(out1.pose.numpy(), outs.pose[s].numpy(), atol=SEQ_ATOL)
        np.testing.assert_allclose(st.graph.lm_xy.numpy(), fin.graph.lm_xy[s].numpy(),
                                   atol=SEQ_ATOL)
        assert bool(st.loop_closure_complete) == bool(fin.loop_closure_complete[s])
        assert int(st.graph.n_landmarks) == int(fin.graph.n_landmarks[s])
        for f in ("send", "loop_closed", "cone_type", "n_landmarks"):
            assert torch.equal(getattr(out1, f), getattr(outs, f)[s]), f
    if name not in MIRRORED:
        return
    jfin, jouts = jrun_batched(jinitial_states(jcfg.capacity, 2),
                               *(jnp.asarray(x) for x in ins), jcfg)
    _assert_like(_np_tree(outs), _np_tree(jax.tree.map(np.asarray, jouts)), JAX_ATOL, "outputs")
    _assert_like(_edges_to_n_obs(state_to_numpy(fin)),
                 _edges_to_n_obs(_np_tree(jax.tree.map(np.asarray, jfin))), JAX_ATOL, "state")


@pytest.mark.parametrize("name", ["improved", "full_batch_periodic"])
def test_batched_sessions_improved_windowed_gn(name):
    """tests/test_parallel.py::test_batched_sessions_improved_windowed_gn:
    the improved mode (the fixed-lag periodic GN within the frame; and the
    full-batch periodic GN, deferred after the frame): every frame but the
    closure frame within 2e-5 of the per-session run, that one within 0.3
    (its publish refine sees the map before the deferred closure GN);
    closure and landmark count equal; for the JAX test's configuration,
    equal to the JAX package's batched run (decisions exact, values
    1e-3)."""
    cfg, jcfg = _cfgs(name)
    assert cfg.periodic_gn_every > 0
    ins = _inputs()
    fin, outs = _port(cfg, ins)
    for s in range(2):
        st, out1 = run_sequence(initial_state(cfg.capacity, "cpu"),
                                *(torch.tensor(x[s]) for x in ins), cfg)
        d = (out1.pose - outs.pose[s]).abs().numpy()
        kc = np.flatnonzero(out1.loop_closed.numpy())
        mask = np.ones(d.shape[0], bool)
        mask[kc] = False
        assert float(d[mask].max()) < REFINE_ATOL, float(d[mask].max())
        assert float(d.max()) < DEVIATION_M
        assert bool(st.loop_closure_complete) == bool(fin.loop_closure_complete[s])
        assert int(st.graph.n_landmarks) == int(fin.graph.n_landmarks[s])
    if name not in MIRRORED:
        return
    jfin, jouts = jrun_batched(jinitial_states(jcfg.capacity, 2),
                               *(jnp.asarray(x) for x in ins), jcfg)
    _assert_like(_np_tree(outs), _np_tree(jax.tree.map(np.asarray, jouts)), JAX_ATOL, "outputs")
    _assert_like(_edges_to_n_obs(state_to_numpy(fin)),
                 _edges_to_n_obs(_np_tree(jax.tree.map(np.asarray, jfin))), JAX_ATOL, "state")


def test_one_session_equals_run_sequence():
    """S = 1 in the compat configuration is bit-equal to `run_sequence`
    (the same ops, the closure GN on the single graph's buckets), but for
    the closure frame's cone packet, which the deferred closure GN leaves
    computed from the map before it, as in the JAX package."""
    cfg, _ = _cfgs("compat")
    ins = [x[:1] for x in _inputs()]
    fin, outs = _port(cfg, ins)
    st, out1 = run_sequence(initial_state(cfg.capacity, "cpu"),
                            *(torch.tensor(x[0]) for x in ins), cfg)
    kc = torch.nonzero(out1.loop_closed).flatten()
    assert len(kc) == 1
    keep = torch.ones(len(out1.pose), dtype=torch.bool)
    keep[kc] = False
    for f in dataclasses.fields(out1):
        a, b = getattr(out1, f.name), getattr(outs, f.name)[0]
        if f.name in ("cone_azimuth", "cone_distance"):
            a, b = a[keep], b[keep]
        assert torch.equal(a, b), f.name
    want = state_to_numpy(st)
    got = state_to_numpy(session_state(fin, 0))
    for k in ("current_cone_index", "loop_closure_complete", "keyframe_count"):
        np.testing.assert_array_equal(got[k], want[k])
    n = int(want["graph"]["n_obs"])
    for k, v in want["graph"].items():
        a = got["graph"][k]
        if k in ("obs_pose", "obs_lm", "obs_xy"):
            a, v = a[:n], v[:n]
        np.testing.assert_array_equal(a, v, err_msg=k)


def test_passes_batched_fresh_states_and_fallbacks():
    """`run_passes_batched` on the CPU from fresh states equals
    `run_sequences_batched`; a session whose first frame leaves its
    first observation slot invalid (the blocks' bootstrap fallback) and a
    pose capacity the frames outgrow (the full-graph fallback) step those
    frames through `perform_keyframe` alone and still equal their own
    `run_sequence`; zero frames give [S, 0] outputs."""
    obs, valid, poses = _inputs()
    valid = valid.copy()
    first = np.flatnonzero(valid[1, 0])
    valid[1, 0, 0] = False
    assert len(first) > 1
    cfg = SlamConfig(capacity=GraphCapacity(24, 128, 2048))
    fin, outs = run_passes_batched(obs, valid, poses, cfg, device="cpu")
    fin2, outs2 = _port(cfg, (obs, valid, poses))
    assert torch.equal(outs.pose, outs2.pose) and torch.equal(fin.graph.poses, fin2.graph.poses)
    for s in range(2):
        st, out1 = run_sequence(initial_state(cfg.capacity, "cpu"), torch.tensor(obs[s]),
                                torch.tensor(valid[s]), torch.tensor(poses[s]), cfg)
        np.testing.assert_allclose(out1.pose.numpy(), outs.pose[s].numpy(), atol=SEQ_ATOL)
        assert int(st.graph.n_landmarks) == int(fin.graph.n_landmarks[s])
        assert int(st.graph.n_poses) == int(fin.graph.n_poses[s]) == 24
        assert torch.equal(out1.cone_type, outs.cone_type[s])
    fin0, outs0 = run_passes_batched(obs[:, :0], valid[:, :0], poses[:, :0], cfg, device="cpu")
    assert outs0.pose.shape == (2, 0, 3) and outs0.send.shape == (2, 0)


def test_defer_gn_flags_what_the_keyframe_would_run():
    """`perform_keyframe(defer_gn=True)` returns the closure and the
    full-batch periodic GN it wants instead of running them: replaying a
    session with the deferred GNs run after each frame gives the
    per-frame run's state."""
    import tpuslam_torch.backend.gauss_newton as gn
    from tpuslam_torch.frontend.keyframe import _gn_config, _periodic_gn_config
    cfg, _ = _cfgs("full_batch_periodic")
    obs, valid, poses = (torch.tensor(x[0]) for x in _inputs())
    st = initial_state(cfg.capacity, "cpu")
    wanted = {"closure": 0, "periodic": 0}
    for t in range(obs.shape[0]):
        st, out, wc, wp = perform_keyframe(st, obs[t], valid[t], poses[t], cfg, defer_gn=True)
        assert wc.dim() == wp.dim() == 0 and bool(wc) == bool(out.loop_closed)
        if bool(wc):
            wanted["closure"] += 1
            st = dataclasses.replace(st, graph=gn.optimize(st.graph, _gn_config(cfg)))
        elif bool(wp):
            wanted["periodic"] += 1
            st = dataclasses.replace(st, graph=gn.optimize(st.graph, _periodic_gn_config(cfg)))
    want, _ = run_sequence(initial_state(cfg.capacity, "cpu"), obs, valid, poses, cfg)
    assert wanted["closure"] == 1 and wanted["periodic"] > 0
    np.testing.assert_allclose(st.graph.poses.numpy(), want.graph.poses.numpy(), atol=SEQ_ATOL)
    assert int(st.graph.n_landmarks) == int(want.graph.n_landmarks)


def test_scan_form_steps_sessions_batched(monkeypatch):
    """Under the scan-form mapping step the sessions still mapping are
    stepped together (`keyframe._mapping_step` over [S, L]): no frame goes
    through `perform_keyframe` but a fallback's. On the skidpad pair none
    does; with a pose capacity the frames outgrow, exactly the frames after
    a session's pose store is full do, and each session still equals its
    own `run_sequence` (within 1e-5, closure and counts exact)."""
    import tpuslam_torch.parallel.batch as batch
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return perform_keyframe(*a, **k)

    monkeypatch.setattr(batch, "perform_keyframe", counted)
    cfg, _ = _cfgs("scan_form")
    ins = _inputs()
    _port(cfg, ins)
    assert not calls
    small = dataclasses.replace(cfg, capacity=GraphCapacity(24, 128, 2048))
    fin, outs = _port(small, ins)
    T = ins[0].shape[1]
    assert len(calls) == 2 * (T - 24), (len(calls), T)
    for s in range(2):
        st, out1 = run_sequence(initial_state(small.capacity, "cpu"),
                                *(torch.tensor(x[s]) for x in ins), small)
        np.testing.assert_allclose(out1.pose.numpy(), outs.pose[s].numpy(), atol=SEQ_ATOL)
        np.testing.assert_allclose(st.graph.lm_xy.numpy(), fin.graph.lm_xy[s].numpy(),
                                   atol=SEQ_ATOL)
        assert bool(st.loop_closure_complete) == bool(fin.loop_closure_complete[s])
        assert int(st.graph.n_landmarks) == int(fin.graph.n_landmarks[s])
        assert torch.equal(out1.cone_type, outs.cone_type[s])


def test_one_session_scan_form_equals_run_sequence():
    """S = 1 under the scan-form mapping step is bit-equal to `run_sequence`
    (the per-frame engine's `_mapping_step` is the same function at S = 1),
    but for the closure frame's cone packet, which the deferred closure GN
    leaves computed from the map before it."""
    cfg, _ = _cfgs("scan_form")
    ins = [x[:1] for x in _inputs()]
    fin, outs = _port(cfg, ins)
    st, out1 = run_sequence(initial_state(cfg.capacity, "cpu"),
                            *(torch.tensor(x[0]) for x in ins), cfg)
    kc = torch.nonzero(out1.loop_closed).flatten()
    assert len(kc) == 1
    keep = torch.ones(len(out1.pose), dtype=torch.bool)
    keep[kc] = False
    for f in dataclasses.fields(out1):
        a, b = getattr(out1, f.name), getattr(outs, f.name)[0]
        if f.name in ("cone_azimuth", "cone_distance"):
            a, b = a[keep], b[keep]
        assert torch.equal(a, b), f.name
    want = state_to_numpy(st)
    got = state_to_numpy(session_state(fin, 0))
    for k in ("current_cone_index", "loop_closure_complete", "keyframe_count"):
        np.testing.assert_array_equal(got[k], want[k])
    n = int(want["graph"]["n_obs"])
    for k, v in want["graph"].items():
        a = got["graph"][k]
        if k in ("obs_pose", "obs_lm", "obs_xy"):
            a, v = a[:n], v[:n]
        np.testing.assert_array_equal(a, v, err_msg=k)
