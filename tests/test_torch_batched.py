"""The port's batched sessions (`run_sequences_blocked_batched`, the batched
closure GN, `parallel.batch.initial_states`) against the port's own
single-session runs and against the JAX package's batched blocked pipeline.

The cases mirror tests/test_blocked_equivalence.py:250-340: three
trackdrive sessions at block 8, each equal to its own `run_sequence`
(discrete outputs exact, values within the JAX package's 2e-3, since the
batched closure GN runs at full capacity and sums in another order), and
16 sessions whose odd half trips the bootstrap fallback and is finished
per frame. The association kernel runs as its plain twin here (CPU
tensors) and the JAX package's Pallas kernel in interpret mode.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_blocked import _pose_cap, _sim
from tests.test_torch_pipeline import _configs, _np_tree
from tpuslam.frontend.blocked import (
    run_sequences_blocked_batched as jax_run_sequences_blocked_batched,
)
from tpuslam.parallel.batch import initial_states as jax_initial_states
from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import blocked
from tpuslam_torch.frontend.blocked import run_sequences_blocked_batched
from tpuslam_torch.frontend.keyframe import _gn_config
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import (
    initial_state, session_state, stack_states, state_from_numpy, state_to_numpy,
)
from tpuslam_torch.parallel.batch import initial_states
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import trackdrive

SEEDS = (11, 21, 31)
ATOL = 2e-3       # tests/test_blocked_equivalence.py:276-283


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _sessions():
    """(obs, valid, poses) numpy stacks of the three sessions, cut to the
    shortest, and the capacity tests/test_blocked_equivalence.py gives
    them (its first session's)."""
    runs = [_sim(trackdrive, seed) for seed in SEEDS]
    t = min(len(r[0]) for r in runs)
    stack = tuple(np.stack([r[k][:t] for r in runs]) for k in range(3))
    return stack, (_pose_cap(len(runs[0][0])), 256, 8192)


def _tensors(stack):
    return tuple(torch.tensor(x) for x in stack)


@functools.lru_cache(maxsize=None)
def _port_batched(name):
    stack, cap = _sessions()
    cfg = _configs(cap, name)[1]
    return run_sequences_blocked_batched(initial_states(cfg.capacity, len(SEEDS), "cpu"),
                                         *_tensors(stack), cfg, block=8)


@functools.lru_cache(maxsize=None)
def _port_single(name, s):
    stack, cap = _sessions()
    cfg = _configs(cap, name)[1]
    return run_sequence(initial_state(cfg.capacity, "cpu"), *(x[s] for x in _tensors(stack)), cfg)


def _assert_session(got, want, what):
    """A session's (state, outputs) as numpy trees against another's:
    discrete outputs exact, values within ATOL; counters, current cone and
    edge landmarks up to n_obs exact, poses and landmarks within ATOL."""
    (s_g, o_g), (s_w, o_w) = got, want
    for k, w in o_w.items():
        g = o_g[k]
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} outputs.{k}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"{what} outputs.{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} outputs.{k}")
    gg, gw = s_g["graph"], s_w["graph"]
    for k in ("n_poses", "n_obs", "n_landmarks", "lm_type"):
        np.testing.assert_array_equal(gg[k], gw[k], err_msg=f"{what} graph.{k}")
    for k in ("current_cone_index", "loop_closure_complete", "keyframe_count"):
        np.testing.assert_array_equal(s_g[k], s_w[k], err_msg=f"{what} {k}")
    n = int(gw["n_obs"])
    np.testing.assert_array_equal(gg["obs_lm"][:n], gw["obs_lm"][:n], err_msg=f"{what} obs_lm")
    np.testing.assert_array_equal(gg["obs_pose"][:n], gw["obs_pose"][:n],
                                  err_msg=f"{what} obs_pose")
    for k in ("poses", "lm_xy"):
        np.testing.assert_allclose(gg[k], gw[k], atol=ATOL, rtol=0, err_msg=f"{what} {k}")


def _session_np(run, s):
    """Session `s` of a batched (state, outputs) as numpy trees."""
    st, outs = run
    return (jax.tree.map(lambda x: x[s], _np_tree(st)),
            {k: v[s] for k, v in _np_tree(outs).items()})


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_batched_matches_per_session(name):
    """Each session of the batched pass equals the port's own per-frame
    `run_sequence` on it ('nearest' through the kernel's twin)."""
    batched_run = _port_batched(name)
    for s in range(len(SEEDS)):
        single = _port_single(name, s)
        assert bool(single[0].loop_closure_complete), f"session {s} must close"
        _assert_session(_session_np(batched_run, s),
                        (_np_tree(single[0]), _np_tree(single[1])), f"{name} session {s}")


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_batched_matches_jax(name):
    """The batched pass equals the JAX package's
    `run_sequences_blocked_batched` on the same inputs, the port started
    from the JAX package's stacked initial state through the numpy
    converters ('nearest': the JAX package's Pallas kernel in interpret
    mode against the port's twin)."""
    stack, cap = _sessions()
    jcfg, cfg = _configs(cap, name)
    jstates = jax_initial_states(jcfg.capacity, len(SEEDS))
    want = jax_run_sequences_blocked_batched(jstates, *stack, jcfg, block=8)
    states = state_from_numpy(_np_tree(jstates), "cpu")
    got = run_sequences_blocked_batched(states, *_tensors(stack), cfg, block=8)
    for s in range(len(SEEDS)):
        _assert_session(_session_np(got, s), _session_np(want, s), f"{name} session {s} vs JAX")


def test_batched_fallback_sessions_finish_per_frame():
    """tests/test_blocked_equivalence.py:298-340 on the port: 16 copies of a
    session, the odd ones with frame 0's first slot invalid (an empty map:
    the bootstrap falls back at frame 0, and the per-frame path finishes
    the whole session); every session equals its own per-frame run."""
    obs, valid, poses = _sim(trackdrive, 11)
    t = (len(obs) // 8) * 8
    S = 16
    cfg = SlamConfig(capacity=GraphCapacity(_pose_cap(len(obs)), 256, 8192))
    obs_b = np.broadcast_to(obs[None, :t], (S,) + obs[:t].shape).copy()
    valid_b = np.broadcast_to(valid[None, :t], (S,) + valid[:t].shape).copy()
    valid_b[1::2, 0, 0] = False
    poses_b = np.broadcast_to(poses[None, :t], (S, t, 3)).copy()
    done = []
    core = blocked.blocked_core_batched

    def recording(*a, **kw):
        out = core(*a, **kw)
        done.append(out[2])
        return out

    blocked.blocked_core_batched = recording
    try:
        got = run_sequences_blocked_batched(initial_states(cfg.capacity, S, "cpu"),
                                            *_tensors((obs_b, valid_b, poses_b)), cfg, block=8)
    finally:
        blocked.blocked_core_batched = core
    assert done == [[t if s % 2 == 0 else 0 for s in range(S)]]
    # the sessions' inputs are two distinct ones, so two per-frame runs
    oracle = {}
    for p in (0, 1):
        st, out = run_sequence(initial_state(cfg.capacity, "cpu"),
                               *(torch.tensor(x[p]) for x in (obs_b, valid_b, poses_b)), cfg)
        oracle[p] = (_np_tree(st), _np_tree(out))
    for s in range(S):
        _assert_session(_session_np(got, s), oracle[s % 2], f"session {s}")


@pytest.mark.parametrize("field,value", [
    ("periodic_gn_every", 16), ("use_gps_prior", True), ("localizer_refine", True),
    ("mapping_publish_refine", True), ("association", "mahalanobis")])
def test_batched_refuses_improved_mode_fields(field, value):
    """The improved mode's fields, which the batched sessions refused before
    they were ported, now run: with each alone, every session of a short
    batched pass (96 frames, block 8) equals its own blocked run
    (tests/test_torch_batched_improved.py covers whole improved laps). The
    EKF fusion flag, once refused by name, is accepted and changes nothing
    here: only the service's `Slam` reads it, as in the JAX package."""
    (obs, valid, poses), cap = _sessions()
    stack = tuple(x[:, :96] for x in (obs, valid, poses))
    cfg = dataclasses.replace(SlamConfig(capacity=GraphCapacity(*cap)), **{field: value})
    st, outs = run_sequences_blocked_batched(initial_states(cfg.capacity, 3, "cpu"),
                                             *_tensors(stack), cfg, block=8)
    for s in range(len(SEEDS)):
        single = blocked.run_sequence_blocked(initial_state(cfg.capacity, "cpu"),
                                              *(x[s] for x in _tensors(stack)), cfg, block=8)
        _assert_session(_session_np((st, outs), s), (_np_tree(single[0]), _np_tree(single[1])),
                        f"{field} session {s}")
    st_e, outs_e = run_sequences_blocked_batched(
        initial_states(cfg.capacity, 3, "cpu"), *_tensors(stack),
        dataclasses.replace(cfg, use_ekf_fusion=True), block=8)
    for s in range(len(SEEDS)):
        _assert_session(_session_np((st_e, outs_e), s), _session_np((st, outs), s),
                        f"{field} with use_ekf_fusion, session {s}")


def test_batched_refuses_first_with_kernel():
    stack, cap = _sessions()
    cfg = SlamConfig(capacity=GraphCapacity(*cap), use_pallas_association=True)
    with pytest.raises(ValueError):
        run_sequences_blocked_batched(initial_states(cfg.capacity, 3, "cpu"),
                                      *_tensors(stack), cfg, block=8)


def _graph_after(frames, cap, noise=0.0):
    """The port's graph after `frames` keyframes of the trackdrive lap, its
    poses moved by seeded noise of `noise` m (and rad), so that the GN
    needs more iterations."""
    obs, valid, poses = _sim(trackdrive, 11)
    cfg = SlamConfig(capacity=cap)
    st, _ = run_sequence(initial_state(cap, "cpu"), torch.tensor(obs[:frames]),
                         torch.tensor(valid[:frames]), torch.tensor(poses[:frames]), cfg)
    g = st.graph
    moved = torch.tensor(np.random.default_rng(5).normal(0.0, noise, tuple(g.poses.shape)),
                         dtype=torch.float32) * g.pose_valid[:, None]
    return dataclasses.replace(g, poses=g.poses + moved), _gn_config(cfg)


def test_batched_gn_stops_each_session_at_its_own_iteration():
    """A stacked graph of four sessions, the third disabled: each enabled
    session equals the single-graph full-capacity `optimize` of its graph,
    stopping at its own iteration (the graphs converge after 4, 5 and 7
    iterations), and the disabled one comes back bit for bit."""
    cap = GraphCapacity(256, 256, 4096)
    graphs = []
    for frames, noise in ((60, 0.0), (211, 0.3), (150, 0.0), (60, 1.0)):
        g, cfg = _graph_after(frames, cap, noise)
        graphs.append(g)
    cfg = dataclasses.replace(cfg, solve_bucket_step=0, edge_bucket_step=0)
    steps = []
    step = gn.gn_step

    def counting(g, c):
        steps.append(1)
        return step(g, c)

    gn.gn_step = counting
    try:
        singles, counts = [], []
        for g in graphs:
            steps.clear()
            singles.append(gn.optimize(g, cfg))
            counts.append(len(steps))
        steps.clear()
        stacked = stack_states([dataclasses.replace(initial_state(cap, "cpu"), graph=g)
                                for g in graphs]).graph
        enable = torch.tensor([True, True, False, True])
        got = gn.optimize(stacked, cfg, enable=enable)
    finally:
        gn.gn_step = step
    enabled = [c for c, e in zip(counts, enable.tolist()) if e]
    assert len(set(enabled)) == 3, counts          # they stop at different iterations
    assert len(steps) == max(enabled)
    for s, (g, want) in enumerate(zip(graphs, singles)):
        for f in ("poses", "lm_xy"):
            value = getattr(got, f)[s]
            if enable[s]:
                # a batched matmul sums in another order than a single one:
                # a few ulps of coordinates up to ~100 m
                torch.testing.assert_close(value, getattr(want, f), atol=1e-4, rtol=0)
            else:
                assert torch.equal(value, getattr(g, f))


def test_initial_states_carry_across():
    """The JAX package's stacked initial state converts to the port's
    `initial_states`, and a stacked state round-trips through numpy
    exactly."""
    cap = (64, 32, 256)
    jstates = _np_tree(jax_initial_states(_configs(cap, "first")[0].capacity, 3))
    ours = state_to_numpy(initial_states(GraphCapacity(*cap), 3, "cpu"))
    assert jax.tree.structure(jstates) == jax.tree.structure(ours)
    for a, b in zip(jax.tree.leaves(jstates), jax.tree.leaves(ours)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    states = _port_batched("first")[0]
    back = state_from_numpy(state_to_numpy(states), "cpu")
    for a, b in zip(jax.tree.leaves(state_to_numpy(back)), jax.tree.leaves(state_to_numpy(states))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert session_state(back, 1).graph.poses.shape == (_sessions()[1][0], 3)
