"""The port's batched sessions under the improved mode
(`run_sequences_blocked_batched` / `blocked_core_batched` with the periodic
GN, GPS priors, both refines and Mahalanobis gating) against each
session's own single-session `run_sequence_blocked` and against the JAX
package's `run_sequences_blocked_batched`.

Three trackdrive sessions (tests/test_torch_batched.py's, cut to 256
frames) run I1
(`SlamConfig.improved()`) at block 16 (every firing on a block's last
frame) and at block 32 (mid-block firing), and I2 (Mahalanobis through the
association kernel, here its plain twin; the JAX package's Pallas kernel in
interpret mode) at block 16; one case has a session whose bootstrap falls
back at frame 0, which the improved per-frame engine then finishes.
Discrete outputs are exact, values within 2e-3 (the batched closure GN is
full-capacity and the batched window GN sums in another order). One
session (S = 1) gives the single-session run's bits.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_batched import _assert_session, _session_np, _sessions, _tensors
from tests.test_torch_pipeline import _np_tree
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.frontend.blocked import (
    run_sequences_blocked_batched as jax_run_sequences_blocked_batched,
)
from tpuslam.parallel.batch import initial_states as jax_initial_states
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import blocked
from tpuslam_torch.frontend.blocked import run_sequence_blocked, run_sequences_blocked_batched
from tpuslam_torch.frontend.state import initial_state, session_state, state_to_numpy
from tpuslam_torch.parallel.batch import initial_states
from tpuslam_torch.runtime.config import SlamConfig

# the laps cut to 256 frames: the closures at frames 212-214 and two or three
# localization blocks after them
FRAMES = 256
# case -> (improved-mode fields, block, sessions whose bootstrap falls back)
CASES = {"I1_b16": ({}, 16, ()), "I1_b32": ({}, 32, ()),
         "I2_b16": (dict(association="mahalanobis", use_pallas_association=True), 16, ()),
         "I1_b16_fallback": ({}, 16, (1,))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(case):
    """(numpy stack, port config, JAX config, block) of a case."""
    kw, block, falls = CASES[case]
    (obs, valid, poses), cap = _sessions()
    obs, valid, poses = obs[:, :FRAMES], valid[:, :FRAMES].copy(), poses[:, :FRAMES]
    for s in falls:
        valid[s, 0, 0] = False       # an empty map and an invalid first slot
    return ((obs, valid, poses), SlamConfig.improved(capacity=GraphCapacity(*cap), **kw),
            JCfg.improved(capacity=JCap(*cap), **kw), block)


@functools.lru_cache(maxsize=None)
def _port_batched(case):
    stack, cfg, _, block = _case(case)
    done = []
    core = blocked.blocked_core_batched

    def recording(*a, **kw):
        out = core(*a, **kw)
        done.append(out[2])
        return out

    blocked.blocked_core_batched = recording
    try:
        run = run_sequences_blocked_batched(initial_states(cfg.capacity, len(stack[0]), "cpu"),
                                            *_tensors(stack), cfg, block=block)
    finally:
        blocked.blocked_core_batched = core
    return run, done


@pytest.mark.parametrize("case", list(CASES))
def test_batched_improved_matches_per_session(case):
    """Each session of the batched pass equals its own single-session
    blocked run; a session that falls back is finished per frame."""
    stack, cfg, _, block = _case(case)
    run, done = _port_batched(case)
    t = stack[0].shape[1]
    falls = CASES[case][2]
    assert done == [[0 if s in falls else -(-t // block) * block for s in range(len(stack[0]))]]
    for s in range(len(stack[0])):
        single = run_sequence_blocked(initial_state(cfg.capacity, "cpu"),
                                      *(x[s] for x in _tensors(stack)), cfg, block=block)
        assert bool(single[0].loop_closure_complete), f"session {s} must close"
        _assert_session(_session_np(run, s), (_np_tree(single[0]), _np_tree(single[1])),
                        f"{case} session {s}")


@pytest.mark.parametrize("case", list(CASES))
def test_batched_improved_matches_jax(case):
    """The batched pass equals the JAX package's
    `run_sequences_blocked_batched` on the same inputs."""
    stack, _, jcfg, block = _case(case)
    want = jax_run_sequences_blocked_batched(jax_initial_states(jcfg.capacity, len(stack[0])),
                                             *stack, jcfg, block=block)
    got, _ = _port_batched(case)
    for s in range(len(stack[0])):
        _assert_session(_session_np(got, s), _session_np(want, s), f"{case} session {s} vs JAX")


@pytest.mark.parametrize("case", ["I1_b16", "I1_b32", "I2_b16"])
def test_batched_improved_one_session_is_bit_equal(case):
    """At S = 1 the batched pass gives the single-session blocked run's bits:
    every output, every state field, the edge rows up to n_obs."""
    stack, cfg, _, block = _case(case)
    obs, valid, poses = (x[:1] for x in _tensors(stack))
    st_b, out_b = run_sequences_blocked_batched(initial_states(cfg.capacity, 1, "cpu"), obs,
                                                valid, poses, cfg, block=block)
    st_1, out_1 = run_sequence_blocked(initial_state(cfg.capacity, "cpu"), obs[0], valid[0],
                                       poses[0], cfg, block=block)
    for f in dataclasses.fields(out_1):
        assert torch.equal(getattr(out_b, f.name)[0], getattr(out_1, f.name)), f.name
    a, b = state_to_numpy(session_state(st_b, 0)), state_to_numpy(st_1)
    for k, v in b.items():
        if k != "graph":
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    for k, v in b["graph"].items():
        np.testing.assert_array_equal(a["graph"][k], v, err_msg=f"graph.{k}")
