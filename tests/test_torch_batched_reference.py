"""`chip_smoke.BATCHED_REFERENCE` recomputed: bench.py's batched-sessions
scenario (16 sessions, block 32, `chip_smoke.batched_scenario`) through the
JAX package's `run_sequences_blocked_batched` in both configurations of
`chip_smoke.py`'s phase `batched` (the Pallas kernel in interpret mode), and
through the port's on the CPU. Each session's closure frame, landmark count
and edge count must equal the constant, which phase `batched` holds the card
to."""
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_pipeline import _np_tree
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.frontend.blocked import (
    run_sequences_blocked_batched as jax_run_sequences_blocked_batched,
)
from tpuslam.parallel.batch import initial_states as jax_initial_states
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.frontend.blocked import run_sequences_blocked_batched
from tpuslam_torch.parallel.batch import initial_states


def _metrics(states, outs):
    """{closure_frame, n_landmarks, n_obs} per session, from numpy trees."""
    closes = [np.flatnonzero(lc) for lc in outs["loop_closed"]]
    return dict(closure_frame=[int(c[0]) if len(c) else -1 for c in closes],
                n_landmarks=states["graph"]["n_landmarks"].tolist(),
                n_obs=states["graph"]["n_obs"].tolist())


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_batched_reference(name):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        track, scen = chip_smoke.scenario()
        obs, valid, poses, t = chip_smoke.batched_scenario(track, len(scen.times))
        cfg = chip_smoke.batched_configs(chip_smoke.batched_cap(t))[name]
        c = cfg.capacity
        jcfg = JCfg(capacity=JCap(c.max_poses, c.max_landmarks, c.max_obs),
                    association=cfg.association,
                    use_pallas_association=cfg.use_pallas_association)
        S = chip_smoke.BATCHED_SESSIONS
        jax_run = jax_run_sequences_blocked_batched(
            jax_initial_states(jcfg.capacity, S), obs, valid, poses, jcfg, block=chip_smoke.BLOCK)
        assert _metrics(*map(_np_tree, jax_run)) == chip_smoke.BATCHED_REFERENCE
        port = run_sequences_blocked_batched(
            initial_states(c, S, "cpu"), *(torch.tensor(x) for x in (obs, valid, poses)), cfg,
            block=chip_smoke.BLOCK)
        assert _metrics(*map(_np_tree, port)) == chip_smoke.BATCHED_REFERENCE
    finally:
        torch.set_num_threads(n)
