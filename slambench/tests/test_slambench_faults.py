"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU stands in), the rest of the
run is driven as on the card, and each fault a cell can have is planted in
the program. One card runs each cell, so no exchange between cards can be
left out."""
import dataclasses

import pytest
import torch

from slambench.tests.conftest import run_cell


def _gn_unchanged(monkeypatch):
    """The closure / joint GN returns the graph it was given."""
    from tpuslam_torch.backend import gauss_newton
    monkeypatch.setattr(gauss_newton, "optimize", lambda g, cfg, **kw: g)


def _replay_half_batch(monkeypatch):
    """Half of the fleet's sessions run; the other half get their outputs."""
    from tpuslam_torch.frontend import blocked
    from tpuslam_torch.frontend.state import map_state
    from tpuslam_torch.parallel.batch import initial_states
    real = blocked.run_sequences_blocked_batched

    def half(states, obs, valid, poses, cfg, block=8):
        h = obs.shape[0] // 2
        st, outs = real(initial_states(cfg.capacity, h, obs.device), obs[:h], valid[:h],
                        poses[:h], cfg, block)
        return (map_state(lambda x: torch.cat([x, x]), st),
                blocked._map_outputs(lambda v: torch.cat([v, v]), outs))

    monkeypatch.setattr(blocked, "run_sequences_blocked_batched", half)


def _replay_one_slot(monkeypatch):
    """The last batch slot's session is run on the first slot's inputs."""
    from tpuslam_torch.frontend import blocked
    real = blocked.run_sequences_blocked_batched

    def one_slot(states, obs, valid, poses, cfg, block=8):
        obs, valid, poses = (torch.cat([x[:-1], x[:1]]) for x in (obs, valid, poses))
        return real(states, obs, valid, poses, cfg, block)

    monkeypatch.setattr(blocked, "run_sequences_blocked_batched", one_slot)


def _replay_answer_altered(monkeypatch):
    """The association moves one match of every call to the next landmark."""
    from tpuslam_torch.frontend import keyframe
    real = keyframe.associate_kernel

    def altered(obs_xy, *a, **kw):
        idx, matched, cost = real(obs_xy, *a, **kw)
        flat = torch.nonzero(matched.reshape(-1))
        if len(flat):
            idx = idx.clone().reshape(-1)
            idx[flat[0, 0]] += 1
            idx = idx.reshape(matched.shape)
        return idx, matched, cost

    monkeypatch.setattr(keyframe, "associate_kernel", altered)


def _fusion_half_batch(monkeypatch):
    """Half of the fleet's sessions are fused; the rest are left out."""
    from tpuslam_torch.parallel import fusion
    real = fusion.fuse_sessions

    def half(stacked, *a, **kw):
        keep = torch.arange(stacked.n_poses.shape[0]) < stacked.n_poses.shape[0] // 2
        zero = {k: torch.where(keep.to(v.device), v, 0) for k, v in
                (("n_poses", stacked.n_poses), ("n_landmarks", stacked.n_landmarks),
                 ("n_obs", stacked.n_obs))}
        return real(dataclasses.replace(stacked, **zero), *a, **kw)

    monkeypatch.setattr(fusion, "fuse_sessions", half)


def _fusion_answer_altered(monkeypatch):
    """The dedup gives one merged landmark a label of its own."""
    from tpuslam_torch.parallel import fusion
    real = fusion.dedup_labels

    def altered(all_xy, *a, **kw):
        lab = real(all_xy, *a, **kw).clone()
        k = torch.arange(len(lab), device=lab.device)
        split = torch.nonzero(lab != k)
        if len(split):
            lab[split[0, 0]] = split[0, 0].to(lab.dtype)
        return lab

    monkeypatch.setattr(fusion, "dedup_labels", altered)


FAULTS = {"tiny.replay": (_gn_unchanged, _replay_half_batch, _replay_one_slot,
                          _replay_answer_altered),
          "tiny.fusion": (_gn_unchanged, _fusion_half_batch, _fusion_answer_altered)}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(checkout, capsys, monkeypatch, cell, fault):
    rc, res = run_cell(checkout, cell, 2**31 + 99, capsys)
    assert rc == 0 and res["correct"], res
    fault(monkeypatch)
    rc, res = run_cell(checkout, cell, 2**31 + 99, capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]
