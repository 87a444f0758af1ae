"""The loop that `optimize_window` replays as CUDA graphs on a stacked batch
(`gauss_newton._WindowGraph`), run eagerly on the CPU: masked iterations,
each a head up to the reduced system, the factor and solve, and a tail
from the solution to the kept update, give the bits of `_iterate_batched`
over `window_gn_step`, with the early-exit read and without it (every
iteration run: a session that has stopped keeps its bits).

The batch is four sessions of one noisy loop (a circle of 12 poses, a ring
of 8 landmarks, as `tests/test_backend.py` builds it), each brought nearer
its fixed point by a number of window steps of its own, so that under the
tolerance one stops after the first iteration, one after the second, one
runs all three, and the fourth is not enabled. The module imports no JAX:
the card's tests build their batch here too.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend import graph as G
from tpuslam_torch.geometry import se2

CAP = G.GraphCapacity(max_poses=64, max_landmarks=32, max_obs=256)
W, EW = 6, 128
CFG = gn.GNConfig(iterations=3, early_exit_tol=1e-3)
ENABLE = (True, True, True, False)
# window steps taken before the round, per session, and the iterations each
# then runs in the round
PRE = {True: (40, 4, 0, 0), False: (40, 2, 0, 0)}
STOPS = [1, 2, 3, 0]
ANCHORS = {"end_and_end_obs": ((12, 11, 12, 10), (20, 17, 20, 15)),
           "end": ((12, 12, 12, 10), None), "head": (None, None)}


def _loop_world(device, n_poses=12, n_lm=8, noise=0.3, seed=3) -> G.FactorGraph:
    """The noisy loop of `tests/test_backend.py::_build_world` as the port's
    graph: poses on a circle of radius 10, landmarks on a ring of 13, each
    seen from the poses within 8 m, noise drawn from `seed`."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    heading = (t + 1.5 * np.pi) % (2 * np.pi) - np.pi
    gt = np.stack([10.0 * np.cos(t), 10.0 * np.sin(t), heading], axis=1)
    ang = np.linspace(0, 2 * np.pi, n_lm, endpoint=False) + 0.2
    gt_lms = np.stack([13.0 * np.cos(ang), 13.0 * np.sin(ang)], axis=1)
    poses = gt + rng.normal(0, noise, gt.shape)
    lms = gt_lms + rng.normal(0, noise, gt_lms.shape)
    g = G.empty_graph(CAP, device)
    prev = None
    for p in torch.tensor(poses, dtype=torch.float32, device=device):
        g = G.add_pose(g, p, torch.zeros_like(p) if prev is None else se2.between(prev, p))
        prev = p
    for row in torch.tensor(lms, dtype=torch.float32, device=device):
        g = G.add_landmark(g, row, torch.tensor(1, dtype=torch.int32, device=device))
    for i, p in enumerate(gt):
        for j, lm in enumerate(gt_lms):
            d = lm - p[:2]
            if np.linalg.norm(d) < 8.0:
                c, s = np.cos(p[2]), np.sin(p[2])
                z = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]]) + rng.normal(0, 0.05, 2)
                g = G.add_observation(g, torch.tensor(i, dtype=torch.int32, device=device),
                                      torch.tensor(j, dtype=torch.int32, device=device),
                                      torch.tensor(z, dtype=torch.float32, device=device))
    return g


def window_batch(device, landmarks: bool, anchor: str):
    """(stacked graph [4], end, end_obs, enable) of one window round: the
    loop world four times, session s moved by PRE[landmarks][s] window
    steps at its own anchor first."""
    one = _loop_world(device)
    end, end_obs = (None if x is None else torch.tensor(x, dtype=torch.int32, device=device)
                    for x in ANCHORS[anchor])
    graphs = []
    for s, k in enumerate(PRE[landmarks]):
        g = one
        for _ in range(k):
            g = gn.window_gn_step(g, CFG, W, EW, landmarks, g.lm_xy if landmarks else None,
                                  None if end is None else end[s],
                                  None if end_obs is None else end_obs[s])
        graphs.append(g)
    stack = G.FactorGraph(**{f.name: torch.stack([getattr(g, f.name) for g in graphs])
                             for f in dataclasses.fields(G.FactorGraph)})
    return stack, end, end_obs, torch.tensor(ENABLE, device=device)


def iterations_run(g, landmarks: bool, end, end_obs, enable) -> list[int]:
    """The iterations each session of the round runs in `_iterate_batched`
    (0 for a disabled one)."""
    running, runs = enable.clone(), [0] * len(ENABLE)
    lm_prior = g.lm_xy if landmarks else None
    for _ in range(CFG.iterations):
        g2 = gn.window_gn_step(g, CFG, W, EW, landmarks, lm_prior, end, end_obs)
        delta = torch.maximum((g2.poses - g.poses).abs().amax((1, 2)),
                              (g2.lm_xy - g.lm_xy).abs().amax((1, 2)))
        runs = [r + int(x) for r, x in zip(runs, running.tolist())]
        keep = running[:, None, None]
        g = dataclasses.replace(g, poses=torch.where(keep, g2.poses, g.poses),
                                lm_xy=torch.where(keep, g2.lm_xy, g.lm_xy))
        running = running & (delta > CFG.early_exit_tol)
    return runs


@pytest.mark.parametrize("anchor", list(ANCHORS))
@pytest.mark.parametrize("landmarks", [True, False], ids=["map_free", "map_fixed"])
def test_window_loop_without_its_read_equals_the_early_exit_loop(landmarks, anchor):
    g, end, end_obs, enable = window_batch("cpu", landmarks, anchor)
    assert iterations_run(g, landmarks, end, end_obs, enable) == STOPS
    want = gn.optimize_window(g, CFG, W, EW, enable=enable, landmarks=landmarks, end=end,
                              end_obs=end_obs)
    loop = gn._WindowGraph(g, CFG, W, EW, landmarks, end, end_obs)
    loop.load(g, enable, end, end_obs)
    for _ in range(CFG.iterations):
        loop.step()
    assert torch.equal(loop.g.poses, want.poses) and torch.equal(loop.g.lm_xy, want.lm_xy)
    got = loop.run(g, enable, end, end_obs)
    for f in dataclasses.fields(G.FactorGraph):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert torch.equal(got.poses[3], g.poses[3]) and torch.equal(got.lm_xy[3], g.lm_xy[3])
    assert not torch.equal(got.poses[2], g.poses[2])
    # the loop's static inputs are its own: a second round on other inputs
    # gives that round's bits and leaves the first result alone
    kept = got.poses.clone()
    again = loop.run(want, None, end, end_obs)
    assert torch.equal(again.poses, gn.optimize_window(
        want, CFG, W, EW, landmarks=landmarks, end=end, end_obs=end_obs).poses)
    assert torch.equal(got.poses, kept)
