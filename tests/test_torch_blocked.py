"""The port's blocked pipeline (`tpuslam_torch.frontend.blocked`) against the
port's per-frame `run_sequence` and against the JAX package's
`run_sequence_blocked`.

The oracle is the port's `run_sequence`, which tests/test_torch_pipeline.py
holds to the JAX package; the cases mirror the reference-compat and
'nearest' cases of tests/test_blocked_equivalence.py. Equality is bit for
bit: every output and every state field, the edge rows up to `n_obs` (the
two paths leave different rows past it). The association kernel runs as its
plain twin here (CPU tensors). One case runs the JAX package's own blocked
path at block 32 on the bench lap (bench.py's path) and holds the port to it
with the tolerances of tests/test_torch_pipeline.py.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_pipeline import _assert_same, _closure, _np_tree
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.frontend.blocked import run_sequence_blocked as jax_run_sequence_blocked
from tpuslam.frontend.state import initial_state as jax_initial_state
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import blocked
from tpuslam_torch.frontend.blocked import run_sequence_blocked
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import initial_state, state_to_numpy
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, simulate, skidpad, trackdrive


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: one intra-op thread takes about the same
    wall time and a third of the CPU time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose_cap(t):
    return max(64, 1 << (t - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _sim(track_fn, seed, laps=1.4, **kw):
    """(obs, valid, poses) of a scenario as tests/test_blocked_equivalence.py
    makes it, as numpy arrays."""
    track = track_fn(seed=seed) if track_fn is trackdrive else track_fn()
    scen = simulate(track, SimConfig(laps=laps, keyframe_dt=0.1, speed=8.0,
                                     max_range=20.0, seed=seed + 1, **kw))
    return (scen.obs.astype(np.float32), scen.obs_valid,
            scen.odom_poses.astype(np.float32))


def _tensors(frames):
    obs, valid, poses = frames
    return torch.tensor(obs), torch.tensor(valid), torch.tensor(poses)


def _both(frames, cfg, block):
    """(per-frame state, outputs), (blocked state, outputs) from a fresh state."""
    ins = _tensors(frames)
    cap = cfg.capacity
    return (run_sequence(initial_state(cap, "cpu"), *ins, cfg),
            run_sequence_blocked(initial_state(cap, "cpu"), *ins, cfg, block=block))


def _assert_bit_equal(per_frame, blocked_run, what):
    (s1, o1), (s2, o2) = per_frame, blocked_run
    o1, o2 = _np_tree(o1), _np_tree(o2)
    for k, want in o1.items():
        assert o2[k].dtype == want.dtype and o2[k].shape == want.shape, f"{what} outputs.{k}"
        np.testing.assert_array_equal(o2[k], want, err_msg=f"{what} outputs.{k}")
    n = int(s1.graph.n_obs)

    def same(a, b, path):
        for k, want in b.items():
            got = a[k]
            if isinstance(want, dict):
                same(got, want, path + k + ".")
                continue
            if k in ("obs_pose", "obs_lm", "obs_xy"):
                got, want = got[:n], want[:n]
            assert got.dtype == want.dtype, path + k
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {path}{k}")
    same(state_to_numpy(s2), state_to_numpy(s1), "state.")


def _check(frames, cfg, block, what, closes=True):
    per_frame, blocked_run = _both(frames, cfg, block)
    if closes:
        assert bool(per_frame[0].loop_closure_complete), what
    _assert_bit_equal(per_frame, blocked_run, what)
    return blocked_run


@pytest.mark.parametrize("association", ["first", "nearest"])
@pytest.mark.parametrize("block", [4, 8, 32])
def test_blocked_matches_run_sequence(association, block):
    frames = _sim(trackdrive, 11)
    cap = GraphCapacity(_pose_cap(len(frames[0])), 256, 8192)
    _check(frames, SlamConfig(capacity=cap, association=association), block,
           f"{association} B={block}")


def test_blocked_skidpad_and_ragged_length():
    """Skidpad lap, and a T that is not a multiple of the block size."""
    frames = _sim(skidpad, 3, laps=1.3)
    t = len(frames[0])
    assert t % 5 != 0
    _check(frames, SlamConfig(capacity=GraphCapacity(_pose_cap(t), 256, 8192)), 5,
           "skidpad B=5")


def test_blocked_with_gps_outlier_frames():
    """Frames that fail the GPS outlier guard stay exact no-ops."""
    obs, valid, poses = _sim(trackdrive, 7)
    poses = poses.copy()
    poses[10] = (500.0, 0.0, 0.0)
    poses[43] = (0.0, -900.0, 1.0)
    cap = GraphCapacity(_pose_cap(len(obs)), 256, 8192)
    _check((obs, valid, poses), SlamConfig(capacity=cap), 8, "outliers")


@pytest.mark.parametrize("cap", [(256, 128), (256, 300), (32, 8192)],
                         ids=["edges_below_one_block", "edges_mid_lap", "landmarks"])
def test_blocked_capacity_saturation_falls_back(cap):
    """Near a capacity the blocks hand over to the per-frame path and the
    pass still equals it: an edge capacity below one block's rows runs the
    whole pass per frame; one the lap outgrows, or a landmark capacity,
    stops the blocks where a block would exceed it (its writes past the
    capacity are dropped, not sent out of range)."""
    frames = _sim(skidpad, 3, laps=1.0)
    t = len(frames[0])
    cfg = SlamConfig(capacity=GraphCapacity(_pose_cap(t), *cap))
    s2, _ = _check(frames, cfg, 8, f"saturated {cap}", closes=False)
    if cap[1] == 300:
        assert int(s2.graph.n_obs) == 300
    if cap[0] == 32:
        assert int(s2.graph.n_landmarks) == 32


def test_blocked_pose_capacity_saturation_falls_back():
    frames = _sim(skidpad, 3, laps=1.0)
    t = len(frames[0])
    cfg = SlamConfig(capacity=GraphCapacity(t - 20, 256, 8192))
    s2, _ = _check(frames, cfg, 8, "pose capacity", closes=False)
    assert int(s2.graph.n_poses) == t - 20


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_blocked_stress_dense_noisy_layouts(seed):
    """High observation noise and dense cone spacing push the duplicate
    representatives (deep chains, cross-frame matches near the gate)."""
    scen = simulate(trackdrive(seed=seed), SimConfig(
        laps=1.3, keyframe_dt=0.12, speed=9.0, max_range=25.0, seed=seed + 1,
        obs_noise_range=0.35, obs_noise_az_deg=1.5, gps_noise=0.4, heading_noise=0.06))
    frames = (scen.obs.astype(np.float32), scen.obs_valid, scen.odom_poses.astype(np.float32))
    cap = GraphCapacity(_pose_cap(len(scen.times)), 384, 8192)
    _check(frames, SlamConfig(capacity=cap), 8, f"stress seed={seed}", closes=False)


def test_blocked_kernel_association_matches_per_frame():
    """'nearest' through the association kernel's provider path (its plain
    twin here): equal to the per-frame path running the same provider, with
    one association call per block."""
    frames = _sim(trackdrive, 11)
    cap = GraphCapacity(_pose_cap(len(frames[0])), 256, 8192)
    cfg = SlamConfig(capacity=cap, association="nearest", use_pallas_association=True)
    assert blocked.blocked_supported(cfg)
    calls = []
    provider = blocked._provider_associate

    def counting(glob, *a, **kw):
        calls.append(glob.shape[0])
        return provider(glob, *a, **kw)

    blocked._provider_associate = counting
    try:
        _check(frames, cfg, 8, "kernel B=8")
    finally:
        blocked._provider_associate = provider
    t = len(frames[0])
    # 27 mapping blocks through the closure at frame 212, then 15
    # localization blocks from the closure block on, each of 8 x 16
    assert calls == [8 * 16] * (212 // 8 + 1 + (-(-t // 8) - 212 // 8))


def test_blocked_rejects_unsupported_config():
    frames = _sim(skidpad, 3, laps=1.0)
    ins = _tensors(frames)
    cap = GraphCapacity(_pose_cap(len(frames[0])), 256, 8192)
    refused = {
        # as the JAX package's blocked path: a periodic GN period that is
        # not a multiple of the block, and 'first' through the kernel
        ValueError: [dict(periodic_gn_every=5, periodic_gn_window=64),
                     dict(use_pallas_association=True)],
        # configurations the JAX package's blocked path runs and the port
        # does not yet, each refused by name
        NotImplementedError: [dict(association="mahalanobis"), dict(periodic_gn_every=8),
                              dict(use_gps_prior=True), dict(localizer_refine=True),
                              dict(mapping_publish_refine=True)],
    }
    for err, cases in refused.items():
        for kw in cases:
            match = None if err is ValueError else next(iter(kw))
            with pytest.raises(err, match=match):
                run_sequence_blocked(initial_state(cap, "cpu"), *ins,
                                     SlamConfig(capacity=cap, **kw), block=8)
    with pytest.raises(NotImplementedError, match="assoc_mesh"):
        run_sequence_blocked(initial_state(cap, "cpu"), *ins, SlamConfig(capacity=cap),
                             block=8, assoc_mesh=object())


def test_blocked_zero_frames_equals_run_sequence():
    cfg = SlamConfig(capacity=GraphCapacity(64, 64, 1024))
    ins = (torch.zeros(0, 64, 4), torch.zeros(0, 64, dtype=torch.bool), torch.zeros(0, 3))
    _assert_bit_equal(run_sequence(initial_state(cfg.capacity, "cpu"), *ins, cfg),
                      run_sequence_blocked(initial_state(cfg.capacity, "cpu"), *ins, cfg,
                                           block=8), "T=0")


def test_blocked_matches_jax_blocked_on_bench_lap():
    """bench.py's path: the JAX package's `run_sequence_blocked` at block 32
    in the reference-compat configuration on the bench lap, against the
    port's."""
    track, scen = chip_smoke.scenario()
    cap = dataclasses.astuple(chip_smoke.CAP)
    frames = (scen.obs.astype(np.float32), scen.obs_valid, scen.odom_poses.astype(np.float32))
    js, jo = jax_run_sequence_blocked(
        jax_initial_state(JCap(*cap)), *(jnp.asarray(x) for x in frames),
        JCfg(capacity=JCap(*cap)), block=32)
    want = (_np_tree(js), _np_tree(jo))
    st, out = run_sequence_blocked(initial_state(GraphCapacity(*cap), "cpu"), *_tensors(frames),
                                   SlamConfig(capacity=GraphCapacity(*cap)), block=32)
    _assert_same((state_to_numpy(st), _np_tree(out)), want, _closure(want[1]))
    metrics = chip_smoke.lap_metrics(track, scen, st, out)
    for k, v in chip_smoke.REFERENCE["first"].items():
        if isinstance(v, int):
            assert metrics[k] == v, (k, metrics[k], v)
        else:
            assert abs(metrics[k] - v) <= chip_smoke.METRIC_ATOL_M, (k, metrics[k], v)
