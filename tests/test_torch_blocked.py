"""The port's blocked pipeline (`tpuslam_torch.frontend.blocked`) against the
port's per-frame `run_sequence` and against the JAX package's
`run_sequence_blocked`.

The oracle is the port's `run_sequence`, which tests/test_torch_pipeline.py
and tests/test_torch_improved.py hold to the JAX package; the cases mirror
tests/test_blocked_equivalence.py, the improved mode's included. Where the
JAX package requires its blocked path to equal its per-frame path bit for
bit, so does this file: every output and every state field, the edge rows
up to `n_obs` (the two paths leave different rows past it). Where it holds
them to a contract instead (Mahalanobis gating lags by up to block - 1
frames; mid-block periodic firings), the same contract. The association
kernel runs as its plain twin here (CPU tensors). One case runs the JAX
package's own blocked path at block 32 on the bench lap (bench.py's path)
and holds the port to it with the tolerances of tests/test_torch_pipeline.py;
tests/test_torch_improved.py does so for the improved mode's blocked runs.
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
from tpuslam_torch.sim import SimConfig, ate, simulate, skidpad, trackdrive


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
        # glob is [sessions, observations, 2]; one session here
        assert glob.shape[0] == 1
        calls.append(glob.shape[-2])
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
        # neither a multiple of the block nor a divisor of it with a
        # fixed-lag window, 'first' through the kernel, the scan-form step
        ValueError: [dict(periodic_gn_every=5, periodic_gn_window=64),
                     dict(periodic_gn_every=4, periodic_gn_window=0),
                     dict(use_pallas_association=True), dict(vectorized_mapping=False)],
    }
    for err, cases in refused.items():
        for kw in cases:
            match = None if err is ValueError else next(iter(kw))
            with pytest.raises(err, match=match):
                run_sequence_blocked(initial_state(cap, "cpu"), *ins,
                                     SlamConfig(capacity=cap, **kw), block=8)
    # the mesh-sharded map, refused until the multi-device tier was ported,
    # runs: on a one-rank mesh it gives the dense run's results (without the
    # localizer's signed type compare, which index providers do not have,
    # as in the JAX package)
    from tpuslam_torch.parallel.mesh import initialize_distributed, make_slam_mesh
    made = initialize_distributed("gloo")
    try:
        mesh = make_slam_mesh(1, 1, device_type="cpu")
        cfg = SlamConfig(capacity=cap, localizer_type_bug=False)
        _assert_bit_equal(run_sequence_blocked(initial_state(cap, "cpu"), *ins, cfg, block=8,
                                               assoc_mesh=mesh),
                          run_sequence_blocked(initial_state(cap, "cpu"), *ins, cfg, block=8),
                          "assoc_mesh")
    finally:
        if made:        # the next test file in this worker gets no world
            torch.distributed.destroy_process_group()


@pytest.mark.parametrize("case", ["cpu", "cpu_batched", "assoc_mesh"])
def test_blocks_stay_eager_off_the_card_and_with_a_mesh(case):
    """The blocks replay CUDA graphs only for CUDA tensors without a mesh:
    on the CPU (one session, or a batch of them) and with an `assoc_mesh`
    they run eagerly, as before, and capture and replay nothing."""
    from tpuslam_torch.parallel.batch import initial_states
    frames = _sim(skidpad, 3, laps=1.0)
    ins = _tensors(frames)
    cap = GraphCapacity(_pose_cap(len(frames[0])), 256, 8192)
    cfg = SlamConfig(capacity=cap, association="nearest", use_pallas_association=True,
                     localizer_type_bug=False)
    mesh, made = None, False
    if case == "assoc_mesh":
        from tpuslam_torch.parallel.mesh import initialize_distributed, make_slam_mesh
        made = initialize_distributed("gloo")
    try:
        if case == "assoc_mesh":
            mesh = make_slam_mesh(1, 1, device_type="cpu")
        assert not blocked._use_graphs(ins[0], mesh)
        if case == "cpu_batched":
            st, _ = blocked.run_sequences_blocked_batched(
                initial_states(cap, 2, "cpu"), *(torch.stack([x, x]) for x in ins), cfg, block=8)
            closed = bool(st.loop_closure_complete.all())
        else:
            st, _ = run_sequence_blocked(initial_state(cap, "cpu"), *ins, cfg, block=8,
                                         assoc_mesh=mesh)
            closed = bool(st.loop_closure_complete)
    finally:
        if made:        # the next test file in this worker gets no world
            torch.distributed.destroy_process_group()
    assert closed
    assert blocked.graph_captures == 0 and blocked.graph_replays == 0 and not blocked._graphs


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


# ---- the improved mode (mirrors of tests/test_blocked_equivalence.py)

def _mahal_frames():
    """tests/test_blocked_equivalence.py's `_mahal_scenario`."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=1))
    frames = (scen.obs.astype(np.float32), scen.obs_valid, scen.odom_poses.astype(np.float32))
    return frames, GraphCapacity(128, 128, 4096)


def _bench_cap(frames):
    return GraphCapacity(_pose_cap(len(frames[0])), 256, 8192)


def test_blocked_localizer_refine():
    frames = _sim(trackdrive, 11)
    _check(frames, SlamConfig(capacity=_bench_cap(frames), localizer_refine=True), 8,
           "localizer refine")


@pytest.mark.parametrize("block", [4, 8])
def test_blocked_periodic_gn_matches_run_sequence(block):
    """GPS priors and the fixed-lag periodic GN every 8 keyframes: every
    firing lands on a block's last frame."""
    frames = _sim(trackdrive, 11)
    cfg = SlamConfig.improved(capacity=_bench_cap(frames), periodic_gn_every=8,
                              mapping_publish_refine=False)
    _check(frames, cfg, block, f"periodic B={block}")


def test_blocked_periodic_full_batch_gn_matches_run_sequence():
    frames = _sim(trackdrive, 11)
    cfg = SlamConfig.improved(capacity=_bench_cap(frames), periodic_gn_window=0,
                              mapping_publish_refine=False)
    _check(frames, cfg, 8, "periodic full batch")


def test_blocked_mahalanobis_block1_bitexact():
    """At block 1 the information lag vanishes."""
    frames = _sim(trackdrive, 11)
    cfg = SlamConfig.improved(capacity=_bench_cap(frames), association="mahalanobis",
                              periodic_gn_every=0)
    _check(frames, cfg, 1, "mahalanobis B=1")


def test_blocked_improved_mode_matches_run_sequence():
    """GPS priors, the localizer refine, the closure GN; no periodic GN."""
    frames = _sim(trackdrive, 11)
    _check(frames, SlamConfig.improved(capacity=_bench_cap(frames), periodic_gn_every=0), 8,
           "improved")


def _lag_contract(cfg, block, max_d=0.05, mean_d=None):
    """tests/test_blocked_equivalence.py's contract where Mahalanobis gating
    lags by up to block - 1 frames: the blocked run closes the loop, builds
    a map within 2 landmarks of the per-frame run's, and publishes within
    `max_d` m of it (and `mean_d` m on average)."""
    frames, _ = _mahal_frames()
    (s1, o1), (s2, o2) = _both(frames, cfg, block)
    assert bool(s2.loop_closure_complete)
    n1, n2 = int(s1.graph.n_landmarks), int(s2.graph.n_landmarks)
    assert n1 < cfg.capacity.max_landmarks
    assert abs(n1 - n2) <= 2, (n1, n2)
    d = torch.linalg.norm(o1.pose[:, :2] - o2.pose[:, :2], dim=1)
    assert float(d.max()) < max_d, float(d.max())
    if mean_d is not None:
        assert float(d.mean()) < mean_d, float(d.mean())


@pytest.mark.parametrize("kernel", [False, True], ids=["dense", "kernel"])
def test_blocked_mahalanobis_block8_lag_contract(kernel):
    _, cap = _mahal_frames()
    _lag_contract(SlamConfig(capacity=cap, association="mahalanobis",
                             use_pallas_association=kernel), 8)


def test_blocked_improved_full_matches_run_sequence():
    """Mahalanobis, GPS priors, periodic GN and the publish refine together:
    a lag-flipped match moves a published pose directly, so up to 0.12 m
    (0.03 m on average), as the JAX package allows."""
    _, cap = _mahal_frames()
    _lag_contract(SlamConfig.improved(capacity=cap, association="mahalanobis"), 8,
                  max_d=0.12, mean_d=0.03)


def test_blocked_publish_refine_matches_run_sequence():
    """The improved default at block 16: the JAX package holds its blocked
    published poses to 1e-4 of its per-frame ones (its batched 3x3 solves
    differ); the port's refine computes each frame's values alike batched
    or not, so everything is bit-equal. The refine beats the graph publish."""
    frames = _sim(trackdrive, 11)
    scen = simulate(trackdrive(seed=11), SimConfig(laps=1.4, keyframe_dt=0.1, speed=8.0,
                                                   max_range=20.0, seed=12))
    cfg = SlamConfig.improved(capacity=_bench_cap(frames))
    assert cfg.mapping_publish_refine
    _, o_on = _check(frames, cfg, 16, "publish refine B=16")
    _, o_off = run_sequence_blocked(initial_state(cfg.capacity, "cpu"), *_tensors(frames),
                                    cfg.with_(mapping_publish_refine=False), block=16)
    t = len(frames[0])
    assert ate(o_on.pose.numpy()[:, :2], scen.gt_poses[:t, :2]) < \
        ate(o_off.pose.numpy()[:, :2], scen.gt_poses[:t, :2])


@pytest.mark.parametrize("every", [8, 16])
def test_blocked_midblock_gn_decouples_cadence(every, monkeypatch):
    """A period dividing the block (32) fires mid-block, each window anchored
    at its firing frame's counts: no frame falls to the per-frame path,
    the decisions match it up to the refinement lag (landmarks within 3,
    the same poses inserted), and the published trajectory is at least as
    accurate, as the JAX package's contract."""
    frames = _sim(trackdrive, 11)
    scen = simulate(trackdrive(seed=11), SimConfig(laps=1.4, keyframe_dt=0.1, speed=8.0,
                                                   max_range=20.0, seed=12))
    cfg = SlamConfig.improved(capacity=_bench_cap(frames), periodic_gn_every=every)
    assert blocked._midblock_gn(cfg, 32)
    done = []
    core = blocked.blocked_core

    def recording(*a, **kw):
        out = core(*a, **kw)
        done.append(out[2])
        return out

    monkeypatch.setattr(blocked, "blocked_core", recording)
    (s_f, o_f), (s_b, o_b) = _both(frames, cfg, 32)
    t = len(frames[0])
    assert done == [-(-t // 32) * 32]
    assert bool(s_b.loop_closure_complete) and bool(s_f.loop_closure_complete)
    assert abs(int(s_b.graph.n_landmarks) - int(s_f.graph.n_landmarks)) <= 3
    assert int(s_b.graph.n_poses) == int(s_f.graph.n_poses)
    a_b = ate(o_b.pose.numpy()[:, :2], scen.gt_poses[:t, :2])
    a_f = ate(o_f.pose.numpy()[:, :2], scen.gt_poses[:t, :2])
    assert a_b <= a_f + 5e-3, (a_b, a_f)
