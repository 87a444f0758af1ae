"""Tests that need a CUDA device: each hand-written kernel against its plain
PyTorch twin on the card (one session and a batch of them), the wrappers'
input checks, and the per-frame engine, the blocked pipeline, its
batched sessions and the fusion on the card against the port's own CPU
runs. They skip without a device. The GPU machine has no JAX, so this
file imports none; run it there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(the suite's conftest imports JAX)."""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_window_graph as WG
from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import blocked
from tpuslam_torch.frontend.blocked import run_pass_blocked, run_sequences_blocked_batched
from tpuslam_torch.frontend.pipeline import run_pass
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.parallel import fusion
from tpuslam_torch.parallel.batch import initial_states, run_sequences_batched
from tpuslam_torch.runtime import cuda_graphs as cg
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, simulate, skidpad, trackdrive

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,seed,ties", [(37, 300, 0, False), (5, 0, 2, False)]
                         + chip_smoke.ASSOC_CHECKS)
@pytest.mark.parametrize("mahalanobis", [False, True])
def test_assoc_kernel_bit_equal_to_plain(cuda, n, m, seed, ties, mahalanobis):
    """Bit-equal to the twin at the lap, blocked and pod shapes, ragged N and
    M, and with ties across chunks and cluster ranks (won by the lower
    index); one launch per call."""
    before = A.launches
    err = chip_smoke.assoc_check(n, m, seed, ties, mahalanobis)[2]
    assert A.launches == before + 1
    assert err == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assoc_kernel_masks(cuda, seed):
    matched, err = chip_smoke.assoc_masked_check(seed)
    assert matched > 0 and err == 0.0


def test_assoc_kernel_is_one_launch(cuda):
    """Exactly one kernel launch per call, whatever the plan, and none (nor a
    count) for N = 0."""
    from torch.profiler import ProfilerActivity, profile
    worlds = [chip_smoke.assoc_world(n, m, 0) for n, m in chip_smoke.ASSOC_SHAPES.values()]
    for w in worlds:
        A.associate_kernel(*w[:4], 1.44)
    torch.cuda.synchronize()
    before = A.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for w in worlds:
            A.associate_kernel(*w[:4], 1.44)
            A.associate_kernel(*w[:4], 9.21, w[4], mahalanobis=True)
        oxy, ot, lxy, lt, _ = worlds[0]
        empty = A.associate_kernel(oxy[:0], ot[:0], lxy, lt, 1.44)
        torch.cuda.synchronize()
    assert A.launches == before + 2 * len(worlds)
    assert [t.shape for t in empty] == [(0,)] * 3
    # the wrapper's `slam.assoc` span shows on the device too, as an annotation
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not e.key.startswith(("Memcpy", "Memset", "slam."))}
    assert sum(kernels.values()) == 2 * len(worlds), kernels
    assert all("assoc_kernel" in k for k in kernels), kernels


def test_assoc_kernel_repeats_bit_for_bit(cuda):
    """The cluster's ranks finish in any order; 50 runs with ties give the
    same bits."""
    oxy, ot, lxy, lt, cov = chip_smoke.assoc_world(512, 4096, 4, ties=True)
    for mahalanobis in (False, True):
        first = A.associate_kernel(oxy, ot, lxy, lt, 9.21, cov, mahalanobis=mahalanobis)
        for _ in range(49):
            got = A.associate_kernel(oxy, ot, lxy, lt, 9.21, cov, mahalanobis=mahalanobis)
            assert all(torch.equal(g, f) for g, f in zip(got, first))


def test_assoc_kernel_rejects_bad_inputs(cuda):
    oxy, ot, lxy, lt, cov = chip_smoke.assoc_world(8, 16, 0)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    count = torch.tensor(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy.double(), ot, lxy, lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot.long(), lxy, lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy.t().contiguous().t(), lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy.cpu(), lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy, lt, 9.21, cov[:, :2].contiguous(), mahalanobis=True)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy, lt, 1.44, obs_valid=valid.int())
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy, lt, 1.44, obs_valid=valid[:7])
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy, lt, 1.44, lm_count=count.long())
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy, lt, 1.44, lm_count=count.cpu())
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, torch.stack([ot, ot], 1)[:, 0], lxy, lt, 1.44)  # strided int32


@pytest.mark.parametrize("s,n,m,seed,ties", chip_smoke.ASSOC_BATCHED_CHECKS)
@pytest.mark.parametrize("mahalanobis", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_assoc_kernel_batched_bit_equal_to_plain(cuda, s, n, m, seed, ties, mahalanobis, masked):
    """S sessions in one launch: bit-equal to the twin on the stack and to S
    single twin calls, at the batched path's 16 x 512 x 256, ragged sizes
    over chunks and cluster ranks, with ties, masks and the float type
    column."""
    before = A.launches
    err = chip_smoke.assoc_batched_check(s, n, m, seed, ties, mahalanobis, masked)[2]
    assert A.launches == before + 1
    assert err == 0.0


def test_assoc_kernel_batched_rejects_bad_inputs(cuda):
    worlds = [chip_smoke.assoc_world(8, 16, i) for i in range(3)]
    oxy, ot, lxy, lt, _ = (torch.stack([w[k] for w in worlds]) for k in range(5))
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy[:2].contiguous(), lt[:2].contiguous(), 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy, lt, 1.44, lm_count=torch.ones(
            2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        A.associate_kernel(oxy[None], ot[None], lxy[None], lt[None], 1.44)


@pytest.mark.parametrize("s,n", chip_smoke.CHOL_BATCHED_CHECKS)
def test_cholesky_kernel_batched_matches_plain_and_single(cuda, s, n):
    """[S, n, n] in one launch: within the twin's tolerance and bit-equal to
    S single launches."""
    assert chip_smoke.chol_batched_check(s, n) <= chip_smoke.CHOL_ATOL + 1.0


def test_cholesky_kernel_batched_is_one_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    a = torch.stack([chip_smoke.spd(384, seed=i) for i in range(16)])
    C.cholesky_kernel(a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        C.cholesky_kernel(a)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not e.key.startswith(("Memcpy", "Memset"))}
    assert sum(kernels.values()) == 1 and all("persistent_cholesky" in k for k in kernels)


def test_cholesky_dispatcher_picks_on_the_matrix_size(cuda):
    """The kernel up to n = 1536 whatever the batch, the library above."""
    before = C.launches
    C.cholesky(torch.stack([chip_smoke.spd(8, seed=i) for i in range(1600)]))
    assert C.launches == before + 1
    C.cholesky(torch.stack([chip_smoke.spd(1600)] * 2))
    assert C.launches == before + 1


@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 200, 384, 768, 1152, 1536])
def test_cholesky_kernel_matches_plain(cuda, n):
    a = chip_smoke.spd(n)
    before = C.launches
    got = C.cholesky_kernel(a)
    assert C.launches == before + 1
    torch.testing.assert_close(got, C.cholesky_plain(a), atol=5e-4, rtol=1e-3)
    assert float((got @ got.T - a).abs().max()) <= 5e-3
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


def test_cholesky_kernel_clamps_nonpositive_pivots(cuda):
    """A non-positive pivot is clamped (rsqrt(max(pivot, 1e-30))) as the twin
    clamps it, instead of stopping the factorization."""
    a = chip_smoke.spd(80)
    a[70, 70] = -1.0
    got, want = C.cholesky_kernel(a).cpu(), C.cholesky_plain(a).cpu()
    assert got[70, 70] < 0 and torch.isfinite(got[:71, :71]).all()
    torch.testing.assert_close(got[:71, :71], want[:71, :71], atol=5e-4, rtol=1e-3)


def test_cholesky_kernel_repeats_bit_for_bit(cuda):
    """Blocks claim tiles in another order every run; the factor must not
    change by a bit (a missed cross-block ordering shows up here)."""
    a = chip_smoke.spd(chip_smoke.CLOSURE_N)
    first = C.cholesky_kernel(a)
    for _ in range(49):
        assert torch.equal(C.cholesky_kernel(a), first)


def test_cholesky_kernel_is_one_launch(cuda):
    from torch.profiler import ProfilerActivity, profile
    a = chip_smoke.spd(chip_smoke.CLOSURE_N)
    C.cholesky_kernel(a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            C.cholesky_kernel(a)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not e.key.startswith(("Memcpy", "Memset"))}
    assert sum(kernels.values()) == 3, kernels
    assert all("persistent_cholesky" in k for k in kernels), kernels


def test_cholesky_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(ValueError):
        C.cholesky_kernel(chip_smoke.spd(8).double())
    with pytest.raises(ValueError):
        C.cholesky_kernel(torch.zeros(4, 5, device=cuda))


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_skidpad_on_cuda_matches_cpu(cuda, name):
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=2))
    kw = {} if name == "first" else dict(association="nearest", use_pallas_association=True)
    cfg = SlamConfig(capacity=GraphCapacity(128, 128, 4096), **kw)
    runs = {}
    for dev in ("cpu", cuda):
        obs = torch.tensor(scen.obs, dtype=torch.float32, device=dev)
        valid = torch.tensor(scen.obs_valid, device=dev)
        poses = torch.tensor(scen.odom_poses, dtype=torch.float32, device=dev)
        before = A.launches
        runs[str(dev)] = run_pass(obs, valid, poses, cfg)
        if str(dev) != "cpu" and name == "nearest":
            assert A.launches - before == len(scen.times)
    (sc, oc), (sg, og) = runs["cpu"], runs["cuda"]
    for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    for f in ("n_landmarks", "n_obs", "lm_type", "obs_lm", "obs_pose"):
        assert torch.equal(getattr(sg.graph, f).cpu(), getattr(sc.graph, f)), f
    np.testing.assert_allclose(sg.graph.poses.cpu().numpy(), sc.graph.poses.numpy(), atol=1e-3)
    assert bool(sg.loop_closure_complete)


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_blocked_skidpad_on_cuda_matches_cpu(cuda, name):
    """The blocked pipeline on the card against the port's CPU run of it:
    discrete outputs and state exact, edge indices up to n_obs and
    published poses exact (no GN publishes them), edge measurements within
    1e-5, the rest within the closure GN's tolerance (its CUDA sums are
    atomics); with the kernel, one launch per block run."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=2))
    kw = {} if name == "first" else dict(association="nearest", use_pallas_association=True)
    cfg = SlamConfig(capacity=GraphCapacity(128, 128, 4096), **kw)
    block = 8
    runs = {}
    for dev in ("cpu", cuda):
        obs = torch.tensor(scen.obs, dtype=torch.float32, device=dev)
        valid = torch.tensor(scen.obs_valid, device=dev)
        poses = torch.tensor(scen.odom_poses, dtype=torch.float32, device=dev)
        before = A.launches
        runs[str(dev)] = run_pass_blocked(obs, valid, poses, cfg, block=block)
        launched = A.launches - before
    (sc, oc), (sg, og) = runs["cpu"], runs["cuda"]
    assert bool(sg.loop_closure_complete)
    if name == "nearest":
        kc = int(torch.nonzero(oc.loop_closed)[0])
        nb = -(-len(scen.times) // block)
        assert launched == kc // block + 1 + nb - (kc + 1) // block, launched
    for f in ("pose", "send", "loop_closed", "n_landmarks", "cone_type"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    n = int(sc.graph.n_obs)
    for f in ("n_landmarks", "n_obs", "n_poses", "lm_type"):
        assert torch.equal(getattr(sg.graph, f).cpu(), getattr(sc.graph, f)), f
    for f in ("obs_lm", "obs_pose"):
        assert torch.equal(getattr(sg.graph, f)[:n].cpu(), getattr(sc.graph, f)[:n]), f
    # CUDA's and the CPU's sin, cos and asin differ in the last bits
    np.testing.assert_allclose(sg.graph.obs_xy[:n].cpu().numpy(), sc.graph.obs_xy[:n].numpy(),
                               atol=1e-5, rtol=0)
    for f in ("current_cone_index", "keyframe_count", "send_cone_data", "loop_closing"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f
    np.testing.assert_allclose(sg.graph.poses.cpu().numpy(), sc.graph.poses.numpy(), atol=1e-3)
    np.testing.assert_allclose(sg.graph.lm_xy.cpu().numpy(), sc.graph.lm_xy.numpy(), atol=1e-3)
    np.testing.assert_allclose(og.cone_distance.cpu().numpy(), oc.cone_distance.numpy(), atol=1e-3)


@pytest.mark.parametrize("name", ["I1", "I2"])
@pytest.mark.parametrize("block", [None, 16], ids=["per_frame", "blocked16"])
def test_improved_skidpad_on_cuda_matches_cpu(cuda, name, block):
    """The improved mode (chip_smoke.IMPROVED) on a skidpad lap of 93
    keyframes, per frame and at block 16, on the card against the port's
    CPU run, within chip_smoke.py's contract for the phase `improved`:
    closure, sends, edges and poses inserted exact; landmarks, current cone
    and every discrete output exact unless a gate decision flipped (the
    GN's CUDA sums are atomics), and then landmarks within 2 and published
    poses within 0.05 m; values within chip_smoke.POSE_ATOL otherwise. I2
    launches the kernel's Mahalanobis form once per keyframe, or per block."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, keyframe_dt=0.1, speed=8.0, max_range=20.0,
                                         seed=4))
    cfg = SlamConfig.improved(capacity=GraphCapacity(256, 128, 4096), **chip_smoke.IMPROVED[name])
    runs = {}
    for dev in ("cpu", cuda):
        before = A.launches
        runs[str(dev)] = chip_smoke.improved_lap(cfg, block, *chip_smoke.inputs(scen, dev))
        launched = A.launches - before
    (sc, oc), (sg, og) = runs["cpu"], runs["cuda"]
    t = len(scen.times)
    assert bool(sg.loop_closure_complete)
    if name == "I2":
        kc = int(torch.nonzero(oc.loop_closed)[0])
        assert launched == (t if block is None else
                            kc // block + 1 + -(-t // block) - (kc + 1) // block), launched
    for f in ("send", "loop_closed"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    for f in ("n_obs", "n_poses"):
        assert torch.equal(getattr(sg.graph, f).cpu(), getattr(sc.graph, f)), f
    flipped = not (torch.equal(og.n_landmarks.cpu(), oc.n_landmarks)
                   and torch.equal(og.cone_type.cpu(), oc.cone_type)
                   and torch.equal(sg.current_cone_index.cpu(), sc.current_cone_index))
    if flipped:
        assert abs(int(sg.graph.n_landmarks) - int(sc.graph.n_landmarks)) \
            <= chip_smoke.CROSS_PATH_LANDMARKS
        d = torch.linalg.norm(og.pose.cpu()[:, :2] - oc.pose[:, :2], dim=1)
        assert float(d.max()) <= chip_smoke.CROSS_PATH_POSE_M
        return
    n = int(sc.graph.n_obs)
    for f in ("obs_lm", "obs_pose"):
        assert torch.equal(getattr(sg.graph, f)[:n].cpu(), getattr(sc.graph, f)[:n]), f
    atol = chip_smoke.POSE_ATOL
    np.testing.assert_allclose(og.pose.cpu().numpy(), oc.pose.numpy(), atol=atol)
    np.testing.assert_allclose(sg.graph.poses.cpu().numpy(), sc.graph.poses.numpy(), atol=atol)
    np.testing.assert_allclose(sg.graph.lm_xy.cpu().numpy(), sc.graph.lm_xy.numpy(), atol=atol)


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_batched_skidpad_on_cuda_matches_cpu(cuda, name):
    """Three skidpad sessions through `run_sequences_blocked_batched` on the
    card against the port's CPU run of it: discrete outputs and state exact,
    the rest within the closure GN's tolerance; with the kernel, one launch
    per block for all sessions."""
    scens = [simulate(skidpad(), SimConfig(laps=1.3, seed=2 + s)) for s in range(3)]
    t = min(len(sc.times) for sc in scens)
    kw = {} if name == "first" else dict(association="nearest", use_pallas_association=True)
    cfg = SlamConfig(capacity=GraphCapacity(128, 128, 4096), **kw)
    block = 8
    runs = {}
    for dev in ("cpu", cuda):
        obs = torch.tensor(np.stack([sc.obs[:t] for sc in scens]), dtype=torch.float32,
                           device=dev)
        valid = torch.tensor(np.stack([sc.obs_valid[:t] for sc in scens]), device=dev)
        poses = torch.tensor(np.stack([sc.odom_poses[:t] for sc in scens]), dtype=torch.float32,
                             device=dev)
        before = A.launches
        runs[str(dev)] = run_sequences_blocked_batched(initial_states(cfg.capacity, 3, dev), obs,
                                                       valid, poses, cfg, block=block)
        launched = A.launches - before
    (sc, oc), (sg, og) = runs["cpu"], runs["cuda"]
    assert bool(sg.loop_closure_complete.all())
    if name == "nearest":
        kc = [int(torch.nonzero(lc)[0]) for lc in oc.loop_closed]
        nb = -(-t // block)
        assert launched == max(kc) // block + 1 + nb - min(kc) // block, launched
    for f in ("pose", "send", "loop_closed", "n_landmarks", "cone_type"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    for f in ("n_landmarks", "n_obs", "n_poses", "lm_type"):
        assert torch.equal(getattr(sg.graph, f).cpu(), getattr(sc.graph, f)), f
    for s in range(3):
        n = int(sc.graph.n_obs[s])
        for f in ("obs_lm", "obs_pose"):
            assert torch.equal(getattr(sg.graph, f)[s, :n].cpu(), getattr(sc.graph, f)[s, :n]), f
    for f in ("current_cone_index", "keyframe_count", "send_cone_data", "loop_closing"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f
    np.testing.assert_allclose(sg.graph.poses.cpu().numpy(), sc.graph.poses.numpy(), atol=1e-3)
    np.testing.assert_allclose(sg.graph.lm_xy.cpu().numpy(), sc.graph.lm_xy.numpy(), atol=1e-3)
    np.testing.assert_allclose(og.cone_distance.cpu().numpy(), oc.cone_distance.numpy(), atol=1e-3)


def test_estimate_se2_on_cuda_matches_cpu(cuda):
    """The ICP registration (tests/test_fusion.py's outlier case) on the card
    against the CPU: the same match count, the transform within 1e-5."""
    rng = np.random.default_rng(5)
    dst = rng.uniform(-20, 20, (80, 2)).astype(np.float32)
    types = rng.integers(1, 4, 80).astype(np.int32)
    src = (dst + rng.normal(0, 0.05, dst.shape) + [0.4, -0.3]).astype(np.float32)
    valid = np.ones(80, bool)
    for trim in (0.0, 0.75):
        got, want = (fusion.estimate_se2(*(torch.tensor(x, device=dev) for x in (
            src, types, valid, dst, types, valid)), gate=3.0, iters=10, trim=trim)
            for dev in (cuda, "cpu"))
        assert int(got[1]) == int(want[1])
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(), atol=1e-5)


def test_fusion_on_cuda_matches_cpu(cuda):
    """Three improved-mode skidpad sessions (Mahalanobis, GPS priors), merged
    on the card and on the CPU, anchored and aligned: labels, landmark and
    merge counts, matches and edges exact; transforms within 1e-5, merged
    values within 1e-3 (the merge's sums are atomics on the card)."""
    scens = [simulate(skidpad(), SimConfig(laps=1.3, seed=2 + s)) for s in range(3)]
    t = min(len(sc.times) for sc in scens)
    cfg = SlamConfig.improved(capacity=GraphCapacity(128, 128, 4096), association="mahalanobis",
                              periodic_gn_every=0)
    ins = [torch.tensor(np.stack([getattr(sc, f)[:t] for sc in scens])) for f in
           ("obs", "obs_valid", "odom_poses")]
    st, _ = run_sequences_blocked_batched(initial_states(cfg.capacity, 3, "cpu"),
                                          ins[0].float(), ins[1], ins[2].float(), cfg, block=8)
    g, info = st.graph, st.lm_info_xy
    for align in (False, True):
        (fc, rc), (fg, rg) = (fusion.fuse_sessions(
            type(g)(**{k: v.to(dev) for k, v in vars(g).items()}), cfg=None, gate=1.2,
            lm_info=info.to(dev), align=align, robust=True) for dev in ("cpu", cuda))
        for k in ("labels", "n_merged_landmarks", "n_cross_session_merges"):
            assert torch.equal(rg[k].cpu(), rc[k]), k
        assert torch.equal(rg["n_align_matched"][1:].cpu(), rc["n_align_matched"][1:])
        np.testing.assert_allclose(rg["tforms"].cpu().numpy(), rc["tforms"].numpy(), atol=1e-5)
        for f in ("n_poses", "n_landmarks", "n_obs", "lm_type", "obs_pose", "obs_lm"):
            assert torch.equal(getattr(fg, f).cpu(), getattr(fc, f)), f
        for f in ("poses", "lm_xy", "odo_w", "prior_pose"):
            np.testing.assert_allclose(getattr(fg, f).cpu().numpy(), getattr(fc, f).numpy(),
                                       atol=1e-3, err_msg=f)


@pytest.mark.parametrize("name", list(chip_smoke.VLP16_REFERENCE))
def test_detect_cones_on_cuda_matches_cpu(cuda, name):
    """bench.py's lidar scenes through `detect_cones` on the card against the
    port's CPU run: with the same (the port's seed-0) triples the cone count,
    validity and labels exact, the tuples within 1e-4 (the cluster sums are
    atomics); with the JAX package's triples, VLP16_REFERENCE."""
    from tpuslam_torch.perception.attention import (
        _connected_components, _connected_components_grid, detect_cones)
    pts, valid, acfg = chip_smoke.vlp16_scenes()[name]
    p_c, v_c = torch.tensor(pts), torch.tensor(valid)
    p_g, v_g = p_c.to(cuda), v_c.to(cuda)
    (cg, okg, ng), (cc, okc, nc) = detect_cones(p_g, v_g, acfg), detect_cones(p_c, v_c, acfg)
    assert int(ng) == int(nc) and torch.equal(okg.cpu(), okc)
    np.testing.assert_allclose(cg.cpu().numpy(), cc.numpy(), atol=1e-4, rtol=0)
    obstacle = v_c & (p_c[:, 2] > -0.85) & (p_c[:, 2] < -0.1)
    cc_fn = _connected_components_grid if len(pts) > acfg.dense_max_points \
        else _connected_components
    assert torch.equal(cc_fn(p_g[:, :2], obstacle.to(cuda), acfg).cpu(),
                       cc_fn(p_c[:, :2], obstacle, acfg))
    want = chip_smoke.VLP16_REFERENCE[name]
    chip_smoke.check_cones(name, detect_cones(p_g, v_g, acfg, ransac_idx=torch.tensor(
        want["triples"], device=cuda)), want["cones"])


def test_ekf_on_cuda_matches_cpu(cuda):
    """BASELINE config 2 through the port's EKF on the card and on the CPU:
    fused poses within 1e-5, the ATEs of EKF_REFERENCE."""
    gps_g, ekf_g, fused_g = chip_smoke.ekf_accel(cuda)
    gps_c, ekf_c, fused_c = chip_smoke.ekf_accel("cpu")
    np.testing.assert_allclose(fused_g, fused_c, atol=1e-5, rtol=0)
    assert abs(ekf_g - chip_smoke.EKF_REFERENCE["accel_ate_ekf"]) <= chip_smoke.METRIC_ATOL_M
    assert gps_g == gps_c


def test_service_replay_on_cuda_matches_cpu(cuda, tmp_path):
    """A skidpad lap replayed from a .rec through `SlamService` on the card
    and on the CPU, with the association kernel: discrete outputs exact,
    values within POSE_ATOL, one kernel launch per keyframe on the card."""
    from tpuslam_torch.runtime.service import SlamService, scenario_to_rec
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=31))
    cfg = SlamConfig(capacity=GraphCapacity(128, 64, 2048), time_between_keyframes_ms=100.0,
                     association="nearest", use_pallas_association=True)
    rec = str(tmp_path / "lap.rec")
    scenario_to_rec(scen, rec, cfg)
    runs = {}
    for dev in ("cpu", cuda):
        svc = SlamService(cfg, device=dev)
        recorder = chip_smoke.Recorder(svc.slam)
        before = A.launches
        svc.run_replay(rec)
        runs[str(dev)] = (svc, recorder, A.launches - before)
    (sc, rc, _), (sg, rg, launched) = runs["cpu"], runs["cuda"]
    assert sg.slam.keyframes_processed == sc.slam.keyframes_processed == launched
    assert sg.slam.loop_closure_complete
    chip_smoke.compare_outputs("replay", rg.stacked(), rc.stacked())
    chip_smoke.compare_published("replay", rg.published, rc.published, sc.slam._gps_ref)


@pytest.mark.parametrize("name", ["first", "nearest"])
def test_passes_batched_on_cuda_matches_cpu(cuda, name):
    """Three skidpad sessions through the per-frame batched engine on the
    card against the port's CPU run of it: discrete outputs exact, values
    within the closure GN's tolerance; with the kernel, one launch per
    frame for all sessions."""
    from tpuslam_torch.parallel.batch import run_passes_batched
    scens = [simulate(skidpad(), SimConfig(laps=1.3, seed=2 + s)) for s in range(3)]
    t = min(len(sc.times) for sc in scens)
    ins = [np.stack([getattr(sc, f)[:t] for sc in scens]) for f in ("obs", "obs_valid",
                                                                   "odom_poses")]
    ins = [x.astype(np.float32) if x.dtype == np.float64 else x for x in ins]
    kw = {} if name == "first" else dict(association="nearest", use_pallas_association=True)
    cfg = SlamConfig(capacity=GraphCapacity(128, 128, 4096), **kw)
    before = A.launches
    sg, og = run_passes_batched(*ins, cfg, device=cuda)
    launched = A.launches - before
    sc, oc = run_passes_batched(*ins, cfg, device="cpu")
    assert launched == (t if name == "nearest" else 0)
    assert bool(sg.loop_closure_complete.all())
    for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    for f in ("n_landmarks", "n_obs", "n_poses", "lm_type"):
        assert torch.equal(getattr(sg.graph, f).cpu(), getattr(sc.graph, f)), f
    np.testing.assert_allclose(sg.graph.poses.cpu().numpy(), sc.graph.poses.numpy(), atol=1e-3)
    np.testing.assert_allclose(og.pose.cpu().numpy(), oc.pose.numpy(), atol=1e-3)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL world in this process and its 1 x 1 mesh on the card,
    destroyed after the module's cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from tpuslam_torch.parallel.mesh import initialize_distributed, make_slam_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mine = initialize_distributed("nccl")
    yield make_slam_mesh(1, 1, device_type="cuda")
    if mine:
        dist.destroy_process_group()


def test_world_of_one_mesh_paths_on_cuda(cuda, nccl_mesh):
    """The mesh paths on a one-rank NCCL mesh on the card, each against its
    unsharded form on the card, with their kernel launches:
    `distributed_optimize` through the Cholesky kernel (one launch per
    iteration, within 1e-3 of `gauss_newton.optimize`); the fleet with
    the association kernel (one launch per block, equal to the batched
    core); `associate_sharded` (equal to `associate`); the fusion with a
    mesh (labels exact, values within 1e-3 of the fusion without one)."""
    import dataclasses

    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.frontend.blocked import blocked_core_batched
    from tpuslam_torch.frontend.keyframe import _gn_config
    from tpuslam_torch.ops.association import associate
    from tpuslam_torch.parallel import (
        associate_sharded, distributed_optimize, run_fleet_blocked,
    )
    scens = [simulate(skidpad(), SimConfig(laps=1.3, seed=2 + s)) for s in range(2)]
    t = min(len(sc.times) for sc in scens) // 8 * 8
    obs, valid, poses = (torch.tensor(np.stack([getattr(sc, f)[:t] for sc in scens]),
                                      device=cuda)
                         for f in ("obs", "obs_valid", "odom_poses"))
    obs, poses = obs.float(), poses.float()
    cfg = SlamConfig(capacity=GraphCapacity(128, 128, 4096), association="nearest",
                     use_pallas_association=True)
    before = A.launches
    st, outs, done = run_fleet_blocked(initial_states(cfg.capacity, 2, cuda), obs, valid, poses,
                                       cfg, nccl_mesh, block=8)
    launched = A.launches - before
    ref, ref_outs, ref_done = blocked_core_batched(initial_states(cfg.capacity, 2, cuda), obs,
                                                   valid, poses, cfg, 8)
    assert done == ref_done == [t, t] and launched > 0
    for f in ("loop_closed", "n_landmarks", "cone_type", "send"):
        assert torch.equal(getattr(outs, f), getattr(ref_outs, f)), f
    np.testing.assert_allclose(st.graph.poses.cpu().numpy(), ref.graph.poses.cpu().numpy(),
                               atol=1e-3)

    g = dataclasses.replace(st.graph, **{f.name: getattr(st.graph, f.name)[0]
                                         for f in dataclasses.fields(st.graph)})
    gcfg = dataclasses.replace(_gn_config(cfg), use_cholesky_kernel=True, iterations=3)
    before = C.launches
    d = distributed_optimize(g, gcfg, nccl_mesh)
    assert C.launches - before == 3
    want = gn.optimize(g, dataclasses.replace(gcfg, early_exit_tol=0.0))
    np.testing.assert_allclose(d.poses.cpu().numpy(), want.poses.cpu().numpy(), atol=1e-3)

    oxy, ot, lxy, lt, packed = chip_smoke.assoc_world(64, 256, 4, cuda)
    ov = torch.ones(64, dtype=torch.bool, device=cuda)
    lv = torch.arange(256, device=cuda) < 200
    for mode in ("first", "nearest"):
        got = associate_sharded(oxy, ot, ov, lxy, lt, lv, 1.5, nccl_mesh, mode=mode)
        want = associate(oxy, ot, ov, lxy, lt, lv, 1.5, mode=mode)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0][got[1]], want[0][want[1]])

    fused, rep = fusion.fuse_sessions(st.graph, cfg=gn.GNConfig(iterations=3), gate=1.2,
                                      mesh=nccl_mesh)
    fused_w, rep_w = fusion.fuse_sessions(st.graph, cfg=gn.GNConfig(iterations=3,
                                                                    early_exit_tol=0.0),
                                          gate=1.2)
    assert torch.equal(rep["labels"], rep_w["labels"])
    np.testing.assert_allclose(fused.lm_xy.cpu().numpy(), fused_w.lm_xy.cpu().numpy(), atol=1e-3)


# -- the blocks' CUDA graphs (frontend/blocked.py `_run_block`) against the eager blocks --

FLEET_SLAM = json.loads((Path(__file__).resolve().parents[1] / "slambench" / "configs"
                         / "trackdrive_nearest.json").read_text())["slam"]


@functools.lru_cache(maxsize=None)
def _fleet_scenarios(sessions: int, first_seed: int):
    """Trackdrive sessions as the replay benchmark's fleet makes them (1.4
    laps at 8 m/s, a keyframe each 0.1 s, range 20 m), one noise seed each."""
    return [simulate(trackdrive(seed=11), SimConfig(laps=1.4, keyframe_dt=0.1, speed=8.0,
                                                    max_range=20.0, seed=first_seed + s))
            for s in range(sessions)]


def _fleet_inputs(device, sessions: int, first_seed: int = 0, cut: int | None = None):
    """(obs, valid, poses) [S, T, ...] of `_fleet_scenarios`; with `cut`, every
    session but the first has its frames from `cut` on past the GPS guard
    (no-ops), so only the first inserts poses up to the end."""
    scens = _fleet_scenarios(sessions, first_seed)
    t = min(len(sc.times) for sc in scens)
    obs, valid, poses = (torch.tensor(np.stack([getattr(sc, f)[:t] for sc in scens]),
                                      device=device)
                         for f in ("obs", "obs_valid", "odom_poses"))
    obs, poses = obs.float(), poses.float()
    if cut is not None:
        poses[1:, cut:] = 2.0 * FLEET_SLAM["gps_outlier_bound"] + 1.0
    return obs, valid, poses


def _core(states, obs, valid, poses, cfg, block):
    """`blocked_core_batched` as `run_sequences_blocked_batched` calls it."""
    obs, valid, poses = blocked._pad_inputs(obs, valid, poses, cfg, block)
    nc, frozen = blocked._pick_compact(valid, states)
    return blocked.blocked_core_batched(states, obs, valid, poses, cfg, block, compact_obs=nc,
                                        frozen=frozen)


def _eager(monkeypatch, fn):
    """`fn()` with the blocks run eagerly."""
    with monkeypatch.context() as m:
        m.setattr(blocked, "_use_graphs", lambda x, mesh: False)
        return fn()


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms, so that the GNs' `index_add_` sums
    add in a fixed order (on the card they are atomics otherwise, and a
    value after a GN may differ in its last bits from one run to the next),
    and the graphs captured anew under them."""
    blocked.block_graphs.clear()
    gn.window_graphs.clear()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _assert_graph_equals_eager(got, eager, eager_again, atol):
    """A graph run's results against two eager runs, tensor by tensor: bit
    for bit wherever the two eager runs agree bit for bit. A tensor in
    which they differ even so is not deterministic eagerly: there a float
    is held within `atol` of the first eager run and an integer or flag to
    one of the two."""
    trio = [cg.tensors(x) for x in (got, eager, eager_again)]
    assert len({len(x) for x in trio}) == 1
    for i, (g, a, b) in enumerate(zip(*trio)):
        g, a, b = g.cpu(), a.cpu(), b.cpu()
        assert g.shape == a.shape and g.dtype == a.dtype, i
        off = (g != a) & ~((g != g) & (a != a))
        what = f"tensor {i} {tuple(g.shape)}: {int(off.sum())} elements differ"
        if g.is_floating_point() and bool(off.any()):
            what += f" by up to {float((g - a).abs()[off].max())}"
        if bool(((a == b) | ((a != a) & (b != b))).all()):
            assert not bool(off.any()), what
        elif g.is_floating_point():
            torch.testing.assert_close(g, a, rtol=0, atol=atol, equal_nan=True, msg=what)
        else:
            assert bool(((g == a) | (g == b)).all()), what


def test_block_graphs_equal_eager_fleet_with_a_fallback(cuda, deterministic, monkeypatch):
    """The fleet configuration at S = 8 with a pose capacity that only the
    first session outgrows: it falls back in a localization block and keeps
    its state from before that block (`_hold`), the others run on. The
    graphs give the eager blocks' states, outputs and fallback frames."""
    cap = GraphCapacity(320, 256, 4096)
    cfg = SlamConfig(capacity=cap, **FLEET_SLAM)
    ins = _fleet_inputs(cuda, 8, cut=300)

    def run():
        return _core(initial_states(cap, 8, cuda), *ins, cfg, 32)
    eager, eager_again = _eager(monkeypatch, run), _eager(monkeypatch, run)
    replays = blocked.block_graphs.replays
    got = run()
    assert blocked.block_graphs.replays > replays
    tp = got[1].pose.shape[1]
    assert got[2][0] < tp and got[2][1:] == [tp] * 7, got[2]
    assert got[2] == eager[2] == eager_again[2]
    _assert_graph_equals_eager(got[:2], eager[:2], eager_again[:2], chip_smoke.POSE_ATOL)


def test_block_graphs_equal_eager_improved_block16(cuda, deterministic, monkeypatch):
    """The improved mode (Mahalanobis gating through the kernel, GPS
    priors, both refines, a fixed-lag periodic GN every 16 keyframes) at
    block 16: the periodic GNs run eagerly between the replays."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, keyframe_dt=0.1, speed=8.0, max_range=20.0,
                                         seed=4))
    cfg = SlamConfig.improved(capacity=GraphCapacity(256, 128, 4096), **chip_smoke.IMPROVED["I2"])
    assert cfg.periodic_gn_every == 16
    ins = chip_smoke.inputs(scen, cuda)

    def run():
        return run_pass_blocked(*ins, cfg, block=16)
    eager, eager_again = _eager(monkeypatch, run), _eager(monkeypatch, run)
    replays = blocked.block_graphs.replays
    got = run()
    assert blocked.block_graphs.replays > replays
    _assert_graph_equals_eager(got, eager, eager_again, chip_smoke.POSE_ATOL)


def test_block_graphs_leave_earlier_results_alone(cuda):
    """Two calls on different inputs of one shape replay the same graphs:
    what the first call returned does not change under the second."""
    cfg = SlamConfig(capacity=GraphCapacity(384, 256, 4096), **FLEET_SLAM)
    first = run_sequences_blocked_batched(initial_states(cfg.capacity, 4, cuda),
                                          *_fleet_inputs(cuda, 4, 0), cfg, block=32)
    kept = cg.fresh(first)
    replays = blocked.block_graphs.replays
    second = run_sequences_blocked_batched(initial_states(cfg.capacity, 4, cuda),
                                           *_fleet_inputs(cuda, 4, 10), cfg, block=32)
    assert blocked.block_graphs.replays > replays
    for a, b in zip(cg.tensors(first), cg.tensors(kept)):
        assert torch.equal(a, b)
    assert not torch.equal(first[1].pose, second[1].pose)


def test_block_graphs_capture_once_per_key_and_replay_per_block(cuda):
    """A new key is captured once, in the call that meets it (its mapping
    and its localization blocks: two keys); each block after that is one
    replay, as each is one association kernel launch."""
    graphs = blocked.block_graphs
    graphs.clear()
    cfg = SlamConfig(capacity=GraphCapacity(384, 256, 4096), **FLEET_SLAM)
    for k, seed in enumerate((0, 10)):
        captures, replays, launches = graphs.captures, graphs.replays, A.launches
        run_sequences_blocked_batched(initial_states(cfg.capacity, 3, cuda),
                                      *_fleet_inputs(cuda, 3, seed), cfg, block=32)
        assert graphs.captures - captures == (2 if k == 0 else 0)
        blocks = A.launches - launches
        assert blocks >= 2 and graphs.replays - replays == blocks
    assert len(graphs) == 2


def test_block_graphs_capture_again_under_deterministic_algorithms(cuda):
    """A block key captured with torch's deterministic algorithms off is
    captured again, not replayed, once they are on: they choose the kernels
    a capture holds."""
    graphs = blocked.block_graphs
    graphs.clear()
    cfg = SlamConfig(capacity=GraphCapacity(384, 256, 4096), **FLEET_SLAM)

    def run():
        run_sequences_blocked_batched(initial_states(cfg.capacity, 2, cuda),
                                      *_fleet_inputs(cuda, 2, 0), cfg, block=32)
    run()
    captures = graphs.captures
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        run()
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphs.captures - captures == 2
    assert sorted(k[3] for k in graphs) == [False, False, True, True]


def test_block_graph_segments_do_not_sync(cuda):
    """A replayed block's copies in, its two graphs and the association
    kernel between them make no host sync."""
    blocked.block_graphs.clear()
    cfg = SlamConfig(capacity=GraphCapacity(384, 256, 4096), **FLEET_SLAM)
    run_sequences_blocked_batched(initial_states(cfg.capacity, 2, cuda),
                                  *_fleet_inputs(cuda, 2, 0), cfg, block=32)
    assert len(blocked.block_graphs) == 2
    for bg in blocked.block_graphs.values():
        leaves = [t.clone() for t in bg.ins]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bg.load(leaves)
            bg.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def test_improved_fleet_spans_leave_the_bits_alone(cuda, deterministic):
    """The improved fleet pass (the benchmark's `improved_fleet`
    configuration) at S = 8 under the profiler, whose `slam.window_gn` and
    `slam.publish_refine` spans then record, gives the bits of two runs
    without it wherever those two agree, and counts its rounds the same."""
    from torch.profiler import ProfilerActivity, profile
    cfg = SlamConfig.improved(capacity=GraphCapacity(384, 256, 4096), use_pallas_association=True)
    ins = _fleet_inputs(cuda, 8)

    def run():
        rounds = blocked.window_gn_rounds
        out = run_sequences_blocked_batched(initial_states(cfg.capacity, 8, cuda), *ins, cfg,
                                            block=32)
        torch.cuda.synchronize()
        return out, blocked.window_gn_rounds - rounds

    (plain, rounds), (again, rounds_again) = run(), run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced, rounds_traced = run()
    names = {e.key for e in prof.key_averages()}
    assert {"slam.window_gn", "slam.publish_refine"} <= names
    assert rounds == rounds_again == rounds_traced > 0
    _assert_graph_equals_eager(traced, plain, again, chip_smoke.POSE_ATOL)


def _eager_windows(monkeypatch, fn):
    """`fn()` with the window GN's loops run eagerly."""
    with monkeypatch.context() as m:
        m.setattr(gn, "_use_window_graphs", lambda g: False)
        return fn()


def test_window_graphs_equal_eager_improved_fleet(cuda, deterministic, monkeypatch):
    """The improved fleet pass (the benchmark's `improved_fleet`
    configuration) at S = 8, its window rounds replayed as CUDA graphs: two
    keys (the mapping rounds anchored at `end` and `end_obs`, the
    localization rounds at `end`), captured once each in the first pass and
    replayed once per round; the sessions but the first stop inserting
    poses at frame 300, so that the first fires alone in the last rounds;
    the states and outputs of the passes whose rounds ran eagerly."""
    cfg = SlamConfig.improved(capacity=GraphCapacity(384, 256, 4096), use_pallas_association=True)
    ins = _fleet_inputs(cuda, 8, cut=300)

    def run():
        return run_sequences_blocked_batched(initial_states(cfg.capacity, 8, cuda), *ins, cfg,
                                             block=32)
    eager, eager_again = _eager_windows(monkeypatch, run), _eager_windows(monkeypatch, run)
    graphs = gn.window_graphs
    for k in range(2):
        counts = (graphs.captures, graphs.replays, blocked.window_gn_rounds,
                  blocked.window_gn_firings)
        got = run()
        captures, replays, rounds, firings = (
            a - b for a, b in zip((graphs.captures, graphs.replays,
                                   blocked.window_gn_rounds, blocked.window_gn_firings), counts))
        assert captures == (2 if k == 0 else 0)
        assert replays == rounds > 0
        assert firings < 8 * rounds
        _assert_graph_equals_eager(got, eager, eager_again, chip_smoke.POSE_ATOL)
    assert len(graphs) == 2
    assert {key[1][4:] for key in graphs} == {(False, False), (False, True)}


@pytest.mark.parametrize("anchor", list(WG.ANCHORS))
@pytest.mark.parametrize("landmarks", [True, False], ids=["map_free", "map_fixed"])
def test_window_graphs_equal_eager_sessions_stopping_apart(cuda, deterministic, monkeypatch,
                                                           landmarks, anchor):
    """A round of four sessions on the card: one stops after the first
    iteration, one after the second, one runs all three, one is not
    enabled (`tests/test_torch_window_graph.py`). The replayed loop, which
    runs every iteration, gives the early-exit loop's bits."""
    g, end, end_obs, enable = WG.window_batch(cuda, landmarks, anchor)
    assert WG.iterations_run(g, landmarks, end, end_obs, enable) == WG.STOPS

    def run():
        return gn.optimize_window(g, WG.CFG, WG.W, WG.EW, enable=enable, landmarks=landmarks,
                                  end=end, end_obs=end_obs)
    eager, eager_again = _eager_windows(monkeypatch, run), _eager_windows(monkeypatch, run)
    replays = gn.window_graphs.replays
    got = run()
    assert gn.window_graphs.replays == replays + 1
    _assert_graph_equals_eager(got, eager, eager_again, chip_smoke.POSE_ATOL)
    assert torch.equal(got.poses[3], g.poses[3]) and torch.equal(got.lm_xy[3], g.lm_xy[3])


def test_window_graphs_equal_eager_in_the_per_frame_batched_engine(cuda, deterministic,
                                                                  monkeypatch):
    """`parallel/batch.py`'s stacked window GN, fired within a keyframe for
    every session at frames 16, 32 and 48 (its window at the graph's
    head), replays as graphs and gives the eager loop's bits."""
    cfg = SlamConfig.improved(capacity=GraphCapacity(384, 256, 4096), use_pallas_association=True)
    obs, valid, poses = (x[:, :48] for x in _fleet_inputs(cuda, 3))

    def run():
        return run_sequences_batched(initial_states(cfg.capacity, 3, cuda), obs, valid, poses,
                                     cfg)
    eager, eager_again = _eager_windows(monkeypatch, run), _eager_windows(monkeypatch, run)
    replays = gn.window_graphs.replays
    got = run()
    assert gn.window_graphs.replays > replays
    _assert_graph_equals_eager(got, eager, eager_again, chip_smoke.POSE_ATOL)


def test_window_graph_segments_do_not_sync(cuda):
    """A replayed round's copies in and its two graphs make no host sync."""
    gn.window_graphs.clear()
    g, end, end_obs, enable = WG.window_batch(cuda, True, "end_and_end_obs")
    gn.optimize_window(g, WG.CFG, WG.W, WG.EW, enable=enable, end=end, end_obs=end_obs)
    (wg,) = gn.window_graphs.values()
    ins = (gn._graph_fields(torch.clone, g), enable.clone(), end.clone(), end_obs.clone())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wg.load(*ins)
        for graph in wg.graphs:
            graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
