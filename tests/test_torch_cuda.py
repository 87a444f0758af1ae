"""Tests that need a CUDA device: each hand-written kernel against its plain
PyTorch twin on the card, the wrappers' input checks, and the per-frame
engine on the card against the port's own CPU run. They skip without a
device. The GPU machine has no JAX, so this file imports none; run it there
with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(the suite's conftest imports JAX)."""
import numpy as np
import pytest
import torch

import chip_smoke
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.pipeline import run_pass
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, simulate, skidpad

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
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not e.key.startswith(("Memcpy", "Memset"))}
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
