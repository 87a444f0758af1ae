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
from tpuslam.sim import SimConfig, simulate, skidpad
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.pipeline import run_pass
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.runtime.config import SlamConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,seed", [(37, 300, 0), (64, 256, 1), (61, 2000, 5), (5, 0, 2)])
@pytest.mark.parametrize("mahalanobis", [False, True])
def test_assoc_kernel_bit_equal_to_plain(cuda, n, m, seed, mahalanobis):
    oxy, ot, lxy, lt, cov = chip_smoke.assoc_world(n, max(m, 1), seed)
    lxy, lt, cov = lxy[:m].contiguous(), lt[:m].contiguous(), cov[:m].contiguous()
    gate2 = 9.21 if mahalanobis else 1.44
    before = A.launches
    got = A.associate_kernel(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis)
    want = A.associate_plain(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis)
    assert A.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_assoc_kernel_rejects_bad_inputs(cuda):
    oxy, ot, lxy, lt, _ = chip_smoke.assoc_world(8, 16, 0)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy.double(), ot, lxy, lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot.long(), lxy, lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy.t().contiguous().t(), lt, 1.44)
    with pytest.raises(ValueError):
        A.associate_kernel(oxy, ot, lxy.cpu(), lt, 1.44)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 768, 1536])
def test_cholesky_kernel_matches_plain(cuda, n):
    a = chip_smoke.spd(n)
    before = C.launches
    got = C.cholesky_kernel(a)
    assert C.launches == before + 1
    torch.testing.assert_close(got, C.cholesky_plain(a), atol=5e-4, rtol=1e-3)
    assert float((got @ got.T - a).abs().max()) <= 5e-3
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


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
