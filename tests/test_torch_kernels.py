"""The port's two kernels on the CPU: the plain PyTorch twins against the
JAX package's Pallas kernels (interpret mode), the wrappers' CPU routing
and launch counters, and the configurations the port refuses and those it
refused before the improved mode was ported. The CUDA
kernels themselves are tested in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_pallas_kernels import _world
from tpuslam.frontend.keyframe import _provider_associate as jax_provider_associate
from tpuslam.ops.association import associate as jax_associate
from tpuslam.ops.cholesky import cholesky_pallas
from tpuslam.ops.pallas_assoc import associate_pallas
from tpuslam.runtime.config import SlamConfig as JaxSlamConfig
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.keyframe import _provider_associate, perform_keyframe
from tpuslam_torch.frontend.state import initial_state
from tpuslam_torch.ops import assoc_kernel as A
from tpuslam_torch.ops import cholesky as C
from tpuslam_torch.ops.association import associate
from tpuslam_torch.runtime.config import SlamConfig


def _cov(m, seed=3):
    rng = np.random.default_rng(seed)
    sig = rng.uniform(0.2, 0.6, (m,))
    rho = rng.uniform(-0.3, 0.3, (m,))
    a = 1.0 / sig ** 2
    return np.stack([a, rho * a, a * (1 + rho ** 2)], axis=1).astype(np.float32)


# the three cases of tests/test_pallas_kernels.py:26-83, then the shapes of
# chip_smoke.ASSOC_SHAPES and the edge cases of chip_smoke.py phase 2, with
# inputs from chip_smoke.assoc_world ("smoke"); "m" keeps the first m landmarks
ASSOC_CASES = {
    "euclidean": dict(world=dict(), gate2=1.44, mahalanobis=False),
    "mahalanobis": dict(world=dict(seed=2), gate2=9.21, mahalanobis=True),
    "multi_tile": dict(world=dict(n=61, m=2000, seed=5), gate2=1.44, mahalanobis=False),
    "blocked": dict(smoke=dict(n=2048, m=256, seed=6), gate2=1.44, mahalanobis=False),
    "blocked16": dict(smoke=dict(n=512, m=256, seed=11), gate2=1.44, mahalanobis=False),
    "blocked16_b16_mahalanobis": dict(smoke=dict(n=256, m=256, seed=12), gate2=9.21,
                                      mahalanobis=True),
    "pod": dict(smoke=dict(n=512, m=4096, seed=7), gate2=1.44, mahalanobis=False),
    "pod_mahalanobis": dict(smoke=dict(n=512, m=4096, seed=8), gate2=9.21, mahalanobis=True),
    "ties": dict(smoke=dict(n=512, m=4096, seed=9, ties=True), gate2=1.44, mahalanobis=False),
    "ties_mahalanobis": dict(smoke=dict(n=64, m=300, seed=10, ties=True), gate2=9.21,
                             mahalanobis=True),
    "no_landmarks": dict(world=dict(), m=0, gate2=1.44, mahalanobis=False),
}


def _assoc_inputs(c):
    if "smoke" in c:
        obs_xy, obs_type, lm_xy, lm_type, cov = (
            t.numpy() for t in chip_smoke.assoc_world(**c["smoke"], device="cpu"))
    else:
        obs_xy, obs_type, lm_xy, lm_type = _world(**c["world"])
        cov = _cov(len(lm_xy))
    m = c.get("m", len(lm_xy))
    return obs_xy, obs_type, lm_xy[:m], lm_type[:m], cov[:m]


@pytest.mark.parametrize("case", list(ASSOC_CASES))
def test_associate_plain_matches_pallas(case):
    c = ASSOC_CASES[case]
    obs_xy, obs_type, lm_xy, lm_type, cov = _assoc_inputs(c)
    want = associate_pallas(jnp.asarray(obs_xy), jnp.asarray(obs_type), jnp.asarray(lm_xy),
                            jnp.asarray(lm_type), c["gate2"],
                            lm_cov_inv_packed=jnp.asarray(cov) if c["mahalanobis"] else None,
                            mahalanobis=c["mahalanobis"], interpret=True)
    A.launches = 0
    got = A.associate_kernel(torch.tensor(obs_xy), torch.tensor(obs_type), torch.tensor(lm_xy),
                             torch.tensor(lm_type), c["gate2"],
                             torch.tensor(cov) if c["mahalanobis"] else None,
                             mahalanobis=c["mahalanobis"])
    assert A.launches == 0            # a CPU tensor takes the plain twin
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() == (len(lm_xy) > 0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    if "ties" in case:                # the tie cases do hold ties, won by the lower index
        chip_smoke.tie_check(got[0].numpy()[got[1].numpy()], len(lm_xy), c["smoke"]["seed"], case)


@pytest.mark.parametrize("seed", [11, 12])
def test_provider_associate_masks_match_jax(seed):
    """The port's `_provider_associate` hands the masks to the kernel's
    wrapper; the JAX package's sets the types -2 and -1 instead. Both give
    the same association."""
    oxy, obs, valid, lxy, lt, n_lm = (
        t.numpy() for t in chip_smoke.assoc_masked_world(seed, device="cpu"))
    lm_valid = np.arange(len(lxy)) < n_lm
    want = jax_provider_associate(jnp.asarray(oxy), jnp.asarray(obs[:, 3]).astype(jnp.int32),
                                  jnp.asarray(valid), jnp.asarray(lxy), jnp.asarray(lt),
                                  jnp.asarray(lm_valid), None,
                                  JaxSlamConfig(association="nearest",
                                                use_pallas_association=True))
    cfg = SlamConfig(association="nearest", use_pallas_association=True)
    obs_t = torch.tensor(obs)
    got = _provider_associate(torch.tensor(oxy), obs_t[:, 3], torch.tensor(valid),
                              torch.tensor(lxy), torch.tensor(lt),
                              torch.tensor(n_lm), None, cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and not got[1][~torch.tensor(valid)].any()
    assert (got[0][got[1]] < int(n_lm)).all()
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("seed", [11, 12])
def test_provider_associate_mahalanobis_matches_jax(seed):
    """The Mahalanobis form of the provider: the packed innovation
    information of each landmark, and the scaled-Euclidean cost of those
    with no information yet (a quarter of them), as the JAX package's."""
    oxy, obs, valid, lxy, lt, n_lm = (
        t.numpy() for t in chip_smoke.assoc_masked_world(seed, device="cpu"))
    info = _cov(len(lxy), seed) * 40.0
    info[::4] = 0.0
    jcfg = JaxSlamConfig(association="mahalanobis", use_pallas_association=True)
    want = jax_provider_associate(jnp.asarray(oxy), jnp.asarray(obs[:, 3]).astype(jnp.int32),
                                  jnp.asarray(valid), jnp.asarray(lxy), jnp.asarray(lt),
                                  jnp.asarray(np.arange(len(lxy)) < n_lm), jnp.asarray(info),
                                  jcfg)
    cfg = SlamConfig(association="mahalanobis", use_pallas_association=True)
    got = _provider_associate(torch.tensor(oxy), torch.tensor(obs)[:, 3], torch.tensor(valid),
                              torch.tensor(lxy), torch.tensor(lt), torch.tensor(n_lm),
                              torch.tensor(info), cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and not got[1][~torch.tensor(valid)].any()
    matched = got[1].numpy()
    np.testing.assert_allclose(got[2].numpy()[matched], np.asarray(want[2])[matched], rtol=1e-5)


def test_associate_masked_equals_type_sentinels():
    """The masked form equals the unmasked form with the invalid
    observations typed -2 and the landmarks past the count typed -1."""
    matched, err = chip_smoke.assoc_masked_check(13, device="cpu")
    assert matched > 0 and err == 0.0


@pytest.mark.parametrize("n,m,sms,want", [
    (64, 256, 132, 1), (2048, 256, 132, 1), (512, 4096, 132, 8), (64, 4097, 132, 8),
    (64, 600, 132, 3), (512, 4096, 32, 2), (4096, 4096, 132, 1), (1, 0, 132, 1)])
def test_assoc_plan_fills_one_wave(n, m, sms, want):
    """The cluster spans the landmark chunks, at most 8 blocks, and no wider
    than keeps the grid within one wave of the card's SMs."""
    assert A._plan(n, m, sms) == want


@pytest.mark.parametrize("n,m,sessions,want", [
    (512, 256, 16, 1), (61, 2000, 3, 8), (512, 4096, 16, 1), (64, 4097, 2, 8), (512, 4096, 4, 2)])
def test_assoc_plan_counts_every_session(n, m, sessions, want):
    """With S sessions the grid holds S x N / 32 tiles, and the cluster is
    no wider than keeps them within one wave of 132 SMs."""
    assert A._plan(n, m, 132, sessions) == want


@pytest.mark.parametrize("mahalanobis", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_associate_plain_batched_equals_single_calls(mahalanobis, masked):
    """The twin on [S, N, M] equals S unbatched calls bit for bit, masks,
    landmark counts and the float type column included."""
    s, n, m = 3, 61, 300
    worlds = [chip_smoke.assoc_world(n, m, 5 + i, device="cpu") for i in range(s)]
    oxy, ot, lxy, lt, cov = (torch.stack([w[k] for w in worlds]) for k in range(5))
    kw = {}
    if masked:
        rows = torch.zeros(s, n, 4)
        rows[..., 3] = ot.float()
        ot = rows[..., 3]
        kw = dict(obs_valid=torch.rand(s, n, generator=torch.Generator().manual_seed(1)) < 0.8,
                  lm_count=torch.tensor([300, 120, 0], dtype=torch.int32))
    gate2 = 9.21 if mahalanobis else 1.44
    got = A.associate_plain(oxy, ot, lxy, lt, gate2, cov, mahalanobis=mahalanobis, **kw)
    assert int(got[1].sum()) > 0
    for i in range(s):
        one = A.associate_plain(oxy[i], ot[i], lxy[i], lt[i], gate2, cov[i],
                                mahalanobis=mahalanobis, **{k: v[i] for k, v in kw.items()})
        for g, w in zip(got, one):
            assert torch.equal(g[i], w)


@pytest.mark.parametrize("n", [1, 33, 100, 200])
def test_cholesky_plain_batched_equals_single_calls(n):
    a = torch.stack([torch.tensor(_spd(n + i)[:n, :n]) for i in range(3)])
    got = C.cholesky_plain(a)
    for i in range(3):
        assert torch.equal(got[i], C.cholesky_plain(a[i]))


def test_cholesky_dispatcher_picks_on_the_matrix_size(monkeypatch):
    """The kernel (its twin on the CPU) up to n = 1536 on the last axis,
    whatever the batch; `cholesky_ex` above it."""
    seen = []
    monkeypatch.setattr(C, "cholesky_kernel", lambda a: seen.append(tuple(a.shape)) or a)
    small = torch.eye(4).expand(1600, 4, 4)
    assert C.cholesky(small) is small and seen == [(1600, 4, 4)]
    big = torch.eye(1600).expand(2, 1600, 1600) * 2.0
    got = C.cholesky(big)
    assert seen == [(1600, 4, 4)]
    torch.testing.assert_close(got, big.sqrt())


@pytest.mark.parametrize("mode,signed", [("first", False), ("nearest", False),
                                         ("mahalanobis", False), ("first", True)])
def test_dense_associate_matches_jax(mode, signed):
    obs_xy, obs_type, lm_xy, lm_type = _world(seed=7)
    rng = np.random.default_rng(8)
    obs_valid = rng.random(len(obs_xy)) < 0.9
    lm_valid = rng.random(len(lm_xy)) < 0.9
    p = _cov(len(lm_xy))
    cov = np.stack([np.stack([p[:, 0], p[:, 1]], -1), np.stack([p[:, 1], p[:, 2]], -1)], -2)
    gate = 9.21 if mode == "mahalanobis" else 1.2
    args = (obs_xy, obs_type, obs_valid, lm_xy, lm_type, lm_valid)
    want = jax_associate(*map(jnp.asarray, args), gate, mode=mode,
                         lm_cov_inv=jnp.asarray(cov), type_signed_bug=signed)
    got = associate(*map(torch.tensor, args), gate, mode=mode,
                    lm_cov_inv=torch.tensor(cov), type_signed_bug=signed)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def _spd(n):
    rng = np.random.default_rng(n)
    m = rng.normal(0, 1, (n, n)).astype(np.float32)
    return m @ m.T / n + np.eye(n, dtype=np.float32) * 2.0


@pytest.mark.parametrize("n", [64, 128, 200, 384])
def test_cholesky_plain_matches_pallas(n):
    spd = _spd(n)
    want = np.asarray(cholesky_pallas(jnp.asarray(spd), interpret=True))
    C.launches = 0
    got = C.cholesky(torch.tensor(spd))
    assert C.launches == 0            # a CPU tensor takes the plain twin
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(np.triu(got.numpy(), 1), 0.0)


def test_cholesky_plain_clamps_nonpositive_pivots():
    """The twin clamps a non-positive pivot as the TPU kernel does
    (rsqrt(max(pivot, 1e-30))) instead of raising."""
    a = torch.tensor(_spd(80))
    a[70, 70] = -1.0
    got = C.cholesky_plain(a)
    want = np.asarray(cholesky_pallas(jnp.asarray(a.numpy()), interpret=True))
    assert got[70, 70] < 0 and np.isfinite(got[:70].numpy()).all()
    np.testing.assert_allclose(got[:70].numpy(), want[:70], atol=5e-4, rtol=1e-3)


def test_first_association_with_kernel_runs_dense(monkeypatch):
    """'first' with use_pallas_association: the kernel has no index-order
    policy, so the per-frame engine keeps the dense association, as the JAX
    package's does; the port equals `tpuslam`'s run_sequence on the skidpad
    lap and never calls the kernel's provider."""
    from tests.test_torch_pipeline import (
        _assert_same, _closure, _frames, _jax_run, _np_tree, _port_run, _scenario)
    from tpuslam.backend.graph import GraphCapacity as JaxCap
    from tpuslam_torch.frontend import keyframe
    from tpuslam_torch.frontend.state import state_to_numpy

    def refuse(*_a, **_k):
        raise AssertionError("'first' reached the kernel's provider")

    monkeypatch.setattr(keyframe, "_provider_associate", refuse)
    _, scen, cap = _scenario("skidpad")
    js, jo = _jax_run(JaxSlamConfig(capacity=JaxCap(*cap), use_pallas_association=True),
                      _frames(scen))
    want = (_np_tree(js), _np_tree(jo))
    st, out = _port_run(SlamConfig(capacity=GraphCapacity(*cap), use_pallas_association=True),
                        _frames(scen))
    assert bool(st.loop_closure_complete)
    _assert_same((state_to_numpy(st), _np_tree(out)), want, _closure(want[1]))


@pytest.mark.parametrize("field,value", [
    ("use_ekf_fusion", True),
    pytest.param("assoc_mesh", "one-rank mesh", id="assoc_mesh-value7")])
def test_unported_config_raises(field, value):
    """Both were refused by name until their slices were ported. The EKF
    fusion is read by the service's `Slam` alone, as in the JAX package,
    and the mesh-sharded map (here on a one-rank gloo mesh) associates as
    the dense map does: `perform_keyframe` gives what it gives without
    either."""
    cap = GraphCapacity(8, 8, 32)
    cfg = SlamConfig(capacity=cap)
    args = (torch.tensor([[10.0, 0.0, 5.0, 1.0]] * 4), torch.ones(4, dtype=torch.bool),
            torch.zeros(3))
    if field == "assoc_mesh":
        from tpuslam_torch.parallel.mesh import initialize_distributed, make_slam_mesh
        made = initialize_distributed("gloo")
        try:
            st, out = perform_keyframe(initial_state(cap, "cpu"), *args, cfg,
                                       assoc_mesh=make_slam_mesh(1, 1, device_type="cpu"))
        finally:
            if made:    # the next test file in this worker gets no world
                torch.distributed.destroy_process_group()
    else:
        st, out = perform_keyframe(initial_state(cap, "cpu"), *args,
                                   cfg.with_(**{field: value}))
    want_st, want_out = perform_keyframe(initial_state(cap, "cpu"), *args, cfg)
    assert int(st.graph.n_poses) == 1
    for a, b in ((st.graph.lm_xy, want_st.graph.lm_xy), (out.pose, want_out.pose),
                 (st.graph.n_landmarks, want_st.graph.n_landmarks)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field,value", [
    ("association", "mahalanobis"), ("use_gps_prior", True), ("periodic_gn_every", 4),
    ("localizer_refine", True), ("mapping_publish_refine", True),
    ("vectorized_mapping", False)])
def test_formerly_refused_field_runs(field, value):
    """Each field the port refused before the improved mode was ported, set
    alone on the reference-compat configuration: the port runs the first
    frames of the skidpad lap as the JAX package does."""
    from tests.test_torch_pipeline import (
        _assert_same, _closure, _frames, _jax_run, _np_tree, _port_run, _scenario)
    from tpuslam.backend.graph import GraphCapacity as JaxCap
    from tpuslam_torch.frontend.state import state_to_numpy

    _, scen, cap = _scenario("skidpad")
    frames = _frames(scen, 0, 24)
    js, jo = _jax_run(JaxSlamConfig(capacity=JaxCap(*cap), **{field: value}), frames)
    want = (_np_tree(js), _np_tree(jo))
    st, out = _port_run(SlamConfig(capacity=GraphCapacity(*cap), **{field: value}), frames)
    _assert_same((state_to_numpy(st), _np_tree(out)), want, _closure(want[1]))
