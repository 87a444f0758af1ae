"""The port's lidar front-end (`tpuslam_torch.perception`: the VLP-16
decoder and `attention.detect_cones`, and `tpuslam_torch.sim.vlp16_sim`)
against the JAX package's, and tests/test_perception.py's cases on the
port (all but the calibration-XML cases, whose loader is not ported).

Both packages draw the same RANSAC triples from a seed: the port computes
`jax.random.randint`'s Threefry-2x32 in numpy. Given the same triples
(`ransac_idx`, or the same seed), RANSAC heights,
dense and grid labels, `grid_cell_overflow` counts and the cone counts and
validity are exact, and heights and cone tuples within 1e-5 (float32 sums
and transcendentals of two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.perception import attention as jattention
from tpuslam.perception import vlp16 as jvlp16
from tpuslam.sim import vlp16_sim as jsim
from tpuslam_torch.perception import vlp16
from tpuslam_torch.perception.attention import (
    AttentionConfig, _connected_components, _connected_components_grid, _ransac_ground,
    detect_cones, grid_cell_overflow,
)
from tpuslam_torch.perception.vlp16 import (
    VLP16_ELEVATIONS_DEG, decode_packet, encode_packet, packet_to_points, spherical_to_xyz,
)
from tpuslam_torch.sim.vlp16_sim import (
    Vlp16SceneConfig, render_scene, scene_to_packets, scene_to_point_cloud_reading,
)

N_CAP = 2048
VALUE_ATOL = 1e-5


def _pad(points, intensity=None, cap=N_CAP):
    n = len(points)
    pts = np.zeros((cap, 3), dtype=np.float32)
    pts[:n] = points[:cap]
    valid = np.arange(cap) < min(n, cap)
    out = [torch.tensor(pts), torch.tensor(valid)]
    if intensity is not None:
        it = np.zeros(cap, dtype=np.float32)
        it[:n] = intensity[:cap]
        out.append(torch.tensor(it))
    return out


def _xy(out, ok):
    out = out[ok].numpy()
    return out, np.stack([out[:, 2] * np.cos(np.radians(out[:, 0])),
                          out[:, 2] * np.sin(np.radians(out[:, 0]))], axis=1)


def _jax_cfg(cfg: AttentionConfig):
    return jattention.AttentionConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _scene(seed=7, n_cones=12, points_per_cone=35):
    rng = np.random.default_rng(seed)
    cones = rng.uniform([1.0, -3.5], [11.0, 3.5], (n_cones, 2))
    types = rng.integers(1, 4, n_cones)
    scfg = Vlp16SceneConfig(seed=seed, points_per_cone=points_per_cone)
    pts, inten = render_scene(cones, types, scfg)
    return scfg, _pad(pts, inten)


# -- the copies

def test_vlp16_decoder_and_sim_equal_jax():
    cones = np.array([[4.0, 1.0], [6.0, -2.0], [9.0, 0.5]])
    types = np.array([1, 2, 1])
    for scfg in (Vlp16SceneConfig(seed=3), Vlp16SceneConfig(seed=9, noise=0.0)):
        jcfg = jsim.Vlp16SceneConfig(**scfg.__dict__)
        for a, b in zip(render_scene(cones, types, scfg), jsim.render_scene(cones, types, jcfg)):
            np.testing.assert_array_equal(a, b)
        msg = scene_to_point_cloud_reading(cones, scfg)
        jmsg = jsim.scene_to_point_cloud_reading(cones, jcfg)
        assert msg.distances == jmsg.distances
        for a, b in zip(vlp16.decode_point_cloud_reading(msg),
                        jvlp16.decode_point_cloud_reading(jmsg)):
            np.testing.assert_array_equal(a, b)
    pts, _ = render_scene(cones, types, Vlp16SceneConfig(seed=5))
    packets = scene_to_packets(pts)
    assert packets == jsim.scene_to_packets(pts)
    for p in packets[:20]:
        for a, b in zip(packet_to_points(p), jvlp16.packet_to_points(p)):
            np.testing.assert_array_equal(a, b)


# -- against the JAX package, with shared triples

@pytest.mark.parametrize("clustering", ["dense", "grid"])
def test_detect_cones_matches_jax_given_the_triples(clustering):
    scfg, (pts, valid, inten) = _scene()
    cfg = AttentionConfig(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                          inlier_found_threshold=300, clustering=clustering)
    jcfg = _jax_cfg(cfg)
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jax.random.randint(key, (cfg.ransac_iterations, 3), 0, N_CAP))
    jp, jv = jnp.asarray(pts.numpy()), jnp.asarray(valid.numpy())
    roi = (valid & (pts[:, 1].abs() <= cfg.x_boundary) & (pts[:, 0] > 0.1)
           & (pts[:, 0] <= cfg.y_boundary))
    h = _ransac_ground(pts, roi, cfg, torch.tensor(idx))
    jh = np.asarray(jattention._ransac_ground(jp, jnp.asarray(roi.numpy()), jcfg, key))
    np.testing.assert_allclose(h.numpy(), jh, atol=VALUE_ATOL, rtol=0)
    obstacle = roi & (h > cfg.inlier_range_threshold) & (h < cfg.cone_height + 0.3)
    assert torch.equal(obstacle, torch.tensor(np.asarray(roi.numpy()) & (jh > 0.06) & (jh < 0.8)))
    port_cc = _connected_components if clustering == "dense" else _connected_components_grid
    jax_cc = jattention._connected_components if clustering == "dense" \
        else jattention._connected_components_grid
    labels = port_cc(pts[:, :2], obstacle, cfg)
    jlabels = np.asarray(jax_cc(jp[:, :2], jnp.asarray(obstacle.numpy()), jcfg))
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    assert len(np.unique(jlabels)) > 10

    got = detect_cones(pts, valid, cfg, intensity=inten, ransac_idx=torch.tensor(idx))
    want = [np.asarray(x) for x in jattention.detect_cones(
        jp, jv, jcfg, seed=0, intensity=jnp.asarray(inten.numpy()))]
    assert int(got[2]) == int(want[2]) == 12
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=VALUE_ATOL, rtol=0)


def test_grid_cell_overflow_matches_jax():
    scfg = Vlp16SceneConfig(seed=5, points_per_cone=300)
    pts, _ = render_scene(np.array([[4.0, 1.0], [6.0, -2.0], [8.5, 2.5]]), np.array([1, 2, 1]),
                          scfg)
    above = pts[:, 2] > (-scfg.sensor_height + 0.05)
    xy = pts[above, :2].astype(np.float32)
    for k in (8, 32, 64):
        cfg = AttentionConfig(cell_capacity=k, clustering="grid")
        got = grid_cell_overflow(torch.tensor(xy), torch.ones(len(xy), dtype=torch.bool), cfg)
        want = jattention.grid_cell_overflow(jnp.asarray(xy), jnp.ones(len(xy), bool),
                                             _jax_cfg(cfg))
        assert got.dtype == torch.int32 and int(got) == int(want)


def test_port_triples_are_seeded_and_device_free():
    from tpuslam_torch.perception.attention import ransac_triples
    cfg = AttentionConfig()
    a, b = ransac_triples(4096, cfg, 0, "cpu"), ransac_triples(4096, cfg, 0, "cpu")
    assert torch.equal(a, b) and a.shape == (cfg.ransac_iterations, 3)
    assert not torch.equal(a, ransac_triples(4096, cfg, 1, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 4096
    scfg, (pts, valid, _) = _scene()
    kw = dict(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
              inlier_found_threshold=300)
    own = detect_cones(pts, valid, AttentionConfig(**kw))
    given = detect_cones(pts, valid, AttentionConfig(**kw), ransac_idx=ransac_triples(
        N_CAP, AttentionConfig(**kw), 0, "cpu"))
    for x, y in zip(own, given):
        assert torch.equal(x, y)


# -- tests/test_perception.py on the port

def test_packet_roundtrip():
    rng = np.random.default_rng(0)
    az = np.repeat((np.arange(24) * 0.2)[:, None], 16, axis=1)
    dist = rng.uniform(1, 50, (24, 16))
    az2, elev, dist2, _ = decode_packet(encode_packet(az, dist))
    np.testing.assert_allclose(elev, VLP16_ELEVATIONS_DEG)
    np.testing.assert_allclose(dist2, dist, atol=0.002)
    np.testing.assert_allclose(az2[::2, 0], az[::2, 0], atol=0.01)


def test_spherical_to_xyz_axes():
    np.testing.assert_allclose(spherical_to_xyz(0.0, 0.0, 10.0), [10, 0, 0], atol=1e-9)
    np.testing.assert_allclose(spherical_to_xyz(90.0, 0.0, 5.0), [0, -5, 0], atol=1e-6)
    assert spherical_to_xyz(0.0, 15.0, 4.0)[2] > 0


def test_attention_detects_scene_cones():
    cones = np.array([[4.0, 1.0], [6.0, -2.0], [9.0, 0.5], [3.0, -3.0]])
    types = np.array([1, 2, 1, 2])
    scfg = Vlp16SceneConfig(seed=3)
    pts, inten = render_scene(cones, types, scfg)
    acfg = AttentionConfig(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                           inlier_found_threshold=300)
    out, ok, n = detect_cones(*_pad(pts)[:2], acfg, intensity=_pad(pts, inten)[2])
    assert int(n) == len(cones)
    out, got_xy = _xy(out, ok)
    for (cx, cy), ct in zip(cones, types):
        d = np.linalg.norm(got_xy - (cx, cy), axis=1)
        assert d.min() < 0.15, (cx, cy, got_xy)
        assert int(out[d.argmin(), 3]) == ct


def test_attention_rejects_wall_and_dust():
    rng = np.random.default_rng(1)
    wall_y = np.linspace(-3, 3, 300)
    wall = np.stack([np.full_like(wall_y, 8.0), wall_y, rng.uniform(0, 0.4, 300)], axis=1)
    speck = np.array([[5.0, 0.0, 0.2]])
    ground = np.stack([rng.uniform(0.5, 11, 800), rng.uniform(-3.5, 3.5, 800),
                       rng.normal(0, 0.01, 800)], axis=1)
    pts = np.vstack([ground, wall, speck])
    pts[:, 2] -= 0.9
    acfg = AttentionConfig(sensor_height=0.9, ground_layer_z=-0.9, inlier_found_threshold=300,
                           min_points=3)
    _, _, n = detect_cones(*_pad(pts), acfg)
    assert int(n) == 0


def test_attention_cell_overflow_visible_and_benign():
    cones = np.array([[4.0, 1.0], [6.0, -2.0], [8.5, 2.5]])
    scfg = Vlp16SceneConfig(seed=5, points_per_cone=300)
    pts, inten = render_scene(cones, np.array([1, 2, 1]), scfg)
    p, v, i = _pad(pts, inten)
    base = dict(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                inlier_found_threshold=300, clustering="grid", max_points=2000)
    a32 = AttentionConfig(**base, cell_capacity=32)
    a64 = AttentionConfig(**base, cell_capacity=64)
    above = pts[:, 2] > (-scfg.sensor_height + 0.05)
    xy = torch.tensor(pts[above, :2], dtype=torch.float32)
    ones = torch.ones(len(xy), dtype=torch.bool)
    ov32 = int(grid_cell_overflow(xy, ones, a32))
    assert ov32 > 0
    assert int(grid_cell_overflow(xy, ones, a64)) < ov32
    out32, ok32, n32 = detect_cones(p, v, a32, intensity=i)
    out64, ok64, n64 = detect_cones(p, v, a64, intensity=i)
    assert int(n32) == int(n64) >= 2
    np.testing.assert_allclose(out32[ok32][:, :3].numpy(), out64[ok64][:, :3].numpy(), atol=0.05)


def _jax_triples(n, cfg, seed=0):
    """The triples the JAX package's `detect_cones(seed=seed)` draws."""
    return torch.tensor(np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                                      (cfg.ransac_iterations, 3), 0, n)))


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 12345, 2 ** 31 - 1])
def test_ransac_triples_equal_jax_random(seed):
    """`ransac_triples` draws `jax.random.randint`'s values (the JAX
    package's default PRNG): a change of that default shows up here."""
    from tpuslam_torch.perception.attention import ransac_triples
    for n in (1, 2, 3, 100, 2048, 4096, 28800, 65535, 65536, 65537):
        for iters in (10, 64):
            cfg = AttentionConfig(ransac_iterations=iters)
            got = ransac_triples(n, cfg, seed, "cpu")
            assert got.dtype == torch.int64
            assert torch.equal(got, _jax_triples(n, cfg, seed)), (seed, n, iters)


def test_full_loop_packets_to_cones():
    """Packets -> points -> cones at the default seed, the port's own
    triples, against the JAX package's `detect_cones` on the same points."""
    cones = np.array([[5.0, 1.5], [8.0, -1.0]])
    scfg = Vlp16SceneConfig(seed=5, points_per_cone=60)
    pts, _ = render_scene(cones, np.array([1, 2]), scfg)
    clouds = [packet_to_points(p) for p in scene_to_packets(pts)]
    all_pts = np.vstack([c[0] for c in clouds if len(c[0])])
    acfg = AttentionConfig(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                           inlier_found_threshold=200)
    p, v = _pad(all_pts)
    out, ok, n = detect_cones(p, v, acfg)
    want = [np.asarray(x) for x in jattention.detect_cones(
        jnp.asarray(p.numpy()), jnp.asarray(v.numpy()), _jax_cfg(acfg))]
    assert int(n) == int(want[2])
    np.testing.assert_array_equal(ok.numpy(), want[1])
    np.testing.assert_allclose(out.numpy(), want[0], atol=VALUE_ATOL, rtol=0)
    _, got_xy = _xy(out, ok)
    for cx, cy in cones:
        assert np.linalg.norm(got_xy - (cx, cy), axis=1).min() < 0.3, (cx, cy, got_xy)


def test_point_cloud_reading_roundtrip():
    cones = np.array([[5.0, 1.0], [7.0, -2.0]])
    scfg = Vlp16SceneConfig(seed=9, noise=0.0)
    cloud, _ = vlp16.decode_point_cloud_reading(scene_to_point_cloud_reading(cones, scfg))
    assert len(cloud) > 1000
    on_ground = np.abs(cloud[:, 2] + scfg.sensor_height) < 0.05
    on_cone = np.linalg.norm(cloud[:, None, :2] - cones[None], axis=-1).min(axis=1) < 0.25
    assert np.mean(on_ground | on_cone) > 0.98
    assert on_cone.sum() >= 8


def _drive_service(svc, cfg, scfg, cones_global, frames, sender=42):
    from tpuslam_torch.geometry import wgs84
    from tpuslam_torch.io import envelope as E
    from tpuslam_torch.io import messages as M
    ref = np.array(cfg.gps_reference)
    for t in range(frames):
        us = int(t * 0.5e6) + 1000
        pose = np.array([2.0 * t, 0.0, 0.0])
        latlon = wgs84.from_cartesian(ref, pose[:2])
        svc.dispatch_envelope(E.pack_message(
            M.Geolocation(latitude=float(latlon[0]), longitude=float(latlon[1]), heading=0.0),
            sample_us=us, sender_stamp=cfg.estimation_id))
        local = cones_global - (pose[:2] + np.array([1.5, 0.0]))
        if frames == 5:
            local = local[local[:, 0] > 1.0]
        svc.dispatch_envelope(E.pack_message(scene_to_point_cloud_reading(local, scfg),
                                             sample_us=us, sender_stamp=sender))


def _service_map_ok(svc, cones_global, frames):
    assert svc.metrics.counters["point_cloud_messages"] == frames
    lm, _ = svc.slam.draw_cones()
    assert 3 <= len(lm) <= len(cones_global) + 1, lm
    d = np.linalg.norm(lm[:, None, :] - cones_global[None], axis=-1).min(axis=1)
    assert np.median(d) < 0.4, (lm, d)


CONES_GLOBAL = np.array([[8.0, 1.5], [11.0, -1.5], [14.0, 1.5], [17.0, -1.5], [20.0, 1.5]])


def test_service_integrated_lidar_frontend():
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.runtime.config import SlamConfig
    from tpuslam_torch.runtime.service import SlamService
    scfg = Vlp16SceneConfig(seed=11, points_per_cone=50)
    cfg = SlamConfig(capacity=GraphCapacity(32, 32, 512), time_between_keyframes_ms=50.0)
    acfg = AttentionConfig(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                           inlier_found_threshold=300)
    svc = SlamService(cfg, attention_cfg=acfg, lidar_sender_id=42, device="cpu")
    _drive_service(svc, cfg, scfg, CONES_GLOBAL, 5)
    _service_map_ok(svc, CONES_GLOBAL, 5)


def test_grid_clustering_matches_dense():
    scfg, (pts, valid, inten) = _scene()
    base = dict(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                inlier_found_threshold=300)
    out_d, ok_d, n_d = detect_cones(pts, valid, AttentionConfig(clustering="dense", **base),
                                    intensity=inten)
    out_g, ok_g, n_g = detect_cones(pts, valid, AttentionConfig(clustering="grid", **base),
                                    intensity=inten)
    assert int(n_d) == int(n_g) > 0
    assert torch.equal(ok_d, ok_g)
    np.testing.assert_allclose(out_d[ok_d].numpy(), out_g[ok_g].numpy(), rtol=0, atol=1e-5)


def test_full_sweep_grid_clustering():
    cones = np.array([[3.0, 1.8], [5.0, -1.8], [7.0, 1.8], [9.0, -1.8], [11.0, 1.8], [4.0, -3.0],
                      [-5.0, 0.0], [3.0, 7.0]])
    scfg = Vlp16SceneConfig(seed=13, noise=0.005, surround_range=30.0)
    cloud, _ = vlp16.decode_point_cloud_reading(scene_to_point_cloud_reading(cones, scfg))
    assert len(cloud) >= 28000
    acfg = AttentionConfig(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                           inlier_found_threshold=1000, min_points=3)
    out, ok, _ = detect_cones(*_pad(cloud, cap=32768), acfg)
    _, got_xy = _xy(out, ok)
    in_roi = cones[(np.abs(cones[:, 1]) <= 4.0) & (cones[:, 0] > 0.1) & (cones[:, 0] <= 12.0)]
    assert len(got_xy) >= len(in_roi)
    for cx, cy in in_roi:
        assert np.linalg.norm(got_xy - (cx, cy), axis=1).min() < 0.3, (cx, cy, got_xy)


def test_service_full_sweep_no_prefilter():
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.runtime.config import SlamConfig
    from tpuslam_torch.runtime.service import SlamService
    scfg = Vlp16SceneConfig(seed=17, noise=0.005)
    cfg = SlamConfig(capacity=GraphCapacity(32, 32, 512), time_between_keyframes_ms=50.0)
    acfg = AttentionConfig(sensor_height=scfg.sensor_height, ground_layer_z=-scfg.sensor_height,
                           inlier_found_threshold=1000, min_points=3, host_prefilter=False,
                           point_capacity=32768)
    svc = SlamService(cfg, attention_cfg=acfg, lidar_sender_id=42, device="cpu")
    _drive_service(svc, cfg, scfg, CONES_GLOBAL, 4)
    _service_map_ok(svc, CONES_GLOBAL, 4)


def test_rec_replay_full_sweeps_into_slam():
    """The full ops path (chip_smoke.sweep_replay, which phase `lidar` runs
    on the card): a .rec of full sweeps and GPS fixes through the service."""
    import chip_smoke
    svc, lm, med = chip_smoke.sweep_replay("cpu")
    assert svc.metrics.counters["point_cloud_messages"] == 4
    assert 3 <= len(lm) <= len(CONES_GLOBAL) + 1 and med < 0.4, (lm, med)


@pytest.mark.parametrize("provider", ["dense", "grid"])
def test_long_wall_rejected_at_default_label_iterations(provider):
    rng = np.random.default_rng(1)
    wall_x = rng.uniform(0.5, 11.5, 900)
    wall = np.stack([wall_x, np.full_like(wall_x, 2.0) + rng.normal(0, 0.03, 900),
                     rng.uniform(0, 0.4, 900)], axis=1)
    ground = np.stack([rng.uniform(0.5, 11, 1500), rng.uniform(-3.5, 3.5, 1500),
                       rng.normal(0, 0.01, 1500)], axis=1)
    pts = np.vstack([ground, wall])
    pts[:, 2] -= 0.9
    acfg = AttentionConfig(sensor_height=0.9, ground_layer_z=-0.9, inlier_found_threshold=300,
                           min_points=3, clustering=provider)
    _, _, n = detect_cones(*_pad(pts, cap=8192), acfg)
    assert int(n) == 0
