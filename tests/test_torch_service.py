"""The port's live service (`tpuslam_torch.core.slam.Slam`,
`runtime.service.SlamService`, `runtime.checkpoint`) on the CPU: every case
of tests/test_runtime.py and of tests/test_end_to_end.py:75-158 on the port,
checkpoints carried across packages in both directions, the port's and the
JAX package's `Slam` publishing the same messages, `run_live` on a bus, and
the EKF fusion through the engine's entry points equal to the JAX package.

Tolerances: discrete outputs exact; values within 1e-5 up to the loop
closure and 1e-3 after it (the closure GN's early exit, as
tests/test_torch_pipeline.py), azimuths in degrees 60x that. A resume on the
CPU is bit-equal to the uninterrupted run, as tests/test_runtime.py holds
the JAX package's.
"""
import asyncio
import dataclasses
import io as pyio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpuslam.backend.graph import GraphCapacity as JCap
from tpuslam.core.slam import Slam as JSlam
from tpuslam.frontend.blocked import run_sequence_blocked as jax_run_blocked
from tpuslam.frontend.keyframe import perform_keyframe as jax_perform_keyframe
from tpuslam.frontend.pipeline import run_sequence as jax_run_sequence
from tpuslam.frontend.state import initial_state as jax_initial_state
from tpuslam.runtime.checkpoint import (load_checkpoint as jax_load_checkpoint,
                                        save_checkpoint as jax_save_checkpoint)
from tpuslam.runtime.config import SlamConfig as JCfg
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.core.slam import Slam, _geo_from_local
from tpuslam_torch.frontend.blocked import run_sequence_blocked
from tpuslam_torch.frontend.keyframe import perform_keyframe
from tpuslam_torch.frontend.pipeline import run_sequence
from tpuslam_torch.frontend.state import initial_state, state_to_numpy
from tpuslam_torch.io import envelope as E
from tpuslam_torch.io import messages as M
from tpuslam_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.runtime.metrics import MetricsRegistry
from tpuslam_torch.runtime.service import SlamService, scenario_to_rec
from tpuslam_torch.sim import SimConfig, simulate, skidpad, trackdrive
from tpuslam_torch.sim.simulator import ate

CAP = GraphCapacity(max_poses=128, max_landmarks=64, max_obs=2048)
JAX_CAP = JCap(max_poses=128, max_landmarks=64, max_obs=2048)
PRE_ATOL, POST_ATOL, DEG_PER_UNIT = 1e-5, 1e-3, 60.0


def _cfg(**kw):
    return SlamConfig(capacity=CAP, **kw)


def _np_tree(x):
    return {f.name: _np_tree(getattr(x, f.name)) if dataclasses.is_dataclass(getattr(x, f.name))
            else np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _assert_trees(got, want, atol=0.0, path=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees(got[k], w, atol, path + k + ".")
            continue
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, path + k
        if w.dtype.kind in "biu" or atol == 0.0:
            np.testing.assert_array_equal(got[k], w, err_msg=path + k)
        else:
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=path + k)


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Slam(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamService(_cfg())
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, initial_state(CAP, "cpu"), _cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(path, _cfg())


# -- tests/test_runtime.py on the port

def test_rec_replay_matches_direct(tmp_path):
    """Scenario -> .rec -> service replay equals the direct drive path (on
    the port bit for bit: the .rec carries the same float32 values)."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=31))
    cfg = _cfg(time_between_keyframes_ms=100.0)
    direct = Slam(cfg, device="cpu")
    direct.run_scenario(scen)
    rec = str(tmp_path / "lap.rec")
    scenario_to_rec(scen, rec, cfg)
    svc = SlamService(cfg, device="cpu")
    svc.run_replay(rec)
    assert svc.slam.loop_closure_complete == direct.loop_closure_complete
    assert int(svc.slam.state.graph.n_landmarks) == int(direct.state.graph.n_landmarks)
    np.testing.assert_array_equal(svc.slam.draw_cones()[0], direct.draw_cones()[0])
    assert svc.metrics.counters["cone_messages"] > 0
    assert svc.metrics.counters["pose_messages"] > 0


def test_sender_stamp_filtering(tmp_path):
    scen = simulate(skidpad(), SimConfig(laps=0.3, seed=32))
    cfg = _cfg()
    rec = str(tmp_path / "lap.rec")
    scenario_to_rec(scen, rec, cfg.with_(detect_cone_id=999, estimation_id=998))
    svc = SlamService(cfg, device="cpu")
    svc.run_replay(rec)
    assert svc.slam.keyframes_processed == 0
    assert int(svc.slam.state.graph.n_poses) == 0


def test_checkpoint_roundtrip(tmp_path):
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=33))
    cfg = _cfg()
    slam = Slam(cfg, device="cpu")
    slam.run_scenario(scen)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, slam.state, cfg, extra={"note": "test"})
    state2, meta = load_checkpoint(path, cfg, device="cpu")
    assert meta["note"] == "test"
    _assert_trees(state_to_numpy(state2), state_to_numpy(slam.state))
    slam2 = Slam(cfg, device="cpu")
    slam2.state = state2
    slam2._odometry[:] = scen.odom_poses[-1]
    slam2.process_frame(scen.obs[-1], scen.obs_valid[-1], int(scen.times[-1] * 1e6) + 500000)
    assert int(slam2.state.graph.n_poses) == int(slam.state.graph.n_poses) + 1


def test_checkpoint_capacity_mismatch(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, Slam(cfg, device="cpu").state, cfg)
    with pytest.raises(ValueError):
        load_checkpoint(path, cfg.with_(capacity=GraphCapacity(8, 8, 8)), device="cpu")


def test_checkpoint_fallbacks_match_jax(tmp_path):
    """A format-1 checkpoint from before the fusion and the Mahalanobis
    gate (no `odo_w`, no `lm_info_xy`) loads in both packages alike: a
    uniform chain and no landmark information."""
    scen = simulate(skidpad(), SimConfig(laps=0.5, seed=33))
    slam = Slam(_cfg(), device="cpu")
    slam.run_scenario(scen)
    full, old = str(tmp_path / "full.npz"), str(tmp_path / "old.npz")
    save_checkpoint(full, slam.state, _cfg())
    z = dict(np.load(full))
    del z["odo_w"], z["lm_info_xy"]
    np.savez_compressed(old, **z)
    state, _ = load_checkpoint(old, _cfg(), device="cpu")
    jstate, _ = jax_load_checkpoint(old, JCfg(capacity=JAX_CAP))
    _assert_trees(state_to_numpy(state), _np_tree(jstate))
    assert bool((state.graph.odo_w == 1).all()) and not bool(state.lm_info_xy.any())


def test_metrics_registry():
    m = MetricsRegistry()
    m.inc("frames")
    m.inc("frames", 4)
    m.set("ate", 0.21)
    with m.timer("step"):
        pass
    snap = m.snapshot()
    assert snap["counters"]["frames"] == 5
    assert snap["gauges"]["ate"] == 0.21
    assert snap["timers"]["step"]["count"] == 1
    out = pyio.StringIO()
    m.dump_json(out)
    assert json.loads(out.getvalue()) == json.loads(json.dumps(snap))


def test_checkpoint_resume_mid_run_exact(tmp_path):
    """Kill the engine mid-lap, restore from the checkpoint in a fresh
    instance, continue: outputs, map and graph equal the uninterrupted run
    bit for bit."""
    cfg = SlamConfig()
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=3))
    t, k = len(scen.times), len(scen.times) // 2
    gold = Slam(cfg, device="cpu")
    gold_tail = [chip_smoke.feed(gold, scen, i).pose.numpy() for i in range(t)][k:]
    a = Slam(cfg, device="cpu")
    for i in range(k):
        chip_smoke.feed(a, scen, i)
    path = str(tmp_path / "mid.npz")
    save_checkpoint(path, a.state, cfg, extra={"host": a.snapshot_host()})
    b = Slam(cfg, device="cpu")
    b.state, meta = load_checkpoint(path, cfg, device="cpu")
    b.restore_host(meta["host"])
    tail = [chip_smoke.feed(b, scen, i).pose.numpy() for i in range(k, t)]
    np.testing.assert_array_equal(np.stack(tail), np.stack(gold_tail))
    _assert_trees(state_to_numpy(b.state), state_to_numpy(gold.state))


def test_checkpoint_resume_with_ekf_and_open_frame():
    """Resume also carries the EKF state and a mid-window cone collector
    (chip_smoke.resume_run, which phase `service` runs on the card): on the
    CPU the resumed tail and final state are bit-equal."""
    k, _, gold, gold_rec, b, b_rec = chip_smoke.resume_run("cpu")
    tail = {f: v[k:] for f, v in gold_rec.stacked().items()}
    chip_smoke.compare_outputs("resume", b_rec.stacked(), tail, atol=0.0)
    _assert_trees(state_to_numpy(b.state), state_to_numpy(gold.state))
    np.testing.assert_array_equal(b._ekf.x.numpy(), gold._ekf.x.numpy())


# -- checkpoints across packages

def _jax_slam_after(cfg_kw, scen, frames):
    j = JSlam(JCfg(capacity=JAX_CAP, **cfg_kw))
    for t in range(frames):
        j.next_pose(_geo_from_local(j._gps_ref, scen.odom_poses[t]), int(scen.times[t] * 1e6))
        j.process_frame(scen.obs[t], scen.obs_valid[t], int(scen.times[t] * 1e6))
    return j


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    """A checkpoint written mid-lap by one package loads in the other, to
    the same arrays and dtypes, and the reader finishes the lap where the
    writer's own uninterrupted run ends."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=33))
    t, k = len(scen.times), len(scen.times) // 2
    path = str(tmp_path / "x.npz")
    jax_slam = _jax_slam_after({}, scen, k)
    port_slam = Slam(_cfg(), device="cpu")
    for i in range(k):
        port_slam.next_pose(_geo_from_local(port_slam._gps_ref, scen.odom_poses[i]),
                            int(scen.times[i] * 1e6))
        port_slam.process_frame(scen.obs[i], scen.obs_valid[i], int(scen.times[i] * 1e6))
    if writer == "jax":
        jax_save_checkpoint(path, jax_slam.state, JCfg(capacity=JAX_CAP),
                            extra={"host": jax_slam.snapshot_host()})
        state, meta = load_checkpoint(path, _cfg(), device="cpu")
        _assert_trees(state_to_numpy(state), _np_tree(jax_slam.state))
        reader = Slam(_cfg(), device="cpu")
        reader.state = state
    else:
        save_checkpoint(path, port_slam.state, _cfg(), extra={"host": port_slam.snapshot_host()})
        state, meta = jax_load_checkpoint(path, JCfg(capacity=JAX_CAP))
        _assert_trees(_np_tree(state), state_to_numpy(port_slam.state))
        reader = JSlam(JCfg(capacity=JAX_CAP))
        reader.state = state
    reader.restore_host(meta["host"])
    assert reader.keyframes_processed == k
    for i in range(k, t):
        reader.next_pose(_geo_from_local(reader._gps_ref, scen.odom_poses[i]),
                         int(scen.times[i] * 1e6))
        reader.process_frame(scen.obs[i], scen.obs_valid[i], int(scen.times[i] * 1e6))
    want = _jax_slam_after({}, scen, t).state
    got = state_to_numpy(reader.state) if writer == "jax" else _np_tree(reader.state)
    _assert_trees(got, _np_tree(want), atol=POST_ATOL)
    assert bool(got["loop_closure_complete"])


def test_checkpoint_config_fingerprint_matches_jax(tmp_path):
    save_checkpoint(str(tmp_path / "p.npz"), initial_state(CAP, "cpu"), _cfg())
    jax_save_checkpoint(str(tmp_path / "j.npz"), jax_initial_state(JAX_CAP),
                        JCfg(capacity=JAX_CAP))
    metas = [bytes(np.load(str(tmp_path / f))["meta_json"]) for f in ("p.npz", "j.npz")]
    assert metas[0] == metas[1]


# -- the port's Slam against the JAX package's

def _messages(published):
    """(class name, sample us, sender, field dict) per published message."""
    return [(type(m).__name__, ts.micros, stamp, dataclasses.asdict(m))
            for m, ts, stamp in published]


@pytest.mark.parametrize("ekf", [False, True], ids=["odometry", "ekf_fusion"])
def test_skidpad_publishes_what_jax_publishes(ekf):
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=51, keyframe_dt=0.1))
    jpub, ppub = [], []
    j = JSlam(JCfg(capacity=JAX_CAP, use_ekf_fusion=ekf), publish=lambda *m: jpub.append(m))
    p = Slam(_cfg(use_ekf_fusion=ekf), publish=lambda *m: ppub.append(m), device="cpu")
    je, pe = j.run_scenario(scen), p.run_scenario(scen)
    np.testing.assert_allclose(pe, je, atol=POST_ATOL, rtol=0)
    assert p.loop_closure_complete and j.loop_closure_complete
    jm, pm = _messages(jpub), _messages(ppub)
    assert len(pm) == len(jm) > 0
    for (pn, pts, ps, pf), (jn, jts, js, jf) in zip(pm, jm):
        assert (pn, pts, ps) == (jn, jts, js)
        for key, want in jf.items():
            got = pf[key]
            if isinstance(want, float):
                atol = POST_ATOL * (DEG_PER_UNIT if key == "azimuthAngle" else 1.0)
                if key in ("latitude", "longitude"):
                    atol = 1e-7   # degrees: ~1 cm
                assert abs(got - want) <= atol, (pn, key, got, want)
            else:
                assert got == want, (pn, key, got, want)
    _assert_trees(state_to_numpy(p.state), _np_tree(j.state), atol=POST_ATOL)


# -- tests/test_end_to_end.py:75-158 on the port

def test_collector_ingest_equals_direct_frames():
    scen = simulate(skidpad(), SimConfig(laps=0.25, seed=2))
    cfg = _cfg()
    direct, msgy = Slam(cfg, device="cpu"), Slam(cfg, device="cpu")
    for t in range(len(scen.times)):
        us = int(scen.times[t] * 1e6)
        geo = _geo_from_local(np.array(cfg.gps_reference), scen.odom_poses[t])
        direct.next_pose(geo, us)
        msgy.next_pose(geo, us)
        direct.process_frame(scen.obs[t], scen.obs_valid[t], us)
        for i in range(int(scen.obs_valid[t].sum())):
            az, zen, dist, ct = scen.obs[t, i]
            msgy.next_cone(M.ObjectDirection(objectId=i, azimuthAngle=az, zenithAngle=zen), us)
            msgy.next_cone(M.ObjectDistance(objectId=i, distance=dist), us)
            msgy.next_cone(M.ObjectType(objectId=i, type=int(ct)), us)
        msgy.flush()
        msgy._keyframe_us = None  # match the forced-keyframe direct path
    assert int(msgy.state.graph.n_landmarks) == int(direct.state.graph.n_landmarks)
    np.testing.assert_allclose(msgy.state.graph.lm_xy.numpy(), direct.state.graph.lm_xy.numpy(),
                               atol=1e-4)


def test_gps_outlier_guard():
    slam = Slam(_cfg(), device="cpu")
    slam._odometry[:] = (500.0, 0.0, 0.0)
    slam.process_frame(np.array([[10.0, 0.0, 5.0, 1.0]]), np.ones(1, dtype=bool), 1000)
    assert int(slam.state.graph.n_poses) == 0


def test_trackdrive_multilap_improved_mode():
    track = trackdrive(seed=4)
    scen = simulate(track, SimConfig(laps=1.15, seed=5, max_range=20.0))
    cfg = SlamConfig(capacity=GraphCapacity(256, 160, 4096), association="nearest",
                     localizer_refine=True, localizer_type_bug=False)
    slam = Slam(cfg, device="cpu")
    slam.run_scenario(scen)
    assert slam.loop_closure_complete
    lm_xy, _ = slam.draw_cones()
    d = np.linalg.norm(lm_xy[:, None, :] - track.cones_xy[None, :, :], axis=-1)
    assert np.median(d.min(axis=1)) < 0.6
    assert d.min(axis=1).max() < 1.5


def test_fault_injection_drop_dup_reorder():
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=5, drop_frame_prob=0.1,
                                         dup_frame_prob=0.1, reorder_frame_prob=0.1))
    assert scen.meta["n_frames"] > 10
    assert np.any(np.diff(scen.times) < 0)
    slam = Slam(SlamConfig(), device="cpu")
    est = slam.run_scenario(scen)
    err = ate(est[:, :2], scen.gt_poses[:, :2])
    assert np.isfinite(err) and err < 1.0, err
    assert int(slam.state.graph.n_landmarks) > 10


# -- run_live

class _Bus:
    """An in-process stand-in for an OD4Session: the service registers its
    delegates, `deliver` calls them as the bus's consumer would."""

    def __init__(self):
        self.delegates, self.sent, self.running = {}, [], False

    def data_trigger(self, data_type, fn):
        self.delegates[data_type] = fn

    async def start(self):
        self.running = True

    async def stop(self):
        self.running = False

    def send(self, msg, sample_us=0, sender_stamp=0):
        self.sent.append((msg, sample_us, sender_stamp))

    def deliver(self, env):
        fn = self.delegates.get(env.dataType)
        if fn is not None:
            fn(env)


def _lap_envelopes(tmp_path, scen, cfg):
    rec = str(tmp_path / "lap.rec")
    scenario_to_rec(scen, rec, cfg)
    return rec, [env for env in E.iterate_envelopes(open(rec, "rb").read())]


def test_run_live_on_a_bus_equals_replay(tmp_path):
    """`run_live` registers its delegates, closes the last frame by the
    idle-aware flush and publishes through the bus; the frames and the
    published messages equal a replay of the same recording."""
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=31))
    cfg = _cfg(time_between_keyframes_ms=100.0)
    rec, envs = _lap_envelopes(tmp_path, scen, cfg)
    replay = SlamService(cfg, device="cpu")
    replay_pub = []
    replay.slam.publish = lambda msg, ts, stamp: replay_pub.append((msg, ts.micros, stamp))
    replay.run_replay(rec)

    bus = _Bus()
    svc = SlamService(cfg, od4=bus, device="cpu")

    async def run():
        task = asyncio.create_task(svc.run_live())
        await asyncio.sleep(0)
        assert bus.running
        for env in envs:
            bus.deliver(env)
        await asyncio.sleep(5 * cfg.gathering_time_ms / 1000.0)
        task.cancel()
        await task

    asyncio.run(run())
    assert not bus.running
    assert svc.slam.keyframes_processed == replay.slam.keyframes_processed == len(scen.times)
    assert [(type(m), m, s) for m, _, s in bus.sent] == [(type(m), m, s) for m, _, s in replay_pub]
    _assert_trees(state_to_numpy(svc.slam.state), state_to_numpy(replay.slam.state))


def test_run_live_needs_a_bus():
    with pytest.raises(ValueError):
        asyncio.run(SlamService(_cfg(), device="cpu").run_live())


def test_run_live_od4_loopback():
    """`run_live` on the port's OD4 session, fed over multicast loopback by a
    second session, as tests/test_io.py::test_od4_session_loopback does."""
    from tpuslam_torch.io.od4 import OD4Session

    cfg = _cfg(cid=197)
    scen = simulate(skidpad(), SimConfig(laps=0.3, seed=32))

    async def run():
        svc = SlamService(cfg, od4=OD4Session(cid=cfg.cid), device="cpu")
        tx = OD4Session(cid=cfg.cid)
        task = asyncio.create_task(svc.run_live())
        try:
            await asyncio.sleep(0.1)
            await tx.start()
        except OSError:
            task.cancel()
            pytest.skip("multicast sockets unavailable")
        us = int(scen.times[0] * 1e6)
        geo = _geo_from_local(np.array(cfg.gps_reference), scen.odom_poses[0])
        for _ in range(20):
            tx.send(geo, sample_us=us, sender_stamp=cfg.estimation_id)
            for i in range(int(scen.obs_valid[0].sum())):
                az, zen, dist, ct = (float(x) for x in scen.obs[0, i])
                tx.send(M.ObjectDirection(objectId=i, azimuthAngle=az, zenithAngle=zen),
                        sample_us=us, sender_stamp=cfg.detect_cone_id)
                tx.send(M.ObjectDistance(objectId=i, distance=dist), sample_us=us,
                        sender_stamp=cfg.detect_cone_id)
                tx.send(M.ObjectType(objectId=i, type=int(ct)), sample_us=us,
                        sender_stamp=cfg.detect_cone_id)
            await asyncio.sleep(0.05)
            if svc.slam.keyframes_processed:
                break
        task.cancel()
        await task
        await tx.stop()
        return svc

    svc = asyncio.run(run())
    if not svc.metrics.counters.get("cone_messages"):
        pytest.skip("multicast loopback not routed on this host")
    assert svc.slam.keyframes_processed >= 1
    assert int(svc.slam.state.graph.n_poses) >= 1


# -- the EKF fusion through the engine's entry points (the refusal is gone)

def _skidpad_frames():
    scen = simulate(skidpad(), SimConfig(laps=1.3, seed=2))
    return scen.obs.astype(np.float32), scen.obs_valid, scen.odom_poses.astype(np.float32)


@pytest.mark.parametrize("path", ["perform_keyframe", "run_sequence", "run_sequence_blocked"])
def test_ekf_fusion_flag_runs_and_equals_jax(path):
    """`use_ekf_fusion` is read by `Slam` alone in both packages: the
    engine's entry points accept it and give the JAX package's results."""
    obs, valid, poses = _skidpad_frames()
    jcfg = JCfg(capacity=JCap(128, 128, 4096), use_ekf_fusion=True)
    cfg = SlamConfig(capacity=GraphCapacity(128, 128, 4096), use_ekf_fusion=True)
    jins = (jnp.asarray(obs), jnp.asarray(valid), jnp.asarray(poses))
    ins = (torch.tensor(obs), torch.tensor(valid), torch.tensor(poses))
    if path == "perform_keyframe":
        js, jo = jax_perform_keyframe(jax_initial_state(jcfg.capacity), *(x[0] for x in jins),
                                      jcfg)
        ps, po = perform_keyframe(initial_state(cfg.capacity, "cpu"), *(x[0] for x in ins), cfg)
        atol = PRE_ATOL
    elif path == "run_sequence":
        js, jo = jax_run_sequence(jax_initial_state(jcfg.capacity), *jins, jcfg)
        ps, po = run_sequence(initial_state(cfg.capacity, "cpu"), *ins, cfg)
        atol = POST_ATOL
    else:
        js, jo = jax_run_blocked(jax_initial_state(jcfg.capacity), *jins, jcfg, block=8)
        ps, po = run_sequence_blocked(initial_state(cfg.capacity, "cpu"), *ins, cfg, block=8)
        atol = POST_ATOL
    _assert_trees(state_to_numpy(ps), _np_tree(js), atol=atol)
    for f in ("send", "loop_closed", "n_landmarks", "cone_type"):
        np.testing.assert_array_equal(getattr(po, f).numpy(), np.asarray(getattr(jo, f)))
    np.testing.assert_allclose(po.pose.numpy(), np.asarray(jo.pose), atol=atol, rtol=0)
    if path != "perform_keyframe":
        assert bool(ps.loop_closure_complete)
    # and equal to the same run without the flag
    plain = dataclasses.replace(cfg, use_ekf_fusion=False)
    if path == "run_sequence":
        _assert_trees(state_to_numpy(run_sequence(initial_state(cfg.capacity, "cpu"), *ins,
                                                  plain)[0]), state_to_numpy(ps))
