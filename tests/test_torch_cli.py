"""The port's CLI (`tpuslam_torch.cli.main`, `slamctl-torch`), its viewer
and its entry points against the JAX package's, on the CPU: each case of
tests/test_cli_viz.py runs the JAX CLI's `main` and the port's
`main(["--device", "cpu", ...])` on the same arguments (subprocess-free).

`sim` agrees on `frames`, `loop_closed` and `landmarks` exactly and on the
ATEs within SIM_ATE_ATOL for every pipeline (the port's resident pass
against the JAX CLI's blocked one, which the JAX tests hold its resident
pass to); `replay` on its metrics;
`export` byte for byte; `fuse` on every field but its time, the map error
within SIM_ATE_ATOL. The JAX outputs are computed once per module. Commands
that make a process group destroy it before they return.
"""
import contextlib
import dataclasses
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_tools import _run_stamp
from tpuslam.cli.main import main as jmain
from tpuslam_torch.cli.main import main as pmain

SIM_ATE_ATOL = 1e-3      # ATE / map error, metres
PIPELINES = ("live", "blocked", "resident")
JAX_PIPELINE = {"live": "live", "blocked": "blocked", "resident": "blocked"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's work on one thread: tier-1 runs six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(fn, argv):
    """(rc, stdout, stderr) of one CLI call in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _jax(argv):
    return _run(jmain, ["--platform", "cpu", *argv])


def _port(argv):
    rc = _run(pmain, ["--device", "cpu", *argv])
    assert not dist.is_initialized(), "the CLI left a process group behind"
    return rc


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _sim_args(pipeline, tmp, tag):
    argv = ["sim", "skidpad", "--laps", "1.3", "--pipeline", pipeline]
    if pipeline == "resident":
        argv += ["--map-shards", "1"]
    if pipeline == "live" and tag == "port":
        argv += ["--rec-out", str(tmp / f"{tag}.rec"), "--png", str(tmp / f"{tag}.png")]
    return argv


@pytest.fixture(scope="module")
def sim_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sim")
    jax_runs = {p: _jax(_sim_args(p, tmp, "jax")) for p in set(JAX_PIPELINE.values())}
    runs = {p: {"jax": jax_runs[JAX_PIPELINE[p]], "port": _port(_sim_args(p, tmp, "port"))}
            for p in PIPELINES}
    return tmp, runs


def _check_sim(got, want):
    for k in ("track", "frames", "loop_closed", "landmarks"):
        assert got[k] == want[k], k
    for k in ("ate_published_m", "ate_odometry_m"):
        assert abs(got[k] - want[k]) <= SIM_ATE_ATOL, (k, got[k], want[k])


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_cli_sim_matches_jax(sim_runs, pipeline):
    """Every pipeline, the resident one on a one-rank gloo world that the
    CLI makes and destroys (`_port` checks that none is left)."""
    tmp, runs = sim_runs
    (jrc, jout, _), (rc, out, _) = runs[pipeline]["jax"], runs[pipeline]["port"]
    assert rc == jrc == 0
    got, want = _last_json(out), _last_json(jout)
    _check_sim(got, want)
    assert got["pipeline"] == pipeline and want["pipeline"] == JAX_PIPELINE[pipeline]
    assert got["loop_closed"] is True and got["frames"] > 10
    if pipeline == "live":
        assert os.path.getsize(tmp / "port.png") > 10_000
        assert os.path.getsize(tmp / "port.rec") > 1_000


def test_cli_pipelines_agree(sim_runs):
    """`sim --pipeline blocked` / `resident` report the live engine's
    trajectory metrics (tests/test_cli_viz.py:162-179)."""
    _, runs = sim_runs
    live = _last_json(runs["live"]["port"][1])
    for p in ("blocked", "resident"):
        other = _last_json(runs[p]["port"][1])
        for k in ("ate_published_m", "loop_closed", "landmarks"):
            assert other[k] == live[k], (p, k)


def test_cli_refuses_a_missing_card_and_bench(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["sim", "skidpad"], ["sim", "skidpad", "--device", "cuda"],
                 ["fuse", "--sessions", "1"], ["viz", str(tmp_path / "x.npz")]):
        rc, out, err = _run(pmain, argv)
        assert rc == 2 and not out and "--device cuda" in err and "CUDA" in err, argv
    # a --device given before the subcommand is not clobbered after it
    rc, out, _ = _run(pmain, ["--device", "cpu", "sim", "skidpad", "--laps", "0.3"])
    assert rc == 0 and _last_json(out)["frames"] > 0
    rc, out, err = _run(pmain, ["bench"])
    assert rc == 2 and "ROADMAP.md §1 item 1" in err


def test_cli_replay_checkpoint_and_viz(sim_runs):
    """Replay the port's recording through both CLIs with --checkpoint and
    --png: the same metrics; each package loads the other's checkpoint;
    `viz` renders the port's."""
    from tpuslam.runtime.checkpoint import load_checkpoint as jload
    from tpuslam_torch.runtime.checkpoint import load_checkpoint

    tmp, _ = sim_runs
    rec = str(tmp / "port.rec")
    common = ["replay", rec, "--timeBetweenKeyframes", "100"]
    jrc, jout, _ = _jax(common + ["--checkpoint", str(tmp / "jax.npz")])
    rc, out, _ = _port(common + ["--checkpoint", str(tmp / "port.npz"),
                                 "--png", str(tmp / "replay.png")])
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert got["gauges"]["landmarks"] > 20 and got["gauges"]["loop_closed"] is True
    assert os.path.getsize(tmp / "replay.png") > 10_000
    jstate, _ = jload(str(tmp / "port.npz"))
    state, _ = load_checkpoint(str(tmp / "jax.npz"), device="cpu")
    n = int(state.graph.n_landmarks)
    assert int(jstate.graph.n_landmarks) == n == got["gauges"]["landmarks"]
    np.testing.assert_allclose(np.asarray(jstate.graph.lm_xy)[:n],
                               state.graph.lm_xy[:n].numpy(), atol=SIM_ATE_ATOL)
    rc, out, _ = _port(["viz", str(tmp / "port.npz"), "--out", str(tmp / "ck.png")])
    assert rc == 0 and os.path.getsize(tmp / "ck.png") > 10_000


def test_cli_export_files_equal_jax(sim_runs):
    tmp, _ = sim_runs
    rec = str(tmp / "port.rec")
    for fmt, typ in (("jsonl", "1134"), ("csv", "1116"), ("jsonl", None)):
        extra = ["--type", typ] if typ else []
        outs = {}
        for name, fn in (("jax", _jax), ("port", _port)):
            path = tmp / f"export-{name}-{fmt}-{typ}"
            rc, _, err = fn(["export", rec, "--format", fmt, *extra, "--out", str(path)])
            assert rc == 0 and "exported" in err
            outs[name] = path.read_bytes()
        assert outs["port"] == outs["jax"] and outs["port"], (fmt, typ)
    lines = (tmp / "export-port-jsonl-1134").read_text().strip().splitlines()
    assert lines and all(json.loads(l)["message"] == "ObjectDistance" for l in lines)
    assert (tmp / "export-port-csv-1116").read_text().startswith(
        "sampleTimeStamp_us;senderStamp;latitude")
    rc, _, err = _run(pmain, ["export", rec, "--format", "csv"])
    assert rc == 1 and "--type is required" in err


def test_cli_sim_improved_mode_matches_jax():
    argv = ["sim", "skidpad", "--improved"]
    (jrc, jout, _), (rc, out, _) = _jax(argv), _port(argv)
    assert rc == jrc == 0
    _check_sim(_last_json(out), _last_json(jout))


@pytest.mark.slow
def test_cli_sim_improved_trackdrive_matches_jax():
    """tests/test_cli_viz.py:58-65 at its size: the improved mode beats the
    raw odometry on the trackdrive lap. Trackdrive scale, so marked slow."""
    argv = ["sim", "trackdrive", "--laps", "1.3", "--improved"]
    (jrc, jout, _), (rc, out, _) = _jax(argv), _port(argv)
    assert rc == jrc == 0
    got = _last_json(out)
    _check_sim(got, _last_json(jout))
    assert got["loop_closed"] is True and got["ate_published_m"] < got["ate_odometry_m"]


def test_cli_msc_equals_jax_but_its_import_line(tmp_path):
    ours = "from tpuslam_torch.io import messages as _M"
    theirs = "from tpuslam.io import messages as _M"
    rc, out, _ = _port(["msc", "--out", str(tmp_path / "gen.py")])
    jrc, jout, _ = _jax(["msc", "--out", str(tmp_path / "jgen.py")])
    assert rc == jrc == 0 and "message classes" in out
    src = (tmp_path / "gen.py").read_text()
    assert src.startswith('"""Generated by slamctl msc')
    jsrc = (tmp_path / "jgen.py").read_text()
    # the default spec is each package's vendored copy: the paths differ
    assert src.replace(ours, theirs).replace("tpuslam_torch/io/", "tpuslam/io/") == jsrc
    rc, out, _ = _port(["msc"])
    assert rc == 0 and "class ObjectDirection:" in out and ours in out


def test_cli_record_roundtrips_bus(tmp_path):
    """`record --type` catches what a JAX-package session publishes on the
    bus, into a file both packages read. Every OD4 socket on the host binds
    port 12175, so every session on the host hears this one: it publishes a
    type no other test triggers on, with a sender stamp drawn for this run,
    and reads back only what carries that stamp."""
    import asyncio

    from tpuslam.io import messages as JM
    from tpuslam.io.od4 import OD4Session as JOD4Session
    from tpuslam.io.rec import read_rec as jread_rec
    from tpuslam_torch.io import envelope as E
    from tpuslam_torch.io import messages as M
    from tpuslam_torch.io.rec import read_rec

    stamp, typ = _run_stamp(), M.GeodeticHeadingReading.ID
    out = str(tmp_path / "bus.rec")
    t = threading.Thread(target=pmain, args=(["record", out, "--cid", "194", "--type",
                                              str(typ), "--duration", "2.0"],), daemon=True)
    t.start()

    async def publish():
        tx = JOD4Session(cid=194)
        try:
            await tx.start()
        except OSError:
            return False
        for i in range(12):
            tx.send(JM.GeodeticHeadingReading(northHeading=0.25 * i), sample_us=1000 + i,
                    sender_stamp=stamp)
            await asyncio.sleep(0.08)
        await tx.stop()
        return True

    time.sleep(0.6)     # let the recorder join the group first
    sent = asyncio.run(publish())
    t.join(timeout=10)
    assert not t.is_alive()
    if not sent:
        pytest.skip("multicast sockets unavailable on this host")
    envs = [e for e in read_rec(out) if e.senderStamp == stamp]
    if not envs:
        pytest.skip("multicast loopback not routed on this host")
    assert all(e.dataType == typ for e in read_rec(out))
    stamps = sorted(e.sampleTimeStamp.micros for e in envs)
    assert stamps == sorted(set(stamps))    # no duplicates
    heads = sorted(E.unpack_message(e).northHeading for e in envs)
    assert set(heads) <= {0.25 * i for i in range(12)}
    assert len([e for e in jread_rec(out) if e.senderStamp == stamp]) == len(envs)


def test_cli_replay_attention_od_config(tmp_path):
    """`replay --attention --od-config`: raw VLP-16 point clouds through the
    cone detector configured by an OpenDaVINCI configuration file, counters
    and gauges equal to the JAX CLI's."""
    from tpuslam_torch.geometry import wgs84
    from tpuslam_torch.io import messages as M
    from tpuslam_torch.io.rec import RecWriter
    from tpuslam_torch.runtime.config import SlamConfig
    from tpuslam_torch.sim.vlp16_sim import Vlp16SceneConfig, scene_to_point_cloud_reading

    scfg = Vlp16SceneConfig(seed=11, points_per_cone=50)
    cones = np.array([[8.0, 1.5], [11.0, -1.5], [14.0, 1.5], [17.0, -1.5], [20.0, 1.5]])
    base = SlamConfig()
    ref = np.array(base.gps_reference)
    rec = str(tmp_path / "vlp.rec")
    with RecWriter(rec) as w:
        for t in range(5):
            us = int(t * 0.5e6) + 1000
            pose = np.array([2.0 * t, 0.0, 0.0])
            latlon = wgs84.from_cartesian(ref, pose[:2])
            w.write_message(M.Geolocation(latitude=float(latlon[0]), longitude=float(latlon[1]),
                                          heading=0.0),
                            sample_us=us, sender_stamp=base.estimation_id)
            local = cones - (pose[:2] + np.array([1.5, 0.0]))
            w.write_message(scene_to_point_cloud_reading(local[local[:, 0] > 1.0], scfg),
                            sample_us=us, sender_stamp=116)
    odconf = tmp_path / "configuration"
    odconf.write_text(
        "logic-cfsd18-sensation-attention.inlierFoundTreshold = 300\n"
        "logic-cfsd18-sensation-attention.numberOfIterations = 10\n"
        "logic-cfsd18-sensation-attention.senderStamp = 116 # lidar\n")
    argv = ["replay", rec, "--attention", "--od-config", str(odconf),
            "--timeBetweenKeyframes", "50"]
    (jrc, jout, _), (rc, out, _) = _jax(argv), _port(argv)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert got["counters"] == want["counters"] and got["gauges"] == want["gauges"]
    assert got["counters"]["point_cloud_messages"] == 5
    assert 3 <= got["gauges"]["landmarks"] <= len(cones) + 1


def test_cli_fuse_matches_jax(tmp_path):
    """`fuse` end to end (tests/test_cli_viz.py:288-313): Mahalanobis
    sessions with the information-weighted merge, --no-align, a fused
    checkpoint; every field equal to the JAX CLI's but the time."""
    from tpuslam.runtime.checkpoint import load_checkpoint as jload
    argv = ["fuse", "--sessions", "2", "--laps", "1.1", "--improved", "--association",
            "mahalanobis", "--no-align"]
    jrc, jout, _ = _jax(argv)
    rc, out, _ = _port(argv + ["--out", str(tmp_path / "fused.npz")])
    assert rc == jrc == 0
    got, want = _last_json(out), _last_json(jout)
    for k in want:
        if k == "map_error_m":
            assert abs(got[k] - want[k]) <= SIM_ATE_ATOL
        elif k != "fuse_seconds":
            assert got[k] == want[k], k
    assert got["cross_session_merges"] > 0 and got["map_error_m"] < 0.1
    assert got["fused_landmarks"] < sum(got["landmarks_per_session"]) * 0.6
    state, meta = jload(str(tmp_path / "fused.npz"))
    assert meta["fused_sessions"] == 2
    assert int(state.graph.n_landmarks) == got["fused_landmarks"]


def test_cli_fuse_world_and_mesh_checks(tmp_path):
    """--solver dd on a one-rank gloo world the CLI makes and destroys, and
    the same result as the single-device solve; --mesh-shards past the
    world size is refused with the JAX CLI's message and exit code."""
    base = ["fuse", "--sessions", "2", "--laps", "0.6", "--gn-iterations", "2"]
    rc, out, _ = _port(base)
    rc_dd, out_dd, _ = _port(base + ["--solver", "dd"])
    assert rc == rc_dd == 0
    a, b = _last_json(out), _last_json(out_dd)
    assert b["solver"] == "dd"
    for k in ("fused_landmarks", "fused_poses", "cross_session_merges", "align_matches"):
        assert a[k] == b[k], k
    assert abs(a["map_error_m"] - b["map_error_m"]) <= SIM_ATE_ATOL
    rc, out, err = _port(base + ["--mesh-shards", "2"])
    assert rc == 2 and not out and "--mesh-shards 2 > 1 devices" in err


# ---------------------------------------------------------------------------
# The viewer (tests/test_cli_viz.py:113-160, :231-285)

def _skidpad_slam(laps, seed, run=True):
    from tpuslam_torch.core.slam import Slam
    from tpuslam_torch.runtime.config import SlamConfig
    from tpuslam_torch.sim import SimConfig, simulate, skidpad
    scen = simulate(skidpad(), SimConfig(laps=laps, seed=seed))
    slam = Slam(SlamConfig(), device="cpu")
    if run:
        slam.run_scenario(scen)
    return slam, scen


def test_live_viewer_renders_and_follows(tmp_path):
    from tpuslam_torch.viz import LiveViewer
    slam, scen = _skidpad_slam(1.2, 0, run=False)
    png = str(tmp_path / "live.png")
    viewer = LiveViewer(lambda: slam.state, png_path=png, interval_s=0.05)
    assert viewer.render_once()
    first_size = os.path.getsize(png)
    with viewer:
        slam.run_scenario(scen)
        deadline = time.time() + 20
        while viewer.frames_rendered < 3 and time.time() < deadline:
            time.sleep(0.05)
    assert viewer.frames_rendered >= 3
    assert os.path.getsize(png) != first_size


def test_live_viewer_runtime_toggles_and_final_frame(tmp_path):
    from tpuslam_torch.viz.live import LiveViewer
    slam, _ = _skidpad_slam(1.1, 2)
    png = str(tmp_path / "t.png")
    viewer = LiveViewer(lambda: slam.state, png_path=png, interval_s=10.0)
    assert viewer.render_once()
    full = os.path.getsize(png)
    viewer.set_toggles(show_cones=False, show_poses=False, show_current_pose=False,
                       show_graph=False)
    assert viewer.render_once()
    assert os.path.getsize(png) != full

    class _Ev:
        key = "c"
    viewer._on_key(_Ev())
    assert viewer.show_cones is True
    _Ev.key = "g"
    viewer._on_key(_Ev())
    assert viewer.show_graph is True
    viewer.stop()
    final = str(tmp_path / "final.png")
    viewer = LiveViewer(lambda: slam.state, png_path=final, interval_s=3600.0)
    viewer.start()
    viewer.stop()
    assert os.path.exists(final)


def test_viewer_copies_the_state_to_the_host():
    """The fields a render reads are host copies, equal to the state's and
    sharing no memory with it."""
    from tpuslam_torch.viz.plot import host_graph
    slam, _ = _skidpad_slam(1.1, 2)
    g = host_graph(slam.state)
    for name, v in g.items():
        t = getattr(slam.state.graph, name).numpy()
        np.testing.assert_array_equal(v, t)
        assert not np.shares_memory(v, t), name


def test_cli_replay_with_live_viewer(sim_runs):
    tmp, _ = sim_runs
    png = str(tmp / "live_replay.png")
    rc, _, _ = _port(["replay", str(tmp / "port.rec"), "--viz-png", png,
                      "--viz-interval", "0.05"])
    assert rc == 0 and os.path.exists(png)


# ---------------------------------------------------------------------------
# Entry points (__graft_entry__.py)

def test_entry_equals_graft_entry():
    import jax
    import __graft_entry__ as graft
    from tpuslam_torch.entry import entry
    jfn, jargs = graft.entry()
    jstate, jout = jax.jit(jfn)(*jargs)
    fn, args = entry("cpu")
    state, out = fn(*args)
    for f in dataclasses.fields(state.graph):
        np.testing.assert_allclose(getattr(state.graph, f.name).numpy(),
                                   np.asarray(getattr(jstate.graph, f.name)), atol=1e-5,
                                   err_msg=f.name)
    for f in dataclasses.fields(out):
        np.testing.assert_allclose(getattr(out, f.name).numpy(),
                                   np.asarray(getattr(jout, f.name)), atol=1e-5,
                                   err_msg=f.name)
    assert int(state.graph.n_landmarks) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry()


def test_dryrun_spawns_its_own_world():
    """With no process group, `dryrun_multichip` spawns a world of gloo
    ranks, runs every tier there and leaves no group behind."""
    from tpuslam_torch.entry import dryrun_multichip
    got = dryrun_multichip(1, device="cpu")
    assert not dist.is_initialized()
    assert set(got) == {"fusion", "dd", "resident", "hier", "resident_online"}
