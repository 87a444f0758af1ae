"""slamctl-torch — the operational CLI of the PyTorch port (counterpart of
`tpuslam.cli.main`, the `slamctl` of the JAX package).

    slamctl-torch sim skidpad                     # on the card (the default)
    slamctl-torch --device cpu sim skidpad        # on the CPU

Subcommands cover the reference's whole ops surface (SURVEY.md §2.2's
embedded cluon tools + the service main):
  run      live OD4 microservice (reference main, src/opendlv-logic-...cpp)
  replay   drive the engine from a .rec recording (cluon-replay equivalent)
  sim      synthetic track run: generate, process, report ATE / write .rec
  bench    the benchmark suite (not yet: the port has no bench script)
  export   .rec -> CSV / JSON-lines (cluon-rec2csv / EnvelopeConverter)
  monitor  live bus message-rate monitor (cluon-livefeed equivalent)
  viz      render map/trajectory/graph from a checkpoint to PNG
  fuse     cross-session map fusion
  record   record the bus to a .rec file
  msc      .odvd -> Python message classes

`--device {cuda,cpu}` (default cuda) places every state a command builds; a
cuda run without a card exits 2 with a message naming the device, and never
falls back to the CPU. The commands that need a process group (`sim
--pipeline resident`, `fuse` with a mesh or a chain solver) use the caller's
as it is, or join the world `torchrun` describes in the environment, or
make a world of one rank ('nccl' on the card, 'gloo' on the CPU), and
destroy a world they made before they return (`parallel.mesh.process_group`).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from collections import Counter
from contextlib import ExitStack


def _add_reference_flags(p: argparse.ArgumentParser):
    """The reference's CLI flags, same names (src/...-slam.cpp:55)."""
    p.add_argument("--cid", type=int, default=111)
    p.add_argument("--id", type=int, default=120)
    p.add_argument("--detectConeId", type=int, default=118)
    p.add_argument("--estimationId", type=int, default=114)
    p.add_argument("--gatheringTimeMs", type=float, default=10)
    p.add_argument("--sameConeThreshold", type=float, default=1.2)
    p.add_argument("--refLatitude", type=float, default=57.714787)
    p.add_argument("--refLongitude", type=float, default=11.948313)
    p.add_argument("--timeBetweenKeyframes", type=float, default=500)
    p.add_argument("--coneMappingThreshold", type=float, default=50)
    p.add_argument("--conesPerPacket", type=int, default=20)
    p.add_argument("--no-compat", action="store_true",
                   help="disable reference-compat quirks (clean math mode)")
    p.add_argument("--improved", action="store_true",
                   help="beats-the-reference accuracy mode: GPS/heading "
                        "priors, calibrated weights, nearest association, "
                        "localizer refine, periodic re-optimization "
                        "(SlamConfig.improved)")
    p.add_argument("--association", default=None,
                   choices=["first", "nearest", "mahalanobis"])
    p.add_argument("--viz-png", default=None, metavar="PATH",
                   help="live viewer: continuously re-render the map to PATH "
                        "(the reference viewer build's render thread)")
    p.add_argument("--viz-interval", type=float, default=0.5)


def _config_from_args(args):
    from tpuslam_torch.runtime.config import SlamConfig
    cfg = SlamConfig.from_cli_args({
        "cid": args.cid, "id": args.id, "detectConeId": args.detectConeId,
        "estimationId": args.estimationId,
        "gatheringTimeMs": args.gatheringTimeMs,
        "sameConeThreshold": args.sameConeThreshold,
        "refLatitude": args.refLatitude, "refLongitude": args.refLongitude,
        "timeBetweenKeyframes": args.timeBetweenKeyframes,
        "coneMappingThreshold": args.coneMappingThreshold,
        "conesPerPacket": args.conesPerPacket,
    })
    if args.improved:
        cfg = SlamConfig.improved(
            **{f: getattr(cfg, f) for f in (
                "cid", "sender_id", "detect_cone_id", "estimation_id",
                "gathering_time_ms", "same_cone_threshold", "ref_latitude",
                "ref_longitude", "time_between_keyframes_ms",
                "cone_mapping_threshold", "cones_per_packet", "capacity")})
    elif args.no_compat:
        cfg = cfg.with_(reference_compat=False, localizer_type_bug=False,
                        association="nearest", localizer_refine=True)
    if args.association:
        cfg = cfg.with_(association=args.association)
    return cfg


def _attention_from_args(args):
    """Integrated lidar front-end options: --attention [--od-config FILE]
    [--lidarId N]. Returns (attention_cfg|None, lidar_sender_id|None)."""
    if not getattr(args, "attention", False):
        return None, None
    from tpuslam_torch.perception.attention import AttentionConfig
    acfg, stamp = AttentionConfig(), None
    if getattr(args, "od_config", None):
        from tpuslam_torch.runtime.odconfig import attention_from_od_config
        with open(args.od_config) as f:
            acfg, stamp = attention_from_od_config(f.read())
    if getattr(args, "lidarId", None) is not None:
        stamp = args.lidarId
    return acfg, stamp


def _device_missing(args) -> bool:
    """True (after saying so) when --device names a CUDA device and there
    is no card."""
    import torch
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"[slamctl] --device {args.device}: no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return True
    return False


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _maybe_viewer(args, svc):
    """The reference viewer build's render thread (slamctl --viz-png)."""
    if not getattr(args, "viz_png", None):
        return None
    from tpuslam_torch.viz import LiveViewer
    return LiveViewer(lambda: svc.slam.state, png_path=args.viz_png,
                      interval_s=args.viz_interval).start()


def cmd_run(args):
    if _device_missing(args):
        return 2
    from tpuslam_torch.io.od4 import OD4Session
    from tpuslam_torch.runtime.service import SlamService
    cfg = _config_from_args(args)
    od4 = OD4Session(cid=cfg.cid)
    acfg, lidar_id = _attention_from_args(args)
    svc = SlamService(cfg, od4=od4, attention_cfg=acfg,
                      lidar_sender_id=lidar_id, device=args.device)
    print(f"[slamctl] joining OD4 session {cfg.cid} "
          f"(group 225.0.0.{cfg.cid}:12175)", file=sys.stderr)
    viewer = _maybe_viewer(args, svc)
    try:
        asyncio.run(svc.run_live())
    except KeyboardInterrupt:
        pass
    finally:
        if viewer:
            viewer.stop()
    svc.metrics.dump_json(sys.stdout)
    return 0


def cmd_replay(args):
    if args.to_bus or args.stdout:
        # cluon-replay mode: publish onto the OD4 bus and/or stdout,
        # remote-controlled by PlayerCommand [9] (from the bus when playing
        # to a bus, from framed envelopes on stdin otherwise — the
        # reference tool's monitorSTDIN path), reporting PlayerStatus [10]
        from tpuslam_torch.io.od4 import OD4Session
        from tpuslam_torch.io.rec import Player, replay_to_bus

        async def run():
            od4 = OD4Session(cid=args.cid) if args.to_bus else None
            if od4:
                await od4.start()
            try:
                n = await replay_to_bus(
                    Player(args.rec), od4, paced=args.paced,
                    speedup=args.speedup,
                    stdout_stream=sys.stdout.buffer if args.stdout else None,
                    command_stream=None if args.to_bus else sys.stdin.buffer)
                print(f"[slamctl] replayed {n} envelopes", file=sys.stderr)
            finally:
                if od4:
                    await od4.stop()

        try:
            asyncio.run(run())
        except KeyboardInterrupt:
            pass
        return 0
    if _device_missing(args):
        return 2
    from tpuslam_torch.runtime.service import SlamService
    cfg = _config_from_args(args)
    acfg, lidar_id = _attention_from_args(args)
    svc = SlamService(cfg, attention_cfg=acfg, lidar_sender_id=lidar_id,
                      device=args.device)
    viewer = _maybe_viewer(args, svc)
    try:
        svc.run_replay(args.rec, paced=args.paced, speedup=args.speedup)
    finally:
        if viewer:
            viewer.stop()
    if args.checkpoint:
        from tpuslam_torch.runtime.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, svc.slam.state, cfg)
    if args.png:
        from tpuslam_torch.viz import save_state_png
        save_state_png(svc.slam.state, args.png)
    svc.metrics.set("loop_closed", svc.slam.loop_closure_complete)
    svc.metrics.set("landmarks", int(svc.slam.state.graph.n_landmarks))
    svc.metrics.dump_json(sys.stdout)
    return 0


def cmd_sim(args):
    if _device_missing(args):
        return 2
    import torch
    from tpuslam_torch.core.slam import Slam
    from tpuslam_torch.sim import SimConfig, simulate, skidpad, acceleration, trackdrive
    from tpuslam_torch.sim.simulator import ate
    cfg = _config_from_args(args)
    track = {"skidpad": skidpad, "acceleration": acceleration,
             "trackdrive": lambda: trackdrive(seed=args.seed)}[args.track]()
    scen = simulate(track, SimConfig(laps=args.laps, seed=args.seed))
    if args.rec_out:
        from tpuslam_torch.runtime.service import scenario_to_rec
        scenario_to_rec(scen, args.rec_out, cfg)
        print(f"[slamctl] wrote {args.rec_out}", file=sys.stderr)
    if args.pipeline in ("blocked", "resident"):
        # whole-lap replay through the frame-blocked pipeline
        # (frontend/blocked.py) — bit-exact vs the live per-frame engine.
        # `resident` runs the same pass with the landmark map sharded over a
        # ('map',) mesh of ranks (parallel/resident_online.py) — the
        # pod-scale-map serving path (BASELINE config 5).
        from tpuslam_torch.frontend.blocked import run_pass_blocked
        obs = torch.tensor(scen.obs, dtype=torch.float32, device=args.device)
        valid = torch.tensor(scen.obs_valid, device=args.device)
        poses = torch.tensor(scen.odom_poses, dtype=torch.float32, device=args.device)
        with ExitStack() as stack:
            if args.pipeline == "resident":
                from tpuslam_torch.parallel.mesh import make_map_mesh, process_group
                from tpuslam_torch.parallel.resident_online import (
                    run_pass_resident_online)
                if args.map_shards < 0:
                    print("[slamctl] --map-shards must be >= 0",
                          file=sys.stderr)
                    return 2
                world = stack.enter_context(process_group(args.device))
                req = args.map_shards or world
                d = max(1, min(req, world))
                while cfg.capacity.max_landmarks % d:
                    d -= 1
                if d != req:
                    print(f"[slamctl] --map-shards {req} adjusted to {d} "
                          f"(must divide landmark capacity "
                          f"{cfg.capacity.max_landmarks} and fit "
                          f"{world} ranks)", file=sys.stderr)
                mesh = make_map_mesh(d, device_type=torch.device(args.device).type)

                def run():
                    return run_pass_resident_online(obs, valid, poses, cfg,
                                                    mesh, block=args.block)
            else:
                def run():
                    return run_pass_blocked(obs, valid, poses, cfg,
                                            block=args.block)
            try:
                run()                                      # warm-up
            except ValueError as e:
                print(f"[slamctl] unsupported pipeline config: {e}",
                      file=sys.stderr)
                return 2
            _sync(args.device)
            t0 = time.perf_counter()
            state, outs = run()
            _sync(args.device)
            dt = time.perf_counter() - t0
        est = outs.pose.cpu().numpy()
        loop_closed = bool(state.loop_closure_complete)
        n_landmarks = int(state.graph.n_landmarks)
        viz_state = state
    else:
        slam = Slam(cfg, device=args.device)
        t0 = time.perf_counter()
        est = slam.run_scenario(scen)
        dt = time.perf_counter() - t0
        loop_closed = slam.loop_closure_complete
        n_landmarks = int(slam.state.graph.n_landmarks)
        viz_state = slam.state
    result = {
        "track": track.name,
        "pipeline": args.pipeline,
        "frames": len(scen.times),
        "fps": round(len(scen.times) / dt, 1),
        "loop_closed": loop_closed,
        "landmarks": n_landmarks,
        "ate_published_m": round(ate(est[:, :2], scen.gt_poses[:, :2]), 4),
        "ate_odometry_m": round(
            ate(scen.odom_poses[:, :2], scen.gt_poses[:, :2]), 4),
    }
    if args.png:
        from tpuslam_torch.viz import save_state_png
        save_state_png(viz_state, args.png, gt_track=track)
        result["png"] = args.png
    print(json.dumps(result))
    return 0


def cmd_bench(args):
    print("[slamctl] the port has no bench yet: bench.py measures the JAX "
          "package; the port's bench script is ROADMAP.md §1 item 1",
          file=sys.stderr)
    return 2


def cmd_fuse(args):
    """Cross-session map fusion: S sessions -> one global map
    (tpuslam_torch/parallel/fusion.py; BASELINE config 5's fused-map flow)."""
    if _device_missing(args):
        return 2
    import numpy as np
    import torch
    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.parallel import fusion, stack_graphs

    cfg = _config_from_args(args)
    dev = torch.device(args.device)
    gt_track = None
    lm_info = None
    if args.checkpoints:
        from tpuslam_torch.runtime.checkpoint import load_checkpoint
        states = [load_checkpoint(p, device=dev)[0] for p in args.checkpoints]
        graphs = [s.graph for s in states]
        # information-weighted merge when the sessions accumulated
        # per-landmark information (mahalanobis mode); all-zero rows fall
        # back to obs-count weights inside fuse_graphs
        caps = {g.capacity for g in graphs}
        if len(caps) != 1:
            print(f"[slamctl] checkpoint capacities differ: {caps}",
                  file=sys.stderr)
            return 2
        lm_info = torch.stack([s.lm_info_xy for s in states])
        cap = graphs[0].capacity
    else:
        # simulate S independent sessions of the same track (distinct noise
        # seeds) and map each one through the engine
        from tpuslam_torch.backend.graph import GraphCapacity
        from tpuslam_torch.frontend.pipeline import run_sequence
        from tpuslam_torch.frontend.state import initial_state
        from tpuslam_torch.sim import SimConfig, simulate, trackdrive
        track = trackdrive(seed=args.seed)
        gt_track = track
        cap = GraphCapacity(max_poses=512, max_landmarks=256, max_obs=8192)
        cfg = cfg.with_(capacity=cap)
        graphs = []
        infos = []
        for s in range(args.sessions):
            scen = simulate(track, SimConfig(laps=args.laps, keyframe_dt=0.25,
                                             seed=args.seed + 1 + s))
            st, _ = run_sequence(
                initial_state(cap, dev),
                torch.tensor(scen.obs, dtype=torch.float32, device=dev),
                torch.tensor(scen.obs_valid, device=dev),
                torch.tensor(scen.odom_poses, dtype=torch.float32, device=dev), cfg)
            graphs.append(st.graph)
            infos.append(st.lm_info_xy)
        lm_info = torch.stack(infos)

    with ExitStack() as stack:
        mesh = None
        solve_mesh = None
        if args.mesh_shards > 1 or args.solver != "auto":
            from tpuslam_torch.parallel.mesh import process_group
            world = stack.enter_context(process_group(dev))
        if args.mesh_shards > 1:
            if world < args.mesh_shards:
                print(f"[slamctl] --mesh-shards {args.mesh_shards} > "
                      f"{world} devices", file=sys.stderr)
                return 2
            if args.solver == "auto":
                from tpuslam_torch.parallel.mesh import make_slam_mesh
                mesh = make_slam_mesh(n_sessions=1, n_edge_shards=args.mesh_shards,
                                      device_type=dev.type)
        if args.solver in ("dd", "hier", "hier3"):
            from tpuslam_torch.parallel.mesh import make_chain_mesh
            n = args.mesh_shards if args.mesh_shards > 1 else world
            if cap.max_poses * len(graphs) % n or cap.max_poses * len(graphs) // n < 3:
                print(f"[slamctl] --solver {args.solver}: fused pose capacity "
                      f"{cap.max_poses * len(graphs)} not partitionable over "
                      f"{n} devices", file=sys.stderr)
                return 2
            if args.solver == "hier" and args.tray and n % args.tray:
                print(f"[slamctl] --tray {args.tray} must divide the device "
                      f"count {n}", file=sys.stderr)
                return 2
            solve_mesh = make_chain_mesh(n, device_type=dev.type)

        gncfg = gn.GNConfig(odo_info=cfg.odo_info, lm_info=cfg.lm_info,
                            iterations=args.gn_iterations,
                            fix_first_poses=0 if cfg.use_gps_prior else 2,
                            fix_first_landmarks=0 if cfg.use_gps_prior else 2)
        stacked = stack_graphs(graphs)
        _sync(dev)
        t0 = time.perf_counter()
        fused, report = fusion.fuse_sessions(
            stacked, cfg=gncfg, gate=cfg.same_cone_threshold, mesh=mesh,
            align=not args.no_align, lm_info=lm_info,
            solver=args.solver, tray=args.tray or None, solve_mesh=solve_mesh)
        _sync(dev)
        dt = time.perf_counter() - t0

    result = {
        "solver": args.solver,
        "sessions": len(graphs),
        "landmarks_per_session": [int(g.n_landmarks) for g in graphs],
        "fused_landmarks": int(fused.n_landmarks),
        "fused_poses": int(fused.n_poses),
        "cross_session_merges": int(report["n_cross_session_merges"]),
        "align_matches": [int(x) for x in report["n_align_matched"].tolist()],
        "mesh_shards": args.mesh_shards,
        "fuse_seconds": round(dt, 3),
    }
    if gt_track is not None:
        lm = fused.lm_xy.cpu().numpy()[:int(fused.n_landmarks)]
        result["map_error_m"] = round(float(np.median(np.linalg.norm(
            lm[:, None, :] - gt_track.cones_xy[None], axis=-1).min(axis=1))), 4)
    if args.out:
        from tpuslam_torch.runtime.checkpoint import save_checkpoint
        save_checkpoint(args.out, _fused_state(fused), cfg,
                        extra={"fused_sessions": len(graphs)})
        result["out"] = args.out
    if args.png:
        from tpuslam_torch.viz import save_state_png
        save_state_png(_fused_state(fused), args.png, gt_track=gt_track)
        result["png"] = args.png
    print(json.dumps(result))
    return 0


def _fused_state(fused):
    """The fused graph as a closed SlamState (for a checkpoint or a PNG)."""
    import torch
    from tpuslam_torch.frontend.state import SlamState
    dev = fused.poses.device

    def flag(v):
        return torch.tensor(v, device=dev)
    return SlamState(
        graph=fused, current_cone_index=torch.tensor(0, dtype=torch.int32, device=dev),
        loop_closing=flag(True), loop_closure_complete=flag(True),
        keyframe_count=fused.n_poses.clone(), send_cone_data=flag(False),
        lm_info_xy=torch.zeros((fused.lm_xy.shape[0], 3), dtype=torch.float32, device=dev))


def cmd_export(args):
    from tpuslam_torch.io.exporters import rec_to_csv, rec_to_jsonl
    from tpuslam_torch.io.rec import read_rec
    if args.format == "csv" and args.type is None:
        print("--type is required for csv export", file=sys.stderr)
        return 1
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        if args.format == "csv":
            n = rec_to_csv(read_rec(args.rec), out, args.type)
        else:
            n = rec_to_jsonl(read_rec(args.rec), out, data_type=args.type)
    finally:
        if args.out:
            out.close()
    print(f"[slamctl] exported {n} envelopes", file=sys.stderr)
    return 0


def cmd_monitor(args):
    """Live bus monitor: per-type message rates (cluon-livefeed)."""
    from tpuslam_torch.io import messages as M
    from tpuslam_torch.io.od4 import OD4Session

    names = {cls.ID: cls.__name__ for cls in M.MESSAGE_REGISTRY.values()}
    counts: Counter = Counter()

    async def run():
        od4 = OD4Session(cid=args.cid)
        od4.catch_all(lambda env: counts.update(
            [(env.dataType, env.senderStamp)]))
        await od4.start()
        try:
            while True:
                await asyncio.sleep(args.interval)
                print(f"--- {time.strftime('%H:%M:%S')} ---")
                for (dt, stamp), n in sorted(counts.items()):
                    name = names.get(dt, f"id{dt}")
                    print(f"  {name:30s} sender={stamp:<5d} "
                          f"{n / args.interval:8.1f} msg/s")
                counts.clear()
        finally:
            await od4.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_record(args):
    """Record the OD4 bus to a .rec file (the reference session's
    opendlv-logger service, reference usecase/docker-compose.yml:37-41;
    output is Player/cluon-replay compatible)."""
    from tpuslam_torch.io.od4 import OD4Session
    from tpuslam_torch.io.rec import RecWriter

    n = 0

    async def run():
        nonlocal n
        od4 = OD4Session(cid=args.cid)
        with RecWriter(args.out) as w:
            def on_env(env):
                nonlocal n
                if args.type is not None and env.dataType != args.type:
                    return
                w.write(env)
                n += 1
            od4.catch_all(on_env)
            await od4.start()
            try:
                if args.duration:
                    await asyncio.sleep(args.duration)
                else:
                    while True:
                        await asyncio.sleep(3600)
            finally:
                await od4.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    print(f"[slamctl] recorded {n} envelopes -> {args.out}")
    return 0


def cmd_viz(args):
    if _device_missing(args):
        return 2
    from tpuslam_torch.runtime.checkpoint import load_checkpoint
    from tpuslam_torch.viz import save_state_png
    state, meta = load_checkpoint(args.checkpoint, device=args.device)
    save_state_png(state, args.out)
    print(f"[slamctl] wrote {args.out}")
    return 0


def cmd_msc(args):
    from tpuslam_torch.io.msc import generate_python_module, generate_python_source
    if not args.odvd:
        # no spec given: use the vendored standard message set (the reference
        # ships src/opendlv-standard-message-set-v0.9.5.odvd for this role)
        import os
        from tpuslam_torch.io import standard_message_set as _sms
        args.odvd = os.path.join(os.path.dirname(_sms.__file__),
                                 "opendlv_standard_message_set.odvd")
    if args.out:
        n = generate_python_module(args.odvd, args.out)
        print(f"[slamctl] {args.odvd}: {n} message classes -> {args.out}")
    else:
        with open(args.odvd) as f:
            sys.stdout.write(generate_python_source(f.read(),
                                                    source_name=args.odvd))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The parser of `slamctl-torch`: each subcommand's parser sets `fn`,
    the function `main` calls with the parsed arguments."""
    p = argparse.ArgumentParser(prog="slamctl-torch",
                                description="landmark GraphSLAM on PyTorch (CUDA or CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_attention_flags(sp):
        sp.add_argument("--attention", action="store_true",
                        help="integrated lidar front-end: consume raw "
                             "PointCloudReading [49] through the cone "
                             "detector (the reference's sibling "
                             "cfsd18-sensation-attention service)")
        sp.add_argument("--od-config", default=None, metavar="FILE",
                        help="OpenDaVINCI configuration file; reads the "
                             "logic-cfsd18-sensation-attention section "
                             "(reference usecase/configuration)")
        sp.add_argument("--lidarId", type=int, default=None,
                        help="accept point clouds only from this senderStamp")

    pr = sub.add_parser("run", help="live OD4 microservice")
    add_attention_flags(pr)
    _add_reference_flags(pr)
    pr.set_defaults(fn=cmd_run)

    pp = sub.add_parser("replay", help="replay a .rec recording")
    add_attention_flags(pp)
    _add_reference_flags(pp)
    pp.add_argument("rec")
    pp.add_argument("--paced", action="store_true")
    pp.add_argument("--speedup", type=float, default=1.0)
    pp.add_argument("--to-bus", action="store_true",
                    help="publish onto the OD4 bus instead of the local "
                         "pipeline (cluon-replay; PlayerCommand-controlled)")
    pp.add_argument("--stdout", action="store_true",
                    help="serialize framed envelopes to stdout "
                         "(cluon-replay --stdout; commands read from stdin "
                         "when not also --to-bus)")
    pp.add_argument("--checkpoint")
    pp.add_argument("--png")
    pp.set_defaults(fn=cmd_replay)

    ps = sub.add_parser("sim", help="synthetic track run")
    _add_reference_flags(ps)
    ps.add_argument("track", choices=["skidpad", "acceleration", "trackdrive"])
    ps.add_argument("--laps", type=float, default=1.3)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--rec-out")
    ps.add_argument("--pipeline", choices=["live", "blocked", "resident"],
                    default="live",
                    help="live = message-level per-frame engine; blocked = "
                         "whole-lap frame-blocked device pipeline "
                         "(frontend/blocked.py, bit-exact); "
                         "resident = the blocked pass with the landmark "
                         "map sharded over a ('map',) mesh of ranks "
                         "(parallel/resident_online.py — per-rank "
                         "landmark memory O(L/D))")
    ps.add_argument("--map-shards", type=int, default=0,
                    help="ranks for --pipeline resident (0 = the whole "
                         "world: the caller's process group, else one rank; "
                         "rounded down to divide the landmark capacity)")
    ps.add_argument("--block", type=int, default=16,
                    help="frames per scan step for the blocked/resident "
                         "pipelines; with --improved, a periodic-GN "
                         "cadence that divides the block runs mid-block "
                         "multi-fire (e.g. --block 32 with the every-16 "
                         "default — the measured throughput sweet spot)")
    ps.add_argument("--png")
    ps.set_defaults(fn=cmd_sim)

    pb = sub.add_parser("bench", help="benchmark suite")
    pb.set_defaults(fn=cmd_bench)

    pf = sub.add_parser("fuse", help="cross-session map fusion: S session "
                                     "checkpoints (or simulated sessions) "
                                     "-> one jointly optimized global map")
    _add_reference_flags(pf)
    pf.add_argument("checkpoints", nargs="*",
                    help="session checkpoint .npz files (omit to simulate "
                         "--sessions sessions)")
    pf.add_argument("--sessions", type=int, default=4)
    pf.add_argument("--laps", type=float, default=1.2)
    pf.add_argument("--seed", type=int, default=11)
    pf.add_argument("--mesh-shards", type=int, default=1,
                    help=">1: landmark-sharded dedup + edge-sharded "
                         "distributed-Schur joint GN over that many ranks "
                         "of the caller's process group")
    pf.add_argument("--solver", choices=["auto", "dd", "hier", "hier3"],
                    default="auto",
                    help="joint-GN backend over the fused graph: auto = "
                         "distributed Schur when --mesh-shards > 1 else "
                         "single-device; dd = pose-chain domain "
                         "decomposition; hier = two-level hierarchical "
                         "solve (tray-local elimination on ICI, O(trays) "
                         "boundary system across trays — the pod-scale "
                         "path, parallel/hier.py); hier3 = three-level "
                         "(trays -> pod boundary on ICI -> O(pods) system "
                         "on DCN — the multi-pod path, parallel/hier3.py)")
    pf.add_argument("--tray", type=int, default=0,
                    help="ICI-domain size for --solver hier (devices per "
                         "tray; must divide the device count; 0 = largest "
                         "divisor <= 16)")
    pf.add_argument("--gn-iterations", type=int, default=5)
    pf.add_argument("--no-align", action="store_true",
                    help="skip SE(2) registration (sessions already aligned)")
    pf.add_argument("--out", default=None, help="write fused checkpoint .npz")
    pf.add_argument("--png", default=None, help="render the fused map")
    pf.set_defaults(fn=cmd_fuse)

    pe = sub.add_parser("export", help=".rec -> csv/jsonl")
    pe.add_argument("rec")
    pe.add_argument("--format", choices=["csv", "jsonl"], default="jsonl")
    pe.add_argument("--type", type=int, default=None)
    pe.add_argument("--out")
    pe.set_defaults(fn=cmd_export)

    pm = sub.add_parser("monitor", help="live bus message rates")
    pm.add_argument("--cid", type=int, default=111)
    pm.add_argument("--interval", type=float, default=2.0)
    pm.set_defaults(fn=cmd_monitor)

    pv = sub.add_parser("viz", help="checkpoint -> PNG")
    pv.add_argument("checkpoint")
    pv.add_argument("--out", default="slam_map.png")
    pv.set_defaults(fn=cmd_viz)

    pc = sub.add_parser("record", help="record the bus to a .rec file "
                                       "(session logger)")
    pc.add_argument("out")
    pc.add_argument("--cid", type=int, default=111)
    pc.add_argument("--type", type=int, default=None,
                    help="record only this message id")
    pc.add_argument("--duration", type=float, default=None,
                    help="stop after N seconds (default: until Ctrl-C)")
    pc.set_defaults(fn=cmd_record)

    pg = sub.add_parser("msc", help=".odvd -> Python message classes "
                                    "(cluon-msc)")
    pg.add_argument("odvd", nargs="?", default=None,
                    help="spec file (default: the vendored standard "
                         "message set v0.9.5)")
    pg.add_argument("--out", default=None,
                    help="output .py path (default: stdout)")
    pg.set_defaults(fn=cmd_msc)

    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where every state a command builds lives (default: "
                        "the card; a cuda run with no card fails)")
    for sp in (pr, pp, ps, pb, pf, pe, pm, pv, pg, pc):
        # SUPPRESS: a subcommand without the flag must not clobber a
        # pre-subcommand --device (argparse overwrites parent defaults)
        sp.add_argument("--device", choices=["cuda", "cpu"],
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
