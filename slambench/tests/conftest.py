"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
files with tiny cells added as files alone, the way a later change adds a
cell."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_REPLAY = dict(kind="sessions", why="four sessions of one lap and a half", sessions=4,
                   track="trackdrive", track_seed=11, laps=1.4, speed=8.0, keyframe_dt=0.1,
                   max_range=20.0, warmup_steps=1, trace_steps=1,
                   judge_sessions=4)
TINY_FUSION = dict(kind="session_graphs", why="one fleet of two sessions", fleets=1,
                   sessions=2, track="trackdrive", track_seed=11, laps=1.4, speed=8.0,
                   keyframe_dt=0.1, max_range=20.0, frame_multiple=16, map_laps=1.0,
                   gps_prior_std=0.15, heading_prior_std=0.05, obs_noise_std=0.3,
                   obs_noise_az_deg=0.3, gate=1.2, align=False, warmup_steps=1, trace_steps=1)


@pytest.fixture
def checkout(tmp_path) -> Path:
    """A checkout holding BENCHMARK.json and slambench/, with the cells
    `tiny.replay` and `tiny.fusion` added as a traffic file and a
    workload entry each."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, mix in (("tiny_replay", TINY_REPLAY), ("tiny_fusion", TINY_FUSION)):
        (tmp_path / "slambench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        dict(name="tiny.replay", config="trackdrive_nearest", traffic="tiny_replay", chips=1,
             why="a tiny fleet for the CPU tests"),
        dict(name="tiny.fusion", config="fleet_fusion", traffic="tiny_fusion", chips=1,
             why="a tiny fusion for the CPU tests")]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny.replay" if "trackdrive_fleet.s64" in m["workloads"]
                                  else "tiny.fusion")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_cell(root: Path, cell: str, seed: int, capsys, seconds: float = 0.01):
    """One run of `cell` on the CPU; (exit code, result dict or None)."""
    from slambench import run
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "0"], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)
