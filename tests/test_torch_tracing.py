"""The port's `slam.*` spans (`tpuslam_torch.runtime.tracing.stage`) in the
paths the benchmark runs: a batched blocked pass (`slam.mapping_block`,
`slam.loc_block`, `slam.closure_gn`, `slam.gn.iteration`, `slam.assoc`,
`slam.per_frame`) and a fusion (`slam.fusion.dedup`, `slam.fusion.merge`,
`slam.fusion.gn`), each under `torch.profiler` with CPU activity.

Each span is counted against what ran (the block functions and the GN
step are wrapped with counters), lies inside its parent on one thread, and
leaves the outputs bit for bit as a run without the profiler gives them.
Without a profiler, `stage` enters no `record_function`.
"""
import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuslam_torch.backend import gauss_newton as gn
from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend import blocked
from tpuslam_torch.frontend.blocked import run_sequences_blocked_batched
from tpuslam_torch.ops.assoc_kernel import associate_kernel
from tpuslam_torch.parallel.batch import initial_states
from tpuslam_torch.parallel.fusion import fuse_sessions
from tpuslam_torch.runtime import tracing
from tpuslam_torch.runtime.config import SlamConfig
from tpuslam_torch.sim import SimConfig, simulate, trackdrive

SEEDS = (11, 21)
CAP = GraphCapacity(384, 256, 4096)     # the replay cell's capacity
BLOCK = 32
# each span's possible parents; the others are outermost
PARENTS = {"slam.assoc": ("slam.mapping_block", "slam.loc_block", "slam.per_frame"),
           "slam.gn.iteration": ("slam.closure_gn", "slam.fusion.gn", "slam.per_frame")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _fleet():
    """(obs, valid, poses) numpy stacks of two 1.4-lap trackdrive sessions,
    cut to the shorter."""
    runs = []
    for seed in SEEDS:
        scen = simulate(trackdrive(seed=seed), SimConfig(laps=1.4, keyframe_dt=0.1, speed=8.0,
                                                         max_range=20.0, seed=seed + 1))
        runs.append((scen.obs.astype(np.float32), scen.obs_valid,
                     scen.odom_poses.astype(np.float32)))
    t = min(len(r[0]) for r in runs)
    return tuple(np.stack([r[k][:t] for r in runs]) for k in range(3))


def _cfg(cap=CAP, **kw):
    """The replay cell's association: nearest, through the kernel's wrapper
    (its plain twin on CPU tensors)."""
    return SlamConfig(capacity=cap, association="nearest", use_pallas_association=True, **kw)


def _spans(prof, tmp_path):
    """The profile's `slam.*` spans as dicts (name, ts, end, tid), in time
    order."""
    path = tmp_path / f"trace-{len(list(tmp_path.iterdir()))}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((dict(name=e["name"], ts=e["ts"], end=e["ts"] + e["dur"], tid=e["tid"])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("slam.")), key=lambda e: e["ts"])


def _traced(fn, tmp_path):
    """(fn's result, its spans) with fn run under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof, tmp_path)


@contextlib.contextmanager
def _counting(module, names):
    """Counts of the calls to `module`'s functions `names` while inside."""
    counts = dict.fromkeys(names, 0)
    inner = {n: getattr(module, n) for n in names}

    def wrap(n):
        def counted(*a, **kw):
            counts[n] += 1
            return inner[n](*a, **kw)
        return counted

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(module, n, inner[n])


def _within(c, p):
    return c["tid"] == p["tid"] and p["ts"] <= c["ts"] and c["end"] <= p["end"]


def _count(spans, name, parents=None):
    return sum(1 for s in spans if s["name"] == name
               and (parents is None or any(_within(s, p) for p in spans
                                           if p["name"] in parents)))


def _assert_nested(spans):
    """Every span lies inside one of its possible parents; the outermost
    spans lie inside no other span and do not overlap."""
    outer = [s for s in spans if s["name"] not in PARENTS]
    for s in spans:
        if s["name"] in PARENTS:
            assert any(_within(s, p) for p in outer if p["name"] in PARENTS[s["name"]]), s
        else:
            assert not any(_within(s, p) for p in spans if p is not s), s
    for a, b in zip(outer, outer[1:]):
        assert a["end"] <= b["ts"], (a, b)


def _assert_equal(got, want):
    """Two (states or graphs, outputs) trees bit for bit."""
    flat_g, flat_w = [], []
    for tree, flat in ((got, flat_g), (want, flat_w)):
        stack = [tree]
        while stack:
            x = stack.pop()
            if dataclasses.is_dataclass(x):
                stack += [getattr(x, f.name) for f in dataclasses.fields(x)]
            elif isinstance(x, (tuple, list)):
                stack += list(x)
            elif isinstance(x, dict):
                stack += [x[k] for k in sorted(x)]
            elif torch.is_tensor(x):
                flat.append(x)
    assert len(flat_g) == len(flat_w) > 0
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _pass(cfg, stack, block=BLOCK):
    return run_sequences_blocked_batched(initial_states(cfg.capacity, stack[0].shape[0], "cpu"),
                                         *(torch.tensor(x) for x in stack), cfg, block=block)


@pytest.mark.parametrize("tol", [1e-4, 0.0], ids=["early_exit", "iteration_cap"])
def test_pass_spans_count_blocks_and_gn_iterations(tol, tmp_path):
    """One `slam.mapping_block` or `slam.loc_block` per block that ran, one
    `slam.closure_gn` with one `slam.gn.iteration` per GN step (fewer than
    the cap at the cell's tolerance, the cap without one), one `slam.assoc`
    per association call, no fallback; the outputs as without the
    profiler."""
    cfg = _cfg(gn_early_exit_tol=tol)
    stack = _fleet()
    with _counting(blocked, ("_mapping_block", "_loc_block")) as blocks, \
            _counting(gn, ("gn_step",)) as steps:
        out, spans = _traced(lambda: _pass(cfg, stack), tmp_path)
    assert blocks["_mapping_block"] > 0 and blocks["_loc_block"] > 0
    assert _count(spans, "slam.mapping_block") == blocks["_mapping_block"]
    assert _count(spans, "slam.loc_block") == blocks["_loc_block"]
    assert _count(spans, "slam.closure_gn") == 1
    assert _count(spans, "slam.gn.iteration") == steps["gn_step"]
    assert _count(spans, "slam.gn.iteration", ("slam.closure_gn",)) == steps["gn_step"]
    if tol:
        assert 0 < steps["gn_step"] < cfg.gn_iterations
    else:
        assert steps["gn_step"] == cfg.gn_iterations
    assert _count(spans, "slam.assoc") == blocks["_mapping_block"] + blocks["_loc_block"]
    assert _count(spans, "slam.per_frame") == 0
    assert {s["name"] for s in spans} == {"slam.mapping_block", "slam.loc_block",
                                          "slam.closure_gn", "slam.gn.iteration", "slam.assoc"}
    _assert_nested(spans)
    assert bool(out[0].loop_closure_complete.all())
    _assert_equal(out, _pass(cfg, stack))


@pytest.mark.parametrize("case", ["bootstrap", "edge_capacity"])
def test_fallen_back_sessions_get_one_per_frame_span(case, tmp_path):
    """One `slam.per_frame` per session the blocks left to the per-frame
    path: a session whose first frame's first slot is invalid (the
    bootstrap falls back, the other session runs in blocks), or an edge
    capacity below one block's rows (every session per frame)."""
    obs, valid, poses = (x[:, :64].copy() for x in _fleet())
    if case == "bootstrap":
        cfg, fell = _cfg(), 1
        valid[1, 0, 0] = False
    else:
        cfg, fell = _cfg(GraphCapacity(384, 256, 512)), 2
    with _counting(blocked, ("run_sequence",)) as per_frame:
        out, spans = _traced(lambda: _pass(cfg, (obs, valid, poses)), tmp_path)
    assert per_frame["run_sequence"] == fell
    assert _count(spans, "slam.per_frame") == fell
    if case == "bootstrap":
        assert _count(spans, "slam.mapping_block") == 64 // BLOCK
    assert _count(spans, "slam.assoc", ("slam.per_frame",)) > 0
    _assert_nested(spans)
    _assert_equal(out, _pass(cfg, (obs, valid, poses)))


def test_fusion_spans_one_per_stage(tmp_path):
    """`fuse_sessions` gives one `slam.fusion.dedup`, `slam.fusion.merge` and
    `slam.fusion.gn`, with one `slam.gn.iteration` per joint GN step inside
    the last; the fused map as without the profiler."""
    states, _ = _pass(_cfg(), _fleet())
    gcfg = gn.GNConfig(iterations=3)

    def fuse():
        return fuse_sessions(states.graph, cfg=gcfg, gate=1.2, align=False,
                             lm_info=states.lm_info_xy)

    with _counting(gn, ("gn_step",)) as steps:
        out, spans = _traced(fuse, tmp_path)
    for name in ("slam.fusion.dedup", "slam.fusion.merge", "slam.fusion.gn"):
        assert _count(spans, name) == 1, name
    assert steps["gn_step"] == gcfg.iterations
    assert _count(spans, "slam.gn.iteration", ("slam.fusion.gn",)) == gcfg.iterations
    assert [s["name"] for s in spans if s["name"] != "slam.gn.iteration"] == [
        "slam.fusion.dedup", "slam.fusion.merge", "slam.fusion.gn"]
    _assert_nested(spans)
    _assert_equal(out, fuse())


def test_stage_without_a_profiler_enters_no_record_function(monkeypatch):
    """With no profiler active, `stage` (and so every span of a pass) calls
    no `record_function`; under one, each span calls it once."""
    calls = []

    def stub(name):
        calls.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(tracing, "record_function", stub)
    obs = torch.zeros(1, 4, 2)
    lm = torch.ones(1, 8, 2)
    types = (torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 8, dtype=torch.int32))
    with tracing.stage("slam.test"):
        associate_kernel(obs, types[0], lm, types[1], 4.0)
    assert tracing.stage("slam.a") is tracing.stage("slam.b")
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.stage("slam.test"):
            associate_kernel(obs, types[0], lm, types[1], 4.0)
    assert calls == ["slam.test", "slam.assoc"]
