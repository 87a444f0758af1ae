"""Profiling hooks: torch.profiler traces + named host-side stage annotations
(counterpart of `tpuslam.runtime.tracing`, which uses jax.profiler).

Replaces the reference's printf-observability (SURVEY.md §5.1). Usage:

    with trace_session("/tmp/slam-trace"):
        with stage("keyframe"):
            perform_keyframe(...)

`trace_session` records host activity, and the card's kernels and copies
when a CUDA device is present, and writes one Chrome-trace JSON file into
`logdir` that Perfetto (ui.perfetto.dev) opens. Nothing here depends on the
device events arriving: the profiler has been seen to drop kernel events
after long profiles, so a trace may hold fewer of them than ran.

The program's own stages are `stage` spans named `slam.*`: the blocked
pipeline's `slam.mapping_block`, `slam.loc_block`, `slam.block_graph` (a
block replayed as CUDA graphs, inside its block's span), `slam.closure_gn`
and `slam.per_frame` (`frontend/blocked.py`), `slam.assoc`
(`ops/assoc_kernel.py`), `slam.gn.iteration` (`backend/gauss_newton.py`),
and the fusion's `slam.fusion.dedup`, `slam.fusion.merge` and
`slam.fusion.gn` (`parallel/fusion.py`). Under a profiler each is a
`user_annotation` event on the host thread, on the clock of the device
events; without one a span costs one check of the profiler's flag.
"""
from __future__ import annotations

import contextlib
import os
import time
from contextlib import contextmanager

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace_session", "stage"]

_OFF = contextlib.nullcontext()


@contextmanager
def trace_session(logdir: str):
    """Capture a host (+ device, with a card) profile for the enclosed block
    into `logdir/trace-<pid>-<ns>.json`. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def stage(name: str):
    """Named region for profiler timelines: a `record_function` while a
    profiler records, else a shared no-op context (no span, no tensor, no
    device read or synchronization either way)."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name)
