"""Profiling hooks: torch.profiler traces + named host-side stage annotations
(counterpart of `tpuslam.runtime.tracing`, which uses jax.profiler).

Replaces the reference's printf-observability (SURVEY.md §5.1). Usage:

    with trace_session("/tmp/slam-trace"):
        with stage("keyframe"):
            perform_keyframe(...)

`trace_session` records host activity, and the card's kernels and copies
when a CUDA device is present, and writes one Chrome-trace JSON file into
`logdir` that Perfetto (ui.perfetto.dev) opens. `stage` also works
standalone as a lightweight host annotation when no trace session is
active. Nothing here depends on the device events arriving: the profiler
has been seen to drop kernel events after long profiles, so a trace may
hold fewer of them than ran.
"""
from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace_session", "stage", "annotate_fn"]


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


@contextmanager
def stage(name: str):
    """Named region visible in profiler timelines (record_function)."""
    with record_function(name):
        yield


def annotate_fn(name: str):
    """Decorator: annotate a function as a named profiler region."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped
    return deco
