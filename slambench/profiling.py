"""The traced run: a `torch.profiler` window over a few steady steps, read
from its Chrome trace into the numbers the per-layer readers take.

`profile(step, n)` runs `step` n times under the profiler (host ops with
their input shapes, CUDA activity), each inside a `slambench.step` span,
and returns a `Trace`. The profiler has dropped kernel events in long
profiles, so `Trace.missing_launches()` counts launch calls whose kernel
never reached the trace, and a reader raises `ShortTrace` when a count it
knows from the shapes is not met; `run.py` profiles again and fails the run
after its last try.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

STEP = "slambench.step"
CHOLESKY_OP = "aten::linalg_cholesky_ex"
CHOLESKY_KERNEL = "persistent_cholesky"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class ShortTrace(RuntimeError):
    """A count the shapes fix is not met by the trace: events were dropped."""


@dataclass
class Event:
    cat: str
    name: str
    ts: float          # microseconds
    dur: float
    tid: object
    args: dict

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Trace:
    """The events of one profiled window, grouped by kind."""

    def __init__(self, events: list[Event], steps: int, window_us: float | None = None):
        """`steps` steps, each in a `slambench.step` span; a trace of the
        device alone has no spans, and its window is the `window_us` that
        the host clock measured from the first device event on."""
        self.steps = steps
        self.kernels = [e for e in events if e.cat == "kernel"]
        self.device = [e for e in events if e.cat in DEVICE_CATS]
        self.host = [e for e in events if e.cat in HOST_CATS]
        self.runtime = [e for e in events if e.cat in ("cuda_runtime", "cuda_driver")]
        self.ops = [e for e in events if e.cat == "cpu_op"]
        if window_us is not None:
            self.t0 = min((e.ts for e in self.device), default=0.0)
            self.t1 = self.t0 + window_us
            return
        spans = [e for e in events if e.cat == "user_annotation" and e.name == STEP]
        if len(spans) != steps:
            raise RuntimeError(f"trace holds {len(spans)} '{STEP}' spans, not {steps}")
        self.t0 = min(e.ts for e in spans)
        self.t1 = max(e.end for e in spans)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> np.ndarray:
        """[K, 2] disjoint intervals (µs) in which the device ran a kernel,
        copy or memset, within the window."""
        iv = sorted((max(e.ts, self.t0), min(e.end, self.t1)) for e in self.device
                    if e.end > self.t0 and e.ts < self.t1)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.array(out, dtype=np.float64).reshape(-1, 2)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float(np.sum(iv[:, 1] - iv[:, 0])) * 1e-6

    def missing_launches(self) -> int:
        """Launch calls in the window whose kernel the trace lacks."""
        have = {e.args.get("correlation") for e in self.kernels}
        calls = [e for e in self.runtime
                 if ("LaunchKernel" in e.name or "LaunchCooperativeKernel" in e.name)
                 and self.t0 <= e.ts <= self.t1]
        return sum(1 for e in calls if e.args.get("correlation") not in have)

    def kernels_named(self, part: str) -> list[Event]:
        return [e for e in self.kernels if part in e.name]

    def kernels_under(self, op_name: str):
        """[(op event, [its kernels])] for each host op named `op_name`: the
        kernels whose launch call ran inside the op on its thread."""
        by_corr = {}
        for k in self.kernels:
            by_corr.setdefault(k.args.get("correlation"), []).append(k)
        out = []
        for op in (o for o in self.ops if o.name == op_name):
            ks = []
            for c in self.runtime:
                if c.tid == op.tid and op.ts <= c.ts <= op.end:
                    ks += by_corr.get(c.args.get("correlation"), [])
            out.append((op, ks))
        return out

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time."""
        tot = {}
        for e in self.device:
            tot[e.name] = tot.get(e.name, 0.0) + e.dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, named: int = 500):
        """[[host op, seconds]]: the device's idle time in the window, summed
        by the innermost host op under way at the middle of each gap, for
        the `named` longest gaps; the rest as 'shorter gaps'."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.t0], iv.reshape(-1), [self.t1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        if not len(gaps):
            return []
        order = np.argsort(gaps[:, 0] - gaps[:, 1])
        hs = np.array([e.ts for e in self.host])
        he = np.array([e.end for e in self.host])
        hd = he - hs
        tot = {}
        for g in gaps[order[:named]]:
            mid = 0.5 * (g[0] + g[1])
            under = np.flatnonzero((hs <= mid) & (he >= mid))
            name = self.host[under[np.argmin(hd[under])]].name if len(under) else "host: no op"
            tot[name] = tot.get(name, 0.0) + (g[1] - g[0]) * 1e-6
        rest = gaps[order[named:]]
        if len(rest):
            tot["shorter gaps"] = float(np.sum(rest[:, 1] - rest[:, 0])) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def recorded_kernels():
    """While tracing, record the shape of every call into the program's two
    hand-written kernels: the association's [S, N, M] (and whether it gates
    by Mahalanobis) at `frontend.keyframe.associate_kernel`, and the
    Cholesky's (S, n) at `ops.cholesky.cholesky_kernel`; with the
    association's launch counter over the same time. Yields the dict the
    readers get, filled in on exit."""
    from tpuslam_torch.frontend import keyframe
    from tpuslam_torch.ops import assoc_kernel, cholesky
    assoc_inner, chol_inner = keyframe.associate_kernel, cholesky.cholesky_kernel
    info = {"assoc_shapes": [], "cholesky_shapes": []}

    def assoc(obs_xy, obs_type, lm_xy, lm_type, gate2, *a, **kw):
        lead = obs_xy.shape[:-2]
        info["assoc_shapes"].append((lead[0] if lead else 1, obs_xy.shape[-2],
                                     lm_xy.shape[-2], bool(kw.get("mahalanobis", False))))
        return assoc_inner(obs_xy, obs_type, lm_xy, lm_type, gate2, *a, **kw)

    def chol(a):
        if a.is_cuda:
            info["cholesky_shapes"].append((int(np.prod(a.shape[:-2])), a.shape[-1]))
        return chol_inner(a)

    keyframe.associate_kernel, cholesky.cholesky_kernel = assoc, chol
    start = assoc_kernel.launches
    try:
        yield info
    finally:
        keyframe.associate_kernel, cholesky.cholesky_kernel = assoc_inner, chol_inner
        info["assoc_launches"] = assoc_kernel.launches - start


def load(path: str, steps: int, window_us: float | None = None) -> Trace:
    with open(path) as f:
        raw = json.load(f)
    evs = [Event(e.get("cat", ""), e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                 e.get("tid"), e.get("args", {}))
           for e in raw.get("traceEvents", []) if e.get("ph") == "X" and "ts" in e]
    return Trace(evs, steps, window_us)


def profile(step, steps: int, host: bool = True) -> Trace:
    """`step()` run `steps` times under torch.profiler; the trace goes
    through a file under TMPDIR. With `host`, host ops (with their input
    shapes) are recorded too and each step is a `slambench.step` span; the
    host's recording slows the steps, so the device's busy and idle time
    are read from a profile without it (`host=False`), whose window is the
    host clock's from a synchronized start to a synchronized end."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with tprofile(activities=acts, record_shapes=host) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            if host:
                with record_function(STEP):
                    step()
            else:
                step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load(path, steps, None if host else window_us)
    finally:
        os.unlink(path)


def cholesky_share(t: Trace, run: dict):
    """Percent of the least time (`roofline.cholesky_bound`) that the
    factorizations of the window took: each `torch.linalg.cholesky_ex` at
    the [S, n, n] or [n, n] its host op was given, over the device time of
    the kernels it launched, and each launch of the program's Cholesky
    kernel at the shape its wrapper recorded (`run["cholesky_shapes"]`).
    None when nothing was factored. Raises `ShortTrace` for a
    factorization whose kernels the trace lacks."""
    from slambench.roofline import cholesky_bound
    need = took = 0.0
    for op, ks in t.kernels_under(CHOLESKY_OP):
        if not ks:
            raise ShortTrace(f"a {CHOLESKY_OP} call has no kernel in the trace")
        dims = op.args["Input Dims"][0]
        s = int(np.prod(dims[:-2])) if len(dims) > 2 else 1
        need += cholesky_bound(s, int(dims[-1]))
        took += sum(k.dur for k in ks) * 1e-6
    shapes = run.get("cholesky_shapes", [])
    ks = t.kernels_named(CHOLESKY_KERNEL)
    if len(ks) != len(shapes):
        raise ShortTrace(f"{len(ks)} {CHOLESKY_KERNEL} kernels in the trace, "
                         f"{len(shapes)} launches recorded")
    for (s, n), k in zip(shapes, ks):
        need += cholesky_bound(s, n)
        took += k.dur * 1e-6
    return 100.0 * need / took if took > 0 else None
