"""The program's own stages in a traced run: the `slam.*` spans that
`tpuslam_torch.runtime.tracing.stage` records as `user_annotation` events on
the host thread, on the clock of the device events of the same trace.

`named` lists a trace's spans of one name, `inside` keeps the spans that lie
within a parent span on the same thread, and `idle_us` is the card's idle
time inside the union of some spans, from the trace's device events
(`Trace.device`). A reader returns None where its span is absent, so a
program without the span (or after a rename) reports nothing.
"""
from __future__ import annotations

import numpy as np

EPS_US = 1e-3       # the trace's timestamps are whole nanoseconds


def named(t, name: str) -> list:
    """The trace's spans called `name`, in time order."""
    return sorted((e for e in t.host if e.cat == "user_annotation" and e.name == name),
                  key=lambda e: e.ts)


def within(child, parent) -> bool:
    """Whether `child` lies inside `parent` on one host thread."""
    return (child.tid == parent.tid and child.ts >= parent.ts - EPS_US
            and child.end <= parent.end + EPS_US)


def inside(children: list, parents: list) -> list:
    """The `children` that lie inside one of `parents`."""
    return [c for c in children if any(within(c, p) for p in parents)]


def total_ms(spans: list) -> float:
    """The spans' summed host time (ms)."""
    return sum(e.dur for e in spans) * 1e-3


def union(spans: list) -> np.ndarray:
    """[K, 2] disjoint intervals (µs) covering the spans."""
    out = []
    for a, b in sorted((e.ts, e.end) for e in spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out, dtype=np.float64).reshape(-1, 2)


def idle_us(t, spans: list) -> float:
    """Time (µs) inside the union of `spans` in which the card ran no
    kernel, copy or memset of the trace."""
    iv = union(spans)
    busy = t.busy_intervals()
    if not len(iv):
        return 0.0
    lo = np.maximum(iv[:, None, 0], busy[None, :, 0])
    hi = np.minimum(iv[:, None, 1], busy[None, :, 1])
    covered = float(np.sum(np.clip(hi - lo, 0.0, None)))
    return float(np.sum(iv[:, 1] - iv[:, 0])) - covered
