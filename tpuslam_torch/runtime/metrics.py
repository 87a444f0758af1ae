"""Metrics registry + structured event log: a copy of
`tpuslam.runtime.metrics` (pure Python).

The reference's observability is raw std::cout prints in the hot path plus
g2o's verbose chi2 dump (SURVEY.md §5.1/§5.5). Here: named counters, gauges,
and timers with JSON/CSV export, and an event log for structured tracing
(keyframes, closures, optimizations).
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, TextIO


@dataclass
class TimerStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class MetricsRegistry:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    gauges: dict = field(default_factory=dict)
    timers: dict = field(default_factory=lambda: defaultdict(TimerStat))
    events: list = field(default_factory=list)
    max_events: int = 100_000

    def inc(self, name: str, by: int = 1):
        self.counters[name] += by

    def set(self, name: str, value):
        self.gauges[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name].add(time.perf_counter() - t0)

    def event(self, kind: str, **payload):
        if len(self.events) < self.max_events:
            self.events.append({"t_us": time.time_ns() // 1000,
                                "kind": kind, **payload})

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "timers": {k: {"count": v.count, "mean_s": v.mean_s,
                           "max_s": v.max_s, "total_s": v.total_s}
                       for k, v in self.timers.items()},
        }

    def dump_json(self, out: TextIO):
        json.dump(self.snapshot(), out, indent=2, default=str)
        out.write("\n")

    def dump_events_jsonl(self, out: TextIO):
        for e in self.events:
            out.write(json.dumps(e, default=str) + "\n")

    def dump_csv(self, out: TextIO):
        out.write("metric;kind;value\n")
        for k, v in sorted(self.counters.items()):
            out.write(f"{k};counter;{v}\n")
        for k, v in sorted(self.gauges.items()):
            out.write(f"{k};gauge;{v}\n")
        for k, v in sorted(self.timers.items()):
            out.write(f"{k};timer_mean_s;{v.mean_s}\n")
