"""The readers of the program's `slam.*` spans (`slambench/spans.py` and the
metrics that read it) on canned profiles: the canned replay profile of
`test_slambench_metrics.py` with the spans a pass records added, and a
fusion profile; each reader's number, and its None where its span is
absent."""
import json

import pytest

from slambench import profiling, spans
from slambench.tests.conftest import REPO
from slambench.tests.test_slambench_metrics import INFO, _events

REPLAY = ("mapping_ms.replay", "localization_ms.replay", "closure_gn_ms.replay",
          "closure_gn_iters.replay", "fallback_sessions.replay", "assoc_host_us.replay",
          "block_idle_pct.replay")
FUSION = ("dedup_ms.fusion", "merge_ms.fusion", "joint_gn_ms.fusion", "joint_gn_iters.fusion")


def _span(name, ts, dur, tid=1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, tid=tid)


def _replay_spans(fallback=True):
    """In each step of 1,000 µs: a mapping block (10-110 µs) holding one
    association call (15-25 µs) over the 3 µs association kernel, the
    closure GN (120-820 µs) over the 600 µs factor kernel with three
    iterations, and a localization block (880-920 µs) over the 10 µs
    elementwise kernel; in the second step one session falls back to the
    per-frame path (940-990 µs), whose own GN iteration lies outside the
    closure GN."""
    ev = []
    for k in range(2):
        t = 1000.0 * k
        ev += [_span("slam.mapping_block", t + 10, 100.0), _span("slam.assoc", t + 15, 10.0),
               _span("slam.closure_gn", t + 120, 700.0),
               _span("slam.loc_block", t + 880, 40.0)]
        ev += [_span("slam.gn.iteration", t + at, 100.0) for at in (130, 300, 500)]
    if fallback:
        ev += [_span("slam.per_frame", 1940.0, 50.0), _span("slam.gn.iteration", 1950.0, 5.0)]
    return ev


def _fusion_spans():
    """In each step (one fused map): the dedup (10-60 µs), the merge
    (70-100 µs) and the joint GN (120-820 µs) with two iterations."""
    ev = []
    for k in range(2):
        t = 1000.0 * k
        ev += [_span("slam.fusion.dedup", t + 10, 50.0), _span("slam.fusion.merge", t + 70, 30.0),
               _span("slam.fusion.gn", t + 120, 700.0),
               _span("slam.gn.iteration", t + 130, 300.0),
               _span("slam.gn.iteration", t + 450, 300.0)]
    return ev


def _trace(tmp_path, extra):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events() + extra}))
    return profiling.load(str(p), 2)


def _read(name, t):
    from slambench import run
    return run._module(REPO / "slambench" / "metrics" / f"{name}.py", f"m_{name}").read(t, INFO)


def test_replay_span_readers(tmp_path):
    t = _trace(tmp_path, _replay_spans())
    assert _read("mapping_ms.replay", t) == pytest.approx(0.1)
    assert _read("localization_ms.replay", t) == pytest.approx(0.04)
    assert _read("closure_gn_ms.replay", t) == pytest.approx(0.7)
    assert _read("closure_gn_iters.replay", t) == pytest.approx(3.0)
    assert _read("fallback_sessions.replay", t) == pytest.approx(0.5)
    assert _read("assoc_host_us.replay", t) == pytest.approx(10.0)
    # 140 µs of blocks a step, of which the card ran 3 + 10 µs
    assert _read("block_idle_pct.replay", t) == pytest.approx(100.0 * 127.0 / 140.0)


def test_fusion_span_readers(tmp_path):
    t = _trace(tmp_path, _fusion_spans())
    assert _read("dedup_ms.fusion", t) == pytest.approx(0.05)
    assert _read("merge_ms.fusion", t) == pytest.approx(0.03)
    assert _read("joint_gn_ms.fusion", t) == pytest.approx(0.7)
    assert _read("joint_gn_iters.fusion", t) == pytest.approx(2.0)


@pytest.mark.parametrize("name", REPLAY + FUSION)
def test_a_reader_without_its_span_reads_none(name, tmp_path):
    """A program without the spans (or with them renamed) reports nothing."""
    t = _trace(tmp_path, [])
    assert _read(name, t) is None
    renamed = [dict(e, name=e["name"].replace("slam.", "old.")) for e in
               _replay_spans() + _fusion_spans()]
    assert _read(name, _trace(tmp_path, renamed)) is None


def test_no_fallback_reads_zero(tmp_path):
    t = _trace(tmp_path, _replay_spans(fallback=False))
    assert _read("fallback_sessions.replay", t) == 0.0


def test_nesting_is_per_thread_and_idle_inside_spans(tmp_path):
    t = _trace(tmp_path, _replay_spans() + [_span("slam.gn.iteration", 200.0, 10.0, tid=2)])
    gn = spans.named(t, "slam.closure_gn")
    iters = spans.named(t, "slam.gn.iteration")
    assert len(iters) == 8 and len(spans.inside(iters, gn)) == 6
    # the factor kernel runs 200-800 µs of each step's 120-820 µs closure GN
    assert spans.idle_us(t, gn) == pytest.approx(2 * 100.0)
    assert spans.union(spans.named(t, "slam.mapping_block")).tolist() == [[10.0, 110.0],
                                                                          [1010.0, 1110.0]]
    assert spans.idle_us(t, []) == 0.0
