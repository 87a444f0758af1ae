"""The reader of the window GN's CUDA-graph replays
(`window_graph_pct.improved`) on the canned profile of
`test_slambench_spans.py` with two `slam.window_gn` rounds a step added,
with and without `slam.window_graph` spans inside them."""
import pytest

from slambench.tests.test_slambench_spans import _read, _span, _trace

NAME = "window_graph_pct.improved"
ROUNDS = (100, 300)     # each round's start in its step of 1,000 µs; 100 µs long


def _rounds():
    """Two `slam.window_gn` rounds a step, each with three iterations."""
    return [s for k in range(2) for at in ROUNDS
            for s in [_span("slam.window_gn", 1000.0 * k + at, 100.0)]
            + [_span("slam.gn.iteration", 1000.0 * k + at + 10 + 30 * i, 25.0) for i in range(3)]]


def _graph_spans(rounds):
    """One `slam.window_graph` span inside each of the given (step, round)."""
    return [_span("slam.window_graph", 1000.0 * k + ROUNDS[r] + 5, 90.0) for k, r in rounds]


@pytest.mark.parametrize("rounds,want", [([(0, 0), (0, 1), (1, 0), (1, 1)], 100.0),
                                         ([(0, 0), (0, 1), (1, 1)], 75.0),
                                         ([(1, 0)], 25.0)],
                         ids=["every_round", "three_of_four", "one_of_four"])
def test_window_graph_share(tmp_path, rounds, want):
    assert _read(NAME, _trace(tmp_path, _rounds() + _graph_spans(rounds))) == want


@pytest.mark.parametrize("extra", [[], [_span("slam.window_graph", 600.0, 5.0),
                                        _span("slam.window_graph", 105.0, 90.0, tid=2)]],
                         ids=["eager_rounds", "spans_outside_the_rounds"])
def test_rounds_without_graph_spans_read_none(tmp_path, extra):
    """Rounds that ran eagerly, or graph spans outside every round (or on
    another thread), read None, as do no rounds at all."""
    assert _read(NAME, _trace(tmp_path, _rounds() + extra)) is None
    assert _read(NAME, _trace(tmp_path, _graph_spans([(0, 0), (1, 1)]))) is None
