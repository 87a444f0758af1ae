"""The reader of the blocks' CUDA-graph replays (`block_graph_pct.replay`)
on the canned replay profile of `test_slambench_spans.py`: one mapping and
one localization block a step, with and without `slam.block_graph` spans."""
import pytest

from slambench.tests.test_slambench_spans import _read, _replay_spans, _span, _trace

NAME = "block_graph_pct.replay"


def _graph_spans(steps=(0, 1)):
    """One `slam.block_graph` span inside each block of the given steps."""
    return [_span("slam.block_graph", 1000.0 * k + at, 5.0) for k in steps for at in (30, 890)]


@pytest.mark.parametrize("steps,want", [((0, 1), 100.0), ((0,), 50.0)],
                         ids=["every_block", "half_the_blocks"])
def test_block_graph_share(tmp_path, steps, want):
    assert _read(NAME, _trace(tmp_path, _replay_spans() + _graph_spans(steps))) == want


@pytest.mark.parametrize("extra", [[], [_span("slam.block_graph", 500.0, 5.0),
                                        _span("slam.block_graph", 30.0, 5.0, tid=2)]],
                         ids=["eager_blocks", "spans_outside_the_blocks"])
def test_blocks_without_graph_spans_read_none(tmp_path, extra):
    """Blocks that ran eagerly, or graph spans outside every block (or on
    another thread), read None, as do no blocks at all."""
    assert _read(NAME, _trace(tmp_path, _replay_spans() + extra)) is None
    assert _read(NAME, _trace(tmp_path, _graph_spans())) is None
