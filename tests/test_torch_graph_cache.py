"""`tpuslam_torch/runtime/cuda_graphs.py` on the CPU: the captures' LRU
cache and its counts, the key rule, the nest helpers with the grouped copy
into static inputs, a split graph's eager steps, and the constant cache.
What only a card can run (the captures and replays) is held to the eager
path in `tests/test_torch_cuda.py`."""
import dataclasses
import gc
import weakref

import pytest
import torch

from tpuslam_torch.runtime import cuda_graphs as cg


@dataclasses.dataclass(frozen=True)
class _Leaf:
    a: torch.Tensor
    b: torch.Tensor
    n: int


def _nest(seed: int):
    """A nest of a dataclass and tuples with float, int and bool tensors,
    a None and a non-tensor field."""
    g = torch.Generator().manual_seed(seed)
    return (_Leaf(torch.randn(3, 2, generator=g), torch.randint(0, 9, (4,), generator=g), 7),
            (torch.rand(5, generator=g) > 0.5, None), torch.randn(2, generator=g))


def test_cache_drops_the_least_recently_used_key_and_counts():
    cache, built = cg.GraphCache(2), []

    def build(name):
        return lambda: built.append(name) or name

    for k in ("a", "b", "a", "c", "b", "a"):
        assert cache.lookup(k, build(k)) == k
    # c evicted b (a was used last), b evicted a, a evicted c
    assert built == ["a", "b", "c", "b", "a"]
    assert list(cache) == ["b", "a"]
    assert (cache.captures, cache.replays) == (5, 6)
    cache.clear()
    assert len(cache) == 0 and (cache.captures, cache.replays) == (5, 6)


@pytest.mark.parametrize("change", ["deterministic", "shape", "dtype"])
def test_key_changes_with_what_a_capture_holds(change):
    leaves = [torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32)]
    before = cg.key("block", ("mapping", 8), leaves)
    assert cg.key("block", ("mapping", 8), [t.clone() for t in leaves]) == before
    assert cg.key("window", ("mapping", 8), leaves) != before
    was = torch.are_deterministic_algorithms_enabled()
    try:
        if change == "deterministic":
            torch.use_deterministic_algorithms(not was, warn_only=True)
        elif change == "shape":
            leaves[0] = torch.zeros(5, 3)
        else:
            leaves[1] = torch.zeros(4, dtype=torch.int64)
        assert cg.key("block", ("mapping", 8), leaves) != before
    finally:
        torch.use_deterministic_algorithms(was)


class _Recorder(cg.SplitGraph):
    """A split graph whose parts record their calls."""

    def __init__(self, ins, split: bool):
        self.calls = []
        super().__init__(ins, split)

    def head(self):
        self.calls.append("head")

    def middle(self):
        self.calls.append("middle")

    def tail(self):
        self.calls.append("tail")


def test_tensors_fresh_and_load_round_trip_a_nest():
    src, other = _nest(0), _nest(1)
    leaves = cg.tensors(src)
    assert len(leaves) == 4 and leaves[0] is src[0].a and leaves[3] is src[2]
    copy = cg.fresh(src)
    assert copy[0].n == 7 and copy[1][1] is None
    for a, b in zip(cg.tensors(copy), leaves):
        assert a is not b and torch.equal(a, b)
    graph = _Recorder(cg.tensors(copy), split=False)
    graph.load(cg.tensors(other))
    for a, b in zip(cg.tensors(copy), cg.tensors(other)):
        assert a is not b and a.dtype == b.dtype and torch.equal(a, b)
    kept = cg.tensors(copy)
    graph.load(kept)   # a leaf that is its own place is left alone
    assert all(a is b for a, b in zip(cg.tensors(copy), kept))


def test_split_graph_steps_eagerly_off_the_card():
    ins = [torch.zeros(2)]
    split, whole = _Recorder(ins, split=True), _Recorder(ins, split=False)
    assert not cg.capturable(ins[0]) and split.graphs == whole.graphs == []
    split.step()
    whole.step()
    assert split.calls == ["head", "middle", "tail"] and whole.calls == ["head", "tail"]


def test_dropped_captures_are_freed_without_the_cycle_collector():
    """The two users hold no reference cycle: a capture the cache drops is
    freed at once, not later by the cycle collector, which may run inside
    another capture, where freeing a graph is an error."""
    from test_torch_window_graph import CFG, EW, W, window_batch

    from tpuslam_torch.backend import gauss_newton as gn
    from tpuslam_torch.backend.graph import GraphCapacity
    from tpuslam_torch.frontend import blocked
    from tpuslam_torch.parallel.batch import initial_states
    from tpuslam_torch.runtime.config import SlamConfig
    g, end, end_obs, _ = window_batch("cpu", True, "end_and_end_obs")
    cfg = SlamConfig(capacity=GraphCapacity(64, 32, 512), association="nearest",
                     use_pallas_association=True)
    S, B, N = 2, 4, 8
    args = (initial_states(cfg.capacity, S, "cpu"), torch.zeros(S, B, N, 4),
            torch.zeros(S, B, N, dtype=torch.bool), torch.zeros(S, B, 3),
            torch.zeros(S, B, dtype=torch.bool), torch.zeros(S, B, dtype=torch.bool))
    cache = cg.GraphCache(2)
    cache.lookup("window", lambda: gn._WindowGraph(g, CFG, W, EW, True, end, end_obs))
    cache.lookup("block", lambda: blocked._BlockGraph("loc", args, cfg))
    assert cache["window"].split and cache["block"].split
    refs = [weakref.ref(x) for x in cache.values()]
    was = gc.isenabled()
    gc.disable()
    try:
        cache.clear()
        assert [r() for r in refs] == [None, None]
    finally:
        if was:
            gc.enable()


def test_const_is_one_tensor_per_values_dtype_and_device():
    a = cg.const((1.0, 2.0), torch.float32, torch.device("cpu"))
    assert a is cg.const((1.0, 2.0), torch.float32, torch.device("cpu"))
    assert a is not cg.const((1.0, 2.0), torch.float64, torch.device("cpu"))
    assert a is not cg.const((1.0, 3.0), torch.float32, torch.device("cpu"))
    eye = cg.const(((1.0, 0.0), (0.0, 1.0)), torch.float32, torch.device("cpu"))
    assert torch.equal(eye, torch.eye(2)) and torch.equal(a, torch.tensor([1.0, 2.0]))
