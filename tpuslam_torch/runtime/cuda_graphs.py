"""CUDA graphs of the port's fixed-shape bodies (a block of the blocked
pipeline, an iteration of the batched window GN): each user captures its
body once per `key` as a `SplitGraph`, keeps it in a `GraphCache`, and on
each call copies the call's tensors in and replays it, the eager kernels in
the eager order. A capture cannot copy from host memory, so code that runs
inside one takes its small constants from `const`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["SplitGraph", "GraphCache", "key", "capturable", "tensors", "fresh", "const"]


def tensors(x) -> list:
    """The tensors of a nest of dataclasses and tuples, in order."""
    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [t for v in x for t in tensors(v)] if isinstance(x, (tuple, list)) else []


def fresh(x):
    """`x`, a nest of dataclasses and tuples, with each tensor copied."""
    if torch.is_tensor(x):
        return x.clone(memory_format=torch.contiguous_format)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: fresh(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return tuple(fresh(v) for v in x) if isinstance(x, tuple) else x


@functools.lru_cache(maxsize=64)
def const(values: tuple, dtype, device):
    """A small constant tensor of (nested) `values`, made once per dtype
    and device. Never written to."""
    return torch.tensor(values, dtype=dtype, device=device)


def capturable(t) -> bool:
    """Whether work on `t` may be replayed as CUDA graphs: `t` is on CUDA
    and no capture is under way."""
    return t.is_cuda and not torch.cuda.is_current_stream_capturing()


def key(tag: str, static: tuple, leaves) -> tuple:
    """A capture's key: all that its body branches on or is sized by."""
    return (tag, static, leaves[0].device, torch.are_deterministic_algorithms_enabled(),
            tuple((t.shape, t.dtype) for t in leaves))


class SplitGraph:
    """A body over static inputs `ins`, in the methods `head`, `middle` and
    `tail` that a subclass defines (they read and write only `ins` and the
    object's fields): with `split`, two CUDA graphs with `middle` launched
    eagerly between them, else one graph of `head` then `tail`. Captured
    after an eager warm-up of `head` and `tail` on a stream of their own
    (which makes the constants a capture reads), both graphs in one memory
    pool, where their results stay until the next replay. Off CUDA, `step`
    runs the methods eagerly. The parts are methods, not callables the
    object holds: a reference cycle through them would leave a dropped
    capture to the cycle collector, which may run during another capture,
    where freeing a graph is an error."""

    def __init__(self, ins: list, split: bool):
        self.ins, self.split, self.graphs = ins, split, []
        dev = ins[0].device
        if dev.type != "cuda":
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.head()
            self.tail()
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for part in ((self.head,), (self.tail,)) if split else ((self.head, self.tail),):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side):
                for fn in part:
                    fn()
            self.graphs.append(graph)

    def load(self, leaves) -> None:
        """`leaves` into their places in `ins`, one `_foreach_copy_` per
        dtype; a leaf that is its place is skipped."""
        groups = {}
        for d, s in zip(self.ins, leaves):
            if s is not d:
                ds, ss = groups.setdefault(d.dtype, ([], []))
                ds.append(d)
                ss.append(s)
        for ds, ss in groups.values():
            torch._foreach_copy_(ds, ss)

    def step(self) -> None:
        """The head, the middle (with `split`) and the tail once, on what
        `ins` holds."""
        first, *rest = [g.replay for g in self.graphs] or [self.head, self.tail]
        first()
        if self.split:
            self.middle()
        for fn in rest:
            fn()


class GraphCache(dict):
    """Captures by key, at most `bound` of them, the least recently used
    dropped (each holds a memory pool): `captures` counts the captures this
    process made, `replays` the lookups."""

    def __init__(self, bound: int):
        super().__init__()
        self.bound, self.captures, self.replays = bound, 0, 0

    def lookup(self, k, build):
        """The capture at `k`, made by `build()` at its first lookup."""
        entry = self.pop(k, None)
        if entry is None:
            while len(self) >= self.bound:
                del self[next(iter(self))]
            entry = build()
            self.captures += 1
        self[k] = entry
        self.replays += 1
        return entry
