"""The collectives of the mesh paths over one axis of a `DeviceMesh`:
`psum` (over the whole axis or within groups of it), `pmin`, `pmax`,
`all_gather` and `ppermute` (the JAX package's `jax.lax` collectives inside
`shard_map`).

Each is one `torch.distributed` call on the axis's process group, out of
place. gloo reduces CUDA tensors (`all_reduce`, through host copies) but
gathers none, so on a gloo group a CUDA tensor is gathered as the sum of
zero-padded buffers: each rank writes its bits into its own slot of a
zero buffer (as integers, so the sum copies them exactly) and one
`all_reduce(SUM)` fills every slot. `ppermute` (the ring halo shift of the
pose-chain solvers) is an `all_gather` from which each rank picks its
source's slot, so it is bit-exact on every backend.

Payload accounting: inside `counting()` every wrapper adds its payload to
the counter, per kind ('psum', 'pmin', 'pmax', 'all_gather', 'ppermute'): one
count per call and the bytes this rank puts in (the per-device input, the
JAX package's `parallel/instrument.py` convention). This is the one place
payloads are counted (`parallel.instrument.collective_payload_bytes`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["shard", "psum", "pmin", "pmax", "all_gather", "ppermute", "counting"]

_COUNTERS: list[dict] = []
_GROUPS: dict = {}

_INT_OF_SIZE = {8: torch.int64, 4: torch.int32}


def shard(mesh, dim: str) -> tuple[int, int]:
    """(this rank's index along `dim`, the axis size); a rank outside the
    mesh holds no shard and raises."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the mesh and holds no shard")
    return mesh.get_local_rank(dim), mesh.size(mesh.mesh_dim_names.index(dim))


@contextlib.contextmanager
def counting():
    """A dict filled, inside, with {kind: {"count", "bytes"}} of every
    collective this process calls (see the module docstring)."""
    rec: dict = {}
    _COUNTERS.append(rec)
    try:
        yield rec
    finally:
        _COUNTERS.remove(rec)


def _count(kind: str, xs):
    if not _COUNTERS:
        return
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    for rec in _COUNTERS:
        r = rec.setdefault(kind, {"count": 0, "bytes": 0})
        r["count"] += 1
        r["bytes"] += nbytes


def _axis_ranks(mesh, dim: str) -> list[int]:
    """The global ranks along `dim` through this rank, in axis order."""
    if mesh.ndim != 1:
        raise ValueError("groups of an axis are supported on a 1-D mesh")
    return [int(r) for r in mesh.mesh.reshape(-1).tolist()]


def _group_of(mesh, dim: str, groups):
    """This rank's process group among `groups` (lists of indices along
    `dim`, which partition the axis, as `axis_index_groups`); None for a
    group of one. Each group is made once per process, by its members
    (`use_local_synchronization`), and kept; a group of the whole axis is
    the axis's own."""
    ranks = _axis_ranks(mesh, dim)
    me, n = shard(mesh, dim)
    mine = [g for g in groups if me in g]
    if len(mine) != 1:
        raise ValueError(f"axis index {me} is in {len(mine)} of the groups {groups}")
    members = tuple(ranks[i] for i in mine[0])
    if len(members) == 1:
        return None
    if len(members) == n:
        return mesh.get_group(dim)
    if members not in _GROUPS:
        _GROUPS[members] = dist.new_group(list(members), use_local_synchronization=True)
    return _GROUPS[members]


def psum(xs, mesh, dim: str, groups=None):
    """The sum over `dim` of a tensor, or of a list of tensors of one dtype
    (one reduction over their concatenation). With `groups` (lists of axis
    indices that partition `dim`, JAX's `axis_index_groups`), the sum over
    this rank's group alone."""
    one = torch.is_tensor(xs)
    xs = [xs] if one else list(xs)
    _count("psum", xs)
    flat = torch.cat([x.reshape(-1) for x in xs])
    group = mesh.get_group(dim) if groups is None else _group_of(mesh, dim, groups)
    if group is not None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out = [part.reshape(x.shape) for part, x in zip(flat.split([x.numel() for x in xs]), xs)]
    return out[0] if one else out


def pmin(x, mesh, dim: str):
    """The elementwise minimum over `dim`."""
    _count("pmin", [x])
    return _reduce(x, dist.ReduceOp.MIN, mesh, dim)


def pmax(x, mesh, dim: str):
    """The elementwise maximum over `dim`."""
    _count("pmax", [x])
    return _reduce(x, dist.ReduceOp.MAX, mesh, dim)


def _reduce(x, op, mesh, dim: str):
    out = x.clone()
    dist.all_reduce(out, op=op, group=mesh.get_group(dim))
    return out


def _as_summable(x):
    """`x` as integers whose sum with zeros gives back its bits."""
    if x.dtype == torch.bool or x.element_size() == 1:
        return x.to(torch.int32)
    return x.contiguous().view(_INT_OF_SIZE[x.element_size()])


def _gather_by_sum(x, group, index: int, size: int):
    """`all_gather` as one `all_reduce(SUM)` of a zero buffer holding `x`
    in slot `index` of `size`."""
    bits = _as_summable(x)
    buf = bits.new_zeros((size, *bits.shape))
    buf[index] = bits
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf = buf.reshape(size * x.shape[0], *x.shape[1:]) if x.dim() else buf
    if x.dtype == torch.bool or x.element_size() == 1:
        return buf.to(x.dtype)
    return buf.view(x.dtype)


def all_gather(x, mesh, dim: str):
    """Every rank's `x` along `dim`, concatenated along axis 0 in axis order
    (stacked for a 0-dim `x`)."""
    _count("all_gather", [x])
    return _all_gather(x, mesh, dim)


def _all_gather(x, mesh, dim: str):
    group = mesh.get_group(dim)
    index, size = shard(mesh, dim)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return _gather_by_sum(x, group, index, size)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts) if x.dim() else torch.stack(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def ppermute(x, mesh, dim: str, perm):
    """JAX's `ppermute` along `dim`: `perm` lists (source, destination)
    axis indices; this rank gets its source's `x`, or zeros when no pair
    sends to it."""
    _count("ppermute", [x])
    me, _ = shard(mesh, dim)
    parts = _all_gather(x, mesh, dim)      # every rank of the axis joins
    src = [s for s, d in perm if d == me]
    if not src:
        return torch.zeros_like(x)
    k = x.shape[0] if x.dim() else 1
    return parts[src[0] * k:(src[0] + 1) * k] if x.dim() else parts[src[0]]
