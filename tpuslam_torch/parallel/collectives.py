"""The collectives of the mesh paths over one axis of a `DeviceMesh`:
`psum`, `pmin` and `all_gather` (the JAX package's `jax.lax` collectives
inside `shard_map`).

Each is one `torch.distributed` call on the axis's process group, out of
place. gloo reduces CUDA tensors (`all_reduce`, through host copies) but
gathers none, so on a gloo group a CUDA tensor is gathered as the sum of
zero-padded buffers: each rank writes its bits into its own slot of a
zero buffer (as integers, so the sum copies them exactly) and one
`all_reduce(SUM)` fills every slot.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["shard", "psum", "pmin", "all_gather"]

_INT_OF_SIZE = {8: torch.int64, 4: torch.int32}


def shard(mesh, dim: str) -> tuple[int, int]:
    """(this rank's index along `dim`, the axis size); a rank outside the
    mesh holds no shard and raises."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the mesh and holds no shard")
    return mesh.get_local_rank(dim), mesh.size(mesh.mesh_dim_names.index(dim))


def psum(xs, mesh, dim: str):
    """The sum over `dim` of a tensor, or of a list of tensors of one dtype
    (one reduction over their concatenation)."""
    one = torch.is_tensor(xs)
    xs = [xs] if one else list(xs)
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(dim))
    out = [part.reshape(x.shape) for part, x in zip(flat.split([x.numel() for x in xs]), xs)]
    return out[0] if one else out


def pmin(x, mesh, dim: str):
    """The elementwise minimum over `dim`."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=mesh.get_group(dim))
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
    group = mesh.get_group(dim)
    index, size = shard(mesh, dim)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return _gather_by_sum(x, group, index, size)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts) if x.dim() else torch.stack(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out
