"""Map-block model parallelism: association against a landmark map
sharded over a mesh axis (counterpart of `tpuslam.parallel.map_blocks`).

Each rank gates the observations against its block of M / n landmarks,
taken by its coordinate on the axis, and one minimum reduction picks the
global winner. The reduction carries a 64-bit key per observation, so one
`pmin` keeps the order the JAX package's two `pmin`s keep:

- 'first': (global landmark index, cost) — the first hit in index order,
  and its cost;
- 'nearest' / 'mahalanobis': (cost, global index) — the least cost, ties
  to the smallest global index, as `argmin` breaks them on the whole map.

The cost enters the key as an order-preserving integer of its float32
bits, so the reduction is exact: match indices, matched masks and costs
equal the single-device association on the gathered map (up to the
cost's own rounding in a smaller block).
"""
from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.ops.association import associate
from tpuslam_torch.parallel.collectives import pmin, shard

__all__ = ["associate_sharded", "sharded_winner"]

_BIG = 1e30
_NO_MATCH = 2 ** 63 - 1


def _cost_order(cost):
    """float32 [..] -> int64 in [0, 2^32), ordered as the floats are
    (-0.0 is +0.0)."""
    bits = (cost + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + 2 ** 31


def _cost_from_order(key):
    bits = key - 2 ** 31
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.to(torch.int32).view(torch.float32)


def associate_sharded(obs_xy, obs_type, obs_valid, lm_xy, lm_type, lm_valid, gate, mesh,
                      axis: str = "edges", mode: str = "first", lm_cov_inv=None,
                      type_signed_bug: bool = False):
    """`ops.association.associate` with the map sharded over `mesh[axis]`,
    batched over leading axes. Every rank passes the whole map (lm_xy [..,
    M, 2], lm_type, lm_valid, lm_cov_inv [.., M, 2, 2]); M must divide by
    the axis size (pad with invalid slots). `gate` is the Euclidean radius
    (squared in float32, as the JAX package's float32 gate) or the
    chi-square bound for 'mahalanobis'. Returns (match_idx int32 into the
    global map, matched, cost; 1e30 where unmatched) on every rank."""
    if mode not in ("first", "nearest", "mahalanobis"):
        raise ValueError(f"unknown association mode {mode!r}")
    if mode == "mahalanobis" and lm_cov_inv is None:
        raise ValueError("mahalanobis mode needs lm_cov_inv")
    i, n = shard(mesh, axis)
    m = lm_xy.shape[-2]
    if m % n:
        raise ValueError(f"{m} landmarks do not divide over {n} '{axis}' shards")
    k = m // n
    mine = slice(i * k, (i + 1) * k)
    idx, matched, cost = associate(
        obs_xy, obs_type, obs_valid, lm_xy[..., mine, :], lm_type[..., mine],
        lm_valid[..., mine], np.float32(gate), mode=mode,
        lm_cov_inv=None if lm_cov_inv is None else lm_cov_inv[..., mine, :, :],
        type_signed_bug=type_signed_bug)
    return sharded_winner(idx.long() + i * k, cost, matched, mode == "first", mesh, axis)


def sharded_winner(gidx, cost, matched, first: bool, mesh, axis: str):
    """Each row's winner over `mesh[axis]` from every rank's local one
    (global index `gidx`, float32 `cost`, `matched`), in one `pmin` of
    64-bit keys: with `first`, the smallest global index and its cost; else
    the least cost, ties to the smallest global index. Returns (index int32,
    0 where unmatched; matched; cost, 1e30 where unmatched) on every rank."""
    order = _cost_order(cost)
    key = (gidx << 32) | order if first else (order << 31) | gidx
    key = pmin(torch.where(matched, key, _NO_MATCH), mesh, axis)
    matched = key != _NO_MATCH
    if first:
        sel, cost = key >> 32, _cost_from_order(key & 0xFFFFFFFF)
    else:
        sel, cost = key & 0x7FFFFFFF, _cost_from_order(key >> 31)
    return (torch.where(matched, sel, 0).to(torch.int32), matched,
            torch.where(matched, cost, _BIG))
