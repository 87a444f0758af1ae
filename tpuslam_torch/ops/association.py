"""Batched observation-to-landmark data association on the dense (N x M)
cost matrix (counterpart of `tpuslam.ops.association`).

Policies: 'first' (first landmark in index order within the gate — the
reference's semantics), 'nearest' and 'mahalanobis'. The tiled kernel for
'nearest'/'mahalanobis' lives in `tpuslam_torch.ops.assoc_kernel`.
"""
from __future__ import annotations

import torch

__all__ = ["cost_matrix", "associate"]

_BIG = 1e30


def cost_matrix(obs_xy, lm_xy, lm_cov_inv=None):
    """Pairwise squared distances [..., N, M]; Mahalanobis if `lm_cov_inv`
    [..., M, 2, 2] is given."""
    d = obs_xy[..., :, None, :] - lm_xy[..., None, :, :]
    if lm_cov_inv is None:
        return torch.sum(d * d, dim=-1)
    sd = torch.einsum("...nmk,...mkl->...nml", d, lm_cov_inv)
    return torch.sum(sd * d, dim=-1)


def associate(obs_xy, obs_type, obs_valid, lm_xy, lm_type, lm_valid,
              gate, mode="first", lm_cov_inv=None, type_signed_bug=False):
    """Associate each observation with at most one landmark, batched over
    leading axes.

    `gate` is the Euclidean radius (squared inside, in its own precision:
    an `np.float32` gate squares in float32) or the chi-square bound for
    'mahalanobis'; `type_signed_bug` reproduces the reference localizer's
    signed type compare. Returns (match_idx [..., N] int32, matched [...,
    N] bool, cost [..., N] f32; 1e30 where unmatched).
    """
    if mode == "mahalanobis":
        if lm_cov_inv is None:
            raise ValueError("mahalanobis mode needs lm_cov_inv")
        c = cost_matrix(obs_xy, lm_xy, lm_cov_inv)
        gate2 = gate
    else:
        c = cost_matrix(obs_xy, lm_xy)
        gate2 = gate * gate

    if type_signed_bug:
        type_ok = (lm_type[..., None, :] - obs_type[..., :, None]) < 1e-4
    else:
        type_ok = lm_type[..., None, :] == obs_type[..., :, None]
    ok = type_ok & lm_valid[..., None, :] & obs_valid[..., :, None] & (c < gate2)

    if mode == "first":
        idx = torch.argmax(ok.to(torch.uint8), dim=-1)
    else:
        idx = torch.argmin(torch.where(ok, c, _BIG), dim=-1)
    matched = torch.any(ok, dim=-1)
    chosen = torch.gather(c, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), matched, torch.where(matched, chosen, _BIG)
