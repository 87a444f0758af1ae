"""Tiled type-gated association: the hand-written CUDA kernel
(`csrc/assoc.cu`, the counterpart of `tpuslam.ops.pallas_assoc`) and its
plain PyTorch twin.

`associate_kernel` takes the twin only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises. `launches` counts the kernel
launches this process made.
"""
from __future__ import annotations

import ctypes

import torch

from tpuslam_torch import _build

__all__ = ["associate_kernel", "associate_plain", "launches"]

_BIG = 1e30
launches = 0


def _gated_cost(obs_xy, obs_type, lm_xy, lm_type, gate2, lm_cov_inv_packed, mahalanobis):
    """[N, M] cost with the gate applied (1e30 outside it), one PyTorch op
    per arithmetic step in the order of the kernel, so no FMA contraction
    can make the two disagree."""
    dx = obs_xy[:, 0:1] - lm_xy[None, :, 0]
    dy = obs_xy[:, 1:2] - lm_xy[None, :, 1]
    if mahalanobis:
        a = lm_cov_inv_packed[None, :, 0]
        b = lm_cov_inv_packed[None, :, 1]
        c = lm_cov_inv_packed[None, :, 2]
        cost = a * dx * dx + 2.0 * b * dx * dy + c * dy * dy
    else:
        cost = dx * dx + dy * dy
    ok = (obs_type[:, None] == lm_type[None, :]) & (cost < gate2)
    return torch.where(ok, cost, _BIG)


def associate_plain(obs_xy, obs_type, lm_xy, lm_type, gate2,
                    lm_cov_inv_packed=None, mahalanobis: bool = False):
    """Plain PyTorch version of `associate_kernel`: the [N, M] gated cost
    and a first-index argmin. Returns (idx [N] int32, matched [N] bool,
    cost [N] f32); unmatched observations get idx 0 and cost 1e30."""
    if mahalanobis and lm_cov_inv_packed is None:
        raise ValueError("mahalanobis needs lm_cov_inv_packed")
    n = obs_xy.shape[0]
    if lm_xy.shape[0] == 0:
        return (torch.zeros(n, dtype=torch.int32, device=obs_xy.device),
                torch.zeros(n, dtype=torch.bool, device=obs_xy.device),
                torch.full((n,), _BIG, dtype=torch.float32, device=obs_xy.device))
    gated = _gated_cost(obs_xy, obs_type, lm_xy, lm_type, gate2, lm_cov_inv_packed,
                        mahalanobis)
    idx = torch.argmin(gated, dim=1)
    cost = torch.gather(gated, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), cost < _BIG, cost


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def associate_kernel(obs_xy, obs_type, lm_xy, lm_type, gate2,
                     lm_cov_inv_packed=None, mahalanobis: bool = False):
    """Type-gated nearest association. Returns (idx [N] int32, matched [N]
    bool, cost [N] f32).

    obs_xy [N,2] f32; obs_type [N] i32 (invalid observations: -2);
    lm_xy [M,2] f32; lm_type [M] i32 (invalid landmarks: -1); gate2 is the
    squared gate (Euclidean) or the chi-square bound (Mahalanobis);
    lm_cov_inv_packed [M,3] = (a, b, c) of each inverse covariance.
    The lowest landmark index wins ties.
    """
    if mahalanobis and lm_cov_inv_packed is None:
        raise ValueError("mahalanobis needs lm_cov_inv_packed")
    if not obs_xy.is_cuda:
        return associate_plain(obs_xy, obs_type, lm_xy, lm_type, gate2,
                               lm_cov_inv_packed, mahalanobis)
    global launches
    n, m = obs_xy.shape[0], lm_xy.shape[0]
    _check(obs_xy, "obs_xy", torch.float32, (n, 2))
    _check(obs_type, "obs_type", torch.int32, (n,))
    _check(lm_xy, "lm_xy", torch.float32, (m, 2))
    _check(lm_type, "lm_type", torch.int32, (m,))
    cov = lm_xy
    if mahalanobis:
        _check(lm_cov_inv_packed, "lm_cov_inv_packed", torch.float32, (m, 3))
        cov = lm_cov_inv_packed
    dev = obs_xy.device
    for name, t in (("obs_type", obs_type), ("lm_xy", lm_xy), ("lm_type", lm_type),
                    ("lm_cov_inv_packed", cov)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, obs_xy on {dev}")
    for name, t in (("obs_xy", obs_xy), ("lm_xy", lm_xy)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (read as float2)")
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    cost = torch.empty(n, dtype=torch.float32, device=dev)
    p = ctypes.c_void_p
    lib = _build.load("assoc", {"tpuslam_assoc": (
        [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         p, p, p, p], ctypes.c_int)})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpuslam_assoc(obs_xy.data_ptr(), obs_type.data_ptr(), lm_xy.data_ptr(),
                                lm_type.data_ptr(), cov.data_ptr(), n, m, float(gate2),
                                int(mahalanobis), idx.data_ptr(), matched.data_ptr(),
                                cost.data_ptr(), stream)
    _build.check(lib, "assoc", err)
    launches += 1
    return idx, matched, cost
