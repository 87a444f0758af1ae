"""Tiled type-gated association: the hand-written CUDA kernel
(`csrc/assoc.cu`, the counterpart of `tpuslam.ops.pallas_assoc`) and its
plain PyTorch twin.

Both take one session's observations and landmarks ([N, 2] and [M, 2]) or
S independent sessions' at once, with a leading session axis on every
input and output ([S, N, 2], [S, M, 2], ...); the kernel covers all S in
one launch, as the JAX package's vmapped Pallas kernel does.

`associate_kernel` takes the twin only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises. `launches` counts the kernel
launches this process made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tpuslam_torch import _build
from tpuslam_torch.runtime.tracing import stage

__all__ = ["associate_kernel", "associate_plain", "launches"]

_BIG = 1e30
MAX_CLUSTER = 8       # the portable thread-block cluster size
CHUNK = 256           # landmarks a block stages per pass (csrc/assoc.cu kChunk)
launches = 0
_entry = None         # the C entry, resolved at the first launch


def _gated_cost(obs_xy, obs_type, lm_xy, lm_type, gate2, lm_cov_inv_packed, mahalanobis):
    """[..., N, M] cost with the gate applied (1e30 outside it), one
    PyTorch op per arithmetic step in the order of the kernel, so no FMA
    contraction can make the two disagree."""
    dx = obs_xy[..., :, 0:1] - lm_xy[..., None, :, 0]
    dy = obs_xy[..., :, 1:2] - lm_xy[..., None, :, 1]
    if mahalanobis:
        a = lm_cov_inv_packed[..., None, :, 0]
        b = lm_cov_inv_packed[..., None, :, 1]
        c = lm_cov_inv_packed[..., None, :, 2]
        cost = a * dx * dx + 2.0 * b * dx * dy + c * dy * dy
    else:
        cost = dx * dx + dy * dy
    ok = (obs_type[..., :, None] == lm_type[..., None, :]) & (cost < gate2)
    return torch.where(ok, cost, _BIG)


def associate_plain(obs_xy, obs_type, lm_xy, lm_type, gate2,
                    lm_cov_inv_packed=None, mahalanobis: bool = False,
                    obs_valid=None, lm_count=None):
    """Plain PyTorch version of `associate_kernel`: the [..., N, M] gated
    cost and a first-index argmin. Returns (idx int32, matched bool, cost
    f32), each [..., N]; unmatched observations get idx 0 and cost 1e30."""
    if mahalanobis and lm_cov_inv_packed is None:
        raise ValueError("mahalanobis needs lm_cov_inv_packed")
    shape, m = obs_xy.shape[:-1], lm_xy.shape[-2]
    if m == 0:
        return (torch.zeros(shape, dtype=torch.int32, device=obs_xy.device),
                torch.zeros(shape, dtype=torch.bool, device=obs_xy.device),
                torch.full(shape, _BIG, dtype=torch.float32, device=obs_xy.device))
    gated = _gated_cost(obs_xy, obs_type.to(torch.int32), lm_xy, lm_type, gate2,
                        lm_cov_inv_packed, mahalanobis)
    if obs_valid is not None:
        gated = torch.where(obs_valid[..., :, None], gated, _BIG)
    if lm_count is not None:
        lm_ok = torch.arange(m, device=lm_xy.device) < lm_count[..., None]
        gated = torch.where(lm_ok[..., None, :], gated, _BIG)
    idx = torch.argmin(gated, dim=-1)
    cost = torch.gather(gated, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), cost < _BIG, cost


@functools.lru_cache(maxsize=64)
def _plan(n: int, m: int, sms: int, sessions: int = 1) -> int:
    """Cluster size for N observations and M landmarks in each of
    `sessions` sessions on a card of `sms` SMs. A block walks chunks of
    CHUNK landmarks; a map of several chunks is split over a cluster of up
    to MAX_CLUSTER blocks, no wider than keeps the grid of S * (N / 32)
    clusters within one wave (a cluster barrier costs about as much as one
    chunk's walk, so one chunk is never split)."""
    tiles = sessions * -(-n // 32)
    return max(1, min(MAX_CLUSTER, -(-m // CHUNK), sms // tiles))


@functools.lru_cache(maxsize=None)
def _sms(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _load():
    global _entry
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib = _build.load("assoc", {"tpuslam_assoc": (
        [p, p, ll, ll, i, p, p, p, p, p, i, i, i, ctypes.c_float, i, i, p, p, p, p], i)})
    _entry = lib.tpuslam_assoc
    return lib


def _bad(name, t, dtype, shape, dev, contiguous=True):
    if (t.dtype != dtype or t.shape != shape or t.get_device() != dev
            or (contiguous and not t.is_contiguous())):
        raise ValueError(f"{name}: want {'contiguous ' if contiguous else ''}{dtype} "
                         f"{tuple(shape)} on cuda:{dev}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device} contiguous={t.is_contiguous()}")


def associate_kernel(obs_xy, obs_type, lm_xy, lm_type, gate2,
                     lm_cov_inv_packed=None, mahalanobis: bool = False,
                     obs_valid=None, lm_count=None):
    """Type-gated nearest association. Returns (idx int32, matched bool,
    cost f32), each [N], or [S, N] for S sessions.

    obs_xy [N,2] f32; obs_type [N] i32, or f32 of any stride (truncated
    toward zero, as `.to(torch.int32)` does); lm_xy [M,2] f32; lm_type [M]
    i32; gate2 is the squared gate (Euclidean) or the chi-square bound
    (Mahalanobis); lm_cov_inv_packed [M,3] = (a, b, c) of each inverse
    covariance. Optional masks: an observation whose `obs_valid` [N] bool is
    False, and a landmark at index >= `lm_count` (int32 scalar tensor), never
    match. The lowest landmark index wins ties. For S sessions every one of
    these has a leading axis S ([S,N,2], [S,N], [S,M,2], [S,M], [S,M,3],
    [S,N], and `lm_count` [S]), and one launch covers them all.
    """
    global launches
    with stage("slam.assoc"):
        if mahalanobis and lm_cov_inv_packed is None:
            raise ValueError("mahalanobis needs lm_cov_inv_packed")
        if not obs_xy.is_cuda:
            return associate_plain(obs_xy, obs_type, lm_xy, lm_type, gate2,
                                   lm_cov_inv_packed, mahalanobis, obs_valid, lm_count)
        lead = tuple(obs_xy.shape[:-2])
        if len(lead) > 1:
            raise ValueError(f"obs_xy: want [N, 2] or [S, N, 2], got {tuple(obs_xy.shape)}")
        s, n, m = (lead[0] if lead else 1), obs_xy.shape[-2], lm_xy.shape[-2]
        dev = obs_xy.get_device()
        _bad("obs_xy", obs_xy, torch.float32, (*lead, n, 2), dev)
        float_type = obs_type.dtype == torch.float32
        _bad("obs_type", obs_type, torch.float32 if float_type else torch.int32, (*lead, n), dev,
             contiguous=not float_type)
        _bad("lm_xy", lm_xy, torch.float32, (*lead, m, 2), dev)
        _bad("lm_type", lm_type, torch.int32, (*lead, m), dev)
        cov = 0
        if mahalanobis:
            _bad("lm_cov_inv_packed", lm_cov_inv_packed, torch.float32, (*lead, m, 3), dev)
            cov = lm_cov_inv_packed.data_ptr()
        valid = count = 0
        if obs_valid is not None:
            _bad("obs_valid", obs_valid, torch.bool, (*lead, n), dev)
            valid = obs_valid.data_ptr()
        if lm_count is not None:
            _bad("lm_count", lm_count, torch.int32, lead, dev)
            count = lm_count.data_ptr()
        if obs_xy.data_ptr() % 8 or lm_xy.data_ptr() % 8:
            raise ValueError("obs_xy and lm_xy must be 8-byte aligned (read as float2)")
        idx = torch.empty((*lead, n), dtype=torch.int32, device=obs_xy.device)
        cost = torch.empty((*lead, n), dtype=torch.float32, device=obs_xy.device)
        matched = torch.empty((*lead, n), dtype=torch.bool, device=obs_xy.device)
        if n == 0 or s == 0:
            return idx, matched, cost
        if _entry is None:
            _load()
        csize = _plan(n, m, _sms(dev), s)
        sstride = obs_type.stride(0) if lead else 0
        err = _entry(obs_xy.data_ptr(), obs_type.data_ptr(), obs_type.stride(-1), sstride,
                     int(float_type), valid, lm_xy.data_ptr(), lm_type.data_ptr(), cov, count,
                     s, n, m, gate2, int(mahalanobis), csize, idx.data_ptr(), cost.data_ptr(),
                     matched.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            _build.check(_build.load("assoc", {}), "assoc", err)
        launches += 1
        return idx, matched, cost
