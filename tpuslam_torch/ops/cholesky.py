"""Cholesky of the Schur-reduced pose system: the hand-written CUDA kernel
(`csrc/cholesky.cu`, the counterpart of `tpuslam.ops.cholesky`'s Pallas
kernel: one cooperative launch of persistent blocks over 32x32 tiles), its
plain PyTorch twin, and the dispatcher `cholesky`.

Each takes one matrix [n, n] or a batch [..., n, n]; the kernel factors a
whole batch in one launch (the batched sessions' closure GN solves every
session's system at once, as the JAX package's vmapped kernel does).

`cholesky_kernel` takes the twin only for a matrix that lies on the CPU; for
a CUDA matrix it launches the kernel or raises. `launches` counts the kernel
launches in this process, one per call whatever the batch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from tpuslam_torch import _build

__all__ = ["cholesky", "cholesky_kernel", "cholesky_plain", "launches", "MAX_KERNEL_N"]

PANEL = 64            # panel width of the plain twin
TILE = 32             # tile edge of the kernel
MAX_KERNEL_N = 1536   # the JAX dispatcher's kernel bound (MAX_VMEM_N)
launches = 0
_entry = None         # the C entry, resolved at the first launch


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Right-looking blocked Cholesky in PyTorch ops, with 64-wide panels
    and the kernel's clamped pivots rsqrt(max(pivot, 1e-30)) — unlike
    `torch.linalg.cholesky`, a non-positive pivot does not raise. Returns the
    lower factor with the strict upper triangle zeroed, batched over leading
    axes."""
    n = a.shape[-1]
    w = a.clone()
    for k0 in range(0, n, PANEL):
        k1 = min(k0 + PANEL, n)
        for j in range(k0, k1):
            inv = torch.rsqrt(torch.clamp(w[..., j, j], min=1e-30))
            w[..., j:, j] *= inv[..., None]
            w[..., j + 1:, j + 1:k1] -= w[..., j + 1:, j:j + 1] * w[..., None, j + 1:k1, j]
        if k1 < n:
            p = w[..., k1:, k0:k1]
            w[..., k1:, k1:] -= p @ p.mT
    return torch.tril(w)


def _load():
    global _entry
    p = ctypes.c_void_p
    i = ctypes.c_int
    _entry = _build.load("cholesky", {"tpuslam_cholesky": ([p, p, p, i, i, p], i)}
                         ).tpuslam_cholesky


def cholesky_kernel(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD f32 matrix [n, n], or of each of a
    batch [..., n, n], by the tiled CUDA kernel in one launch (the plain
    twin for a CPU tensor)."""
    if not a.is_cuda:
        return cholesky_plain(a)
    global launches
    if a.dtype != torch.float32 or a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"want square f32 matrices, got {a.dtype} {tuple(a.shape)}")
    if a.get_device() != torch.cuda.current_device():
        raise ValueError(f"matrix on cuda:{a.get_device()}, launches go to the current "
                         f"device cuda:{torch.cuda.current_device()}")
    n = a.shape[-1]
    batch = math.prod(a.shape[:-2])
    out = a.clone(memory_format=torch.contiguous_format)   # factored in place
    tiles = -(-n // TILE)
    # scratch in one buffer: the claim counter and each matrix's ready flags
    # per lower tile (the kernel zeroes both), then its inverse pivots
    n_work = 1 + batch * tiles * (tiles + 1) // 2
    work = torch.empty(n_work + batch * tiles * TILE, dtype=torch.int32, device=a.device)
    if _entry is None:
        _load()
    err = _entry(out.data_ptr(), work.data_ptr(), work.data_ptr() + 4 * n_work, n, batch,
                 torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        _build.check(_build.load("cholesky", {}), "cholesky", err)
    launches += 1
    return out


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """The tiled kernel up to n = 1536, `torch.linalg.cholesky_ex` above,
    as the JAX package's dispatcher does; `a` is [n, n] or [..., n, n]."""
    if a.shape[-1] <= MAX_KERNEL_N:
        return cholesky_kernel(a)
    return torch.linalg.cholesky_ex(a).L
