"""Cholesky of the Schur-reduced pose system: the hand-written CUDA kernel
(`csrc/cholesky.cu`, the counterpart of `tpuslam.ops.cholesky`'s Pallas
kernel: one cooperative launch of persistent blocks over 32x32 tiles), its
plain PyTorch twin, and the dispatcher `cholesky`.

`cholesky_kernel` takes the twin only for a matrix that lies on the CPU; for
a CUDA matrix it launches the kernel or raises. `launches` counts the
factorizations the kernel ran in this process, one launch each.
"""
from __future__ import annotations

import ctypes

import torch

from tpuslam_torch import _build

__all__ = ["cholesky", "cholesky_kernel", "cholesky_plain", "launches", "MAX_KERNEL_N"]

PANEL = 64            # panel width of the plain twin
TILE = 32             # tile edge of the kernel
MAX_KERNEL_N = 1536   # the JAX dispatcher's kernel bound (MAX_VMEM_N)
launches = 0


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Right-looking blocked Cholesky in PyTorch ops, with 64-wide panels
    and the kernel's clamped pivots rsqrt(max(pivot, 1e-30)) — unlike
    `torch.linalg.cholesky`, a non-positive pivot does not raise. Returns the
    lower factor with the strict upper triangle zeroed."""
    n = a.shape[0]
    w = a.clone()
    for k0 in range(0, n, PANEL):
        k1 = min(k0 + PANEL, n)
        for j in range(k0, k1):
            inv = torch.rsqrt(torch.clamp(w[j, j], min=1e-30))
            w[j:, j] *= inv
            w[j + 1:, j + 1:k1] -= w[j + 1:, j:j + 1] * w[j + 1:k1, j][None, :]
        if k1 < n:
            p = w[k1:, k0:k1]
            w[k1:, k1:] -= p @ p.T
    return torch.tril(w)


def cholesky_kernel(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD f32 matrix [n, n] by the tiled
    CUDA kernel (the plain twin for a CPU matrix)."""
    if not a.is_cuda:
        return cholesky_plain(a)
    global launches
    if a.dtype != torch.float32 or a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"want a square f32 matrix, got {a.dtype} {tuple(a.shape)}")
    n = a.shape[0]
    out = a.clone(memory_format=torch.contiguous_format)   # factored in place
    tiles = -(-n // TILE)
    # scratch: the claim counter and one ready flag per lower tile (the kernel
    # zeroes both), and the inverse pivots
    work = torch.empty(1 + tiles * (tiles + 1) // 2, dtype=torch.int32, device=a.device)
    inv = torch.empty(tiles * TILE, dtype=torch.float32, device=a.device)
    p = ctypes.c_void_p
    lib = _build.load("cholesky", {"tpuslam_cholesky": ([p, p, p, ctypes.c_int, p], ctypes.c_int)})
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.tpuslam_cholesky(out.data_ptr(), work.data_ptr(), inv.data_ptr(), n, stream)
    _build.check(lib, "cholesky", err)
    launches += 1
    return out


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """The tiled kernel up to n = 1536, `torch.linalg.cholesky_ex` above,
    as the JAX package's dispatcher does."""
    if a.shape[0] <= MAX_KERNEL_N:
        return cholesky_kernel(a)
    return torch.linalg.cholesky_ex(a).L
