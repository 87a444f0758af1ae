"""Operations, bytes and the card's peaks: the least time a kernel's work
could take, for the per-layer roofline shares.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity, at
its 700 W limit: 67 TFLOP/s FP32 outside the tensor cores and 3.35 TB/s of
HBM3. A share is stated against these whatever power limit the card is set
to; the run prints the card's `power.limit` beside it.
"""
from __future__ import annotations

PEAK_FP32_FLOP_S = 67e12
PEAK_HBM_BYTE_S = 3.35e12
PEAKS_SOURCE = "NVIDIA H100 SXM5 80GB data sheet: 67 TFLOP/s FP32 (no tensor cores), 3.35 TB/s"


def bound(flop: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the least time the card could
    take for `flop` FP32 operations and `nbytes` moved, and which sets it."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOP_S, nbytes / PEAK_HBM_BYTE_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def assoc_flop(n: int, m: int, mahalanobis: bool) -> float:
    """FP32 operations of the association cost for n observations and m
    landmarks: per pair, Euclidean 2 sub, 2 mul, 1 add; Mahalanobis 2 sub,
    6 mul, 2 add, and 2 once per landmark."""
    return 10 * n * m + m if mahalanobis else 5 * n * m


def assoc_bytes(n: int, m: int, mahalanobis: bool) -> float:
    """Bytes the association must read and write once: observations
    (x, y, type, valid), landmarks (x, y, type, and the packed inverse
    covariance when Mahalanobis), and per observation its index, cost and
    match flag."""
    return n * (8 + 4 + 1) + m * (8 + 4 + (12 if mahalanobis else 0)) + n * (4 + 4 + 1)


def assoc_bound(s: int, n: int, m: int, mahalanobis: bool = False) -> float:
    """Least seconds for one launch over s sessions of n x m."""
    return bound(s * assoc_flop(n, m, mahalanobis), s * assoc_bytes(n, m, mahalanobis))[0]


def cholesky_flop(n: int) -> float:
    """FP32 operations of one n x n Cholesky factorization: n^3 / 3."""
    return n ** 3 / 3.0


def cholesky_bound(s: int, n: int) -> float:
    """Least seconds to factor s matrices of n x n in FP32: n^3 / 3
    operations each, the lower triangle read and the factor written."""
    return bound(s * cholesky_flop(n), s * 2 * 4 * n * (n + 1) / 2)[0]
