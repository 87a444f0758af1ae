"""The joint GN's factorizations' share of their roofline over the profiled
fused maps: n^3 / 3 FP32 operations for each n x n factored by
`torch.linalg.cholesky_ex` (n = 9,216 for eight sessions of 384 poses),
over the device time of its kernels (`profiling.cholesky_share`). Layer:
closure GN (`backend/gauss_newton.py`); moves `fused_map_s`."""
from slambench.profiling import cholesky_share


def read(t, run):
    return cholesky_share(t, run)
