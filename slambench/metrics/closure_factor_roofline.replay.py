"""The closure GN's factorizations' share of their roofline over a fleet
pass: S n^3 / 3 FP32 operations for each [S, n, n] factored
(`torch.linalg.cholesky_ex`, or the program's Cholesky kernel), over the
device time of the kernels that factored them (`profiling.cholesky_share`).
Layer: closure GN (`backend/gauss_newton.py`, `ops/cholesky.py`); moves
`keyframes_per_s`."""
from slambench.profiling import cholesky_share


def read(t, run):
    return cholesky_share(t, run)
