"""Iterations of the batched closure GN per fleet pass: the
`slam.gn.iteration` spans inside `slam.closure_gn` over the profiled
passes (an exact count: the GN stops at its iteration cap or its
tolerance). Layer: closure GN (`backend/gauss_newton.py`,
`ops/cholesky.py`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    gn = spans.named(t, "slam.closure_gn")
    if not gn:
        return None
    return len(spans.inside(spans.named(t, "slam.gn.iteration"), gn)) / t.steps
