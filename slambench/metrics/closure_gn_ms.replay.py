"""Host time of the batched closure GN per fleet pass: the `slam.closure_gn`
spans over the profiled passes. Layer: closure GN
(`backend/gauss_newton.py`, `ops/cholesky.py`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    gn = spans.named(t, "slam.closure_gn")
    return spans.total_ms(gn) / t.steps if gn else None
