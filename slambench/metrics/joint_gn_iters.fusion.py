"""Iterations of the fusion's joint GN per fused map: the
`slam.gn.iteration` spans inside `slam.fusion.gn` over the profiled maps.
Layer: closure GN (`backend/gauss_newton.py`, `ops/cholesky.py`); moves
`fused_map_s`."""
from slambench import spans


def read(t, run):
    gn = spans.named(t, "slam.fusion.gn")
    if not gn:
        return None
    iters = spans.inside(spans.named(t, "slam.gn.iteration"), gn)
    return len(iters) / (t.steps * run["maps_per_step"])
