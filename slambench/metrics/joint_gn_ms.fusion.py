"""Host time of the fusion's joint GN per fused map: the `slam.fusion.gn`
spans over the profiled maps. Layer: closure GN (`backend/gauss_newton.py`,
`ops/cholesky.py`); moves `fused_map_s`."""
from slambench import spans


def read(t, run):
    gn = spans.named(t, "slam.fusion.gn")
    return spans.total_ms(gn) / (t.steps * run["maps_per_step"]) if gn else None
