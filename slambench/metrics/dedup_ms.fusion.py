"""Host time of the fusion's landmark dedup per fused map: the
`slam.fusion.dedup` spans over the profiled maps. Layer: fusion
(`parallel/fusion.py`); moves `fused_map_s`."""
from slambench import spans


def read(t, run):
    dedup = spans.named(t, "slam.fusion.dedup")
    return spans.total_ms(dedup) / (t.steps * run["maps_per_step"]) if dedup else None
