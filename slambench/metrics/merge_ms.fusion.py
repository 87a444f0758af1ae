"""Host time of the fusion's merge of poses, landmarks and edges per fused
map: the `slam.fusion.merge` spans over the profiled maps. Layer: fusion
(`parallel/fusion.py`); moves `fused_map_s`."""
from slambench import spans


def read(t, run):
    merge = spans.named(t, "slam.fusion.merge")
    return spans.total_ms(merge) / (t.steps * run["maps_per_step"]) if merge else None
