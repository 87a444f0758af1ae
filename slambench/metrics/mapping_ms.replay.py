"""Host time of the mapping blocks per fleet pass: the summed
`slam.mapping_block` spans (each block's association, mapping update, flag
read and state hold) over the profiled passes. Layer: keyframe logic
(`frontend/blocked.py`, `frontend/keyframe.py`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    blocks = spans.named(t, "slam.mapping_block")
    return spans.total_ms(blocks) / t.steps if blocks else None
