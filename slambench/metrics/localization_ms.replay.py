"""Host time of the localization blocks per fleet pass: the summed
`slam.loc_block` spans over the profiled passes. Layer: keyframe logic
(`frontend/blocked.py`, `frontend/keyframe.py`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    blocks = spans.named(t, "slam.loc_block")
    return spans.total_ms(blocks) / t.steps if blocks else None
