"""Sessions per fleet pass that the blocks could not finish and the
per-frame path did: the `slam.per_frame` spans over the profiled passes, 0
where none fell back. None when the trace holds neither a
`slam.mapping_block` nor a `slam.per_frame` span (a program without the
spans). Layer: the blocked entry (`frontend/blocked.py`); moves
`keyframes_per_s`."""
from slambench import spans


def read(t, run):
    fell = spans.named(t, "slam.per_frame")
    if not fell and not spans.named(t, "slam.mapping_block"):
        return None
    return len(fell) / t.steps
