"""Kernel launches per session-keyframe of a fleet pass: every kernel event
of the profiled passes over the passes' session-keyframes. Layer: the
blocked entry (`frontend/blocked.py`); moves `keyframes_per_s`."""


def read(t, run):
    if not t.kernels:
        return None
    return len(t.kernels) / (t.steps * run["keyframes_per_step"])
