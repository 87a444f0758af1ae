"""Host time of one association call: the mean `slam.assoc` span (the
kernel wrapper's checks, allocations and launch) over the profiled passes.
Layer: association (`ops/assoc_kernel.py`, `csrc/assoc.cu`); moves
`keyframes_per_s`."""
from slambench import spans


def read(t, run):
    calls = spans.named(t, "slam.assoc")
    return 1e3 * spans.total_ms(calls) / len(calls) if calls else None
