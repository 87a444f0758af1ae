"""Device-to-host copies and host waits on the device per fleet pass: the
profiled passes' `Memcpy DtoH` events plus their stream, device and event
synchronizations. Layer: the blocked entry (`frontend/blocked.py`); moves
`keyframes_per_s`."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(t, run):
    inside = [e for e in t.device + t.runtime if t.t0 <= e.ts <= t.t1]
    copies = sum(1 for e in inside if e.cat == "gpu_memcpy" and "DtoH" in e.name)
    waits = sum(1 for e in inside if e.name in SYNCS)
    if copies + waits == 0:
        return None
    return (copies + waits) / t.steps
