"""Kernel launches per fused map: every kernel event of the profiled maps
over their number. Layer: fusion (`parallel/fusion.py`); moves
`fused_map_s`."""


def read(t, run):
    if not t.kernels:
        return None
    return len(t.kernels) / (t.steps * run["maps_per_step"])
