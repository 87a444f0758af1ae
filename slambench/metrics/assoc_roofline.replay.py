"""The association kernel's share of its roofline over a fleet pass: the
least time of every launch at its [S, N, M] (`roofline.assoc_bound`, from
the shapes the driver recorded at the kernel's wrapper), summed, over the
summed device time of the `assoc_kernel` events. The launch count must
equal both the wrapper's recorded calls and the kernel's own launch
counter, or the trace is short. Layer: association (`ops/assoc_kernel.py`,
`csrc/assoc.cu`); moves `keyframes_per_s`."""
from slambench.profiling import ShortTrace
from slambench.roofline import assoc_bound


def read(t, run):
    ks = t.kernels_named("assoc_kernel")
    shapes = run["assoc_shapes"]
    if len(ks) != len(shapes) or len(ks) != run["assoc_launches"]:
        raise ShortTrace(f"{len(ks)} assoc_kernel events, {len(shapes)} wrapper calls, "
                         f"{run['assoc_launches']} counted launches")
    if not ks:
        return None
    need = sum(assoc_bound(*shape) for shape in shapes)
    return 100.0 * need / (sum(k.dur for k in ks) * 1e-6)
