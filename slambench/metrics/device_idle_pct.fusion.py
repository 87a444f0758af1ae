"""Share of the profiled fused maps in which no kernel, copy or memset ran
on the card, from a profile of the device alone (the host's recording
would stretch the maps). Layer: device (one H100); moves `fused_map_s`."""


def read(t, run):
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
