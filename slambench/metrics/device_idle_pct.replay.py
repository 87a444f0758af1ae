"""Share of the profiled fleet passes in which no kernel, copy or memset
ran on the card, from a profile of the device alone (the host's recording
would stretch the passes). Layer: device (one H100); moves
`keyframes_per_s`."""


def read(t, run):
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
