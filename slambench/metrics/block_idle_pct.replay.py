"""Share of the blocks' host time in which the card was idle: no kernel,
copy or memset of the trace ran inside the union of the `slam.mapping_block`
and `slam.loc_block` spans, over their summed time. Layer: device (one
H100); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    blocks = spans.named(t, "slam.mapping_block") + spans.named(t, "slam.loc_block")
    if not blocks:
        return None
    return 100.0 * spans.idle_us(t, blocks) / (1e3 * spans.total_ms(blocks))
