"""Share of the fleet pass's blocks that ran by replaying their CUDA graphs:
the `slam.mapping_block` and `slam.loc_block` spans that hold a
`slam.block_graph` span, over all of them, in percent. None where no block
ran, and where blocks ran but none holds the span (a program that runs its
blocks eagerly). Layer: keyframe logic (`frontend/blocked.py`,
`frontend/keyframe.py`); moves `keyframes_per_s`."""
from slambench import spans


def read(t, run):
    blocks = spans.named(t, "slam.mapping_block") + spans.named(t, "slam.loc_block")
    graphs = spans.named(t, "slam.block_graph")
    replayed = [b for b in blocks if spans.inside(graphs, [b])]
    if not replayed:
        return None
    return 100.0 * len(replayed) / len(blocks)
