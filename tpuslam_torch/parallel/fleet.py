"""Fleet-scale session parallelism: the blocked pipeline over a mesh axis
(counterpart of `tpuslam.parallel.fleet`).

Within a device, `blocked_core_batched` runs S sessions as one op stream;
across ranks, each runs it on its own chunk of the sessions, taken by its
coordinate on the mesh axis. Sessions are independent mapping problems, so
the pipeline itself needs no collective: the chunks' states, outputs and
`done_upto` are gathered once, at the end, and every rank returns the whole
fleet's.
"""
from __future__ import annotations

import torch

from tpuslam_torch.frontend.blocked import _map_outputs, _pick_compact, blocked_core_batched
from tpuslam_torch.frontend.state import SlamState, map_state
from tpuslam_torch.parallel.collectives import all_gather, shard
from tpuslam_torch.runtime.config import SlamConfig

__all__ = ["run_fleet_blocked"]


def run_fleet_blocked(states: SlamState, obs_seq, valid_seq, pose_seq, cfg: SlamConfig, mesh,
                      block: int = 8, axis: str = "sessions"):
    """S sessions' whole-lap blocked passes with the sessions sharded over
    `mesh[axis]`: states stacked [S], obs_seq [S, Tp, N, 4], valid_seq
    [S, Tp, N], pose_seq [S, Tp, 3], Tp a multiple of `block`, S a multiple
    of the axis size. The observation compaction width is picked from the
    whole fleet's inputs, as `run_sequences_blocked_batched` picks it (the
    JAX package's fleet keeps 32: the results are the same, the
    association narrower). Returns (states, outputs [S, Tp], done_upto) as
    `blocked_core_batched` does, for all S sessions on every rank."""
    i, n = shard(mesh, axis)
    S = obs_seq.shape[0]
    if S % n:
        raise ValueError(f"{S} sessions do not divide over {n} '{axis}' shards")
    k = S // n
    mine = slice(i * k, (i + 1) * k)
    nc, frozen = _pick_compact(valid_seq, states)
    st, outs, done = blocked_core_batched(map_state(lambda v: v[mine], states), obs_seq[mine],
                                          valid_seq[mine], pose_seq[mine], cfg, block, nc,
                                          frozen[mine])
    done_all = all_gather(torch.tensor(done, dtype=torch.int32, device=obs_seq.device),
                          mesh, axis)

    def gather(v):
        return all_gather(v, mesh, axis)
    return (map_state(gather, st), _map_outputs(gather, outs),
            [int(d) for d in done_all.tolist()])

