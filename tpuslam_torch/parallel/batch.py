"""Batched multi-session state (counterpart of `tpuslam.parallel.batch`).

One session is dispatch-bound: its ops are small. S independent sessions
(cars, laps, replay shards) run as one stacked state, a leading axis S on
every field, so each op of the batched blocked pipeline
(`frontend.blocked.run_sequences_blocked_batched`) does the work of all S.
"""
from __future__ import annotations

from tpuslam_torch.backend.graph import GraphCapacity
from tpuslam_torch.frontend.state import SlamState, initial_state, stack_states

__all__ = ["initial_states"]


def initial_states(cap: GraphCapacity, n_sessions: int, device) -> SlamState:
    """Stacked initial state for `n_sessions` independent sessions."""
    return stack_states([initial_state(cap, device)] * n_sessions)
