"""Measured collective payloads (counterpart of `tpuslam.parallel.instrument`).

The JAX package walks a traced jaxpr for its collective primitives, and
counts collective instructions in the compiled HLO
(`compiled_collective_count`). Neither has a counterpart here: a PyTorch
program is not traced, and whether a branch or a loop iteration runs is
known only when it runs. Instead every wrapper of
`parallel.collectives` (`psum`, `pmin`, `pmax`, `all_gather`, `ppermute`) adds
its payload to a counter while one is open, and
`collective_payload_bytes` runs the function once under one: the counts
are those of that run, every loop iteration and taken branch included.

Conventions (the JAX package's, and `comm_model.tier_bytes_per_iteration`'s):
per call, the bytes this rank puts in, its input (psum, pmin, pmax, ppermute,
and all_gather, whose gathered total is the input times the axis size).
"""
from __future__ import annotations

from tpuslam_torch.parallel.collectives import counting

__all__ = ["collective_payload_bytes", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("psum", "pmin", "pmax", "all_gather", "ppermute")


def collective_payload_bytes(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once and return {kind: {"count",
    "bytes"}} of the collectives this rank called in it (kinds it did not
    call are absent) and "total_bytes"."""
    with counting() as rec:
        fn(*args, **kwargs)
    out = {k: dict(v) for k, v in rec.items()}
    out["total_bytes"] = sum(v["bytes"] for v in rec.values())
    return out
