"""Process meshes for the multi-device tier (counterpart of
`tpuslam.parallel.mesh`).

The JAX package runs one program over a device `Mesh`. Here the program
runs once per process, one rank per device (SPMD over `torch.distributed`),
and a `torch.distributed.device_mesh.DeviceMesh` names the axes:

- 'sessions': data parallelism over independent mapping sessions (each rank
  holds a chunk of them; no communication but at the end of a call);
- 'edges': model parallelism within a session: each rank assembles its
  slice of the observation-edge list (or gates its block of the landmark
  map), and a sum (or minimum) over this axis is the distributed Schur
  reduction (`parallel.collectives`).

Every rank passes the same global inputs and gets the same global results,
as JAX's global arrays are; a rank takes its shard by its coordinate on an
axis. `n_sessions * n_edge_shards` must divide the world size, and ranks past
the mesh (the JAX package's `devices[:use]`) hold no shard: the mesh paths
refuse them.

The backend is the caller's choice: NCCL for CUDA tensors, gloo for the CPU
(gloo also reduces CUDA tensors, through host copies). A world of one rank
is a real process group whose collectives are identities.
"""
from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_slam_mesh", "make_chain_mesh", "make_map_mesh", "initialize_distributed",
           "free_port"]


def free_port() -> int:
    """A TCP port on localhost that is free now (bound from port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(backend: str, coordinator_address: str | None = None,
                           num_processes: int = 1, process_id: int = 0,
                           timeout_s: float | None = None) -> bool:
    """Join this process to a world of `num_processes` ranks as rank
    `process_id`, through `torch.distributed.init_process_group` with
    `backend` ('nccl' or 'gloo') and the rendezvous `coordinator_address`
    ('host:port' or a 'tcp://' URL; a free localhost port for a world of
    one). With a CUDA device, the rank's current device is its rank modulo
    the device count. `timeout_s` bounds each collective's wait (the
    backend's default when None). Returns False when the process group
    already exists (nothing is done), True otherwise."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' (CUDA) or 'gloo' (CPU)")
    if dist.is_initialized():
        return False
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' asked for, but no CUDA device is available")
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError("a world of several ranks needs a coordinator_address")
        coordinator_address = f"localhost:{free_port()}"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def _check(device_type: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type 'cuda' asked for, but no CUDA device is available")
    return dist.get_world_size()


def make_slam_mesh(n_sessions: int = 1, n_edge_shards: int | None = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A ('sessions', 'edges') mesh over the world's ranks, row-major: rank
    s * n_edge_shards + e sits at (s, e). `n_edge_shards` defaults to the
    world size over `n_sessions`. Every rank of the world must call it (it
    creates the axes' process groups)."""
    n = _check(device_type)
    if n_edge_shards is None:
        if n % n_sessions:
            raise ValueError(f"{n} ranks not divisible by {n_sessions} sessions")
        n_edge_shards = n // n_sessions
    use = n_sessions * n_edge_shards
    if use < 1 or n % use:
        raise ValueError(f"a {n_sessions} x {n_edge_shards} mesh does not divide {n} ranks")
    return DeviceMesh(device_type, torch.arange(use).reshape(n_sessions, n_edge_shards),
                      mesh_dim_names=("sessions", "edges"))


def _line_mesh(name: str, n_shards: int | None, device_type: str) -> DeviceMesh:
    """A 1-D (`name`,) mesh over the first `n_shards` ranks (all by default)."""
    n = _check(device_type)
    use = n_shards or n
    if use < 1 or n % use:
        raise ValueError(f"a {name} of {use} shards does not divide {n} ranks")
    return DeviceMesh(device_type, torch.arange(use), mesh_dim_names=(name,))


def make_chain_mesh(n_shards: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D ('chain',) mesh for pose-chain parallelism over the first
    `n_shards` ranks (all by default)."""
    return _line_mesh("chain", n_shards, device_type)


def make_map_mesh(n_shards: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D ('map',) mesh over the first `n_shards` ranks (all by default)
    for the landmark map sharded in blocks (`parallel.resident_online`)."""
    return _line_mesh("map", n_shards, device_type)
