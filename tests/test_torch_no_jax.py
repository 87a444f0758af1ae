"""The port and its GPU smoke script import without JAX and without the JAX
package: in a fresh interpreter with both `jax` and `tpuslam` made
unimportable, every module of `tpuslam_torch` (the blocked pipeline, the
batched sessions, the fusion, the live service with its IO stack, EKF,
WGS84 projection and checkpoint, the lidar front-end, the per-frame batched
engine, the multi-device tier on `torch.distributed`, its pose-chain
solvers and the map-resident online pass among them),
`chip_smoke` and the GPU tests `tests/test_torch_cuda.py` import."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
for name in list(sys.modules):           # a sitecustomize may have imported it
    if name.split(".")[0] in ("jax", "jaxlib", "tpuslam"):
        del sys.modules[name]
sys.modules["jax"] = sys.modules["tpuslam"] = None
import tpuslam_torch
for mod in pkgutil.walk_packages(tpuslam_torch.__path__, "tpuslam_torch."):
    importlib.import_module(mod.name)
from tpuslam_torch.frontend.blocked import run_pass_blocked, run_sequence_blocked
from tpuslam_torch.frontend.blocked import run_sequences_blocked_batched
from tpuslam_torch.parallel.batch import initial_states, run_passes_batched, run_sequences_batched
from tpuslam_torch.parallel import (
    associate_sharded, distributed_gn_step, distributed_optimize, fuse_graphs,
    initialize_distributed, make_chain_mesh, make_slam_mesh, multisession_optimize,
    run_fleet_blocked,
)
from tpuslam_torch.parallel.collectives import (
    all_gather, counting, pmax, pmin, ppermute, psum, shard,
)
from tpuslam_torch.parallel import make_map_mesh
from tpuslam_torch.parallel.resident_online import (
    initial_shards, resident_online_core, resident_online_supported, run_pass_resident_online,
)
from tpuslam_torch.parallel import (
    chain_optimize, chain_optimize_resident, partition_chain_resident,
    partition_edges_by_pose_block, resident_comm_bytes_per_iteration,
)
from tpuslam_torch.parallel.chain import chain_gn_step, chain_gn_step_dd, partition_chain
from tpuslam_torch.parallel.resident import chain_gn_step_dd_resident
from tpuslam_torch.parallel.hier import chain_optimize_hier, partition_chain_hier
from tpuslam_torch.parallel.hier3 import chain_optimize_hier3, partition_chain_hier3
from tpuslam_torch.parallel.instrument import collective_payload_bytes
from tpuslam_torch.parallel.comm_model import CommModel, tier_bytes_per_iteration
from tpuslam_torch.parallel.mesh import free_port
from tpuslam_torch.parallel.fusion import fuse_sessions
from tpuslam_torch.parallel.multisession import stack_graphs
from tpuslam_torch.core.slam import Slam
from tpuslam_torch.frontend.motion import ekf_init, ekf_predict, ekf_update_position
from tpuslam_torch.geometry.wgs84 import local_projector, to_cartesian, to_cartesian_torch
from tpuslam_torch.io import envelope, messages, od4, proto, rec
from tpuslam_torch.perception.attention import detect_cones, grid_cell_overflow
from tpuslam_torch.perception.vlp16 import decode_point_cloud_reading
from tpuslam_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from tpuslam_torch.runtime.metrics import MetricsRegistry
from tpuslam_torch.runtime.service import SlamService, scenario_to_rec
from tpuslam_torch.sim.vlp16_sim import render_scene, scene_to_point_cloud_reading
import chip_smoke
sys.path.insert(0, "tests")
import test_torch_cuda
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpuslam")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


def test_port_and_chip_smoke_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
