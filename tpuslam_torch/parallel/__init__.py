from tpuslam_torch.parallel.mesh import (  # noqa: F401
    make_chain_mesh, make_map_mesh, make_slam_mesh, initialize_distributed,
)
from tpuslam_torch.parallel.distributed import (  # noqa: F401
    distributed_gn_step, distributed_optimize,
)
from tpuslam_torch.parallel.multisession import multisession_optimize, stack_graphs  # noqa: F401
from tpuslam_torch.parallel.chain import chain_optimize, partition_edges_by_pose_block  # noqa: F401
from tpuslam_torch.parallel.fleet import run_fleet_blocked  # noqa: F401
from tpuslam_torch.parallel.map_blocks import associate_sharded  # noqa: F401
from tpuslam_torch.parallel.resident import (  # noqa: F401
    chain_optimize_resident, partition_chain_resident,
    resident_comm_bytes_per_iteration,
)
from tpuslam_torch.parallel.fusion import (  # noqa: F401
    align_to_anchor, fuse_graphs, fuse_sessions,
)
from tpuslam_torch.parallel.resident_online import (  # noqa: F401
    initial_shards, resident_online_core, resident_online_supported, run_pass_resident_online,
)
