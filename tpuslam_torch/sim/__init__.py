"""Track generators and the observation/odometry simulator: copies of the
JAX package's numpy-only `tpuslam.sim` modules, for the port's own runs."""
from tpuslam_torch.sim.tracks import Track, skidpad, acceleration, trackdrive  # noqa: F401
from tpuslam_torch.sim.simulator import SimConfig, Scenario, simulate, ate  # noqa: F401
