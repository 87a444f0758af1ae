from tpuslam_torch.viz.live import LiveViewer  # noqa: F401
from tpuslam_torch.viz.plot import plot_state, save_state_png  # noqa: F401
