"""Live viewer — the reference's Pangolin render thread, reborn.

The reference's viewer build spawns `std::thread viewThread(&Viewer::Run,
viewer)` next to the service and re-renders cones / pose trail / current
pose / graph edges every frame, with menu checkboxes toggling each layer
(reference viewerbuild/src/opendlv-logic-cfsd18-sensation-slam.cpp:69-71,
viewer.cpp:43-60). Here the same loop is a daemon thread that pulls a state
snapshot from a callback and re-renders with matplotlib — to an interactive
window when a display is available, or to a continuously-refreshed PNG in
headless deployments (point a browser/image viewer at it).

The four layer toggles match the Pangolin menu one-to-one and, like the
reference's checkboxes, are evaluated EVERY render frame (reference
viewer.cpp:43-56): flip them at runtime via `set_toggles(...)` (or attribute
assignment) and the next frame reflects it. In window mode the keys
c/p/o/g toggle cones / poses / current pose / graph interactively — the
keyboard stands in for the Pangolin menu panel.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from tpuslam_torch.viz.plot import host_graph, plot_graph

__all__ = ["LiveViewer"]


class LiveViewer:
    """Background renderer of a live SLAM state.

    get_state: callable returning the current SlamState. The engine
    replaces its state on every keyframe and never writes a state's tensors
    in place, so no locking is needed (unlike the reference's mutex-guarded
    draw* getters, src/slam.cpp:758-784). Each frame copies the fields it
    draws to the host first (`host_graph`, from this thread, the tensors on
    any device) and keeps no reference to the state past that copy.
    """

    def __init__(self, get_state: Callable[[], object],
                 png_path: Optional[str] = None,
                 interval_s: float = 0.5,
                 show_cones: bool = True, show_poses: bool = True,
                 show_current_pose: bool = True, show_graph: bool = True,
                 window: bool = False):
        self.get_state = get_state
        self.png_path = png_path
        self.interval_s = interval_s
        self.show_cones = show_cones
        self.show_poses = show_poses
        self.show_current_pose = show_current_pose
        self.show_graph = show_graph
        self.window = window
        self.frames_rendered = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fig = None

    # -- lifecycle (Viewer::Run on a thread) --------------------------------
    def start(self) -> "LiveViewer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpuslam-viewer")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # final frame: the last state always lands on disk even when the
        # run finished faster than one render interval
        if self.png_path:
            try:
                self.render_once()
            except Exception:
                pass
        if self._fig is not None:
            import matplotlib.pyplot as plt
            plt.close(self._fig)
            self._fig = None

    def set_toggles(self, show_cones=None, show_poses=None,
                    show_current_pose=None, show_graph=None):
        """Runtime layer toggles — the Pangolin menu checkboxes
        (reference viewer.cpp:43-56): evaluated on the NEXT rendered frame.
        Plain attribute stores (GIL-atomic), safe from any thread."""
        if show_cones is not None:
            self.show_cones = bool(show_cones)
        if show_poses is not None:
            self.show_poses = bool(show_poses)
        if show_current_pose is not None:
            self.show_current_pose = bool(show_current_pose)
        if show_graph is not None:
            self.show_graph = bool(show_graph)

    def _on_key(self, event):
        key = getattr(event, "key", None)
        if key == "c":
            self.show_cones = not self.show_cones
        elif key == "p":
            self.show_poses = not self.show_poses
        elif key == "o":
            self.show_current_pose = not self.show_current_pose
        elif key == "g":
            self.show_graph = not self.show_graph

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- render loop ---------------------------------------------------------
    def render_once(self) -> bool:
        """One frame: snapshot -> draw. Returns False if no state yet."""
        state = self.get_state()
        if state is None:
            return False
        graph = host_graph(state)
        del state
        import matplotlib
        if not self.window:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        if self._fig is None:
            self._fig, self._ax = plt.subplots(figsize=(8, 8))
            if self.window:
                plt.ion()
                self._fig.canvas.mpl_connect("key_press_event", self._on_key)
                self._fig.show()
        self._ax.clear()
        plot_graph(graph, ax=self._ax, show_cones=self.show_cones,
                   show_poses=self.show_poses, show_graph=self.show_graph,
                   show_current=self.show_current_pose)
        self._ax.set_title(f"tpuslam live — frame {self.frames_rendered}")
        if self.png_path:
            # atomic swap so readers never see a torn file
            tmp = self.png_path + ".tmp"
            self._fig.savefig(tmp, dpi=100, bbox_inches="tight", format="png")
            import os
            os.replace(tmp, self.png_path)
        if self.window:
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
        self.frames_rendered += 1
        return True

    def _run(self):
        while not self._stop.is_set():
            try:
                self.render_once()
            except Exception:
                pass  # rendering must never take down the service
            self._stop.wait(self.interval_s)
