"""PyTorch/CUDA port of the `tpuslam` per-frame SLAM engine.

Mirrors the JAX package's layout (`runtime/`, `backend/`, `geometry/`,
`frontend/`, `ops/`) so each module sits where its counterpart does. The
package imports `torch`, `numpy` and the JAX-free `tpuslam.compat` /
`tpuslam.sim` modules only: it never imports `jax`. The two hand-written
CUDA kernels live in `csrc/` and are built with `nvcc` on first use
(`_build.py`).
"""
