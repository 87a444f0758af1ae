"""PyTorch/CUDA port of the `tpuslam` per-frame SLAM engine.

Mirrors the JAX package's layout (`runtime/`, `backend/`, `geometry/`,
`frontend/`, `ops/`) so each module sits where its counterpart does. The
package imports `torch` and `numpy` only: it never imports `jax` nor any
module of the JAX package `tpuslam`, and keeps its own copies of the
numpy-only `compat` constants and `sim` scenarios. The two hand-written
CUDA kernels live in `csrc/` and are built with `nvcc` on first use
(`_build.py`).
"""
