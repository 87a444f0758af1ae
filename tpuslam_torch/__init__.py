"""PyTorch/CUDA port of `tpuslam`, the online cone GraphSLAM engine.

Mirrors the JAX package's layout (`runtime/`, `backend/`, `geometry/`,
`frontend/`, `ops/`, `parallel/`, `core/`, `io/`, `perception/`) so each
module sits where its counterpart does. The package imports `torch` and
`numpy` only: it never imports `jax` nor any module of the JAX package
`tpuslam`, and keeps its own copies of the pure-Python modules it needs
(`compat`, `sim`, the `io` stack, `runtime.metrics`, `perception.vlp16`).
The two hand-written CUDA kernels live in `csrc/` and are built with `nvcc`
on first use (`_build.py`).
"""
