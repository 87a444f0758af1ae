"""PyTorch/CUDA port of `tpuslam`, the online cone GraphSLAM engine.

Mirrors the JAX package's layout (`runtime/`, `backend/`, `geometry/`,
`frontend/`, `ops/`, `parallel/`, `core/`, `io/`, `perception/`, `native/`,
`viz/`, `cli/`; `entry.py` for `__graft_entry__.py`) so each module sits
where its counterpart does. The package imports `torch` and `numpy` only
(matplotlib on first render): it never imports `jax` nor any module of the
JAX package `tpuslam`, and keeps its own copies of the pure-Python modules
it needs (`compat`, `sim`, the `io` stack, `runtime.metrics`,
`runtime.odconfig`, `perception.vlp16`, `perception.calib`). The two
hand-written CUDA kernels live in `csrc/` and are built with `nvcc` on
first use (`_build.py`); the native OD4 codec and receiver (`native/`) with
g++ on first use (`native/_build.py`).
"""
