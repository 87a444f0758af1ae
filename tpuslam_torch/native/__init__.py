"""The native OD4 codec and multicast receiver (C++, bound with ctypes): a
copy of `tpuslam.native`. The libraries are built with g++ on first use into
the git-ignored `tpuslam_torch/build/native/` (`native._build`); nothing is
built at import. Host transport only: no device code."""
