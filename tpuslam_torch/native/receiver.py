"""ctypes bindings for the native OD4 multicast endpoint (libod4recv.so): a
copy of `tpuslam.native.receiver`, built on first use as `native.codec` is.

The native endpoint (od4recv.cpp) is the live-ingest data-loader: a C++
receive thread with kernel RX timestamps and self-send filtering feeding a
ring buffer, drained from Python in batches. `tpuslam_torch.io.od4.OD4Session`
uses it when available (`native=True`); everything degrades to the pure
asyncio endpoint otherwise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from tpuslam_torch.native import _build

_TARGET = "libod4recv.so"
_lib: Optional[ctypes.CDLL] = None

_MAX_BATCH = 1024
_BUF_CAP = 1 << 20  # 1 MiB per drain


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = _build.build(_TARGET)
    except RuntimeError:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.od4r_open.restype = i64
    lib.od4r_open.argtypes = [ctypes.c_uint32, ctypes.c_uint16, ctypes.c_int,
                              ctypes.c_char_p]
    lib.od4r_send.restype = i64
    lib.od4r_send.argtypes = [i64, ctypes.c_char_p, i64]
    lib.od4r_wait.restype = i64
    lib.od4r_wait.argtypes = [i64, i64]
    lib.od4r_drain.restype = i64
    lib.od4r_drain.argtypes = [i64, u8p, i64, i64p, i64p, i64p, i64]
    lib.od4r_stats.restype = None
    lib.od4r_stats.argtypes = [i64, i64p, i64p]
    lib.od4r_close.restype = None
    lib.od4r_close.argtypes = [i64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeOD4Endpoint:
    """One multicast bus endpoint backed by the native receive thread."""

    def __init__(self, cid: int, port: int = 12175, rcvbuf: int = 1 << 20,
                 interface: str = "0.0.0.0"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native receiver unavailable")
        self._lib = lib
        self._h = lib.od4r_open(cid & 0xFF, port, rcvbuf,
                                interface.encode())
        if self._h <= 0:
            raise OSError(f"od4r_open failed: {self._h}")
        self._buf = np.zeros(_BUF_CAP, dtype=np.uint8)
        self._offs = np.zeros(_MAX_BATCH, dtype=np.int64)
        self._lens = np.zeros(_MAX_BATCH, dtype=np.int64)
        self._ts = np.zeros(_MAX_BATCH, dtype=np.int64)

    def send(self, data: bytes) -> int:
        return int(self._lib.od4r_send(self._h, data, len(data)))

    def wait(self, timeout_s: float = 0.05) -> int:
        """Block in C (GIL released) until a datagram arrives or timeout."""
        return int(self._lib.od4r_wait(self._h, int(timeout_s * 1e6)))

    def drain(self) -> list[tuple[bytes, int]]:
        """All pending datagrams as [(payload, rx_time_us)], arrival order."""
        def p(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        n = int(self._lib.od4r_drain(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _BUF_CAP, p(self._offs), p(self._lens), p(self._ts), _MAX_BATCH))
        out = []
        for i in range(n):
            o, ln = int(self._offs[i]), int(self._lens[i])
            out.append((self._buf[o:o + ln].tobytes(), int(self._ts[i])))
        return out

    def stats(self) -> tuple[int, int]:
        rx = ctypes.c_int64(0)
        dr = ctypes.c_int64(0)
        self._lib.od4r_stats(self._h, ctypes.byref(rx), ctypes.byref(dr))
        return rx.value, dr.value

    def close(self):
        if self._h > 0:
            self._lib.od4r_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
