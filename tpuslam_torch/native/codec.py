"""ctypes bindings for the native OD4 codec (libod4codec.so): a copy of
`tpuslam.native.codec`.

Builds with `make` and g++ on first use, into `tpuslam_torch/build/native/`
(`native._build`), when the library is missing and a compiler is available;
everything degrades gracefully to the pure-Python codec
(tpuslam_torch.io.proto / envelope) when unavailable.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from tpuslam_torch.native import _build

_TARGET = "libod4codec.so"
_lib: Optional[ctypes.CDLL] = None


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
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.od4_scan.restype = ctypes.c_int64
    lib.od4_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p,
                             ctypes.c_int64]
    lib.od4_decode_headers.restype = ctypes.c_int64
    lib.od4_decode_headers.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64, i32p, u32p, i64p,
                                       i64p, i64p]
    lib.od4_decode_cones.restype = ctypes.c_int64
    lib.od4_decode_cones.argtypes = [ctypes.c_char_p, i64p, i64p,
                                     ctypes.c_int64, ctypes.c_int32,
                                     u32p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def scan_frames(buf: bytes) -> list[tuple[int, int]]:
    """[(payload_offset, payload_length)] of every framed envelope."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    max_frames = max(len(buf) // 6, 16)
    offs = np.zeros(max_frames, dtype=np.int64)
    lens = np.zeros(max_frames, dtype=np.int64)
    n = lib.od4_scan(buf, len(buf), _ptr(offs, ctypes.c_int64),
                     _ptr(lens, ctypes.c_int64), max_frames)
    return list(zip(offs[:n].tolist(), lens[:n].tolist()))


def decode_headers(buf: bytes):
    """Bulk envelope-header decode -> dict of numpy arrays."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    max_frames = max(len(buf) // 6, 16)
    dt = np.zeros(max_frames, dtype=np.int32)
    ss = np.zeros(max_frames, dtype=np.uint32)
    ts = np.zeros(max_frames, dtype=np.int64)
    po = np.zeros(max_frames, dtype=np.int64)
    pl = np.zeros(max_frames, dtype=np.int64)
    n = lib.od4_decode_headers(buf, len(buf), max_frames,
                               _ptr(dt, ctypes.c_int32), _ptr(ss, ctypes.c_uint32),
                               _ptr(ts, ctypes.c_int64), _ptr(po, ctypes.c_int64),
                               _ptr(pl, ctypes.c_int64))
    return {"data_type": dt[:n], "sender_stamp": ss[:n], "sample_us": ts[:n],
            "payload_off": po[:n], "payload_len": pl[:n]}


def decode_cones(buf: bytes, payload_off: np.ndarray, payload_len: np.ndarray,
                 kind: int):
    """Batched decode of ObjectDirection/Distance/Type payloads.

    Returns (object_ids uint32[N], values float32[N,2]) where values columns
    are (azimuth, zenith) / (distance, 0) / (type, 0) by kind.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    n = len(payload_off)
    ids = np.zeros(n, dtype=np.uint32)
    vals = np.zeros((n, 2), dtype=np.float32)
    po = np.ascontiguousarray(payload_off, dtype=np.int64)
    pl = np.ascontiguousarray(payload_len, dtype=np.int64)
    ok = lib.od4_decode_cones(buf, _ptr(po, ctypes.c_int64),
                              _ptr(pl, ctypes.c_int64), n, kind,
                              _ptr(ids, ctypes.c_uint32),
                              _ptr(vals, ctypes.c_float))
    if ok != n:
        raise ValueError(f"decoded {ok}/{n} payloads")
    return ids, vals
