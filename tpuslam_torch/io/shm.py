"""Interprocess shared memory with lock + condition semantics.

A copy of `tpuslam.io.shm` (pure Python), so that the port imports nothing of
the JAX package.

Equivalent of libcluon's `SharedMemory` (reference
src/cluon-complete-build.hpp:8109-8188): a named region used by sibling
OpenDLV services to hand raw point clouds between processes on one host
(usecase/configuration:103-110). The reference places a pthread
mutex/condvar header in the mapping; Python cannot host robust pthread
primitives in shared memory, so the same contract — `lock`/`unlock`,
`wait`/`notify_all`, `data`, `valid` — is built from primitives that are
process-safe from Python:

- region: `multiprocessing.shared_memory.SharedMemory` (POSIX shm_open)
- mutual exclusion: `fcntl.flock` on a sidecar lock file (kernel-arbitrated,
  crash-released — strictly more robust than the reference's non-robust
  pthread mutex, which deadlocks if a holder dies)
- condition: a generation counter in the first 8 bytes of the region;
  `notify_all` bumps it under the lock, `wait` sleeps until it changes.

The user-visible buffer excludes the 8-byte header, like the reference's
`m_userAccessibleSharedMemory` offset past its header.
"""
from __future__ import annotations

import os
import struct
import tempfile
import time
from multiprocessing import shared_memory

try:
    import fcntl
except ImportError:  # non-POSIX
    fcntl = None

__all__ = ["SharedMemoryArea"]

_HEADER = 8  # u64 notify generation counter


def _sanitize(name: str) -> str:
    # reference: must start with '/', <= 255 chars (cluon:8120-8123)
    name = name if name.startswith("/") else "/" + name
    return name[:255]


class SharedMemoryArea:
    """Named interprocess buffer. size>0 creates (owner), size=0 attaches."""

    def __init__(self, name: str, size: int = 0):
        self._name = _sanitize(name)
        self._owner = size > 0
        self._valid = False
        self._shm = None
        self._lockfd = -1
        self._lock_depth = 0   # reentrancy: flock is per-fd, not per-call
        key = self._name.strip("/").replace("/", "_")
        self._lockpath = os.path.join(tempfile.gettempdir(),
                                      f"tpuslam-shm-{key}.lock")
        try:
            if self._owner:
                self._shm = shared_memory.SharedMemory(
                    name=key, create=True, size=size + _HEADER)
                self._shm.buf[:_HEADER] = b"\0" * _HEADER
            else:
                self._shm = shared_memory.SharedMemory(name=key)
            self._lockfd = os.open(self._lockpath, os.O_CREAT | os.O_RDWR, 0o600)
            self._valid = True
        except (OSError, ValueError):
            self.close()

    # -- reference API surface -------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def size(self) -> int:
        return 0 if self._shm is None else len(self._shm.buf) - _HEADER

    def valid(self) -> bool:
        return self._valid

    @property
    def data(self) -> memoryview:
        """User-accessible region (past the header)."""
        return self._shm.buf[_HEADER:]

    def lock(self):
        """Reentrant within this handle: nested lock/unlock pairs (e.g.
        notify_all under lock, the pthread-condvar idiom the reference's
        header implies) do not release the outer hold."""
        if fcntl is not None and self._lockfd >= 0:
            if self._lock_depth == 0:
                fcntl.flock(self._lockfd, fcntl.LOCK_EX)
            self._lock_depth += 1

    def unlock(self):
        if fcntl is not None and self._lockfd >= 0 and self._lock_depth > 0:
            self._lock_depth -= 1
            if self._lock_depth == 0:
                fcntl.flock(self._lockfd, fcntl.LOCK_UN)

    def _generation(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 0)[0]

    def notify_all(self):
        """Bump the generation counter; wakes every waiter."""
        self.lock()
        try:
            struct.pack_into("<Q", self._shm.buf, 0, self._generation() + 1)
        finally:
            self.unlock()

    def wait(self, timeout: float | None = None, poll_s: float = 0.0005) -> bool:
        """Block until notify_all is called (generation changes).
        Returns False on timeout."""
        start = self._generation()
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._generation() == start:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll_s)
        return True

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._valid = False
        if self._lockfd >= 0:
            os.close(self._lockfd)
            self._lockfd = -1
        if self._shm is not None:
            try:
                self._shm.close()
            except BufferError:
                # a caller still holds a memoryview from `data`; the mapping
                # stays alive with it, but the owner must still unlink so the
                # named segment does not leak past this process
                pass
            if self._owner:
                try:
                    self._shm.unlink()
                except FileNotFoundError:
                    pass
                try:
                    os.unlink(self._lockpath)
                except FileNotFoundError:
                    pass
            self._shm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
