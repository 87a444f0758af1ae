"""TCP transport: connection + server with cluon-style delegates.

A copy of `tpuslam.io.tcp` (pure Python), so that the port imports nothing of
the JAX package.

Equivalent of libcluon's `TCPConnection`/`TCPServer` (reference
src/cluon-complete-build.hpp:5421+; impl :9531+): a connection delivers
received byte chunks to a new-data delegate together with a receive
timestamp and reports loss via a connection-lost delegate; a server hands
each accepted connection (with its peer "ip:port" string) to a
new-connection delegate. The reference runs one reader thread per
connection; here a single asyncio loop owns all sockets (same
single-owner model as tpuslam_torch.io.od4).

Not used by the OD4 bus (that is UDP multicast) — this is the ops/bridge
transport, e.g. streaming `.rec` envelopes to a remote monitor. Envelope
framing from tpuslam_torch.io.envelope applies unchanged on a TCP stream.
"""
from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Optional

__all__ = ["TCPConnection", "TCPServer"]

NewDataDelegate = Callable[[bytes, int], None]      # (chunk, recv_time_us)
ConnectionLost = Callable[[], None]


class TCPConnection:
    """A client or accepted TCP stream with delegate-based receive."""

    def __init__(self,
                 on_data: Optional[NewDataDelegate] = None,
                 on_connection_lost: Optional[ConnectionLost] = None):
        self.on_data = on_data
        self.on_connection_lost = on_connection_lost
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pump: Optional[asyncio.Task] = None
        self._running = False

    @property
    def is_running(self) -> bool:
        return self._running

    async def connect(self, host: str, port: int):
        self._reader, self._writer = await asyncio.open_connection(host, port)
        self._start()

    def adopt(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        """Wrap an accepted server-side stream (used by TCPServer)."""
        self._attach(reader, writer)
        self._start_pump()

    def _attach(self, reader, writer):
        """Make the connection sendable (is_running, send) without starting
        the read pump — TCPServer attaches before invoking the delegate so
        a delegate-time send works, and starts the pump after the delegate
        has had the chance to set on_data."""
        self._reader, self._writer = reader, writer
        self._running = True

    def _start(self):
        self._running = True
        self._start_pump()

    def _start_pump(self):
        self._pump = asyncio.get_running_loop().create_task(self._read_loop())

    async def _read_loop(self):
        try:
            while True:
                chunk = await self._reader.read(65535)
                if not chunk:
                    break
                if self.on_data is not None:
                    self.on_data(chunk, time.time_ns() // 1000)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            was_running, self._running = self._running, False
            if was_running and self.on_connection_lost is not None:
                self.on_connection_lost()

    def send(self, data: bytes) -> int:
        """Queue bytes for send; returns len(data), or -1 if not connected
        (mirrors the reference's byte-count/errno contract)."""
        if not self._running or self._writer is None:
            return -1
        self._writer.write(data)
        return len(data)

    async def drain(self):
        if self._writer is not None:
            await self._writer.drain()

    async def stop(self):
        self._running = False
        if self._pump is not None:
            self._pump.cancel()
            try:
                await self._pump
            except asyncio.CancelledError:
                pass
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class TCPServer:
    """Accepts connections and hands (peer "ip:port", TCPConnection) to the
    delegate, like the reference's newConnectionDelegate."""

    def __init__(self, on_connection: Callable[[str, TCPConnection],
                                               Optional[Awaitable[None]]]):
        self.on_connection = on_connection
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: list[TCPConnection] = []

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    @property
    def is_running(self) -> bool:
        return self._server is not None and self._server.is_serving()

    async def start(self, port: int = 0, host: str = "127.0.0.1"):
        async def handler(reader, writer):
            peer = writer.get_extra_info("peername")
            conn = TCPConnection()
            self._conns.append(conn)
            conn._attach(reader, writer)   # delegate can send immediately
            res = self.on_connection(f"{peer[0]}:{peer[1]}", conn)
            if asyncio.iscoroutine(res):
                await res
            conn._start_pump()             # on_data is set; start delivering

        self._server = await asyncio.start_server(handler, host, port)

    async def stop(self):
        for c in self._conns:
            await c.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
