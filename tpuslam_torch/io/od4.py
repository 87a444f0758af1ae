"""OD4 session: UDP-multicast pub/sub bus, asyncio-native.

The reference's cluon::OD4Session joins multicast group `225.0.0.<CID>` port
12175, runs a select()-driven socket thread feeding a condition-variable
pipeline thread, filters self-sent datagrams, and dispatches per-message-ID
delegates (reference src/cluon-complete-build.hpp:7753-7845, 9129-9530,
12779-12875). Here the same semantics are a single asyncio task + queue: the
datagram callback enqueues, one consumer drains to the delegates — same
decoupling, no threads, no mutexes.

A copy of `tpuslam.io.od4`. With `native=True` (default: auto) the socket
path runs in the native C++ endpoint (tpuslam_torch/native/od4recv.cpp,
built with g++ on first use into `tpuslam_torch/build/native/`; the analogue
of the reference's native UDPReceiver thread, with kernel RX timestamps and
self-send filtering in C), drained in batches by one asyncio task; the
dispatch semantics are identical either way.
"""
from __future__ import annotations

import asyncio
import socket
import struct
from typing import Callable, Dict, Optional

from tpuslam_torch.io import messages as M
from tpuslam_torch.io import envelope as E

__all__ = ["OD4Session"]

OD4_PORT = 12175


def multicast_group(cid: int) -> str:
    return f"225.0.0.{cid}"


class OD4Session:
    """Asyncio OD4 bus endpoint with cluon-compatible wire format."""

    def __init__(self, cid: int, interface: str = "0.0.0.0",
                 native: Optional[bool] = None):
        self.cid = cid
        self.group = multicast_group(cid)
        self.interface = interface
        self._delegates: Dict[int, Callable] = {}
        self._catch_all: Optional[Callable] = None
        self._transport = None
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=4096)
        self._consumer_task = None
        self._pump_task = None
        self._local_addr = None
        self._native_ep = None
        self._want_native = native
        self.running = False

    # ------------------------------------------------------------- delegates
    def data_trigger(self, data_type: int, fn: Callable):
        """Register a per-message-ID delegate (OD4Session::dataTrigger)."""
        self._delegates[data_type] = fn

    def catch_all(self, fn: Callable):
        self._catch_all = fn

    # ---------------------------------------------------------------- socket
    def _make_socket(self) -> socket.socket:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except OSError:
                pass
        sock.bind((self.interface, OD4_PORT))
        mreq = struct.pack("4s4s", socket.inet_aton(self.group),
                           socket.inet_aton("0.0.0.0"))
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        sock.setblocking(False)
        return sock

    def _enqueue_datagram(self, data: bytes, recv_us: int):
        pos = 0
        while True:
            env, pos = E.extract_envelope(data, pos)
            if env is None:
                break
            env.received = M.TimeStamp.from_micros(recv_us)
            try:
                self._queue.put_nowait(env)
            except asyncio.QueueFull:
                pass  # shed load like a full kernel socket buffer

    async def _pump_native(self):
        """Batch-drain the native ring buffer into the dispatch queue. The
        blocking wait runs in the default executor with the GIL released."""
        loop = asyncio.get_running_loop()
        while True:
            n = await loop.run_in_executor(None, self._native_ep.wait, 0.05)
            if n <= 0:
                continue
            for data, recv_us in self._native_ep.drain():
                self._enqueue_datagram(data, recv_us)

    async def start(self):
        loop = asyncio.get_running_loop()
        if self._want_native is not False:
            try:
                # library load may compile C++ on first use — keep it off
                # the event loop thread
                from tpuslam_torch.native.receiver import NativeOD4Endpoint
                self._native_ep = await loop.run_in_executor(
                    None, lambda: NativeOD4Endpoint(
                        self.cid, interface=self.interface))
            except Exception:
                if self._want_native is True:
                    raise
                self._native_ep = None
        if self._native_ep is not None:
            self._pump_task = asyncio.create_task(self._pump_native())
            self._consumer_task = asyncio.create_task(self._consume())
            self.running = True
            return
        sock = self._make_socket()

        class _Proto(asyncio.DatagramProtocol):
            def __init__(p):
                p.buffer = b""

            def datagram_received(p, data, addr):
                # self-sent filtering (reference cluon :9507-9513)
                if addr == self._local_addr:
                    return
                self._enqueue_datagram(data, E.now_us())

        self._transport, _ = await loop.create_datagram_endpoint(
            _Proto, sock=sock)
        self._local_addr = self._transport.get_extra_info("sockname")
        self._consumer_task = asyncio.create_task(self._consume())
        self.running = True

    async def _consume(self):
        """Pipeline drain: queue -> delegate dispatch (cluon :12842-12863)."""
        while True:
            env = await self._queue.get()
            fn = self._delegates.get(env.dataType)
            try:
                if fn is not None:
                    fn(env)
                elif self._catch_all is not None:
                    self._catch_all(env)
            except Exception:  # delegate errors must not kill the bus
                pass

    def send(self, msg, sample_us: int = 0, sender_stamp: int = 0):
        """Serialize + multicast one message (OD4Session::send)."""
        env = E.pack_message(msg, sample_us, sender_stamp)
        return self.send_envelope(env)

    def send_envelope(self, env):
        """Multicast an already-built envelope verbatim (cluon's
        OD4Session::send(Envelope&&) used by cluon-replay to re-publish
        recorded envelopes with their original timestamps, reference
        src/cluon-complete-build.hpp:16037-16040)."""
        data = E.serialize_envelope(env)
        if self._native_ep is not None:
            self._native_ep.send(data)
        elif self._transport is not None:
            self._transport.sendto(data, (self.group, OD4_PORT))
        return env

    async def time_trigger(self, freq_hz: float, fn: Callable[[], bool]):
        """Rate-limited loop (OD4Session::timeTrigger, cluon :12794-12821):
        calls fn at freq_hz until it returns False."""
        period = 1.0 / freq_hz
        while True:
            t0 = asyncio.get_running_loop().time()
            if not fn():
                return
            dt = asyncio.get_running_loop().time() - t0
            await asyncio.sleep(max(0.0, period - dt))

    async def stop(self):
        self.running = False
        if self._pump_task:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
            self._pump_task = None
        if self._consumer_task:
            self._consumer_task.cancel()
        if self._transport:
            self._transport.close()
        if self._native_ep is not None:
            ep, self._native_ep = self._native_ep, None
            ep.close()
