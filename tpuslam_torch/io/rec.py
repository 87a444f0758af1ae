""".rec recording files: write, indexed read, and paced replay. A copy of
`tpuslam.io.rec` without its native scan (`tpuslam/native/` is not
copied): `read_rec` frames envelopes in Python, with the same result.

The `.rec` format is simply a concatenation of framed envelopes; libcluon's
`Player` builds a chronological index over sample timestamps and replays with
inter-envelope delays (reference src/cluon-complete-build.hpp:7887-8108,
13280+). The replay harness is load-bearing for evals (SURVEY.md §2.2):
recorded runs replay either paced (real-time) or as-fast-as-possible into the
ingest path.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from tpuslam_torch.io import messages as M
from tpuslam_torch.io import envelope as E

__all__ = ["RecWriter", "read_rec", "RecIndex", "Player", "replay_to_bus"]


class RecWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, env: M.Envelope):
        self._f.write(E.serialize_envelope(env))

    def write_message(self, msg, sample_us: int = 0, sender_stamp: int = 0):
        self.write(E.pack_message(msg, sample_us, sender_stamp))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_rec(path: str) -> Iterator[M.Envelope]:
    """Stream envelopes from a .rec file."""
    with open(path, "rb") as f:
        buf = f.read()
    yield from E.iterate_envelopes(buf)


@dataclass
class RecIndex:
    """Chronological index over sample timestamps (Player's initializeIndex,
    reference src/cluon-complete-build.hpp:7962)."""
    envelopes: list
    order: list  # indices sorted by sampleTimeStamp

    @classmethod
    def build(cls, path: str) -> "RecIndex":
        envs = list(read_rec(path))
        order = sorted(range(len(envs)),
                       key=lambda i: envs[i].sampleTimeStamp.micros)
        return cls(envelopes=envs, order=order)

    def __len__(self):
        return len(self.envelopes)


class Player:
    """Chronological replay with pacing, seek, and auto-rewind."""

    def __init__(self, path: str, auto_rewind: bool = False):
        self.index = RecIndex.build(path)
        self.auto_rewind = auto_rewind
        self._cursor = 0

    def __len__(self):
        return len(self.index)

    @property
    def has_more(self) -> bool:
        return self._cursor < len(self.index) or \
            (self.auto_rewind and len(self.index) > 0)

    def seek(self, ratio: float):
        """Jump to a fraction of the recording (Player::seekTo,
        reference src/cluon-complete-build.hpp:7946)."""
        self._cursor = max(0, min(len(self.index),
                                  int(ratio * len(self.index))))

    def next_envelope(self) -> Optional[M.Envelope]:
        if self._cursor >= len(self.index):
            if not self.auto_rewind or not self.index.order:
                return None
            self._cursor = 0
        env = self.index.envelopes[self.index.order[self._cursor]]
        self._cursor += 1
        return env

    def delay_us(self) -> int:
        """Microseconds until the next envelope relative to the current one."""
        i = self._cursor
        if i <= 0 or i >= len(self.index):
            return 0
        prev = self.index.envelopes[self.index.order[i - 1]].sampleTimeStamp.micros
        nxt = self.index.envelopes[self.index.order[i]].sampleTimeStamp.micros
        return max(0, nxt - prev)

    def replay(self, sink: Callable[[M.Envelope], None], paced: bool = False,
               speedup: float = 1.0):
        """Push the whole recording into `sink`, optionally real-time paced."""
        while True:
            env = self.next_envelope()
            if env is None:
                return
            sink(env)
            if paced:
                d = self.delay_us()
                if d:
                    time.sleep(d / 1e6 / speedup)
            if self._cursor >= len(self.index) and not self.auto_rewind:
                return


async def replay_to_bus(player: Player, od4=None, paced: bool = True,
                        speedup: float = 1.0, status_every: int = 10,
                        stdout_stream=None, command_stream=None):
    """Publish a recording onto an OD4 bus and/or a byte stream,
    remote-controlled like the cluon-replay tool (reference
    src/cluon-complete-build.hpp:15863-16054):

    - obeys `PlayerCommand` [9] — command 1=play, 2=pause, 3=seekTo(ratio)
      (:16020-16033) — from the bus, or from framed envelopes on
      `command_stream` (the tool's stdin-monitoring thread, :15912-15924;
      like the reference, bus commands are ignored while a command stream
      is monitored);
    - reports `PlayerStatus` [10]: state=1 while loading (:15939), state=2
      with numberOfEntries once playing (:15968-15970), then progress every
      `status_every` replayed envelopes (the Player's statisticsCounter%10
      cadence, :13600-13618);
    - while paused it idles at 100 ms ticks (:16050);
    - envelopes are re-published verbatim (original timestamps) to the bus
      and/or serialized to `stdout_stream` (playBackToStdout, :15877).
    """
    import asyncio
    import threading

    from tpuslam_torch.io import proto

    playing = True
    pending_seek: list[float] = []

    def on_command(env: M.Envelope):
        nonlocal playing
        pc = proto.decode(M.PlayerCommand, env.serializedData)
        if pc.command in (1, 2):
            playing = pc.command == 1
        elif pc.command == 3:
            pending_seek.append(pc.seekTo)

    if command_stream is not None:
        def watch_stdin():
            buf = b""
            while True:
                chunk = command_stream.read(64)
                if not chunk:
                    return
                buf += chunk
                while True:
                    env, pos = E.extract_envelope(buf)
                    if env is None:
                        break
                    buf = buf[pos:]
                    if env.dataType == M.PlayerCommand.ID:
                        on_command(env)

        threading.Thread(target=watch_stdin, daemon=True).start()
    elif od4 is not None:
        od4.data_trigger(M.PlayerCommand.ID, on_command)

    def emit(env: M.Envelope):
        if od4 is not None:
            od4.send_envelope(env)
        if stdout_stream is not None:
            stdout_stream.write(E.serialize_envelope(env))
            stdout_stream.flush()

    def status(state: int, current: int):
        ps = M.PlayerStatus(state=state, numberOfEntries=len(player),
                            currentEntryForPlayback=current)
        emit(E.pack_message(ps, sample_us=int(time.time() * 1e6)))

    status(1, 0)  # loading
    status(2, 0)  # playback starts
    replayed = 0
    while player.has_more:
        if pending_seek:
            player.seek(pending_seek.pop())
            pending_seek.clear()
        if not playing:
            await asyncio.sleep(0.1)
            continue
        env = player.next_envelope()
        if env is None:
            break
        emit(env)
        replayed += 1
        if status_every and replayed % status_every == 0:
            status(2, replayed)
        if paced:
            d = player.delay_us()
            if d:
                await asyncio.sleep(d / 1e6 / speedup)
        if player._cursor >= len(player.index) and not player.auto_rewind:
            break
    status(2, replayed)
    return replayed
