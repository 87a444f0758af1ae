"""The port's copies of the JAX package's pure-Python IO stack
(`tpuslam_torch.io`: messages, proto, envelope, rec, od4) against the
originals: every message type packs to the same bytes in both packages and
each decodes the other's, envelopes frame alike, and a .rec written by
either plays in the other. Then the cases of tests/test_io.py that do not
need the native codec, the ODVD tooling or the reference checkout, run on
the port's copies."""
import asyncio
import dataclasses
import io as pyio
import struct

import numpy as np
import pytest

from tpuslam.io import envelope as JE
from tpuslam.io import messages as JM
from tpuslam.io import proto as jproto
from tpuslam.io.rec import Player as JPlayer, RecWriter as JRecWriter
from tpuslam_torch.io import envelope as E
from tpuslam_torch.io import messages as M
from tpuslam_torch.io import proto
from tpuslam_torch.io.rec import Player, RecWriter, read_rec, replay_to_bus

PORT_TYPES = sorted(M.MESSAGE_REGISTRY.items())


def _sample(cls, rng, nested_of):
    """An instance of `cls` with every field set from `rng`."""
    kw = {}
    for _, kind, name, nested in cls.FIELDS:
        if kind == M.VARINT_SIGNED:
            kw[name] = int(rng.integers(-2**31, 2**31))
        elif kind == M.VARINT_UNSIGNED:
            kw[name] = int(rng.integers(0, 256))
        elif kind == M.FLOAT:
            kw[name] = float(np.float32(rng.normal(0, 100)))
        elif kind == M.DOUBLE:
            kw[name] = float(rng.normal(0, 100))
        elif kind == M.STRING:
            kw[name] = bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
        else:
            kw[name] = _sample(nested_of(nested), rng, nested_of)
    return cls(**kw)


def _twin(msg, module):
    """The same message as an instance of `module`'s class of that name."""
    cls = getattr(module, type(msg).__name__)
    kw = {}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        kw[f.name] = _twin(v, module) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _plain(msg):
    return dataclasses.asdict(msg)


def test_registries_hold_the_same_types():
    for mid, cls in PORT_TYPES:
        jcls = getattr(JM, cls.__name__)
        assert jcls.ID == mid and jcls.LONG_NAME == cls.LONG_NAME
        assert [f[:3] for f in jcls.FIELDS] == [f[:3] for f in cls.FIELDS]


@pytest.mark.parametrize("mid,cls", PORT_TYPES, ids=[c.__name__ for _, c in PORT_TYPES])
def test_message_packs_to_the_same_bytes(mid, cls):
    rng = np.random.default_rng(mid)
    for _ in range(5):
        msg = _sample(cls, rng, lambda c: c)
        jmsg = _twin(msg, JM)
        data = proto.encode(msg)
        assert data == jproto.encode(jmsg)
        assert _plain(proto.decode(cls, data)) == _plain(jproto.decode(type(jmsg), data))


def test_envelope_frames_to_the_same_bytes():
    msg = M.Geolocation(latitude=57.70716, longitude=11.93782, altitude=12.5, heading=1.25)
    env = E.pack_message(msg, sample_us=1234567, sender_stamp=114)
    env.sent = M.TimeStamp.from_micros(42)
    jenv = _twin(env, JM)
    data = E.serialize_envelope(env)
    assert data == JE.serialize_envelope(jenv)
    out, _ = JE.extract_envelope(data)
    assert _plain(out) == _plain(jenv)
    assert _plain(E.unpack_message(E.extract_envelope(data)[0])) == _plain(msg)


def _envelopes(path, player_cls):
    got = []
    player_cls(path).replay(got.append)
    return [(e.dataType, e.senderStamp, e.sampleTimeStamp.micros, e.serializedData)
            for e in got]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rec_written_by_either_plays_in_the_other(tmp_path, writer):
    path = str(tmp_path / "mixed.rec")
    rng = np.random.default_rng(3)
    mod, rec_writer = (JM, JRecWriter) if writer == "jax" else (M, RecWriter)
    with rec_writer(path) as w:
        for t in range(30):
            cls = PORT_TYPES[t % len(PORT_TYPES)][1]
            msg = _twin(_sample(cls, rng, lambda c: c), mod)
            w.write_message(msg, sample_us=int(rng.integers(0, 10**7)),
                            sender_stamp=int(rng.integers(0, 200)))
    port, jax_ = _envelopes(path, Player), _envelopes(path, JPlayer)
    assert len(port) == 30 and port == jax_
    assert [e.dataType for e in read_rec(path)] == [e.dataType for e in JE.iterate_envelopes(
        open(path, "rb").read())]


# -- tests/test_io.py's cases on the port's copies

def test_varint_zigzag_vectors():
    assert proto.zigzag_encode(0) == 0
    assert proto.zigzag_encode(-1) == 1
    assert proto.zigzag_encode(1) == 2
    assert proto.zigzag_encode(-2) == 3
    for v in (0, 1, -1, 127, 128, -300, 2 ** 31 - 1, -(2 ** 31)):
        assert proto.zigzag_decode(proto.zigzag_encode(v)) == v
    out = bytearray()
    proto.write_varint(out, 300)
    assert bytes(out) == b"\xac\x02"
    val, pos = proto.read_varint(bytes(out), 0)
    assert val == 300 and pos == 2


def test_message_roundtrip_all_types():
    msgs = [
        M.Geolocation(latitude=57.70716, longitude=11.93782, altitude=12.5, heading=1.25),
        M.ObjectDirection(objectId=7, azimuthAngle=-32.5, zenithAngle=1.5),
        M.ObjectDistance(objectId=7, distance=12.25),
        M.ObjectType(objectId=7, type=2),
        M.AngularVelocityReading(angularVelocityZ=0.42),
        M.GeodeticWgs84Reading(latitude=-33.5, longitude=151.2),
        M.GeodeticHeadingReading(northHeading=3.1),
    ]
    for m in msgs:
        back = proto.decode(type(m), proto.encode(m))
        for _, kind, name, _ in m.FIELDS:
            a, b = getattr(m, name), getattr(back, name)
            if kind == M.FLOAT:
                assert abs(a - np.float32(b)) < 1e-5, (name, a, b)
            elif kind == M.DOUBLE:
                assert abs(a - b) < 1e-12
            else:
                assert a == b, (name, a, b)


def test_wire_format_bytes():
    assert proto.encode(M.ObjectType(objectId=3, type=2)) == b"\x08\x03\x10\x02"
    assert proto.encode(M.ObjectDistance(objectId=1, distance=2.0)) == \
        b"\x08\x01\x15" + struct.pack("<f", 2.0)


def test_envelope_frame_roundtrip():
    env = E.pack_message(M.ObjectType(objectId=1, type=4), sample_us=1234567, sender_stamp=118)
    data = E.serialize_envelope(env)
    assert data[0] == 0x0D and data[1] == 0xA4
    out, _ = E.extract_envelope(b"garbage" + data + b"tail")
    assert out is not None and out.senderStamp == 118
    assert out.sampleTimeStamp.micros == 1234567
    msg = E.unpack_message(out)
    assert isinstance(msg, M.ObjectType) and msg.type == 4


def test_rec_write_read_player(tmp_path):
    path = str(tmp_path / "test.rec")
    with RecWriter(path) as w:
        for t in range(10):
            w.write_message(M.ObjectDistance(objectId=t, distance=float(t)),
                            sample_us=(10 - t) * 1000, sender_stamp=118)
    assert len(list(read_rec(path))) == 10
    times = []
    Player(path).replay(lambda e: times.append(e.sampleTimeStamp.micros))
    assert times == sorted(times) and len(times) == 10
    p2 = Player(path)
    p2.seek(0.5)
    rest = []
    p2.replay(rest.append)
    assert len(rest) == 5


def test_player_command_status_wire_format():
    pc = M.PlayerCommand(command=3, seekTo=0.5)
    data = proto.encode(pc)
    assert data == bytes([0x08, 0x03, 0x15]) + struct.pack("<f", 0.5)
    assert proto.decode(M.PlayerCommand, data) == pc
    ps = M.PlayerStatus(state=2, numberOfEntries=300, currentEntryForPlayback=7)
    data = proto.encode(ps)
    assert data == bytes([0x08, 0x02, 0x10, 0xAC, 0x02, 0x18, 0x07])
    assert proto.decode(M.PlayerStatus, data) == ps
    assert M.MESSAGE_REGISTRY[9] is M.PlayerCommand
    assert M.MESSAGE_REGISTRY[10] is M.PlayerStatus


def test_replay_to_stdout_stream(tmp_path):
    path = str(tmp_path / "sout.rec")
    with RecWriter(path) as w:
        for t in range(25):
            w.write_message(M.ObjectDistance(objectId=t, distance=1.0 * t),
                            sample_us=t * 1000, sender_stamp=7)
    out = pyio.BytesIO()
    n = asyncio.run(replay_to_bus(Player(path), od4=None, paced=False, stdout_stream=out))
    assert n == 25
    envs = list(E.iterate_envelopes(out.getvalue()))
    data = [e for e in envs if e.dataType == M.ObjectDistance.ID]
    stat = [proto.decode(M.PlayerStatus, e.serializedData) for e in envs
            if e.dataType == M.PlayerStatus.ID]
    assert len(data) == 25 and data[0].senderStamp == 7
    assert [s.state for s in stat] == [1, 2, 2, 2, 2]
    assert stat[-1].currentEntryForPlayback == 25
    assert all(s.numberOfEntries == 25 for s in stat)


def test_od4_session_loopback():
    """Two of the port's OD4 sessions on one CID exchange an envelope via
    multicast, as tests/test_io.py::test_od4_session_loopback does."""
    from tpuslam_torch.io.od4 import OD4Session

    async def run():
        rx, tx = OD4Session(cid=199), OD4Session(cid=199)
        got = []
        rx.data_trigger(M.ObjectType.ID, got.append)
        try:
            await rx.start()
            await tx.start()
        except OSError:
            pytest.skip("multicast sockets unavailable")
        for _ in range(20):
            tx.send(M.ObjectType(objectId=5, type=3), sample_us=42, sender_stamp=9)
            await asyncio.sleep(0.05)
            if got:
                break
        await rx.stop()
        await tx.stop()
        return got

    got = asyncio.run(run())
    if not got:
        pytest.skip("multicast loopback not routed on this host")
    assert got[0].senderStamp == 9
    msg = E.unpack_message(got[0])
    assert msg.objectId == 5 and msg.type == 3


def test_od4_session_stop_idempotent_and_send_after_stop():
    from tpuslam_torch.io.od4 import OD4Session

    async def scenario():
        s = OD4Session(cid=199)
        await s.start()
        assert s.running
        await s.stop()
        assert not s.running
        await s.stop()
        s.send(M.GeodeticHeadingReading(northHeading=0.5))
        return True

    assert asyncio.run(scenario())
