"""The port's operational tooling against the JAX package's, module by
module, on the same inputs: the MsgPack / LCM codecs, the ODVD parser and
emitter, the vendored standard message set, the msc code generator, the JSON
codec and envelope converter, TCP and shared memory (tests/test_codecs.py,
tests/test_io.py:26-72 and :154-226); the native C++ codec and OD4 endpoint
(tests/test_io.py:227-260 and :317-390) and its ThreadSanitizer gate
(tests/test_native_tsan.py); the VLP-16 calibration
(tests/test_perception.py:375-420); the OpenDaVINCI configuration layer
(tests/test_aux.py:67-); tracing on torch.profiler (tests/test_aux.py:30-48).

The two packages' message classes are different Python classes, so outputs
are compared as bytes, text or plain values, never as objects. Cases that
need multicast skip where the host does not route it, as the originals
do."""
import asyncio
import dataclasses
import glob
import json
import os
import struct
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch

from tests.test_torch_io import _sample, _twin
from tpuslam.io import codecs as jcodecs
from tpuslam.io import messages as JM
from tpuslam.io import odvd as jodvd
from tpuslam.io import standard_message_set as JSMS
from tpuslam_torch.io import codecs
from tpuslam_torch.io import envelope as E
from tpuslam_torch.io import messages as M
from tpuslam_torch.io import proto
from tpuslam_torch.io import standard_message_set as SMS
from tpuslam_torch.io.odvd import load_standard_message_set, message_to_odvd, parse_odvd
from tpuslam_torch.io.rec import RecWriter, read_rec
from tpuslam_torch.io.shm import SharedMemoryArea
from tpuslam_torch.io.tcp import TCPConnection, TCPServer

ODVD = os.path.join(os.path.dirname(SMS.__file__), "opendlv_standard_message_set.odvd")
JODVD = os.path.join(os.path.dirname(JSMS.__file__), "opendlv_standard_message_set.odvd")
PORT_TYPES = sorted(M.MESSAGE_REGISTRY.items())
TYPE_IDS = [c.__name__ for _, c in PORT_TYPES]
CODEC_MESSAGES = [
    M.Geolocation(latitude=57.70716, longitude=11.93782, altitude=12.5, heading=1.25),
    M.ObjectDirection(objectId=7, azimuthAngle=-32.5, zenithAngle=1.5),
    M.ObjectDistance(objectId=300, distance=12.25),
    M.ObjectType(objectId=70000, type=2),
    M.AngularVelocityReading(angularVelocityZ=-0.42),
    M.GeodeticWgs84Reading(latitude=-33.5, longitude=151.2),
    M.TimeStamp(seconds=-5, microseconds=123456),
    M.Envelope(dataType=1116, serializedData=b"\x01\x02",
               sent=M.TimeStamp(seconds=1, microseconds=2), senderStamp=114),
]


def _run_name(tag):
    """A shared-memory name of this run alone: every checkout on the host
    shares /dev/shm."""
    return f"/tpuslam-torch-test-{tag}-{os.getpid()}-{uuid.uuid4().hex[:8]}"


def _run_stamp():
    """A sender stamp of this run alone (the bus is the host's), 1 .. 2**31 - 1."""
    return 1 + (os.getpid() * 7919 + uuid.uuid4().int) % (2 ** 31 - 1)


def _plain(msg):
    return dataclasses.asdict(msg)


def _spec_key(specs):
    return [(s.name, s.ident, s.fields, s.odvd_types) for s in specs]


# ---------------------------------------------------------------------------
# MsgPack and LCM (tests/test_codecs.py:23-171)

@pytest.mark.parametrize("msg", CODEC_MESSAGES, ids=lambda m: type(m).__name__)
def test_msgpack_and_lcm_bytes_equal_jax(msg):
    jmsg = _twin(msg, JM)
    data = codecs.to_msgpack(msg)
    assert data == jcodecs.to_msgpack(jmsg)
    assert _plain(codecs.from_msgpack(type(msg), data)) == \
        _plain(jcodecs.from_msgpack(type(jmsg), data))
    assert codecs.msgpack_to_dict(data) == jcodecs.msgpack_to_dict(data)
    lcm = codecs.to_lcm(msg)
    assert lcm == jcodecs.to_lcm(jmsg)
    assert codecs.to_lcm(msg, with_hash=False) == lcm[8:]
    assert _plain(codecs.from_lcm(type(msg), lcm)) == _plain(jcodecs.from_lcm(type(jmsg), lcm))


@pytest.mark.parametrize("mid,cls", PORT_TYPES, ids=TYPE_IDS)
def test_random_messages_encode_alike_in_both_codecs(mid, cls):
    """Every registered type, fields drawn at random: the same MsgPack and
    LCM bytes and type hash as the JAX package's, and each decodes the
    other's."""
    rng = np.random.default_rng(100 + mid)
    jcls = getattr(JM, cls.__name__)
    assert codecs.lcm_hash(cls) == jcodecs.lcm_hash(jcls)
    for _ in range(3):
        msg = _sample(cls, rng, lambda c: c)
        jmsg = _twin(msg, JM)
        for enc, dec, jenc, jdec in ((codecs.to_msgpack, codecs.from_msgpack,
                                      jcodecs.to_msgpack, jcodecs.from_msgpack),
                                     (codecs.to_lcm, codecs.from_lcm,
                                      jcodecs.to_lcm, jcodecs.from_lcm)):
            data = enc(msg)
            assert data == jenc(jmsg)
            assert _plain(dec(cls, data)) == _plain(jdec(jcls, data))


def test_msgpack_wire_layout_and_width_promotion():
    """The cluon ToMsgPackVisitor layout (reference
    src/cluon-complete-build.hpp:12505-12700) and encodeUint / encodeInt's
    width steps (:12549-12608), byte for byte as the JAX package's."""
    buf = codecs.to_msgpack(M.ObjectDistance(objectId=3, distance=12.25))
    assert buf == bytes([0x82, 0xA8]) + b"objectId" + bytes([3, 0xA8]) + b"distance" + \
        bytes([0xCA]) + struct.pack(">f", 12.25)
    for v, tag in [(0x7F, None), (0x80, 0xCC), (0x100, 0xCD), (0x10000, 0xCE),
                   (0x100000000, 0xCF)]:
        m = M.ObjectType(objectId=v, type=0)
        buf = codecs.to_msgpack(m)
        assert buf == jcodecs.to_msgpack(_twin(m, JM))
        assert buf[1 + 1 + len("objectId")] == (v if tag is None else tag)
        assert codecs.from_msgpack(M.ObjectType, buf).objectId == v
    for v in (-1, -31, -32, -129, -(1 << 16), -(1 << 40)):
        buf = codecs.to_msgpack(M.TimeStamp(seconds=v))
        assert buf == jcodecs.to_msgpack(JM.TimeStamp(seconds=v))
        assert codecs.from_msgpack(M.TimeStamp, buf).seconds == v


def test_lcm_layout_hash_and_strings():
    """Big-endian declaration-order fields after the 8-byte hash (reference
    :12195-12327), the hash recurrence (:12331-12343) stepped by hand, a
    wrong type refused, strings NUL-terminated."""
    buf = codecs.to_lcm(M.ObjectType(objectId=5, type=2))
    assert buf[8:] == struct.pack(">II", 5, 2)
    with pytest.raises(ValueError, match="hash mismatch"):
        codecs.from_lcm(M.ObjectDistance, buf)

    def step(h, c):
        h = (((h << 8) ^ (h >> 55)) + c) & ((1 << 64) - 1)
        return h - (1 << 64) if h >= (1 << 63) else h

    h = 0x12345678
    for s in ("northHeading", "float"):
        h = step(h, min(len(s), 255))
        for ch in s:
            h = step(h, ord(ch))
    h = step(h, 0)
    want = ((h << 1) + ((h >> 63) & 1)) & ((1 << 64) - 1)
    want = want - (1 << 64) if want >= (1 << 63) else want
    assert codecs.lcm_hash(M.GeodeticHeadingReading) == want
    env = M.Envelope(dataType=1, serializedData=b"ab")
    buf = codecs.to_lcm(env, with_hash=False)
    assert buf[:11] == struct.pack(">i", 1) + struct.pack(">i", 3) + b"ab\0"
    back = codecs.from_lcm(M.Envelope, buf, with_hash=False)
    assert back.serializedData == b"ab" and back.sent.seconds == 0


def test_lcm_to_generic_via_runtime_spec():
    spec = {s.name: s for s in SMS.to_specs()}["opendlv.logic.sensation.Geolocation"]
    jspec = {s.name: s for s in JSMS.to_specs()}["opendlv.logic.sensation.Geolocation"]
    buf = codecs.to_lcm(M.Geolocation(latitude=57.7, longitude=11.9, altitude=2.0,
                                      heading=0.25))
    g, jg = codecs.lcm_to_generic(spec, buf), jcodecs.lcm_to_generic(jspec, buf)
    assert (g.dataType, g.values) == (jg.dataType, jg.values)
    assert g.dataType == 1116 and abs(g.values["latitude"] - 57.7) < 1e-12


# ---------------------------------------------------------------------------
# ODVD, the standard set and msc (tests/test_codecs.py:174-202,
# tests/test_io.py:26-72, :154-226)

@pytest.mark.parametrize("mid,cls", PORT_TYPES, ids=TYPE_IDS)
def test_odvd_emitter_equals_jax_and_roundtrips(mid, cls):
    text = message_to_odvd(cls)
    assert text == jodvd.message_to_odvd(getattr(JM, cls.__name__))
    assert _spec_key(parse_odvd(text)) == _spec_key(jodvd.parse_odvd(text))
    own = parse_odvd(text)[-1]
    assert (own.ident, own.name) == (cls.ID, cls.LONG_NAME)
    # the parser keeps the scalar fields; a nested message is declared first
    assert [f[:3] for f in own.fields] == [f[:3] for f in cls.FIELDS if f[1] != M.MESSAGE]
    for _, kind, name, nested in cls.FIELDS:
        if kind == M.MESSAGE:
            assert text.index(f"message {nested.LONG_NAME}") < text.index(
                f"message {cls.LONG_NAME}")
            assert f"{nested.LONG_NAME} {name} [ id = " in text


def test_vendored_standard_set_equals_jax():
    assert open(ODVD).read() == open(JODVD).read()
    assert SMS.STANDARD_MESSAGES == JSMS.STANDARD_MESSAGES
    assert len(SMS.STANDARD_MESSAGES) == 62
    text = SMS.standard_odvd_text()
    assert text == JSMS.standard_odvd_text()
    assert _spec_key(parse_odvd(text)) == _spec_key(parse_odvd(open(ODVD).read())) == \
        _spec_key(jodvd.parse_odvd(open(JODVD).read()))
    assert _spec_key(SMS.to_specs()) == _spec_key(JSMS.to_specs())
    table = {n: (i, f) for n, i, f in SMS.STANDARD_MESSAGES}
    for cls in M.MESSAGE_REGISTRY.values():
        if getattr(cls, "LONG_NAME", "") in table:
            ident, fields = table[cls.LONG_NAME]
            assert ident == cls.ID
            assert [(f[2], f[0]) for f in cls.FIELDS] == [(fn, fi) for fn, fi, _ in fields]
    before = dict(M.MESSAGE_REGISTRY)
    try:
        assert len(SMS.build_classes(register=False)) == 62
        SMS.build_classes(register=True)
        assert M.MESSAGE_REGISTRY[M.ObjectDirection.ID] is M.ObjectDirection
        assert 1002 in M.MESSAGE_REGISTRY
    finally:
        M.MESSAGE_REGISTRY.clear()
        M.MESSAGE_REGISTRY.update(before)
    kin = load_standard_message_set(ODVD, register=False)[
        "opendlv.logic.sensation.Equilibrioception"]
    assert abs(proto.decode(kin, proto.encode(kin(vx=1.5))).vx - 1.5) < 1e-6


def test_msc_source_equals_jax_but_its_import_line(tmp_path):
    """The generated module names the port's messages module and is
    otherwise the JAX package's text; its classes are byte-identical on the
    wire to the port's hand-written ones."""
    import importlib.util

    from tpuslam.io.msc import generate_python_source as jgenerate
    from tpuslam_torch.io.msc import generate_python_module, generate_python_source

    text = open(ODVD).read()
    src, jsrc = generate_python_source(text, ODVD), jgenerate(text, ODVD)
    ours = "from tpuslam_torch.io import messages as _M"
    theirs = "from tpuslam.io import messages as _M"
    assert src.splitlines().count(ours) == 1 and ours not in jsrc
    assert src.replace(ours, theirs) == jsrc
    out = tmp_path / "gen_messages.py"
    assert generate_python_module(ODVD, str(out)) > 50
    spec = importlib.util.spec_from_file_location("gen_messages", out)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    for hand in (M.ObjectDirection(objectId=7, azimuthAngle=12.5, zenithAngle=-3.25),
                 M.Geolocation(latitude=57.71, longitude=11.94, heading=1.25),
                 M.GeodeticWgs84Reading(latitude=57.0, longitude=-11.0),
                 M.AngularVelocityReading(angularVelocityZ=0.5)):
        g = gen.BY_ID[hand.ID](**_plain(hand))
        assert proto.encode(g) == proto.encode(hand)
        assert proto.decode(type(g), proto.encode(hand)) == g
    assert gen.opendlv.proxy.GeodeticWgs84Reading.ID == 19
    assert gen.register_all(registry={})[M.ObjectDirection.ID].LONG_NAME == \
        M.ObjectDirection.LONG_NAME
    assert gen.register_all()[M.ObjectDirection.ID] is M.ObjectDirection


# ---------------------------------------------------------------------------
# JSON codec and envelope converter (tests/test_codecs.py:301-334)

def test_json_codec_and_envelope_converter_equal_jax():
    from tpuslam.io import exporters as JX
    from tpuslam.io import proto as jproto
    from tpuslam_torch.io import exporters as X
    for msg in CODEC_MESSAGES:
        jmsg = _twin(msg, JM)
        text = X.message_to_json(msg)
        assert text == JX.message_to_json(jmsg)
        assert _plain(X.message_from_json(type(msg), text)) == \
            _plain(JX.message_from_json(type(jmsg), text))
    geo = M.Geolocation(latitude=57.7, longitude=11.9, altitude=3.0, heading=0.5)
    assert X.message_from_json(M.Geolocation, X.message_to_json(geo)) == geo
    partial = X.message_from_json(M.ObjectType, '{"type": 2, "bogus": 1}')
    assert (partial.type, partial.objectId) == (2, 0)
    env = E.pack_message(M.ObjectDistance(objectId=4, distance=9.5), sample_us=123456,
                         sender_stamp=118)
    jenv = jproto.decode(JM.Envelope, proto.encode(env))     # the same `sent` stamp
    d = X.envelope_to_dict(env)
    assert json.dumps(d, sort_keys=True, default=str) == \
        json.dumps(JX.envelope_to_dict(jenv), sort_keys=True, default=str)
    back = X.envelope_from_dict(d)
    assert proto.encode(back) == proto.encode(env)
    m = E.unpack_message(back)
    assert m.objectId == 4 and abs(m.distance - 9.5) < 1e-6


# ---------------------------------------------------------------------------
# TCP (tests/test_codecs.py:205-250, :354-373), across the two packages

@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_tcp_loopback_delegates_and_connection_lost(client_pkg):
    from tpuslam.io import tcp as jtcp
    client_cls = TCPConnection if client_pkg == "port" else jtcp.TCPConnection

    async def run():
        got_server, got_client, conns = [], [], []
        lost = asyncio.Event()

        def on_conn(peer, conn):
            assert conn.is_running
            assert conn.send(b"greet") == 5
            conn.on_data = lambda b, ts: got_server.append(b)
            conns.append(conn)

        server = TCPServer(on_conn)
        await server.start()
        client = client_cls(on_data=lambda b, ts: got_client.append(b),
                            on_connection_lost=lost.set)
        await client.connect("127.0.0.1", server.port)
        assert client.send(b"hello") == 5
        await client.drain()
        for _ in range(200):
            if got_server and b"".join(got_client) == b"greet":
                break
            await asyncio.sleep(0.01)
        conns[0].send(b"world")
        await conns[0].drain()
        for _ in range(200):
            if b"".join(got_client) == b"greetworld":
                break
            await asyncio.sleep(0.01)
        await server.stop()
        await asyncio.wait_for(lost.wait(), 5)
        assert client.send(b"x") == -1 or not client.is_running
        await client.stop()
        return b"".join(got_server), b"".join(got_client)

    assert asyncio.run(run()) == (b"hello", b"greetworld")


# ---------------------------------------------------------------------------
# Shared memory (tests/test_codecs.py:253-298, :376-385), across packages

def test_shared_memory_same_process_and_lock_depth():
    from tpuslam.io.shm import SharedMemoryArea as JArea
    name = _run_name("a")
    with SharedMemoryArea(name, size=64) as shm:
        assert shm.valid() and shm.size == 64 and shm.name == name
        shm.lock()
        shm.data[:5] = b"hello"
        shm.notify_all()                  # nested lock/unlock inside
        assert shm._lock_depth == 1
        shm.unlock()
        assert shm._lock_depth == 0
        with JArea(name) as reader:     # the JAX package attaches
            assert reader.valid() and reader.size == 64
            assert bytes(reader.data[:5]) == b"hello"
        assert not shm.wait(timeout=0.05)


def test_shared_memory_cross_process_notify():
    """The JAX package's area here, the port's in a producer subprocess:
    the subprocess writes, notifies; this process wakes and reads."""
    from tpuslam.io.shm import SharedMemoryArea as JArea
    name = _run_name("b")
    with JArea(name, size=32) as shm:
        code = textwrap.dedent("""
            import sys
            from tpuslam_torch.io.shm import SharedMemoryArea
            shm = SharedMemoryArea(sys.argv[1])
            assert shm.valid()
            shm.lock(); shm.data[:4] = b"PING"; shm.unlock()
            shm.notify_all()
            shm.close()
        """)
        proc = subprocess.Popen([sys.executable, "-c", code, name])
        try:
            assert shm.wait(timeout=20.0), "notify never arrived"
            assert bytes(shm.data[:4]) == b"PING"
        finally:
            assert proc.wait(timeout=20) == 0


# ---------------------------------------------------------------------------
# The native codec and OD4 endpoint (tests/test_io.py:227-260, :317-390)

def _rec_bytes(path):
    with RecWriter(path) as w:
        for t in range(50):
            w.write_message(M.ObjectDirection(objectId=t % 7, azimuthAngle=t * 0.5,
                                              zenithAngle=-1.0),
                            sample_us=t * 100, sender_stamp=118)
    buf = open(path, "rb").read()
    end = buf.find(b"\x0d\xa4", len(buf) // 2)       # garbage mid-stream
    return buf[:end] + b"\xde\xad\xbe\xef" + buf[end:]


def test_native_codec_equals_python_and_jax(tmp_path):
    from tpuslam.native import codec as jcodec
    from tpuslam_torch.native import _build, codec
    if not codec.available():
        pytest.skip("native codec not built (no compiler?)")
    lib = _build.output_path("libod4codec.so")
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-3:] == ("tpuslam_torch", "build", "native")
    buf = _rec_bytes(str(tmp_path / "n.rec"))
    hdr = codec.decode_headers(buf)
    assert len(hdr["data_type"]) == 50 and set(hdr["data_type"].tolist()) == {1133}
    assert hdr["sender_stamp"].tolist() == [118] * 50
    assert hdr["sample_us"].tolist() == [t * 100 for t in range(50)]
    ids, vals = codec.decode_cones(buf, hdr["payload_off"], hdr["payload_len"], 1133)
    assert ids.tolist() == [t % 7 for t in range(50)]
    np.testing.assert_allclose(vals[:, 0], [t * 0.5 for t in range(50)], atol=1e-5)
    np.testing.assert_allclose(vals[:, 1], -1.0, atol=1e-6)
    py = list(E.iterate_envelopes(buf))
    assert [proto.encode(proto.decode(M.Envelope, buf[o:o + n]))
            for o, n in codec.scan_frames(buf)] == [proto.encode(e) for e in py]
    if jcodec.available():
        jh = jcodec.decode_headers(buf)
        for k in hdr:
            np.testing.assert_array_equal(hdr[k], jh[k], err_msg=k)
        jids, jvals = jcodec.decode_cones(buf, jh["payload_off"], jh["payload_len"], 1133)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(vals, jvals)
    # read_rec takes the native scan: the same envelopes as the Python framing
    path = str(tmp_path / "g.rec")
    open(path, "wb").write(buf)
    assert [proto.encode(e) for e in read_rec(path)] == [proto.encode(e) for e in py]


def test_od4_session_native_interop_and_self_send_filter():
    """Native endpoints exchange envelopes with pure-Python ones both ways
    and never receive their own datagrams; `native=True` really takes the
    native path. Every OD4 socket on the host binds port 12175, so every
    session on the host hears these: the messages are of types no other
    test triggers on, and carry sender stamps drawn for this run, by which
    each receiver keeps only its own."""
    from tpuslam_torch.io.od4 import OD4Session
    from tpuslam_torch.native import receiver as nat
    if not nat.available():
        pytest.skip("native receiver library unavailable")
    base = _run_stamp() % (2 ** 31 - 4)
    py_stamp, native_stamp, self_stamp = base + 1, base + 2, base + 3

    def keep(got, stamp):
        return lambda env: got.append(env) if env.senderStamp == stamp else None

    async def run():
        rx_native = OD4Session(cid=196, native=True)
        tx_python = OD4Session(cid=196, native=False)
        rx_python = OD4Session(cid=196, native=False)
        tx_native = OD4Session(cid=196, native=True)
        got_native, got_python, own = [], [], []
        rx_native.data_trigger(M.GeodeticWgs84Reading.ID, keep(got_native, py_stamp))
        rx_python.data_trigger(M.AngularVelocityReading.ID, keep(got_python, native_stamp))
        tx_native.catch_all(keep(own, self_stamp))
        sessions = (rx_native, tx_python, rx_python, tx_native)
        try:
            for s in sessions:
                await s.start()
        except OSError:
            pytest.skip("multicast sockets unavailable on this host")
        assert rx_native._native_ep is not None and tx_python._native_ep is None
        for _ in range(40):
            tx_python.send(M.GeodeticWgs84Reading(latitude=57.5, longitude=11.75),
                           sender_stamp=py_stamp)
            tx_native.send(M.AngularVelocityReading(angularVelocityZ=-0.5),
                           sender_stamp=native_stamp)
            tx_native.send(M.GeodeticHeadingReading(northHeading=0.5), sender_stamp=self_stamp)
            await asyncio.sleep(0.05)
            if got_native and got_python:
                break
        for s in sessions:
            await s.stop()
        return got_native, got_python, own

    got_native, got_python, own = asyncio.run(run())
    if not (got_native and got_python):
        pytest.skip("multicast loopback not routed on this host")
    assert own == []
    env = got_native[0]
    assert env.received.micros > 0
    m1 = E.unpack_message(env)
    assert m1.latitude == 57.5 and m1.longitude == 11.75
    assert E.unpack_message(got_python[0]).angularVelocityZ == -0.5


def test_native_true_raises_when_it_cannot_build(monkeypatch):
    from tpuslam_torch.io.od4 import OD4Session
    from tpuslam_torch.native import receiver as nat

    def broken(target, timeout_s=180.0):
        raise RuntimeError("make: g++: not found")
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat._build, "build", broken)
    assert not nat.available()

    async def run(native):
        s = OD4Session(cid=195, native=native)
        try:
            await s.start()
        except OSError:
            pytest.skip("multicast sockets unavailable on this host")
        finally:
            await s.stop()
        return s

    with pytest.raises(RuntimeError, match="native receiver unavailable"):
        asyncio.run(run(True))
    asyncio.run(run(None))          # auto: the asyncio endpoint


def test_od4recv_under_thread_sanitizer():
    from tpuslam_torch.native import _build
    try:
        exe = _build.build("od4recv_tsan_test")
    except RuntimeError as e:
        pytest.skip(f"tsan build unavailable: {str(e)[-200:]}")
    assert exe.parent == _build.BUILD_DIR
    env = {**os.environ, "TSAN_OPTIONS": "exitcode=66 halt_on_error=0"}
    proc = subprocess.run([str(exe)], env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode == 2:
        pytest.skip("multicast sockets unavailable on this host")
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    assert "TSAN_DRIVER_OK" in proc.stdout
    assert "WARNING: ThreadSanitizer" not in proc.stderr, proc.stderr[-4000:]


# ---------------------------------------------------------------------------
# The VLP-16 calibration (tests/test_perception.py:375-420)

def test_calibration_equals_jax():
    from tpuslam.perception import calib as jcalib
    from tpuslam.perception.vlp16 import decode_point_cloud_reading as jdecode
    from tpuslam.sim.vlp16_sim import Vlp16SceneConfig as JScene
    from tpuslam.sim.vlp16_sim import scene_to_point_cloud_reading as jscene
    from tpuslam_torch.perception import calib
    from tpuslam_torch.perception.vlp16 import (
        DISTANCE_RESOLUTION_M, VLP16_ELEVATIONS_DEG, decode_point_cloud_reading,
    )
    path = calib.default_calibration_path()
    assert open(path).read() == open(jcalib.default_calibration_path()).read()
    assert calib.nominal_vlp16_db_xml() == jcalib.nominal_vlp16_db_xml() == open(path).read()
    assert calib.nominal_vlp16_db_xml(16) == jcalib.nominal_vlp16_db_xml(16)
    c, jc = calib.load_calibration(path), jcalib.load_calibration(path)
    for f in dataclasses.fields(c):
        np.testing.assert_array_equal(getattr(c, f.name), getattr(jc, f.name), err_msg=f.name)
    assert abs(c.dist_lsb_m - DISTANCE_RESOLUTION_M) < 1e-12 and c.n_lasers == 64
    assert sorted(c.vert_correction_deg[:16].tolist()) == list(range(-15, 16, 2))
    np.testing.assert_array_equal(c.elevations_for_channels(16), jc.elevations_for_channels(16))
    np.testing.assert_array_equal(c.elevations_for_channels(16), VLP16_ELEVATIONS_DEG)
    # a point cloud decoded with the calibration, as the JAX package decodes it
    msg = jscene(np.array([[6.0, 1.5], [9.0, -2.0]]), JScene(seed=3, points_per_cone=30))
    pts, _ = decode_point_cloud_reading(_twin(msg, M), calib=c)
    jpts, _ = jdecode(msg, calib=jc)
    assert len(pts) > 0
    np.testing.assert_array_equal(pts, jpts)


# ---------------------------------------------------------------------------
# The OpenDaVINCI configuration layer (tests/test_aux.py:67-)

_OD_CONFIG = """\
# a usecase-style configuration (reference usecase/configuration's format)
global.buffer.memorySegmentSize = 2800000 # Size of a memory segment in bytes.
global.buffer.numberOfMemorySegments = 4
logic-cfsd18-sensation-attention.connectDistanceThreshold = 0.8
logic-cfsd18-sensation-attention.minNumOfPointsForCone = 2
logic-cfsd18-sensation-attention.maxNumOfPointsForCone = 80
logic-cfsd18-sensation-attention.zRangeThreshold = 0.1
logic-cfsd18-sensation-attention.inlierRangeTreshold = 0.06
logic-cfsd18-sensation-attention.dotThreshold = 0.3
%RANSAC
logic-cfsd18-sensation-attention.inlierFoundTreshold = 80
logic-cfsd18-sensation-attention.numberOfIterations = 10
logic-cfsd18-sensation-attention.senderStamp = 116
logic-cfsd18-sensation-attention:3.numberOfIterations = 25
logic-cfsd18-sensation-slam.gatheringTimeMs = 10
"""


@pytest.mark.parametrize("ident", [None, 3, 4])
def test_od_configuration_equals_jax(ident):
    from tpuslam.runtime import odconfig as jod
    from tpuslam_torch.runtime import odconfig as od
    cfg = od.parse_od_configuration(_OD_CONFIG)
    assert cfg == jod.parse_od_configuration(_OD_CONFIG)
    assert cfg["global.buffer.numberOfMemorySegments"] == "4"
    section = "logic-cfsd18-sensation-attention"
    view = od.module_view(cfg, section, ident)
    assert view == jod.module_view(cfg, section, ident)
    assert view["buffer.memorySegmentSize"] == "2800000"
    acfg, stamp = od.attention_from_od_config(_OD_CONFIG, ident)
    jacfg, jstamp = jod.attention_from_od_config(_OD_CONFIG, ident)
    assert stamp == jstamp == 116
    assert dataclasses.asdict(acfg) == dataclasses.asdict(jacfg)
    assert acfg.ransac_iterations == (25 if ident == 3 else 10)
    assert (acfg.min_points, acfg.max_points, acfg.inlier_found_threshold) == (2, 80, 80)
    text2 = "a.k = 1\na:7.k = 2\nglobal.g = 9\n"
    assert od.module_view(od.parse_od_configuration(text2), "a")["k"] == "1"
    assert od.module_view(od.parse_od_configuration(text2), "a", 7)["k"] == "2"


# ---------------------------------------------------------------------------
# Tracing on torch.profiler (tests/test_aux.py:30-48)

def test_tracing_stages_and_trace_file(tmp_path):
    from tpuslam_torch.runtime.tracing import stage, trace_session

    with stage("outside-a-session"):
        assert float(torch.arange(4.0).sum() + 1) == 7.0
    logdir = str(tmp_path / "trace")
    with trace_session(logdir):
        with stage("unit-test-stage"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
            with stage("nested-stage"):
                x + 1
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"unit-test-stage", "nested-stage"} <= set(spans)
    assert "outside-a-session" not in {e.get("name") for e in events}
    outer, inner = spans["unit-test-stage"], spans["nested-stage"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
