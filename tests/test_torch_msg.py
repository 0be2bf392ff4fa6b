"""The port's messenger against the reference: frames, transport, fault
injection, and the runtime helpers under them.

Two kinds of test, on the CPU:

- **twins** of the reference's loopback tests (``tests/test_msg.py``,
  ``tests/test_wire_protocol.py`` but its live-cluster class,
  ``tests/test_msgr_failures.py``'s ``TestInjectionMechanism`` and
  ``TestMidVectoredWriteSever``, and the unit cases of
  ``tests/test_throttle.py``, ``tests/test_recv_pool.py`` and
  ``tests/test_auth.py``), the same bodies run on ``ceph_tpu_torch``;
  the cases that need a ``MiniCluster`` wait for the port's OSD;
- **cross-package wire checks**: for every registered message type the
  port's frame equals the reference's byte for byte, each package
  decodes the other's frames (batch frames included), the ``TYPE_ID``
  tables and ``wire_manifest.json`` are equal, and the two messengers
  handshake and talk over loopback.

Every async body runs under ``asyncio.wait_for`` (:func:`run`), so a
hang fails in seconds.
"""

import asyncio
import json
import random
import struct
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.auth import (
    AuthContext,
    Keyring,
    Ticket,
    challenge_response,
    new_secret,
)
from ceph_tpu_torch.common import Config, stack_ledger
from ceph_tpu_torch.common.recv_pool import RecvPool, recv_pool
from ceph_tpu_torch.common.slab import SlabPool, frame_slab
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.msg import AsyncMessenger, Dispatcher, messages
from ceph_tpu_torch.msg import message as msgmod
from ceph_tpu_torch.msg.message import (
    BadFrame,
    Message,
    decode_frame,
    decode_frame_msgs,
    encode_batch_frame,
    encode_frame,
    encode_frame_segments,
)
from ceph_tpu_torch.store import CollectionId, ObjectId, Transaction

# every async body's limit: the slowest twin (continuous injection)
# takes about a second
ASYNC_LIMIT_S = 60.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, ASYNC_LIMIT_S))


# ======================================================================
# twins of the reference's test_msg.py (all 14)
# ======================================================================

# -- framing -----------------------------------------------------------------


def test_frame_roundtrip():
    m = messages.MOSDOp(
        tid=7, epoch=3, pool=1, oid="foo",
        ops=[{"op": "write", "offset": 0, "length": 5, "data": 0}],
        blobs=[b"hello"],
    )
    out, seq = decode_frame(encode_frame(m, seq=42))
    assert isinstance(out, messages.MOSDOp)
    assert seq == 42
    assert out.tid == 7 and out.pool == 1 and out.oid == "foo"
    assert out.ops == m.ops
    assert out.blobs == [b"hello"]


def test_frame_multiple_blobs_and_empty():
    m = messages.MOSDECSubOpReadReply(
        pgid="1.0", tid=1, shard=2,
        reads=[{"data": 0}, {"data": 1}], attrs={}, errors=[],
        blobs=[b"\x00" * 4096, b""],
    )
    out, _ = decode_frame(encode_frame(m))
    assert out.blobs == [b"\x00" * 4096, b""]


def test_frame_crc_detects_corruption():
    m = messages.MPing(stamp=1.5, epoch=2)
    frame = bytearray(encode_frame(m))
    frame[len(frame) // 2] ^= 0xFF
    with pytest.raises(BadFrame):
        decode_frame(bytes(frame))


def test_frame_bad_magic():
    with pytest.raises(BadFrame):
        decode_frame(b"XXXX" + b"\x00" * 20)


def test_unknown_type_rejected():
    class MUnknown(Message):
        TYPE = "nope_not_registered"
        TYPE_ID = 0x7EEF  # encodes fine; never in the decode registry
        FIELDS = ("x",)

    with pytest.raises(BadFrame):
        decode_frame(encode_frame(MUnknown(x=1)))


def test_unknown_field_rejected():
    with pytest.raises(TypeError):
        messages.MPing(stamp=1, bogus=2)


# -- transaction wire form ---------------------------------------------------


def test_txn_roundtrip():
    cid = CollectionId("1.0s1")
    oid = ObjectId("obj", shard=1)
    txn = (
        Transaction()
        .create_collection(cid)
        .touch(cid, oid)
        .write(cid, oid, 128, b"chunkdata")
        .zero(cid, oid, 0, 16)
        .truncate(cid, oid, 256)
        .setattr(cid, oid, "hinfo_key", b"\x01\x02")
        .rmattr(cid, oid, "old")
        .omap_setkeys(cid, oid, {"k1": b"v1", "k2": b"v2"})
        .omap_rmkeys(cid, oid, ["k1"])
        .omap_clear(cid, oid)
        .clone(cid, oid, ObjectId("obj2", shard=1))
        .remove(cid, oid)
        .remove_collection(cid)
    )
    ops, blobs = messages.encode_txn(txn)
    back = messages.decode_txn(ops, blobs)
    assert back.ops == txn.ops


def test_txn_rides_in_message():
    cid = CollectionId("2.3s0")
    oid = ObjectId("x", shard=0)
    txn = Transaction().write(cid, oid, 0, b"\xaa" * 512).setattr(cid, oid, "h", b"v")
    ops, blobs = messages.encode_txn(txn)
    m = messages.MOSDECSubOpWrite(
        pgid="2.3", tid=9, from_osd=0, shard=0, txn=ops,
        log=[], at_version=[1, 4], trim_to=[0, 0], blobs=blobs,
    )
    out, _ = decode_frame(encode_frame(m))
    assert messages.decode_txn(out.txn, out.blobs).ops == txn.ops
    assert out.at_version == [1, 4]


# -- asyncio transport -------------------------------------------------------


class Collector(Dispatcher):
    def __init__(self):
        self.got: list[tuple[str, Message]] = []
        self.resets: list[str] = []
        self.event = asyncio.Event()

    async def ms_dispatch(self, conn, msg):
        self.got.append((conn.peer_name, msg))
        self.event.set()

    def ms_handle_reset(self, conn):
        self.resets.append(conn.peer_name)


class Echo(Dispatcher):
    async def ms_dispatch(self, conn, msg):
        conn.send(messages.MPingReply(stamp=msg.stamp, epoch=msg.epoch))

    def ms_handle_reset(self, conn):
        pass


async def _wait(pred, timeout=5.0):
    async with asyncio.timeout(timeout):
        while not pred():
            await asyncio.sleep(0.005)


def test_ping_pong_over_loopback():
    async def main():
        server_disp = Echo()
        server = AsyncMessenger("osd.0", server_disp)
        addr = await server.bind()

        client_disp = Collector()
        client = AsyncMessenger("client.1", client_disp)
        conn = await client.connect(addr)
        assert conn.peer_name == "osd.0"
        for i in range(10):
            conn.send(messages.MPing(stamp=float(i), epoch=1))
        await _wait(lambda: len(client_disp.got) == 10)
        # ordered delivery
        assert [m.stamp for _, m in client_disp.got] == [float(i) for i in range(10)]
        assert all(n == "osd.0" for n, _ in client_disp.got)
        await client.shutdown()
        await server.shutdown()

    run(main())


def test_large_blob_transfer():
    async def main():
        disp = Collector()
        server = AsyncMessenger("osd.1", disp)
        addr = await server.bind()
        client = AsyncMessenger("client.2", Collector())
        conn = await client.connect(addr)
        payload = bytes(range(256)) * (1 << 14)  # 4 MiB
        conn.send(
            messages.MOSDECSubOpWrite(
                pgid="1.0", tid=1, from_osd=0, shard=3, txn=[],
                log=[], at_version=[1, 1], trim_to=[0, 0], blobs=[payload],
            )
        )
        await _wait(lambda: disp.got)
        name, msg = disp.got[0]
        assert name == "client.2"
        assert msg.blobs[0] == payload
        await client.shutdown()
        await server.shutdown()

    run(main())


def test_connection_cached_and_reset_callback():
    async def main():
        server = AsyncMessenger("osd.2", Echo())
        addr = await server.bind()
        disp = Collector()
        client = AsyncMessenger("client.3", disp)
        c1 = await client.connect(addr)
        c2 = await client.connect(addr)
        assert c1 is c2
        await server.shutdown()  # peer dies -> client sees reset
        await _wait(lambda: disp.resets)
        assert disp.resets == ["osd.2"]
        # reconnect after reset opens a fresh connection
        server2 = AsyncMessenger("osd.2", Echo())
        addr2 = await server2.bind()
        c4 = await client.connect(addr2)
        assert c4 is not c1
        await client.shutdown()
        await server2.shutdown()

    run(main())


def test_concurrent_connect_shares_one_stream():
    """Racing connect() calls must not open duplicate connections."""

    async def main():
        server = AsyncMessenger("osd.5", Echo())
        addr = await server.bind()
        client = AsyncMessenger("client.9", Collector())
        conns = await asyncio.gather(*[client.connect(addr) for _ in range(8)])
        assert all(c is conns[0] for c in conns)
        assert len(server._all) == 1
        await client.shutdown()
        await server.shutdown()

    run(main())


def test_dispatcher_exception_keeps_connection_alive():
    """A handler bug on one message must not drop the peer link."""

    class Flaky(Dispatcher):
        def __init__(self):
            self.ok = []

        async def ms_dispatch(self, conn, msg):
            if msg.stamp == 0.0:
                raise KeyError("handler bug")
            self.ok.append(msg.stamp)

        def ms_handle_reset(self, conn):
            pass

    async def main():
        disp = Flaky()
        server = AsyncMessenger("osd.6", disp)
        addr = await server.bind()
        client = AsyncMessenger("client.10", Collector())
        conn = await client.connect(addr)
        conn.send(messages.MPing(stamp=0.0, epoch=1))  # triggers handler bug
        conn.send(messages.MPing(stamp=1.0, epoch=1))  # must still arrive
        await _wait(lambda: disp.ok)
        assert disp.ok == [1.0]
        await client.shutdown()
        await server.shutdown()

    run(main())


def test_bidirectional_entities():
    """Two messengers each bound and connected to each other (OSD<->OSD)."""

    async def main():
        d_a, d_b = Collector(), Collector()
        a = AsyncMessenger("osd.0", d_a)
        b = AsyncMessenger("osd.1", d_b)
        addr_a = await a.bind()
        addr_b = await b.bind()
        (await a.connect(addr_b)).send(messages.MPing(stamp=1.0, epoch=1))
        (await b.connect(addr_a)).send(messages.MPing(stamp=2.0, epoch=1))
        await _wait(lambda: d_a.got and d_b.got)
        assert d_b.got[0][1].stamp == 1.0
        assert d_a.got[0][1].stamp == 2.0
        await a.shutdown()
        await b.shutdown()

    run(main())


# ======================================================================
# twins of the reference's test_wire_protocol.py (all but TestLiveClusterAllocsFlat)
# ======================================================================

# -- sample construction ------------------------------------------------------

# field-name driven sample values: every registered type gets a
# realistic-ish instance; anything unlisted falls back by position
_BY_NAME = {
    "ops": [{"op": "writefull", "data": 0}],
    "snapc": {"seq": 3, "snaps": [3, 2]},
    "stamps": {"submit": 12345.123456789},
    "spans": [{"hop": "wire", "t0": 1.5, "dur": 0.002, "entity": "osd.0"}],
    "entries": [{"stamp": 1.0, "name": "osd.0", "level": "warn",
                 "msg": "x"}],
    "perf": {"osd": {"op": 7}},
    "cmd": {"prefix": "status"},
    "osdmap": {"epoch": 4, "pools": {}},
    "incrementals": [{"epoch": 4}],
    "out": [{"version": [1, 2]}],
    "reads": [{"oid": ["o", 0], "offset": 0, "length": 8, "data": 0}],
    "pushes": [{"oid": ["o", 0], "data": 0, "attrs": {}, "version": 1}],
    "txn": [["touch", "1.0", ["o", 0]]],
    "log": [],
    "at_version": [1, 4],
    "trim_to": [0, 0],
    "pgs": {"1.0": {"objects": 1, "bytes": 4096, "primary": 0}},
    "store": {"used": 1},
    "profile": {"plugin": "isa", "k": "4", "m": "2"},
    "stripes": [2, 1],
    "present": [0, 1, 2],
    "shards": [0, 4],
    "accepted": {"epoch": 1, "version": 2, "value": {}},
    "intervals": [[1, 2, [0, 1]]],
    "objects": {"o": {"version": [1, 1], "size": 9}},
    "names": ["a", "b"],
    "report": {"pg": "1.0", "objects": 0, "errors": [], "repaired": 0,
               "clean": True},
    "sub": True,
    "down": False,
    "repair": False,
    "attrs": {},
    "errors": [],
}
_FALLBACK = [7, "s", 2.5, [1, 2], {"k": 1}, 3, "t"]


def _sample(cls) -> Message:
    kw = {}
    for i, f in enumerate(cls.FIELDS):
        kw[f] = _BY_NAME.get(f, _FALLBACK[i % len(_FALLBACK)])
    return cls(**kw)


def _flat(segs) -> bytes:
    return b"".join(bytes(s) for s in segs)


def _rebuild_crc(frame: bytearray) -> bytes:
    """Recompute the trailer crc of a hand-mutated frame (forged
    frames must fail on STRUCTURE, not on the crc shortcut)."""
    from ceph_tpu_torch.utils import native

    crc = native.crc32c_view(msgmod.CRC_SEED, bytes(frame), len(frame) - 4)
    struct.pack_into("<I", frame, len(frame) - 4, crc)
    return bytes(frame)


class TestRoundTrip:
    def test_every_registered_type_roundtrips(self):
        blobs = [b"", b"payload" * 37]
        for tid, cls in sorted(msgmod._REGISTRY.items()):
            m = _sample(cls)
            m.blobs = list(blobs)
            out, seq = decode_frame(encode_frame(m, 11))
            assert seq == 11, cls.__name__
            assert type(out) is cls
            assert out.fields() == m.fields(), cls.__name__
            assert [bytes(b) for b in out.blobs] == blobs, cls.__name__
            assert out.trace is None and out.sent is None

    def test_every_registered_type_reencodes_byte_identical(self,
                                                            monkeypatch):
        # frozen clock: a traced re-encode would otherwise take a new
        # send stamp and could never be byte-compared
        monkeypatch.setattr(time, "monotonic", lambda: 12345.675309)
        for traced in (False, True):
            for tid, cls in sorted(msgmod._REGISTRY.items()):
                m = _sample(cls)
                m.blobs = [b"xy" * 100]
                if traced:
                    m.trace = f"client.9:t{tid}"
                f1 = encode_frame(m, 5)
                out, _ = decode_frame(f1)
                assert out.trace == m.trace
                if traced:
                    assert out.sent == 12345.675309
                f2 = encode_frame(out, 5)
                assert f2 == f1, (cls.__name__, traced)

    def test_tail_modes_on_the_wire(self):
        """Admin/auth types really ride the JSON tail; data types ride
        marshal — the flag is readable in the raw frame."""
        f = encode_frame(messages.MMonCommand(tid=1,
                                              cmd={"prefix": "status"}), 1)
        (_, _tid, flags, *_rest) = msgmod._FIXED.unpack_from(f, 0)
        assert flags & msgmod.FLAG_TAIL_JSON
        assert b'"prefix"' in f  # greppable in a pcap: the point
        f2 = encode_frame(_sample(messages.MOSDOp), 1)
        (_, _tid, flags2, *_rest) = msgmod._FIXED.unpack_from(f2, 0)
        assert flags2 & msgmod.FLAG_TAIL_BIN
        assert b'"tid"' not in f2  # positional tail: no key strings

    def test_small_frame_is_one_segment_large_is_vectored(self):
        small, n, rel = encode_frame_segments(
            messages.MPing(stamp=1.0, epoch=1), 1)
        assert len(small) == 1 and n <= msgmod.SMALL_FRAME_MAX
        rel()
        segs, total, rel2 = encode_frame_segments(
            _sample(messages.MOSDOp), 1)
        assert len(segs) == 1  # no blobs set by _sample -> tail only
        rel2()
        m = _sample(messages.MOSDOp)
        m.blobs = [b"z" * 4096]
        segs, total, rel3 = encode_frame_segments(m, 1)
        assert len(segs) == 3  # header block, borrowed blob, crc view
        assert segs[1] is m.blobs[0]  # the blob rides BORROWED
        rel3()


class TestBadFrames:
    def _frame(self) -> bytes:
        m = _sample(messages.MOSDOp)
        m.blobs = [b"D" * 64, b"E" * 32]
        m.trace = "c:t1"
        return encode_frame(m, 9)

    def test_truncation_at_every_boundary_is_badframe(self):
        f = self._frame()
        for k in range(len(f)):
            with pytest.raises(BadFrame):
                decode_frame(f[:k])

    def test_random_corruption_never_escapes_badframe(self):
        f = self._frame()
        rng = random.Random(1312)
        for _ in range(400):
            ba = bytearray(f)
            for _flip in range(rng.randrange(1, 4)):
                ba[rng.randrange(len(ba))] ^= 1 << rng.randrange(8)
            try:
                decode_frame_msgs(bytes(ba))
            except BadFrame:
                pass  # the only acceptable failure mode

    def test_unknown_type_id_with_valid_crc(self):
        ba = bytearray(self._frame())
        struct.pack_into("<H", ba, 4, 0x7EEF)  # type_id field
        with pytest.raises(BadFrame, match="unknown message type id"):
            decode_frame(_rebuild_crc(ba))

    def test_lying_blob_count_is_badframe(self):
        ba = bytearray(self._frame())
        struct.pack_into("<H", ba, 24, 40)  # blob_count field
        with pytest.raises(BadFrame):
            decode_frame(_rebuild_crc(ba))

    def test_lying_tail_len_is_badframe(self):
        ba = bytearray(self._frame())
        struct.pack_into("<I", ba, 28, 1 << 24)  # tail_len field
        with pytest.raises(BadFrame, match="truncated header"):
            decode_frame(_rebuild_crc(ba))

    def test_wrong_tail_arity_is_badframe(self):
        """A crc-valid frame whose positional tail does not match the
        class schema (version skew) must be a decode error, not a
        reader-loop crash."""
        import marshal

        tail = marshal.dumps((1, 2, 3), 2)  # MPing has 2 fields
        trace = b""
        head = msgmod._FIXED.pack(
            msgmod.MAGIC, messages.MPing.TYPE_ID, msgmod.FLAG_TAIL_BIN,
            1, 0.0, 0, len(trace), len(tail))
        ba = bytearray(head + trace + tail + b"\0\0\0\0")
        with pytest.raises(BadFrame, match="arity"):
            decode_frame(_rebuild_crc(ba))

    def test_batch_entry_overrun_is_badframe(self):
        acks = [messages.MOSDOpReply(tid=i, result=0, epoch=1)
                for i in range(3)]
        segs, total, rel = encode_batch_frame(acks, 1)
        ba = bytearray(_flat(segs))
        rel()
        # first sub-entry's tail_len overruns the frame
        struct.pack_into("<I", ba, msgmod._FIXED.size + 4, 1 << 20)
        with pytest.raises(BadFrame):
            decode_frame_msgs(_rebuild_crc(ba))

    def test_batch_bad_utf8_trace_is_badframe(self):
        """Review finding: the batch path must wrap a corrupt trace id
        into BadFrame exactly like the single-frame path — an escaped
        UnicodeDecodeError would kill the reader loop as an unhandled
        task exception instead of the controlled corrupt-peer drop."""
        a = messages.MOSDOpReply(tid=1, result=0, epoch=1)
        a.trace = "c:t1"
        segs, _t, rel = encode_batch_frame([a, a], 1)
        ba = bytearray(_flat(segs))
        rel()
        # the trace bytes sit right after the first sub-entry header
        off = msgmod._FIXED.size + msgmod._SUB.size
        assert bytes(ba[off:off + 4]) == b"c:t1"
        ba[off] = 0xFF  # invalid UTF-8 lead byte
        with pytest.raises(BadFrame, match="bad trace id"):
            decode_frame_msgs(_rebuild_crc(ba))

    def test_batch_frames_reject_single_decode_api(self):
        acks = [messages.MOSDOpReply(tid=i, result=0, epoch=1)
                for i in range(2)]
        segs, _t, rel = encode_batch_frame(acks, 1)
        frame = _flat(segs)
        rel()
        with pytest.raises(BadFrame, match="decode_frame_msgs"):
            decode_frame(frame)
        outs, _ = decode_frame_msgs(frame)
        assert [o.tid for o in outs] == [0, 1]

    def test_empty_and_garbage_input(self):
        for junk in (b"", b"CTPB", b"XXXX" + b"\0" * 64,
                     b"\0" * 36, self._frame()[4:]):
            with pytest.raises(BadFrame):
                decode_frame(junk)


class TestCrcChain:
    def test_crc_chains_across_slab_backed_segments(self):
        """The vectored frame's trailer crc — computed over the slab
        header block then CHAINED across borrowed blob views — equals
        the crc of the joined bytes, and any post-encode blob mutation
        fails decode."""
        m = _sample(messages.MOSDECSubOpWrite)
        blob = bytearray(b"Q" * 5000)  # mutable on purpose
        m.blobs = [blob, b"R" * 3000]
        segs, total, rel = encode_frame_segments(m, 3)
        assert len(segs) > 2  # really vectored: slab header + views
        flat = _flat(segs)
        assert len(flat) == total
        out, _ = decode_frame_msgs(flat)  # chained crc verifies
        # the caller-mutation contract: flip one payload byte between
        # encode and drain -> the peer's crc check MUST catch it
        blob[100] ^= 0xFF
        with pytest.raises(BadFrame, match="crc mismatch"):
            decode_frame_msgs(_flat(segs))
        rel()


class TestSlabPool:
    def test_reuse_returns_the_same_block(self):
        pool = SlabPool()
        a = pool.checkout(100)
        backing = a.data
        a.release()
        b = pool.checkout(200)  # same 256B class
        assert b.data is backing
        assert pool.hits == 1 and pool.misses == 1

    def test_free_lists_are_bounded(self):
        pool = SlabPool(per_class=2)
        bufs = [pool.checkout(64) for _ in range(5)]
        for b in bufs:
            b.release()
        st = pool.stats()
        assert st["free"][256] == 2  # 3 dropped to the GC
        assert st["bytes_held"] == 512

    def test_byte_cap_bounds_large_classes(self):
        pool = SlabPool(per_class=64, class_bytes=1 << 20)
        st = pool.stats()
        assert st["caps"][262144] == 4  # 1MiB / 256KiB
        assert st["caps"][256] == 64

    def test_oversize_checkout_never_pools(self):
        pool = SlabPool()
        big = pool.checkout(1 << 21)
        assert len(big.data) == 1 << 21
        big.release()
        assert pool.stats()["bytes_held"] == 0
        assert pool.misses == 1

    def test_double_release_is_idempotent(self):
        pool = SlabPool()
        a = pool.checkout(10)
        a.release()
        a.release()
        assert pool.stats()["free"][256] == 1

    def test_concurrent_checkout_hands_distinct_blocks(self):
        pool = SlabPool()
        a = pool.checkout(100)
        b = pool.checkout(100)
        assert a.data is not b.data
        a.release()
        b.release()

    def test_threaded_churn_stays_consistent(self):
        pool = SlabPool()
        errors: list = []

        def churn(seed):
            rng = random.Random(seed)
            try:
                for _ in range(400):
                    buf = pool.checkout(rng.choice((64, 900, 4000)))
                    buf.data[0] = seed  # we own it exclusively
                    if buf.data[0] != seed:
                        errors.append("clobbered")
                    buf.release()
            except Exception as e:  # pragma: no cover - the assertion
                errors.append(repr(e))

        ts = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors
        st = pool.stats()
        assert st["hits"] + st["misses"] == 4 * 400

    def test_checkouts_feed_the_stack_ledger(self):
        pc = stack_ledger.stack_perf()
        pool = frame_slab()
        pool.stats()  # flush any pending hit tally first
        h0 = int(pc.get("slab_hits"))
        m0 = int(pc.get("slab_misses"))
        a0 = int(pc.get("frame_allocs"))
        buf = pool.checkout(32)
        buf.release()
        buf = pool.checkout(32)
        buf.release()
        pool.stats()
        assert int(pc.get("slab_hits")) >= h0 + 1
        # a miss (if the class was cold) counts into frame_allocs too
        assert int(pc.get("slab_misses")) - m0 == \
            int(pc.get("frame_allocs")) - a0


class _Sink(Dispatcher):
    def __init__(self):
        self.got = []
        self.resets = 0
        self.event = asyncio.Event()

    async def ms_dispatch(self, conn, msg):
        self.got.append(msg)
        self.event.set()

    def ms_handle_reset(self, conn):
        self.resets += 1


class _AckBurst(Dispatcher):
    """On any inbound message, answer with a burst of coalescible acks
    (queued in one tick, so the writer loop can batch them) plus an
    optional trailing blob-carrying reply (never coalescible)."""

    def __init__(self, n: int, with_blob_tail: bool = False):
        self.n = n
        self.with_blob_tail = with_blob_tail

    async def ms_dispatch(self, conn, msg):
        for i in range(self.n):
            conn.send(messages.MOSDOpReply(
                tid=i, result=0, epoch=7, out=[{"v": i}]))
        if self.with_blob_tail:
            conn.send(messages.MOSDOpReply(
                tid=self.n, result=0, epoch=7, out=[{"data": 0}],
                blobs=[b"READ" * 64]))

    def ms_handle_reset(self, conn):
        pass


async def _wait(pred, timeout=5.0):
    async with asyncio.timeout(timeout):
        while not pred():
            await asyncio.sleep(0.005)


class TestReplyCoalescing:
    def test_burst_coalesces_in_order_byte_identical(self):
        async def main():
            srv = AsyncMessenger("osd.0", _AckBurst(12))
            await srv.bind()
            sink = _Sink()
            cli = AsyncMessenger("client.1", sink)
            conn = await cli.connect(srv.addr, "osd.0")
            conn.send(messages.MPing(stamp=1.0, epoch=1))
            await _wait(lambda: len(sink.got) >= 12)
            acks = [m for m in sink.got
                    if isinstance(m, messages.MOSDOpReply)]
            assert [a.tid for a in acks] == list(range(12))  # ordered
            assert [a.out for a in acks] == [[{"v": i}] for i in range(12)]
            assert all(a.trace for a in acks)  # trace ids survived
            # the burst actually shared frames: fewer frames than acks
            assert srv.perf.get("coalesced_frames") >= 1
            assert srv.perf.get("send_coalesced") >= 2
            await cli.shutdown()
            await srv.shutdown()

        run(main())

    def test_blob_reply_flushes_the_run_and_keeps_order(self):
        async def main():
            srv = AsyncMessenger("osd.0", _AckBurst(5, with_blob_tail=True))
            await srv.bind()
            sink = _Sink()
            cli = AsyncMessenger("client.1", sink)
            conn = await cli.connect(srv.addr, "osd.0")
            conn.send(messages.MPing(stamp=1.0, epoch=1))
            await _wait(lambda: len(sink.got) >= 6)
            acks = [m for m in sink.got
                    if isinstance(m, messages.MOSDOpReply)]
            assert [a.tid for a in acks] == list(range(6))
            assert bytes(acks[5].blobs[0]) == b"READ" * 64
            await cli.shutdown()
            await srv.shutdown()

        run(main())

    def test_coalesce_max_1_disables_batching(self):
        async def main():
            srv = AsyncMessenger("osd.0", _AckBurst(8))
            srv.reply_coalesce_max = 1
            await srv.bind()
            sink = _Sink()
            cli = AsyncMessenger("client.1", sink)
            conn = await cli.connect(srv.addr, "osd.0")
            conn.send(messages.MPing(stamp=1.0, epoch=1))
            await _wait(lambda: len(sink.got) >= 8)
            assert srv.perf.get("coalesced_frames") == 0
            acks = [m for m in sink.got
                    if isinstance(m, messages.MOSDOpReply)]
            assert [a.tid for a in acks] == list(range(8))
            await cli.shutdown()
            await srv.shutdown()

        run(main())

    def test_sever_mid_batch_eats_the_whole_batch(self):
        """The fault discipline on the coalesced path: an injected
        mid-vectored-write sever on a batch frame delivers NO member
        (length framing + crc — a prefix of acks can never leak), the
        peer sees a clean reset, and a resent burst arrives whole."""

        async def main():
            sink = _Sink()
            cli = AsyncMessenger("client.1", sink)
            srv = AsyncMessenger("osd.0", _AckBurst(10))
            await srv.bind()
            fired = {"n": 0}

            def inject_once():
                fired["n"] += 1
                return fired["n"] == 1

            srv._inject_failure = inject_once
            conn = await cli.connect(srv.addr, "osd.0")
            conn.send(messages.MPing(stamp=1.0, epoch=1))
            await asyncio.sleep(0.3)
            # the server's first write was the (severed) burst: either
            # nothing arrived, or — if the writer flushed a lone ack
            # before batching — a strict PREFIX arrived intact; no
            # torn/partial member ever decodes
            acks = [m for m in sink.got
                    if isinstance(m, messages.MOSDOpReply)]
            assert len(acks) < 10
            assert [a.tid for a in acks] == list(range(len(acks)))
            assert sink.resets >= 1
            # resend on a fresh connection delivers the full burst
            conn2 = await cli.connect(srv.addr, "osd.0")
            assert conn2 is not conn
            sink.got.clear()
            conn2.send(messages.MPing(stamp=2.0, epoch=1))
            await _wait(lambda: len([
                m for m in sink.got
                if isinstance(m, messages.MOSDOpReply)]) >= 10)
            acks = [m for m in sink.got
                    if isinstance(m, messages.MOSDOpReply)]
            assert [a.tid for a in acks] == list(range(10))
            assert [a.out for a in acks] == [[{"v": i}] for i in range(10)]
            await cli.shutdown()
            await srv.shutdown()

        run(main())


class TestOpBatchFrames:
    """Multi-op REQUEST batch frames: the extended
    sub-entry layout (FLAG_BATCH_BLOBS), member blobs concatenated
    after the entry table, ordered roundtrip with ``from_batch`` set,
    and the same corruption containment the ack path pins."""

    def _ops(self, n=3, blob_sizes=(64, 4096, 0)):
        msgs = []
        for i in range(n):
            m = messages.MOSDOp(
                tid=i, epoch=1, pool=1, oid=f"o{i}",
                ops=[{"op": "writefull", "data": 0}],
                snapc=None, snapid=None,
                stamps={"submit": 1.0}, client=7)
            sz = blob_sizes[i % len(blob_sizes)]
            if sz:
                m.blobs = [bytes([65 + i]) * sz]
            msgs.append(m)
        return msgs

    def test_extended_layout_pin(self):
        """The byte layout the manifest's ``batch_frame`` object pins:
        header blob_count = member count, FLAG_BATCH|FLAG_BATCH_BLOBS,
        tail_len = entries-region length, _SUBX entries with per-member
        u32 blob-length tables, blobs after the table in member
        order."""
        msgs = self._ops()
        segs, total, rel = encode_batch_frame(msgs, 7)
        frame = _flat(segs)
        rel()
        assert len(frame) == total
        (magic, tid, flags, seq, _sent, blob_count, trace_len,
         tail_len) = msgmod._FIXED.unpack_from(frame, 0)
        assert magic == msgmod.MAGIC
        assert tid == msgmod.TYPE_ID_BATCH
        assert flags & msgmod.FLAG_BATCH
        assert flags & msgmod.FLAG_BATCH_BLOBS
        assert seq == 7 and blob_count == 3 and trace_len == 0
        # walk the extended entry table by hand
        off = msgmod._FIXED.size
        entries_end = off + tail_len
        blob_lens = []
        for m in msgs:
            (styp, _sfl, strace, stail, sblobs) = \
                msgmod._SUBX.unpack_from(frame, off)
            off += msgmod._SUBX.size
            assert styp == messages.MOSDOp.TYPE_ID
            assert sblobs == len(m.blobs)
            lens = struct.unpack_from(f"<{sblobs}I", frame, off)
            off += 4 * sblobs
            assert list(lens) == [len(b) for b in m.blobs]
            blob_lens.extend(lens)
            off += strace + stail
        assert off == entries_end
        # member blobs sit AFTER the entry table, in member order
        assert frame[entries_end:entries_end + 64] == b"A" * 64
        assert frame[entries_end + 64:entries_end + 64 + 4096] == b"B" * 4096
        assert entries_end + sum(blob_lens) == len(frame) - 4
        # and the decode contract: order, fields, blobs, from_batch
        outs, seq2 = decode_frame_msgs(frame)
        assert seq2 == 7
        assert [o.tid for o in outs] == [0, 1, 2]
        assert all(o.from_batch for o in outs)
        assert bytes(outs[0].blobs[0]) == b"A" * 64
        assert bytes(outs[1].blobs[0]) == b"B" * 4096
        assert outs[2].blobs == []
        assert [o.oid for o in outs] == ["o0", "o1", "o2"]

    def test_blob_free_batch_stays_compact(self):
        """The compact ack-batch format is untouched: no blob on any
        member -> no FLAG_BATCH_BLOBS, compact _SUB entries, one slab
        segment (byte-compatible with peers that predate blob batches)."""
        acks = [messages.MOSDOpReply(tid=i, result=0, epoch=1)
                for i in range(4)]
        segs, _t, rel = encode_batch_frame(acks, 1)
        assert len(segs) == 1  # always gathered
        frame = _flat(segs)
        rel()
        (_m, _tid, flags, _s, _st, bc, _tr, tail_len) = \
            msgmod._FIXED.unpack_from(frame, 0)
        assert not (flags & msgmod.FLAG_BATCH_BLOBS)
        assert bc == 4
        # compact layout: the entries region runs to the crc (no blob
        # section), and each entry is a _SUB header
        assert msgmod._FIXED.size + tail_len == len(frame) - 4
        (styp, *_rest) = msgmod._SUB.unpack_from(frame, msgmod._FIXED.size)
        assert styp == messages.MOSDOpReply.TYPE_ID
        outs, _ = decode_frame_msgs(frame)
        assert all(o.from_batch for o in outs)

    def test_truncation_at_every_boundary_is_badframe(self):
        segs, _t, rel = encode_batch_frame(
            self._ops(blob_sizes=(64, 32, 0)), 1)
        frame = _flat(segs)
        rel()
        for k in range(len(frame)):
            with pytest.raises(BadFrame):
                decode_frame_msgs(frame[:k])

    def test_random_corruption_never_escapes_badframe(self):
        """The fuzz pin extended to multi-op request frames: bit flips
        anywhere — header, entry table, blob-length tables, blob
        bytes, crc — either decode to the same bytes (a flip the crc
        catches first never gets that far) or raise BadFrame; nothing
        else may escape."""
        segs, _t, rel = encode_batch_frame(self._ops(), 3)
        frame = _flat(segs)
        rel()
        rng = random.Random(1919)
        for _ in range(400):
            ba = bytearray(frame)
            for _flip in range(rng.randrange(1, 4)):
                ba[rng.randrange(len(ba))] ^= 1 << rng.randrange(8)
            try:
                decode_frame_msgs(bytes(ba))
            except BadFrame:
                pass  # the only acceptable failure mode

    def test_live_op_burst_batches_in_order(self):
        """Same-tick MOSDOp sends to one peer ship as multi-op frames
        (op_batch_max) and dispatch in send order with from_batch
        set — the wire half of the client aggregator contract."""

        async def main():
            sink = _Sink()
            srv = AsyncMessenger("osd.0", sink)
            await srv.bind()
            cli = AsyncMessenger("client.1", _Sink())
            conn = await cli.connect(srv.addr, "osd.0")
            for m in self._ops(n=10, blob_sizes=(256,)):
                conn.send(m)
            await _wait(lambda: len(sink.got) >= 10)
            ops = [m for m in sink.got if isinstance(m, messages.MOSDOp)]
            assert [o.tid for o in ops] == list(range(10))
            assert all(o.from_batch for o in ops)
            assert all(bytes(o.blobs[0]) == bytes([65 + o.tid]) * 256
                       for o in ops)
            assert cli.perf.get("batch_frames") >= 1
            assert cli.perf.get("batched_ops") >= 10
            await cli.shutdown()
            await srv.shutdown()

        run(main())

    def test_op_batch_max_1_disables_batching(self):
        async def main():
            sink = _Sink()
            srv = AsyncMessenger("osd.0", sink)
            await srv.bind()
            cli = AsyncMessenger("client.1", _Sink())
            cli.op_batch_max = 1
            conn = await cli.connect(srv.addr, "osd.0")
            for m in self._ops(n=6, blob_sizes=(64,)):
                conn.send(m)
            await _wait(lambda: len(sink.got) >= 6)
            assert cli.perf.get("batch_frames") == 0
            ops = [m for m in sink.got if isinstance(m, messages.MOSDOp)]
            assert [o.tid for o in ops] == list(range(6))
            assert not any(o.from_batch for o in ops)
            await cli.shutdown()
            await srv.shutdown()

        run(main())


# ======================================================================
# twins of the reference's test_msgr_failures.py (TestInjectionMechanism, TestMidVectoredWriteSever)
# ======================================================================

class _ResetSink(Dispatcher):
    def __init__(self):
        self.got = []
        self.resets = 0

    async def ms_dispatch(self, conn, msg):
        self.got.append(msg)

    def ms_handle_reset(self, conn):
        self.resets += 1


class TestInjectionMechanism:
    def test_injection_severs_links_but_never_corrupts(self):
        """With 1-in-8 injection, many sends across reconnects: every
        frame that ARRIVES is intact (crc framing rejects truncation),
        and at least one link was actually severed."""

        async def main():
            sink = _ResetSink()
            server = AsyncMessenger("srv", sink)
            await server.bind()
            cfg = Config(overrides={"ms_inject_socket_failures": 8})
            cli_sink = _ResetSink()
            client = AsyncMessenger("cli", cli_sink)
            client.apply_config(cfg)
            assert client.inject_socket_failures == 8
            sent = 0
            for i in range(120):
                try:
                    conn = await client.connect(server.addr, "srv")
                    conn.send(messages.MPing(stamp=float(i)))
                    sent += 1
                except (ConnectionError, OSError):
                    continue  # injected failure mid-handshake: retry
                await asyncio.sleep(0.005)
            await asyncio.sleep(0.2)
            # some frames were lost to injected severs...
            assert len(sink.got) < sent
            assert sink.resets > 0 or cli_sink.resets > 0
            # ...but every delivered frame is whole and well-typed
            for m in sink.got:
                assert isinstance(m, messages.MPing)
                assert isinstance(m.stamp, float)
            await client.shutdown()
            await server.shutdown()

        run(main())

    def test_zero_means_disabled(self):
        m = AsyncMessenger("x", _ResetSink())
        assert not any(m._inject_failure() for _ in range(10000))


class TestMidVectoredWriteSever:
    """Frames are SEGMENT LISTS written vectored (writelines); an
    injected sever must be able to land mid-list — whole leading
    segments delivered, the rest never — and the peer must treat the
    half-delivered frame as a reset, never decode it."""

    def _big_op(self, i: int) -> messages.MOSDOp:
        # >1024 bytes of blob across MULTIPLE blobs: the frame takes the
        # vectored segment path (the <=1KiB control fast path joins)
        return messages.MOSDOp(
            tid=i, epoch=1, pool=1, oid=f"obj-{i}",
            ops=[{"op": "writefull", "data": 0}],
            blobs=[bytes([i % 256]) * 3000, bytes([255 - i % 256]) * 2000],
        )

    def test_sever_mid_vectored_write_resets_cleanly(self):
        """Force the injection on exactly one large vectored frame: the
        receiver sees a connection reset and NO message (the length-
        prefixed read never completes, the crc can never pass) — then a
        reconnect + resend delivers the same payload intact."""

        async def main():
            sink = _ResetSink()
            server = AsyncMessenger("srv", sink)
            await server.bind()
            client = AsyncMessenger("cli", _ResetSink())
            # deterministic single-shot injection: first vectored write
            # severs, everything after flows
            fired = {"n": 0}

            def inject_once():
                fired["n"] += 1
                return fired["n"] == 1

            client._inject_failure = inject_once
            conn = await client.connect(server.addr, "srv")
            conn.send(self._big_op(1))  # severed mid-segment-list
            await asyncio.sleep(0.3)
            assert sink.got == []  # the half-frame never decoded
            assert sink.resets >= 1  # ...and the peer saw a clean reset
            # client resend path: a fresh connect + send delivers intact
            conn2 = await client.connect(server.addr, "srv")
            assert conn2 is not conn  # the severed conn was dropped
            msg = self._big_op(1)
            conn2.send(msg)
            await asyncio.sleep(0.3)
            assert len(sink.got) == 1
            got = sink.got[0]
            assert isinstance(got, messages.MOSDOp)
            assert got.oid == "obj-1" and got.tid == 1
            assert [bytes(b) for b in got.blobs] == \
                [bytes(b) for b in msg.blobs]
            await client.shutdown()
            await server.shutdown()

        run(main())

    def test_continuous_injection_never_yields_half_frames(self):
        """1-in-4 injection over a stream of multi-blob vectored frames:
        every frame that ARRIVES carries its full blobs byte-exact;
        severed ones vanish entirely (crc/length framing)."""

        async def main():
            sink = _ResetSink()
            server = AsyncMessenger("srv", sink)
            await server.bind()
            cfg = Config(overrides={"ms_inject_socket_failures": 4})
            client = AsyncMessenger("cli", _ResetSink())
            client.apply_config(cfg)
            sent = {}
            for i in range(40):
                try:
                    conn = await client.connect(server.addr, "srv")
                    conn.send(self._big_op(i))
                    sent[i] = self._big_op(i)
                except (ConnectionError, OSError):
                    continue  # injected failure mid-handshake
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.3)
            assert sink.resets > 0  # severs really happened
            assert 0 < len(sink.got) < len(sent)  # ...and ate frames
            for got in sink.got:
                want = sent[got.tid]
                assert [bytes(b) for b in got.blobs] == \
                    [bytes(b) for b in want.blobs], got.tid
            await client.shutdown()
            await server.shutdown()

        run(main())


# ======================================================================
# twins of the reference's test_throttle.py (TestThrottle)
# ======================================================================

class TestThrottle:
    def test_unlimited_never_blocks(self):
        async def main():
            t = Throttle("t", 0)
            for _ in range(100):
                await t.acquire(10**9)
            assert t.get_current() == 100 * 10**9

        run(main())

    def test_blocks_and_wakes_fifo(self):
        async def main():
            t = Throttle("t", 10)
            await t.acquire(8)
            order = []

            async def taker(tag, n):
                await t.acquire(n)
                order.append(tag)

            t1 = asyncio.ensure_future(taker("a", 5))
            await asyncio.sleep(0.01)
            t2 = asyncio.ensure_future(taker("b", 1))
            await asyncio.sleep(0.01)
            assert order == []  # 'a' blocks; 'b' queues FIFO behind it
            t.release(8)
            await asyncio.gather(t1, t2)
            assert order == ["a", "b"]
            assert t.get_current() == 6

        run(main())

    def test_oversized_request_admitted_alone(self):
        async def main():
            t = Throttle("t", 10)
            await t.acquire(50)  # > limit, current == 0: admitted
            got = []

            async def taker():
                await t.acquire(1)
                got.append(1)

            task = asyncio.ensure_future(taker())
            await asyncio.sleep(0.01)
            assert got == []
            t.release(50)
            await task
            assert got == [1]

        run(main())

    def test_multi_unit_release_wakes_fifo_no_overtaking(self):
        """One release big enough for several waiters wakes them in
        strict arrival order — and a small LATER request never
        overtakes a large older one even when the small one would fit
        (the head blocks the line until it fits)."""

        async def main():
            t = Throttle("t", 10)
            await t.acquire(10)
            order = []

            async def taker(tag, n):
                await t.acquire(n)
                order.append(tag)

            tasks = [
                asyncio.ensure_future(taker("big", 6)),
                asyncio.ensure_future(taker("mid", 3)),
                asyncio.ensure_future(taker("small", 1)),
            ]
            for _ in range(3):
                await asyncio.sleep(0)
            assert order == []
            t.release(4)  # 'small' would fit; 'big' (head) would not
            await asyncio.sleep(0.01)
            assert order == []  # no overtaking: the head holds the line
            t.release(6)  # now 10 free: big(6) + mid(3) + small(1) fit
            await asyncio.gather(*tasks)
            assert order == ["big", "mid", "small"]
            assert t.get_current() == 10

        run(main())

    def test_dump_reports_oldest_waiter_age(self):
        async def main():
            t = Throttle("t", 10)
            await t.acquire(10)
            assert t.dump()["oldest_waiter_age"] == 0.0
            task = asyncio.ensure_future(t.acquire(5))
            await asyncio.sleep(0.05)
            d = t.dump()
            assert d["waiters"] == 1
            assert 0.03 <= d["oldest_waiter_age"] < 30.0
            t.release(10)
            await task
            assert t.dump()["oldest_waiter_age"] == 0.0

        run(main())

    def test_cancelled_head_wakes_the_line(self):
        """A cancelled HEAD waiter must re-run the wake loop: the
        waiter behind it may fit NOW, and no further release is coming
        (the missed-wakeup wedge)."""

        async def main():
            t = Throttle("t", 10)
            await t.acquire(9)
            got = []

            async def taker(tag, n):
                await t.acquire(n)
                got.append(tag)

            big = asyncio.ensure_future(taker("big", 5))
            small = asyncio.ensure_future(taker("small", 1))
            for _ in range(3):
                await asyncio.sleep(0)
            assert got == []
            big.cancel()
            with pytest.raises(asyncio.CancelledError):
                await big
            async with asyncio.timeout(2):
                await small  # woken by the cancellation, not a release
            assert got == ["small"] and t.get_current() == 10

        run(main())

    def test_cancelled_waiter_releases_slot(self):
        async def main():
            t = Throttle("t", 10)
            await t.acquire(10)
            task = asyncio.ensure_future(t.acquire(5))
            await asyncio.sleep(0.01)
            assert t.waiters() == 1
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            assert t.waiters() == 0
            t.release(10)
            await t.acquire(10)  # full budget available again

        run(main())


# ======================================================================
# twins of the reference's test_recv_pool.py (TestRecvPoolUnit)
# ======================================================================

class TestRecvPoolUnit:
    def test_checkout_release_reuses_block(self):
        pool = RecvPool()
        blk = pool.checkout(1000)
        assert blk.cap == 4096  # smallest class that fits
        blk.buf[:4] = b"abcd"
        blk.release()
        blk2 = pool.checkout(2000)
        assert blk2 is blk  # identity reuse: allocation-free
        assert pool.stats()["free"][4096] == 0

    def test_class_ladder_and_oversize(self):
        pool = RecvPool()
        assert pool.checkout(4096).cap == 4096
        assert pool.checkout(4097).cap == 16384
        assert pool.checkout(1 << 20).cap == 1 << 20
        big = pool.checkout((1 << 20) + 1)
        assert big.cap == (1 << 20) + 1  # exact, not a class
        big.release()  # oversize: dropped, never pooled
        assert all(n == 0 for n in pool.stats()["free"].values())

    def test_release_idempotent(self):
        pool = RecvPool()
        blk = pool.checkout(100)
        blk.release()
        blk.release()  # second release must not double-insert
        assert pool.stats()["free"][4096] == 1

    def test_free_list_bounds(self):
        pool = RecvPool(per_class=2, max_held_bytes=1 << 30)
        blocks = [pool.checkout(100) for _ in range(5)]
        for b in blocks:
            b.release()
        st = pool.stats()
        assert st["free"][4096] == 2  # count cap
        assert st["held_bytes"] == 2 * 4096
        pool2 = RecvPool(per_class=64, max_held_bytes=8192)
        blocks = [pool2.checkout(100) for _ in range(5)]
        for b in blocks:
            b.release()
        assert pool2.stats()["held_bytes"] <= 8192  # byte cap

    def test_held_view_quarantines_then_recycles(self):
        """The lifetime pin: a view held past release keeps the block
        un-recycled (its bytes stay intact under further pool churn);
        dropping the view lets the next pool operation recycle it."""
        pool = RecvPool()
        blk = pool.checkout(64)
        blk.buf[:5] = b"hello"
        view = blk.view(5)
        blk.release()
        st = pool.stats()
        assert st["quarantined"] == 1
        assert st["free"][4096] == 0  # NOT on the free list
        # churn the pool: the quarantined block must never be handed out
        for _ in range(8):
            other = pool.checkout(64)
            assert other is not blk
            other.buf[:5] = b"XXXXX"
            other.release()
        assert bytes(view) == b"hello"  # bytes intact throughout
        view.release()
        pool.checkout(64).release()  # any traffic sweeps
        st = pool.stats()
        assert st["quarantined"] == 0
        assert blk in pool._free[4096]  # recycled at last-view death

    def test_quarantine_bound_drops_to_gc(self):
        pool = RecvPool(quarantine_max=3)
        views = []
        for i in range(6):
            b = pool.checkout(64)
            b.buf[:1] = bytes([i])
            views.append(b.view(1))
            b.release()
        assert pool.stats()["quarantined"] <= 3
        # evicted blocks stay valid: the views own their bytearrays
        for i, v in enumerate(views):
            assert v[0] == i

    def test_counters_fed(self):
        stack_ledger.reset_stack()
        pool = RecvPool()
        blk = pool.checkout(100)  # miss
        blk.release()
        for _ in range(3):
            pool.checkout(100).release()  # hits (tally flushed on put)
        pc = stack_ledger.stack_perf()
        assert int(pc.get("recv_allocs")) == 1
        assert int(pc.get("recv_slab_hits")) == 3
        assert int(pc.get("frame_allocs")) >= 1  # miss also books here
        assert int(pc.get("recv_bytes_held")) == 4096


# ======================================================================
# twins of the reference's test_auth.py (TestTickets, TestReplayProtection's unit cases)
# ======================================================================

class TestTickets:
    def test_issue_verify(self):
        secret = new_secret()
        t = Ticket.issue(secret, "osd.1")
        assert Ticket.verify(secret, t) == "osd.1"

    def test_tampered_rejected(self):
        secret = new_secret()
        t = Ticket.issue(secret, "client.admin")
        t2 = {**t, "entity": "client.evil"}
        assert Ticket.verify(secret, t2) is None
        t3 = {**t, "sig": "0" * 64}
        assert Ticket.verify(secret, t3) is None
        assert Ticket.verify(secret, None) is None
        assert Ticket.verify(secret, {"entity": "x"}) is None

    def test_wrong_cluster_secret(self):
        t = Ticket.issue(new_secret(), "osd.1")
        assert Ticket.verify(new_secret(), t) is None

    def test_expired(self):
        secret = new_secret()
        t = Ticket.issue(secret, "osd.1", lifetime=-1.0)
        assert Ticket.verify(secret, t) is None

    def test_keyring_roundtrip(self, tmp_path):
        kr = Keyring.generate(["client.admin", "client.rgw"])
        path = str(tmp_path / "keyring")
        kr.save(path)
        kr2 = Keyring.load(path)
        assert kr2.cluster_secret == kr.cluster_secret
        assert kr2.get("client.admin") == kr.get("client.admin")

    def test_challenge_response_depends_on_both(self):
        s, n = new_secret(), new_secret()
        assert challenge_response(s, n) != challenge_response(s, new_secret())
        assert challenge_response(s, n) != challenge_response(new_secret(), n)


class TestReplayProtection:
    """The handshake challenge: ticket bytes alone (observable on the
    wire) must not authenticate a connection (CVE-2018-1128 analog)."""

    def test_session_key_seal_roundtrip(self):
        from ceph_tpu_torch.auth import seal_skey, unseal_skey

        cluster, entity = new_secret(), new_secret()
        t = Ticket.issue(cluster, "client.a")
        skey = Ticket.session_key(cluster, t)
        sealed = seal_skey(entity, t, skey)
        assert sealed != skey
        assert unseal_skey(entity, t, sealed) == skey
        # wrong entity secret recovers garbage, not the key
        assert unseal_skey(new_secret(), t, sealed) != skey

    def test_verify_demands_proof_when_challenged(self):
        cs = new_secret()
        server = AuthContext("osd.0", cluster_secret=cs, require=True)
        client = AuthContext("client.a", cluster_secret=cs)
        authz = client.authorizer()
        # unchallenged path still verifies the ticket
        assert server.verify(authz) == "client.a"
        nonce = new_secret()
        # ticket without proof: rejected
        assert server.verify(authz, challenge=nonce, proof=None) is None
        # stale proof (for another nonce): rejected
        stale = client.prove(new_secret())
        assert server.verify(authz, challenge=nonce, proof=stale) is None
        # correct proof: accepted
        assert server.verify(
            authz, challenge=nonce, proof=client.prove(nonce)
        ) == "client.a"

    def test_require_without_secret_fails_closed(self):
        with pytest.raises(ValueError):
            AuthContext("osd.0", require=True)


# ======================================================================
# cross-package wire checks: the port and the reference on one wire
# ======================================================================


def _ref():
    from ceph_tpu.msg import message as ref_msgmod
    from ceph_tpu.msg import messages as ref_messages

    return ref_msgmod, ref_messages


def _pair(tid: int, blobs=()):
    """The same sample fields as one message of each package."""
    ref_msgmod, _ = _ref()
    cls, rcls = msgmod._REGISTRY[tid], ref_msgmod._REGISTRY[tid]
    kw = {f: _BY_NAME.get(f, _FALLBACK[i % len(_FALLBACK)])
          for i, f in enumerate(cls.FIELDS)}
    m, r = cls(**kw), rcls(**kw)
    m.blobs, r.blobs = list(blobs), list(blobs)
    return m, r


class TestCrossPackageWire:
    def test_type_id_tables_and_manifests_are_equal(self):
        import os

        import ceph_tpu.msg as ref_msg

        import ceph_tpu_torch.msg as port_msg

        ref_msgmod, _ = _ref()
        table = {t: (c.__name__, c.TYPE, c.FIELDS, c.WIRE_TAIL)
                 for t, c in msgmod._REGISTRY.items()}
        ref_table = {t: (c.__name__, c.TYPE, c.FIELDS, c.WIRE_TAIL)
                     for t, c in ref_msgmod._REGISTRY.items()}
        assert table == ref_table
        manifests = []
        for pkg in (port_msg, ref_msg):
            path = os.path.join(os.path.dirname(pkg.__file__),
                                "wire_manifest.json")
            with open(path) as f:
                manifests.append(json.load(f))
        assert manifests[0] == manifests[1]
        assert {c.TYPE: t for t, c in msgmod._REGISTRY.items()} == \
            manifests[0]["types"]

    @pytest.mark.parametrize("traced", [False, True])
    def test_every_type_encodes_byte_identical_and_cross_decodes(
            self, traced, monkeypatch):
        # frozen clock: a traced frame carries a send stamp
        monkeypatch.setattr(time, "monotonic", lambda: 4242.125)
        ref_msgmod, _ = _ref()
        rng = np.random.default_rng(17)
        payload = rng.integers(0, 256, size=5000, dtype=np.uint8)
        blobs = [b"", payload.tobytes(), b"tail" * 9]
        for tid in sorted(msgmod._REGISTRY):
            m, r = _pair(tid, blobs)
            if traced:
                m.trace = r.trace = f"osd.3:t{tid}"
            port_f = encode_frame(m, 77)
            ref_f = ref_msgmod.encode_frame(r, 77)
            name = type(m).__name__
            assert port_f == ref_f, name
            # each package reads the other's frame
            got, seq = decode_frame(ref_f)
            assert seq == 77 and type(got) is type(m), name
            assert got.fields() == m.fields(), name
            assert [bytes(b) for b in got.blobs] == \
                [bytes(b) for b in blobs], name
            assert got.trace == m.trace, name
            rgot, rseq = ref_msgmod.decode_frame(port_f)
            assert rseq == 77 and type(rgot) is type(r), name
            assert rgot.fields() == r.fields(), name
            assert [bytes(b) for b in rgot.blobs] == \
                [bytes(b) for b in blobs], name

    @pytest.mark.parametrize("with_blobs", [False, True])
    def test_batch_frames_byte_identical_and_cross_decode(
            self, with_blobs, monkeypatch):
        monkeypatch.setattr(time, "monotonic", lambda: 99.5)
        ref_msgmod, ref_messages = _ref()
        if with_blobs:
            # the multi-op REQUEST layout (per-member blob tables)
            kws = [dict(tid=i, epoch=2, pool=1, oid=f"o{i}",
                        ops=[{"op": "writefull", "data": 0}])
                   for i in range(5)]
            blobs = [[bytes([i]) * (300 + 7 * i)] for i in range(5)]
            port = [messages.MOSDOp(**kw, blobs=list(b))
                    for kw, b in zip(kws, blobs)]
            ref = [ref_messages.MOSDOp(**kw, blobs=list(b))
                   for kw, b in zip(kws, blobs)]
        else:
            # the coalesced-ack layout
            kws = [dict(tid=i, result=0, epoch=1) for i in range(6)]
            port = [messages.MOSDOpReply(**kw) for kw in kws]
            ref = [ref_messages.MOSDOpReply(**kw) for kw in kws]
        for m, r in zip(port, ref):
            m.trace = r.trace = f"client.4:t{m.tid}"
        segs, _n, rel = encode_batch_frame(port, 30)
        port_f = _flat(segs)
        rel()
        rsegs, _rn, rrel = ref_msgmod.encode_batch_frame(ref, 30)
        ref_f = _flat(rsegs)
        rrel()
        assert port_f == ref_f
        got, seq0 = decode_frame_msgs(ref_f)
        rgot, rseq0 = ref_msgmod.decode_frame_msgs(port_f)
        assert seq0 == rseq0 == 30
        for a, b, want in zip(got, rgot, port):
            assert a.fields() == b.fields() == want.fields()
            assert a.trace == b.trace == want.trace
            assert [bytes(x) for x in a.blobs] == \
                [bytes(x) for x in b.blobs] == \
                [bytes(x) for x in want.blobs]

    def test_transaction_wire_form_is_shared(self):
        """A shard Transaction encoded by either package decodes in the
        other to the same op list (the ECSubWrite payload)."""
        from ceph_tpu.msg import messages as ref_messages
        from ceph_tpu.store import CollectionId as RCid
        from ceph_tpu.store import ObjectId as ROid
        from ceph_tpu.store import Transaction as RTxn

        def build(T, C, O):
            c, o = C("1.2s0"), O("obj", shard=0)
            return (T().create_collection(c).touch(c, o)
                    .write(c, o, 128, b"chunkdata").zero(c, o, 0, 16)
                    .setattr(c, o, "hinfo_key", b"\x01\x02")
                    .omap_setkeys(c, o, {"k1": b"v1", "k2": b"v2"})
                    .clone(c, o, O("obj2", shard=0)).remove(c, o))

        t = build(Transaction, CollectionId, ObjectId)
        rt = build(RTxn, RCid, ROid)
        wire, blobs = messages.encode_txn(t)
        rwire, rblobs = ref_messages.encode_txn(rt)
        assert wire == rwire
        assert [bytes(b) for b in blobs] == [bytes(b) for b in rblobs]
        assert repr(ref_messages.decode_txn(wire, blobs).ops) == \
            repr(t.ops)
        assert repr(messages.decode_txn(rwire, rblobs).ops) == \
            repr(rt.ops)

    def test_messengers_of_both_packages_talk(self):
        """A port messenger and a reference messenger handshake over
        loopback and exchange pings both ways, with the trace id of the
        sender restored on the receiving side."""
        from ceph_tpu.msg import AsyncMessenger as RefMessenger
        from ceph_tpu.msg import Dispatcher as RefDispatcher
        from ceph_tpu.msg import messages as ref_messages

        class Got:
            def __init__(self):
                self.got = []

            async def ms_dispatch(self, conn, msg):
                self.got.append((conn.peer_name, msg))

            def ms_handle_reset(self, conn):
                pass

        class PortGot(Got, Dispatcher):
            pass

        class RefGot(Got, RefDispatcher):
            pass

        async def main():
            pd, rd = PortGot(), RefGot()
            port = AsyncMessenger("osd.7", pd)
            ref = RefMessenger("osd.8", rd)
            await port.bind()
            await ref.bind()
            c1 = await port.connect(ref.addr, "osd.8")
            m = messages.MPing(stamp=1.5, epoch=3)
            m.trace = "osd.7:t1"
            c1.send(m)
            c2 = await ref.connect(port.addr, "osd.7")
            c2.send(ref_messages.MPing(stamp=2.5, epoch=4))
            while not (pd.got and rd.got):
                await asyncio.sleep(0.005)
            assert rd.got[0][0] == "osd.7"
            assert rd.got[0][1].stamp == 1.5
            assert rd.got[0][1].trace == "osd.7:t1"
            assert pd.got[0][0] == "osd.8"
            assert type(pd.got[0][1]) is messages.MPing
            assert pd.got[0][1].stamp == 2.5
            await port.shutdown()
            await ref.shutdown()

        run(main())

    def test_dispatch_restores_the_ports_trace_context(self):
        """The port's messenger restores an inbound frame's trace id
        into the PORT's ``current_trace`` (the variable the port's EC
        dispatcher reads), never the reference's."""
        from ceph_tpu.common import tracing as ref_tracing

        from ceph_tpu_torch.common import tracing

        seen = []

        class Probe(Dispatcher):
            async def ms_dispatch(self, conn, msg):
                seen.append((tracing.current_trace.get(),
                             ref_tracing.current_trace.get()))

            def ms_handle_reset(self, conn):
                pass

        async def main():
            server = AsyncMessenger("osd.9", Probe())
            await server.bind()
            client = AsyncMessenger("client.9", Probe())
            conn = await client.connect(server.addr)
            m = messages.MPing(stamp=0.5, epoch=1)
            m.trace = "client.9:t42"
            conn.send(m)
            while not seen:
                await asyncio.sleep(0.005)
            assert seen[0] == ("client.9:t42", None)
            await client.shutdown()
            await server.shutdown()

        run(main())


def test_crc32c_view_matches_the_reference():
    from ceph_tpu.utils import native as ref_native

    from ceph_tpu_torch.utils import native

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=70001, dtype=np.uint8).tobytes()
    for buf in (data, bytearray(data), memoryview(data)[5:],
                memoryview(bytearray(data))[:4097], b""):
        for n in (None, 0, 3):
            if n is not None and n > len(buf):
                continue
            assert native.crc32c_view(0xFFFFFFFF, buf, n) == \
                ref_native.crc32c_view(0xFFFFFFFF, buf, n)


def test_wire_profile_tool_times_and_profiles_a_round(capsys):
    """``tools/wire_profile.py`` carries echo frames over loopback and
    prints one timed round, one profiled round and its top functions."""
    from ceph_tpu_torch.tools import wire_profile

    assert wire_profile.main(["--objects", "8", "--object-mib", "1",
                              "--per-rpc", "2", "--clients", "2",
                              "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(
        "the messenger alone (4 RPCs of 2 MiB out and 2 MiB back over 2 "
        "client messengers, no erasure code): "), out
    assert out[1].startswith("profiled round: ") and len(out) == 5, out
