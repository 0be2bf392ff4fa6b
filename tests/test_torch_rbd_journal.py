"""The port's RBD journal and rbd-mirror (``ceph_tpu_torch.rbd.journal``,
``ceph_tpu_torch.rbd.mirror``) held against the reference's, on the CPU.

- **Framing:** ``encode_frame`` writes the reference's bytes (``struct``
  lengths, a ``zlib`` crc, a JSON header), on the reference case's frames
  and on seeded random ones, and each package's ``decode_frames`` reads
  the other's frames, torn and corrupt tails included, to the same events.
- **Twins** of every case of ``tests/test_rbd_journal.py`` (a client that
  dies between journaling and applying a write, idempotent replay,
  discard and resize events, a torn tail, commit and trim, an image
  without the feature) and of ``tests/test_rbd_mirror.py`` (bootstrap and
  incremental replay, a re-bootstrap over a stale copy, resize, the
  refusals, a bootstrap under a live writer, a read-only open, a mirror
  client that holds trim).  Each runs on both packages' ``MiniCluster``s
  through ``tests/test_torch_rbd.py``'s ``twin``: the reads, errnos and
  replay counts, every journal object's frames decoded by both packages,
  and at the end every pool's head objects (bytes, xattrs, omap: the
  headers' commit positions and journal clients among them) must be equal.
  ``TRIM_BYTES`` is set in the package's own ``rbd.journal`` for the
  length of a case, as the reference's cases set it.

Every scenario runs under ``asyncio.wait_for``.
"""

import json
import zlib

import numpy as np
import pytest

import ceph_tpu.rbd.journal as ref_journal
import ceph_tpu_torch.rbd.journal as port_journal
from ceph_tpu_torch.rbd.journal import COMMIT_KEY, JOURNAL_PREFIX
from tests.test_torch_rbd import OBJ, ORDER, twin

JOURNALS = {"ref": ref_journal, "port": port_journal}


def _frames(journal, buf, start=0):
    return [(end, hdr, payload) for end, hdr, payload in journal.decode_frames(buf, start)]


# -- framing ---------------------------------------------------------------------------


class TestFraming:
    def test_roundtrip_and_torn_tail(self):
        for enc in JOURNALS.values():
            f1 = enc.encode_frame({"tid": 1, "op": "write", "off": 0}, b"abc")
            f2 = enc.encode_frame({"tid": 2, "op": "discard", "off": 9, "len": 4})
            f3 = enc.encode_frame({"tid": 3, "op": "write", "off": 5}, b"zz")
            buf = f1 + f2
            bad = bytearray(buf + f3)
            bad[-1] ^= 0xFF
            for dec in JOURNALS.values():
                frames = _frames(dec, buf)
                assert [h["tid"] for _e, h, _p in frames] == [1, 2]
                assert frames[0][2] == b"abc" and frames[1][2] == b""
                for cut in (1, 7, len(f3) - 1):
                    assert [h["tid"] for _e, h, _p in _frames(dec, buf + f3[:cut])] == [1, 2]
                assert [h["tid"] for _e, h, _p in _frames(dec, bytes(bad))] == [1, 2]

    def test_decode_from_offset(self):
        for enc in JOURNALS.values():
            f1 = enc.encode_frame({"tid": 1, "op": "write", "off": 0}, b"abc")
            f2 = enc.encode_frame({"tid": 2, "op": "write", "off": 3}, b"de")
            for dec in JOURNALS.values():
                frames = _frames(dec, f1 + f2, start=len(f1))
                assert len(frames) == 1 and frames[0][1]["tid"] == 2

    def test_frames_are_the_references_bytes(self):
        rng = np.random.default_rng(18)
        for tid in range(64):
            hdr = {"tid": tid, "op": ["write", "discard", "resize"][tid % 3],
                   "off": int(rng.integers(0, 1 << 30)), "len": int(rng.integers(0, 1 << 20))}
            payload = rng.integers(0, 256, int(rng.integers(0, 600)), dtype=np.uint8).tobytes()
            frame = port_journal.encode_frame(hdr, payload)
            assert frame == ref_journal.encode_frame(hdr, payload)
            body = frame[12:]
            assert int.from_bytes(frame[4:8], "big") == zlib.crc32(body)
            assert json.loads(body[: int.from_bytes(frame[8:12], "big")]) == hdr


# -- twins -------------------------------------------------------------------------------


async def _journaled_image(r, name="jimg", size=8 * OBJ):
    _cl, io = await r.pool(size=2)
    rbd = r.RBD(io)
    await rbd.create(name, size, order=ORDER, features=["journaling"])
    return io, rbd


async def _journal(r, io, image_id, what="journal"):
    """The image's journal object decoded by both packages: the same
    events, recorded."""
    try:
        buf = bytes(await io.read(JOURNAL_PREFIX + image_id))
    except Exception as e:
        if type(e).__name__ not in ("RadosError", "RbdError"):
            raise
        buf = b""
    frames = {who: _frames(j, buf) for who, j in JOURNALS.items()}
    assert frames["port"] == frames["ref"]
    return r.note(what, frames["port"])


def _journal_module(r):
    return JOURNALS[r.P.name]


class TestCrashReplay:
    def test_client_dies_between_journal_and_data_write(self):
        async def scenario(r):
            io, _rbd = await _journaled_image(r)
            img = await r.Image.open(io, "jimg")
            await img.write(0, b"base" * 1000)

            async def dead_apply(offset, data):
                raise RuntimeError("client died mid-write")

            img._apply_write_data = dead_apply
            with pytest.raises(RuntimeError):
                await img.write(OBJ - 100, b"X" * 300)  # spans 2 objects
            await _journal(r, io, img.image_id, "journal at the crash")
            img2 = await r.Image.open(io, "jimg")
            assert await r.call("replayed", img2.read(OBJ - 100, 300)) == b"X" * 300
            assert await img2.read(0, 4000) == b"base" * 1000
            await img2.close()

        twin(scenario)

    def test_replay_is_idempotent_across_reopens(self):
        async def scenario(r):
            io, _rbd = await _journaled_image(r)
            img = await r.Image.open(io, "jimg")
            await img.write(100, b"A" * 500)
            await img.write(OBJ, b"B" * 500)
            await io.omap_set(img.header, {COMMIT_KEY: b"0"})
            for i in range(2):
                reopened = await r.Image.open(io, "jimg")
                assert await r.call(f"A {i}", reopened.read(100, 500)) == b"A" * 500
                assert await r.call(f"B {i}", reopened.read(OBJ, 500)) == b"B" * 500
                await reopened.close()

        twin(scenario)

    def test_discard_and_resize_replay(self):
        async def scenario(r):
            io, _rbd = await _journaled_image(r)
            img = await r.Image.open(io, "jimg")
            await img.write(0, b"D" * (2 * OBJ))

            async def dead_discard(offset, length):
                raise RuntimeError("died mid-discard")

            img._apply_discard_data = dead_discard
            with pytest.raises(RuntimeError):
                await img.discard(0, OBJ)
            img2 = await r.Image.open(io, "jimg")
            assert await r.call("discarded", img2.read(0, OBJ)) == b"\x00" * OBJ
            assert await img2.read(OBJ, OBJ) == b"D" * OBJ
            await img2.resize(3 * OBJ)
            assert r.note("resized", img2.size_bytes) == 3 * OBJ
            await _journal(r, io, img2.image_id)
            await img2.close()

        twin(scenario)

    def test_torn_journal_tail_ignored_on_open(self):
        async def scenario(r):
            io, _rbd = await _journaled_image(r)
            img = await r.Image.open(io, "jimg")
            await img.write(0, b"ok" * 100)
            await img.close()
            frame = _journal_module(r).encode_frame(
                {"tid": 99, "op": "write", "off": 0}, b"GARBAGE" * 50)
            await io.append(JOURNAL_PREFIX + img.image_id, frame[:17])
            img2 = await r.Image.open(io, "jimg")
            assert await r.call("read", img2.read(0, 200)) == b"ok" * 100

            async def dead_apply(offset, data):
                raise RuntimeError("died again")

            img2._apply_write_data = dead_apply
            with pytest.raises(RuntimeError):
                await img2.write(500, b"more")
            await _journal(r, io, img.image_id)
            img3 = await r.Image.open(io, "jimg")
            assert await r.call("replayed", img3.read(500, 4)) == b"more"
            await img3.close()

        twin(scenario)


class TestJournalMaintenance:
    def test_commit_position_advances_and_trims(self, monkeypatch):
        async def scenario(r):
            J = _journal_module(r)
            io, _rbd = await _journaled_image(r)
            img = await r.Image.open(io, "jimg")
            monkeypatch.setattr(J, "TRIM_BYTES", 4096)
            for i in range(J.COMMIT_EVERY + 2):
                await img.write(0, bytes([i]) * 600)
            h = await io.omap_get(img.header)
            r.note("commit before close", bytes(h.get(COMMIT_KEY, b"0")))
            await img.close()
            h = await io.omap_get(img.header)
            committed = int(h[COMMIT_KEY])
            await _journal(r, io, img.image_id)
            assert r.note("committed", committed) >= 0
            try:
                jlen = len(await io.read(JOURNAL_PREFIX + img.image_id))
            except Exception:
                jlen = 0
            assert committed == jlen, (committed, jlen)
            monkeypatch.undo()
            img2 = await r.Image.open(io, "jimg")
            assert (await r.call("read", img2.read(0, 600)))[:1] == bytes([J.COMMIT_EVERY + 1])
            await img2.close()

        twin(scenario)

    def test_unjournaled_image_has_no_journal(self):
        async def scenario(r):
            _cl, io = await r.pool(size=2)
            await r.RBD(io).create("plain", 4 * OBJ, order=ORDER)
            img = await r.Image.open(io, "plain")
            assert img._journal is None
            await img.write(0, b"x" * 100)
            await img.close()

        twin(scenario)


# -- tests/test_rbd_mirror.py -------------------------------------------------------------


async def _mirror_setup(r):
    cl = await r.cluster.client()
    await cl.create_pool("src", "replicated", size=2)
    await cl.create_pool("dst", "replicated", size=2)
    sio, dio = cl.io_ctx("src"), cl.io_ctx("dst")
    await r.RBD(sio).create("vol", 6 * OBJ, order=ORDER, features=["journaling"])
    return sio, dio


def _mirrorer(r, *a, **kw):
    return r.P.rbd.ImageMirrorer(*a, **kw)


class TestMirror:
    def test_bootstrap_and_incremental_replay(self):
        async def scenario(r):
            sio, dio = await _mirror_setup(r)
            img = await r.Image.open(sio, "vol")
            await img.write(0, b"pre-mirror" * 100)
            await img.close()
            m = _mirrorer(r, sio, dio, "vol")
            await m.bootstrap()
            dst = await r.Image.open(dio, "vol")
            assert await r.call("bootstrapped", dst.read(0, 1000)) == b"pre-mirror" * 100
            await dst.close()
            img = await r.Image.open(sio, "vol")
            await img.write(2 * OBJ, b"delta" * 200)
            await img.discard(0, 10)
            await _journal(r, sio, img.image_id)
            await img.close()
            assert await r.call("applied", m.sync()) >= 2
            dst = await r.Image.open(dio, "vol")
            assert await r.call("delta", dst.read(2 * OBJ, 1000)) == b"delta" * 200
            assert await dst.read(0, 10) == b"\x00" * 10
            await dst.close()
            assert await r.call("idle sync", m.sync()) == 0

        twin(scenario, n_osds=4)

    def test_rebootstrap_overwrites_stale_destination(self):
        async def scenario(r):
            sio, dio = await _mirror_setup(r)
            m = _mirrorer(r, sio, dio, "vol")
            await m.bootstrap()
            img = await r.Image.open(sio, "vol")
            await img.write(OBJ, b"Z" * 1000)
            await img.close()
            await m.sync()
            dst = await r.Image.open(dio, "vol")
            assert await dst.read(OBJ, 1000) == b"Z" * 1000
            await dst.close()
            img = await r.Image.open(sio, "vol")
            await img.discard(OBJ, 1000)
            await img.close()
            m2 = _mirrorer(r, sio, dio, "vol", mirror_id="peer2")
            await m2.bootstrap()
            dst = await r.Image.open(dio, "vol")
            assert await r.call("zeroed", dst.read(OBJ, 1000)) == b"\x00" * 1000
            await dst.close()

        twin(scenario, n_osds=4)

    def test_resize_replicates(self):
        async def scenario(r):
            sio, dio = await _mirror_setup(r)
            m = _mirrorer(r, sio, dio, "vol")
            await m.bootstrap()
            img = await r.Image.open(sio, "vol")
            await img.resize(2 * OBJ)
            await img.close()
            await m.sync()
            dst = await r.Image.open(dio, "vol")
            assert r.note("size", dst.size_bytes) == 2 * OBJ
            await dst.close()

        twin(scenario, n_osds=4)

    def test_unjournaled_image_rejected(self):
        async def scenario(r):
            cl = await r.cluster.client()
            await cl.create_pool("src", "replicated", size=2)
            await cl.create_pool("dst", "replicated", size=2)
            sio, dio = cl.io_ctx("src"), cl.io_ctx("dst")
            await r.RBD(sio).create("plain", 2 * OBJ, order=ORDER)
            await r.fails("bootstrap", _mirrorer(r, sio, dio, "plain").bootstrap())

        twin(scenario, n_osds=4)

    def test_bootstrap_with_live_writer_is_readonly(self, monkeypatch):
        async def scenario(r):
            J = _journal_module(r)
            sio, dio = await _mirror_setup(r)
            monkeypatch.setattr(J, "TRIM_BYTES", 1024)
            img = await r.Image.open(sio, "vol")  # live writer
            await img.write(0, b"A" * 2000)
            m = _mirrorer(r, sio, dio, "vol")
            await m.bootstrap()
            await img.write(OBJ, b"B" * 500)
            await img.close()
            assert await r.call("applied", m.sync()) >= 1
            dst = await r.Image.open(dio, "vol")
            assert await r.call("A", dst.read(0, 2000)) == b"A" * 2000
            assert await r.call("B", dst.read(OBJ, 500)) == b"B" * 500
            assert "journaling" in r.note("features", list(dst.features))
            await dst.close()
            monkeypatch.undo()

        twin(scenario, n_osds=4)

    def test_readonly_open_rejects_writes(self):
        async def scenario(r):
            sio, _dio = await _mirror_setup(r)
            ro = await r.Image.open(sio, "vol", read_only=True)
            assert ro._journal is None
            assert (await r.fails("write", ro.write(0, b"x")))[1] == -30  # EROFS
            await ro.close()

        twin(scenario, n_osds=4)

    def test_registered_client_holds_trim(self, monkeypatch):
        async def scenario(r):
            J = _journal_module(r)
            sio, dio = await _mirror_setup(r)
            m = _mirrorer(r, sio, dio, "vol")
            await m.bootstrap()
            monkeypatch.setattr(J, "TRIM_BYTES", 2048)
            img = await r.Image.open(sio, "vol")
            payloads = []
            for i in range(J.COMMIT_EVERY + 3):
                data = bytes([i + 1]) * 300
                payloads.append((i * 512, data))
                await img.write(i * 512, data)
            await img.close()
            frames = await _journal(r, sio, m.image_id, "held journal")
            assert frames, "journal trimmed past an unconsumed mirror client"
            assert await r.call("applied", m.sync()) == J.COMMIT_EVERY + 3
            dst = await r.Image.open(dio, "vol")
            for off, data in payloads:
                assert await dst.read(off, len(data)) == data
            await dst.close()
            img = await r.Image.open(sio, "vol")
            for _ in range(J.COMMIT_EVERY + 1):
                await img.write(0, b"t" * 300)
            await img.close()
            await m.sync()
            img = await r.Image.open(sio, "vol")
            for _ in range(J.COMMIT_EVERY + 1):
                await img.write(4096, b"u" * 300)
            await img.close()
            await _journal(r, sio, m.image_id, "after the catch-up")
            monkeypatch.undo()

        twin(scenario, n_osds=4)
