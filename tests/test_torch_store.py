"""The port's object stores against the reference's.

- Twins of the reference's store tests that need no ``MiniCluster``,
  run on ``ceph_tpu_torch.store``: every test of ``tests/test_store.py``
  over the three stores (``mem``, ``wal``, ``blue``, with
  ``sync="none"`` as there), the first ten tests of
  ``tests/test_wal_store.py``, and ``TestAllocator``,
  ``TestAtRestIntegrity``, ``TestPersistenceAndCrash``,
  ``TestCompression`` and ``TestDoubleRemove`` of
  ``tests/test_blue_store.py``.
- Across the packages: the same transactions give the same journal
  record bytes, the same WalStore journal and checkpoint files and the
  same BlueStore block file and KV rows; a store written by either
  package mounts in the other with equal contents (and ``fsck()`` clean
  for BlueStore).
- The slice: ``chip_smoke.py`` phase 12's flow on the CPU (its restart,
  its three lost shards and its WalStore crash), and the shard stores it
  leaves against the reference's stores given the same inputs.

Tolerance: exact equality throughout.
"""

import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu_torch.store import (
    CollectionId,
    CrashPoint,
    MemStore,
    ObjectId,
    Transaction,
    WalStore,
)
from ceph_tpu_torch.store.blue import Allocator, BitrotError, BlueStore
from ceph_tpu_torch.store.wal import _HDR, decode_txn, encode_txn

# -- the ObjectStore contract, over the three stores (tests/test_store.py) --



@pytest.fixture(params=["mem", "wal", "blue"])
def store(request, tmp_path):
    """The ObjectStore CONTRACT suite runs against every backend:
    MemStore, WalStore (journal+checkpoint), and BlueStore (block file +
    KV onodes + at-rest checksums)."""
    if request.param == "mem":
        s = MemStore()
    elif request.param == "wal":
        s = WalStore(str(tmp_path / "wal"), sync="none")
    else:
        s = BlueStore(str(tmp_path / "blue"), sync="none")
    s.mkfs()
    s.mount()
    yield s
    s.umount()


CID = CollectionId("1.0s0")
OID = ObjectId("obj", shard=0)


def _mkcoll(store, cid=CID):
    store.apply(Transaction().create_collection(cid))


def test_collection_lifecycle(store):
    assert not store.collection_exists(CID)
    _mkcoll(store)
    assert store.collection_exists(CID)
    assert store.list_collections() == [CID]
    store.apply(Transaction().remove_collection(CID))
    assert not store.collection_exists(CID)


def test_write_read_extends(store):
    _mkcoll(store)
    store.apply(Transaction().write(CID, OID, 0, b"hello"))
    assert store.read(CID, OID) == b"hello"
    # overwrite middle + extend with hole
    store.apply(Transaction().write(CID, OID, 3, b"XY").write(CID, OID, 8, b"Z"))
    assert store.read(CID, OID) == b"helXY\x00\x00\x00Z"
    assert store.stat(CID, OID) == 9
    assert store.read(CID, OID, 3, 2) == b"XY"
    assert store.read(CID, OID, 8) == b"Z"


def test_zero_truncate_remove(store):
    _mkcoll(store)
    store.apply(Transaction().write(CID, OID, 0, b"abcdef"))
    store.apply(Transaction().zero(CID, OID, 1, 2))
    assert store.read(CID, OID) == b"a\x00\x00def"
    store.apply(Transaction().truncate(CID, OID, 2))
    assert store.read(CID, OID) == b"a\x00"
    store.apply(Transaction().truncate(CID, OID, 4))  # extend with zeros
    assert store.read(CID, OID) == b"a\x00\x00\x00"
    store.apply(Transaction().remove(CID, OID))
    assert not store.exists(CID, OID)
    with pytest.raises(KeyError):
        store.read(CID, OID)


def test_touch_and_clone(store):
    _mkcoll(store)
    store.apply(Transaction().touch(CID, OID))
    assert store.exists(CID, OID)
    assert store.stat(CID, OID) == 0
    store.apply(
        Transaction()
        .write(CID, OID, 0, b"payload")
        .setattr(CID, OID, "a", b"1")
        .omap_setkeys(CID, OID, {"k": b"v"})
    )
    dst = ObjectId("obj-clone", shard=0)
    store.apply(Transaction().clone(CID, OID, dst))
    assert store.read(CID, dst) == b"payload"
    assert store.getattr(CID, dst, "a") == b"1"
    assert store.omap_get(CID, dst) == {"k": b"v"}
    # clone is a copy, not a reference
    store.apply(Transaction().write(CID, OID, 0, b"PAYLOAD"))
    assert store.read(CID, dst) == b"payload"


def test_xattrs(store):
    _mkcoll(store)
    store.apply(
        Transaction().setattr(CID, OID, "hinfo_key", b"\x01\x02").setattr(CID, OID, "_", b"oi")
    )
    assert store.getattr(CID, OID, "hinfo_key") == b"\x01\x02"
    assert store.getattrs(CID, OID) == {"hinfo_key": b"\x01\x02", "_": b"oi"}
    store.apply(Transaction().rmattr(CID, OID, "_"))
    assert store.getattrs(CID, OID) == {"hinfo_key": b"\x01\x02"}


def test_omap(store):
    _mkcoll(store)
    store.apply(Transaction().omap_setkeys(CID, OID, {"b": b"2", "a": b"1", "c": b"3"}))
    assert store.omap_get(CID, OID) == {"a": b"1", "b": b"2", "c": b"3"}
    assert store.omap_get_keys(CID, OID, ["a", "zz"]) == {"a": b"1"}
    store.apply(Transaction().omap_rmkeys(CID, OID, ["a", "b"]))
    assert store.omap_get(CID, OID) == {"c": b"3"}
    store.apply(Transaction().omap_clear(CID, OID))
    assert store.omap_get(CID, OID) == {}


def test_list_objects_sorted(store):
    _mkcoll(store)
    t = Transaction()
    for name in ["zeta", "alpha", "mid"]:
        t.touch(CID, ObjectId(name, shard=0))
    store.apply(t)
    assert [o.name for o in store.list_objects(CID)] == ["alpha", "mid", "zeta"]


def test_missing_collection_raises(store):
    with pytest.raises(KeyError):
        store.apply(Transaction().touch(CID, OID))
    with pytest.raises(KeyError):
        store.list_objects(CID)


def test_transaction_atomic_under_single_apply(store):
    """All ops of one txn are visible together (single-lock replay)."""
    _mkcoll(store)
    t = (
        Transaction()
        .write(CID, OID, 0, b"data")
        .setattr(CID, OID, "v", b"1")
        .omap_setkeys(CID, OID, {"log": b"entry"})
    )
    assert len(t) == 3
    store.apply(t)
    assert store.read(CID, OID) == b"data"
    assert store.getattr(CID, OID, "v") == b"1"


def test_failed_transaction_rolls_back(store):
    """apply is all-or-nothing: a failing op undoes every prior op."""
    _mkcoll(store)
    store.apply(Transaction().write(CID, OID, 0, b"orig").setattr(CID, OID, "a", b"1"))
    bad = (
        Transaction()
        .write(CID, OID, 0, b"NEWDATA")
        .touch(CID, ObjectId("side", shard=0))
        .rmattr(CID, ObjectId("missing", shard=0), "k")  # fails: object absent
    )
    with pytest.raises(KeyError):
        store.apply(bad)
    assert store.read(CID, OID) == b"orig"
    assert not store.exists(CID, ObjectId("side", shard=0))
    # collection-level rollback: failed txn that created a collection
    with pytest.raises(KeyError):
        store.apply(
            Transaction()
            .create_collection(CollectionId("9.9"))
            .rmattr(CID, ObjectId("missing", shard=0), "k")
        )
    assert not store.collection_exists(CollectionId("9.9"))


def test_rollback_collection_recreate_preserves_original_objects(store):
    """remove_collection + create_collection + write(old oid) + fail must
    restore the original object (ordered undo log, replayed in reverse)."""
    _mkcoll(store)
    store.apply(Transaction().write(CID, OID, 0, b"orig"))
    bad = (
        Transaction()
        .remove_collection(CID)
        .create_collection(CID)
        .write(CID, OID, 0, b"NEW")
        .rmattr(CID, ObjectId("missing", shard=0), "k")  # fails
    )
    with pytest.raises(KeyError):
        store.apply(bad)
    assert store.read(CID, OID) == b"orig"


def test_unmounted_store_rejects_io():
    s = MemStore()
    s.mkfs()
    with pytest.raises(RuntimeError):
        s.apply(Transaction().create_collection(CID))
    with pytest.raises(RuntimeError):
        s.list_collections()
    s.mount()
    s.apply(Transaction().create_collection(CID))
    s.umount()
    with pytest.raises(RuntimeError):
        s.read(CID, OID)


def test_queue_transaction_callbacks(store):
    _mkcoll(store)
    fired = []
    store.queue_transaction(
        Transaction().write(CID, OID, 0, b"x"),
        on_applied=lambda: fired.append("applied"),
        on_commit=lambda: fired.append("commit"),
    )
    assert fired == ["applied", "commit"]
    assert store.read(CID, OID) == b"x"


def test_try_stash_is_stash_if_absent(store):
    """Re-applying a sub-write transaction (osd_subop_retries re-send
    after an ack was lost) must keep the TRUE pre-write stash: try_stash
    is a no-op when the stash already exists: a clobbered stash
    would roll back to post-write data)."""
    _mkcoll(store)
    stash = ObjectId("obj\x00stash\x000000000001.000000000001", 0)
    store.apply(Transaction().write(CID, OID, 0, b"OLD-DATA"))
    txn = (
        Transaction()
        .try_stash(CID, OID, stash)
        .write(CID, OID, 0, b"NEW-DATA")
        .setattr(CID, OID, "_oi", b"v2")
    )
    store.apply(txn)
    assert store.read(CID, stash) == b"OLD-DATA"
    # the re-sent duplicate applies the same txn again
    store.apply(txn)
    assert store.read(CID, stash) == b"OLD-DATA", (
        "re-applied txn clobbered the pre-write stash"
    )
    assert store.read(CID, OID) == b"NEW-DATA"
    # rollback restores the genuine old bytes and consumes the stash
    store.apply(Transaction().stash_restore(CID, stash, OID))
    assert store.read(CID, OID) == b"OLD-DATA"
    assert not store.exists(CID, stash)


# -- WalStore (tests/test_wal_store.py, the ten cases before the cluster's) --



def _fresh(path, **kw):
    s = WalStore(str(path), sync="none", **kw)
    return s


def _reopen(path, **kw):
    s = WalStore(str(path), sync="none", **kw)
    s.mount()
    return s


def test_txn_codec_roundtrip():
    txn = (
        Transaction()
        .create_collection(CID)
        .touch(CID, OID)
        .write(CID, OID, 7, b"payload")
        .zero(CID, OID, 0, 3)
        .truncate(CID, OID, 11)
        .clone(CID, OID, ObjectId("copy", 0))
        .try_stash(CID, OID, ObjectId("st", 0))
        .stash_restore(CID, ObjectId("st", 0), OID)
        .setattr(CID, OID, "k", b"v")
        .rmattr(CID, OID, "k")
        .omap_setkeys(CID, OID, {"a": b"1", "b": b"2"})
        .omap_rmkeys(CID, OID, ["a"])
        .omap_clear(CID, OID)
        .remove(CID, OID)
        .remove_collection(CID)
    )
    back = decode_txn(encode_txn(txn))
    assert back.ops == txn.ops


def test_survives_clean_umount(tmp_path):
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID).write(CID, OID, 0, b"hello"))
    s.apply(Transaction().setattr(CID, OID, "x", b"y"))
    s.umount()
    s2 = _reopen(tmp_path / "a")
    assert s2.read(CID, OID) == b"hello"
    assert s2.getattr(CID, OID, "x") == b"y"


def test_survives_process_death_without_umount(tmp_path):
    """The acid test: no umount, no checkpoint — journal replay only."""
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID).write(CID, OID, 0, b"hello"))
    s.apply(Transaction().write(CID, OID, 5, b" world"))
    s.apply(Transaction().omap_setkeys(CID, OID, {"k": b"v"}))
    # abandon without umount (simulated crash)
    s._journal.close()
    s2 = _reopen(tmp_path / "a")
    assert s2.read(CID, OID) == b"hello world"
    assert s2.omap_get(CID, OID) == {"k": b"v"}


def test_torn_tail_is_discarded(tmp_path):
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID).write(CID, OID, 0, b"good"))
    s._journal.close()
    jp = s._journal_path
    # append a record whose payload is cut short (torn write)
    payload = encode_txn(Transaction().write(CID, OID, 0, b"BADBADBAD"))
    import zlib

    with open(jp, "ab") as f:
        f.write(_HDR.pack(0x57414C31, 99, len(payload), zlib.crc32(payload)))
        f.write(payload[: len(payload) // 2])
    s2 = _reopen(tmp_path / "a")
    assert s2.read(CID, OID) == b"good"
    # and the tail was truncated so future appends are clean
    s2.apply(Transaction().write(CID, OID, 0, b"next"))
    s2._journal.close()
    s3 = _reopen(tmp_path / "a")
    assert s3.read(CID, OID) == b"next"


def test_corrupt_crc_stops_replay(tmp_path):
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID).write(CID, OID, 0, b"one"))
    s.apply(Transaction().write(CID, OID, 0, b"two"))
    s._journal.close()
    jp = s._journal_path
    # flip a byte in the LAST record's payload
    data = bytearray(open(jp, "rb").read())
    data[-1] ^= 0xFF
    open(jp, "wb").write(data)
    s2 = _reopen(tmp_path / "a")
    assert s2.read(CID, OID) == b"one"


def test_crash_between_journal_and_apply(tmp_path):
    """filestore_kill_at analog: the record is journaled, the process dies
    before the in-memory apply — the write MUST be there after mount."""
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID))
    s.crash_after = 1
    with pytest.raises(CrashPoint):
        s.apply(Transaction().write(CID, OID, 0, b"committed"))
    # in-memory state never saw it...
    assert not s.exists(CID, OID)
    s._journal.close()
    # ...but the journal did: remount applies it
    s2 = _reopen(tmp_path / "a")
    assert s2.read(CID, OID) == b"committed"


def test_checkpoint_compacts_journal(tmp_path):
    s = _fresh(tmp_path / "a", checkpoint_bytes=4096)
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID))
    for i in range(64):
        s.apply(Transaction().write(CID, ObjectId(f"o{i}", 0), 0, b"x" * 256))
    assert os.path.exists(s._checkpoint_path)
    assert os.path.getsize(s._journal_path) < 4096 + 2048
    s._journal.close()  # crash: replay = checkpoint + short journal
    s2 = _reopen(tmp_path / "a")
    for i in range(64):
        assert s2.read(CID, ObjectId(f"o{i}", 0)) == b"x" * 256


def test_checkpoint_then_more_writes(tmp_path):
    s = _fresh(tmp_path / "a", checkpoint_bytes=1 << 30)
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID).write(CID, OID, 0, b"base"))
    s.umount()  # checkpoints
    s2 = _reopen(tmp_path / "a")
    s2.apply(Transaction().write(CID, OID, 4, b"+tail"))
    s2._journal.close()  # crash
    s3 = _reopen(tmp_path / "a")
    assert s3.read(CID, OID) == b"base+tail"


def test_mkfs_wipes(tmp_path):
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(CID).write(CID, OID, 0, b"old"))
    s.umount()
    s2 = _fresh(tmp_path / "a")
    s2.mkfs()
    s2.mount()
    assert not s2.collection_exists(CID)


def test_matches_memstore_semantics(tmp_path):
    """WalStore IS a MemStore for the OSD: same atomic-rollback contract."""
    s = _fresh(tmp_path / "a")
    s.mkfs()
    s.mount()
    m = MemStore()
    m.mkfs()
    m.mount()
    good = Transaction().create_collection(CID).write(CID, OID, 0, b"ok")
    for st in (s, m):
        st.apply(good)
    bad = Transaction().write(CID, OID, 0, b"claw").rmattr(
        CID, ObjectId("ghost", 0), "nope"
    )
    for st in (s, m):
        with pytest.raises(KeyError):
            st.apply(bad)
    assert s.read(CID, OID) == m.read(CID, OID) == b"ok"
    # the failed (never-acked) record replays as a no-op: rollback holds
    s._journal.close()
    s2 = _reopen(tmp_path / "a")
    assert s2.read(CID, OID) == b"ok"
    assert not s2.exists(CID, ObjectId("ghost", 0))


# -- cluster-level: true process-death durability ---------------------------



# -- BlueStore (tests/test_blue_store.py, the cases without a cluster) --



def _mk(tmp_path, **kw):
    s = BlueStore(str(tmp_path / "b"), sync="none", **kw)
    s.mkfs()
    s.mount()
    return s


def _put(store, data, oid=OID):
    txn = Transaction().create_collection(CID).write(CID, oid, 0, data)
    store.apply(txn)


class TestAllocator:
    def test_alloc_free_reuse(self):
        a = Allocator(min_alloc=4096)
        o1 = a.alloc(5000)   # rounds to 8192
        o2 = a.alloc(100)    # 4096
        assert o2 == o1 + 8192
        a.release(o1, 8192)
        o3 = a.alloc(4096)   # first-fit reuses the hole
        assert o3 == o1
        o4 = a.alloc(4096)
        assert o4 == o1 + 4096  # remainder of the hole

    def test_merge_adjacent(self):
        a = Allocator(min_alloc=4096)
        o1, o2, o3 = a.alloc(4096), a.alloc(4096), a.alloc(4096)
        a.release(o1, 4096)
        a.release(o2, 4096)
        assert a.alloc(8192) == o1  # merged span satisfies a bigger ask

    def test_init_from_used(self):
        a = Allocator(min_alloc=4096)
        a.init_from_used([(8192, 4096), (20480, 100)])
        assert a.alloc(8192) == 0          # hole before first extent
        assert a.alloc(8192) == 12288      # hole between extents
        assert a.alloc(4096) == 24576      # past the high-water mark


class TestAtRestIntegrity:
    def test_bitrot_caught_on_ordinary_read(self, tmp_path):
        """Flip one byte in the block file: the very next read()
        raises BitrotError — no scrub, no EC layer involved."""
        s = _mk(tmp_path)
        _put(s, b"precious bytes" * 100)
        assert s.read(CID, OID) == b"precious bytes" * 100
        ext = s._onodes[next(iter(s._onodes))].extents[0]
        boff = ext[2]
        with open(s._block_path, "r+b") as f:
            f.seek(boff + 7)
            byte = f.read(1)
            f.seek(boff + 7)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(BitrotError):
            s.read(CID, OID)
        assert s.stats["csum_errors"] == 1
        s.umount()

    def test_fsck_reports_rotten_blobs(self, tmp_path):
        s = _mk(tmp_path)
        _put(s, b"A" * 5000)
        _put(s, b"B" * 5000, ObjectId("other", 0))
        r = s.fsck()
        assert r["errors"] == [] and r["objects"] == 2
        ext = s._onodes[f"1.0s0\x1fother\x1f0"].extents[0]
        with open(s._block_path, "r+b") as f:
            f.seek(ext[2])
            f.write(b"\xde\xad")
        r = s.fsck()
        assert len(r["errors"]) == 1
        assert "other" in r["errors"][0]["onode"]
        s.umount()

    def test_hostile_object_names_cannot_collide_keys(self, tmp_path):
        """A client-controlled name containing the onode-key separator
        must neither collide with another object's key nor break
        list_objects."""
        s = _mk(tmp_path)
        evil = ObjectId("a\x1fb", 0)       # raw separator in the name
        evil2 = ObjectId("a", 0)           # would collide if unescaped
        pct = ObjectId("a%1Fb", 0)         # escape-alike literal
        _put(s, b"evil" * 100, evil)
        _put(s, b"plain" * 100, evil2)
        _put(s, b"pct" * 100, pct)
        names = {o.name for o in s.list_objects(CID)}
        assert names == {"a\x1fb", "a", "a%1Fb"}
        assert s.read(CID, evil) == b"evil" * 100
        assert s.read(CID, evil2) == b"plain" * 100
        assert s.read(CID, pct) == b"pct" * 100
        s.umount()
        s2 = BlueStore(str(tmp_path / "b"), sync="none")
        s2.mount()  # keys round-trip through the KV db
        assert {o.name for o in s2.list_objects(CID)} == names
        s2.umount()

    def test_partial_overwrite_rmw_keeps_checksums_valid(self, tmp_path):
        """Overwriting the middle of a blob splits it; the kept pieces
        are re-checksummed so later reads still verify."""
        s = _mk(tmp_path)
        _put(s, bytes(range(200)) * 40)  # 8000 bytes
        s.apply(Transaction().write(CID, OID, 3000, b"X" * 100))
        want = bytearray(bytes(range(200)) * 40)
        want[3000:3100] = b"X" * 100
        assert s.read(CID, OID) == bytes(want)
        assert s.fsck()["errors"] == []
        # the object now has 3 extents (head, new, tail)
        assert len(s._onodes[next(iter(s._onodes))].extents) == 3
        s.umount()


class TestPersistenceAndCrash:
    def test_remount_preserves_everything(self, tmp_path):
        s = _mk(tmp_path)
        txn = (
            Transaction()
            .create_collection(CID)
            .write(CID, OID, 0, b"data!" * 100)
            .setattr(CID, OID, "k", b"v")
            .omap_setkeys(CID, OID, {"ok": b"ov"})
        )
        s.apply(txn)
        s.umount()
        s2 = BlueStore(str(tmp_path / "b"), sync="none")
        s2.mount()
        assert s2.read(CID, OID) == b"data!" * 100
        assert s2.getattr(CID, OID, "k") == b"v"
        assert s2.omap_get(CID, OID) == {"ok": b"ov"}
        assert s2.fsck()["errors"] == []
        s2.umount()

    def test_crash_before_kv_commit_leaks_then_reclaims(self, tmp_path):
        """Blobs written by a txn whose KV commit never happened are
        invisible after remount, and their space is reclaimed by the
        mount-time allocator rebuild."""
        s = _mk(tmp_path)
        _put(s, b"committed" * 100)
        committed_end = s.alloc.end

        real_submit = s._db.submit

        def boom(txn, sync=True):
            raise RuntimeError("simulated crash before KV commit")

        s._db.submit = boom
        with pytest.raises(RuntimeError):
            s.apply(Transaction().write(CID, ObjectId("n", 0), 0, b"Z" * 9000))
        s._db.submit = real_submit
        # block file grew, metadata didn't
        assert not s.exists(CID, ObjectId("n", 0))
        s.umount()
        s2 = BlueStore(str(tmp_path / "b"), sync="none")
        s2.mount()
        assert s2.read(CID, OID) == b"committed" * 100
        assert not s2.exists(CID, ObjectId("n", 0))
        # the leaked extent's space is allocatable again
        assert s2.alloc.end == committed_end
        s2.umount()

    def test_failed_op_mid_txn_commits_nothing(self, tmp_path):
        s = _mk(tmp_path)
        _put(s, b"base")
        with pytest.raises(KeyError):
            s.apply(
                Transaction()
                .write(CID, OID, 0, b"NEW!")
                .clone(CID, ObjectId("ghost", 0), ObjectId("copy", 0))
            )
        assert s.read(CID, OID) == b"base"  # first op not visible
        s.umount()


class TestCompression:
    def test_blob_compression_roundtrip_and_savings(self, tmp_path):
        s = _mk(tmp_path, compression="zlib")
        data = b"compress me please " * 1000
        _put(s, data)
        assert s.read(CID, OID) == data
        assert s.stats["compressed_blobs"] == 1
        assert s.stats["compressed_saved"] > 0
        ext = s._onodes[next(iter(s._onodes))].extents[0]
        assert ext[3] < len(data)  # stored < logical
        assert ext[5] == "zlib"
        s.umount()
        # algorithm change between mounts: old blobs still decode
        s2 = BlueStore(str(tmp_path / "b"), sync="none", compression="none")
        s2.mount()
        assert s2.read(CID, OID) == data
        s2.umount()

    def test_incompressible_stays_raw(self, tmp_path):
        s = _mk(tmp_path, compression="zlib")
        data = os.urandom(4096)
        _put(s, data)
        ext = s._onodes[next(iter(s._onodes))].extents[0]
        assert ext[5] == "none" and ext[3] == len(data)
        assert s.read(CID, OID) == data
        s.umount()




class TestDoubleRemove:
    def test_double_remove_in_one_txn_no_double_free(self, tmp_path):
        """remove+remove (contract-legal no-op second remove) must not
        free the extents twice — a double-free hands the same block to
        two later writes."""
        s = _mk(tmp_path)
        _put(s, b"D" * 4096)
        s.apply(Transaction().remove(CID, OID).remove(CID, OID))
        # two fresh writes must land on DISTINCT blocks
        s.apply(Transaction().write(CID, ObjectId("x", 0), 0, b"X" * 4096))
        s.apply(Transaction().write(CID, ObjectId("y", 0), 0, b"Y" * 4096))
        assert s.read(CID, ObjectId("x", 0)) == b"X" * 4096
        assert s.read(CID, ObjectId("y", 0)) == b"Y" * 4096
        assert s.fsck()["errors"] == []
        s.umount()

    def test_re_mkfs_wipes_metadata(self, tmp_path):
        s = _mk(tmp_path)
        _put(s, b"old data" * 100)
        s.umount()
        s2 = BlueStore(str(tmp_path / "b"), sync="none")
        s2.mkfs()  # re-format: block truncated AND kv wiped
        s2.mount()
        assert not s2.exists(CID, OID)
        assert s2.fsck() == {"objects": 0, "blobs": 0, "errors": []}
        s2.umount()


# -- across the packages -------------------------------------------------------


def _workload(store_mod, seed=7, n=40):
    """A seeded mix of every op kind the journal codec knows, as a list
    of transactions built from ``store_mod``'s own classes."""
    C, O, T = store_mod.CollectionId, store_mod.ObjectId, store_mod.Transaction
    rng = np.random.default_rng(seed)
    cids = [C("1.0s0"), C("1.1s2")]
    names = [f"obj{i}" for i in range(6)] + ["a\x1fb", "snap\x00x"]
    txns = [T().create_collection(cids[0]).create_collection(cids[1])]
    for i in range(n):
        cid = cids[int(rng.integers(2))]
        oid = O(names[int(rng.integers(len(names)))], int(rng.integers(3)))
        other = O(names[int(rng.integers(len(names)))], oid.shard)
        t = T().touch(cid, oid)
        kind = int(rng.integers(8))
        data = rng.integers(0, 256, int(rng.integers(1, 9000)), dtype=np.uint8).tobytes()
        if kind == 0:
            t.write(cid, oid, int(rng.integers(0, 5000)), data)
        elif kind == 1:
            t.write(cid, oid, 0, data).zero(cid, oid, 100, 300)
        elif kind == 2:
            t.write(cid, oid, 0, data).truncate(cid, oid, int(rng.integers(0, 4000)))
        elif kind == 3:
            t.write(cid, oid, 0, data).clone(cid, oid, other)
        elif kind == 4:
            stash = O(f"{oid.name}\x00stash\x00{i:010d}", oid.shard)
            t.try_stash(cid, oid, stash).write(cid, oid, 0, data[:512])
        elif kind == 5:
            t.setattr(cid, oid, f"k{i % 3}", data[:64]).setattr(cid, oid, "_", b"oi")
            if i % 2:
                t.rmattr(cid, oid, "_")
        elif kind == 6:
            t.omap_setkeys(cid, oid, {f"{i:04d}": data[:40], "h": b"x"})
            t.omap_rmkeys(cid, oid, ["h"])
        else:
            t.remove(cid, oid)
        txns.append(t)
    return txns


def _contents(store):
    """Everything a store holds, in plain values (comparable across the
    two packages' classes)."""
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            out[(cid.pg, oid.name, oid.shard)] = (
                store.read(cid, oid), store.getattrs(cid, oid),
                store.omap_get(cid, oid),
            )
    return out


def _ref():
    from ceph_tpu import store as ref_store

    return ref_store


def _port():
    from ceph_tpu_torch import store as port_store

    return port_store


def _files(path):
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def test_journal_records_equal_the_reference():
    from ceph_tpu.store.wal import decode_txn as ref_decode
    from ceph_tpu.store.wal import encode_txn as ref_encode

    for mine, theirs in zip(_workload(_port()), _workload(_ref())):
        payload = encode_txn(mine)
        assert payload == ref_encode(theirs)
        assert encode_txn(decode_txn(payload)) == payload
        assert ref_encode(ref_decode(payload)) == payload


@pytest.mark.parametrize("compression", ["none", "zlib"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_walstore_crosses_packages(tmp_path, writer, compression):
    """A journal (no umount: replay on mount) and a checkpoint (after
    umount) written by one package mount in the other with equal
    contents; both packages write the same files byte for byte."""
    mods = {"port": _port(), "ref": _ref()}
    reader = "ref" if writer == "port" else "port"
    stores = {}
    for name, mod in mods.items():
        s = mod.WalStore(str(tmp_path / name), sync="none", compression=compression)
        s.mkfs()
        s.mount()
        for t in _workload(mod):
            s.apply(t)
        stores[name] = s
    want = _contents(stores[writer])
    assert _contents(stores[reader]) == want
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    # the journal alone, replayed by the other package
    stores[writer].crash_close()
    other = mods[reader].WalStore(str(tmp_path / writer), sync="none",
                                  compression=compression)
    other.mount()
    assert _contents(other) == want
    other.umount()  # the other package checkpoints
    # and back: the checkpoint the other package wrote
    back = mods[writer].WalStore(str(tmp_path / writer), sync="none")
    back.mount()
    assert _contents(back) == want
    back.umount()
    # a checkpoint of the writer's own, read by the other
    stores[reader].umount()
    s = mods[writer].WalStore(str(tmp_path / reader), sync="none", compression=compression)
    s.mount()
    assert _contents(s) == want
    s.umount()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("compression", ["none", "zlib"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_bluestore_crosses_packages(tmp_path, writer, compression):
    """A block file and KV directory written by one package mount in the
    other with equal contents and ``fsck()`` clean; both packages write
    the same block bytes and the same KV files."""
    mods = {"port": _port(), "ref": _ref()}
    reader = "ref" if writer == "port" else "port"
    stores = {}
    for name, mod in mods.items():
        s = mod.BlueStore(str(tmp_path / name), sync="none", compression=compression)
        s.mkfs()
        s.mount()
        for t in _workload(mod):
            s.apply(t)
        stores[name] = s
    want = _contents(stores[writer])
    assert _contents(stores[reader]) == want
    assert stores["port"].stats == stores["ref"].stats
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    for name, s in stores.items():
        s.crash_close() if name == writer else s.umount()
    other = mods[reader].BlueStore(str(tmp_path / writer), sync="none")
    other.mount()
    assert _contents(other) == want
    assert other.fsck()["errors"] == []
    # the other package writes on, and the writer mounts that again
    for t in _workload(mods[reader], seed=8, n=10)[1:]:
        other.apply(t)
    want = _contents(other)
    other.umount()
    back = mods[writer].BlueStore(str(tmp_path / writer), sync="none")
    back.mount()
    assert _contents(back) == want
    assert back.fsck()["errors"] == []
    back.umount()


def test_memstore_matches_the_reference():
    """The same workload leaves the two packages' MemStores equal, and a
    failing transaction rolls back in both."""
    stores = {}
    for name, mod in (("port", _port()), ("ref", _ref())):
        s = mod.MemStore()
        s.mkfs()
        s.mount()
        for t in _workload(mod, seed=11, n=60):
            s.apply(t)
        bad = mod.Transaction().write(mod.CollectionId("1.0s0"), mod.ObjectId("obj0", 0),
                                      0, b"x").rmattr(mod.CollectionId("1.0s0"),
                                                      mod.ObjectId("ghost", 0), "nope")
        with pytest.raises(KeyError):
            s.apply(bad)
        stores[name] = _contents(s)
    assert stores["port"] == stores["ref"]


# -- the slice: the OSD's EC writes in the shard stores (chip_smoke phase 12) --

PHASE12_OBJECT = 64 << 10
PHASE12_SEED = 12


@pytest.fixture
def phase12_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.run_osd_stores`` on the CPU at 64 KiB objects: the
    port's dispatcher on a CPU codec's batching lane (the lane a card's
    codec takes), the plain kernels counting as launches, 11 port
    BlueStores and the WalStore under ``tmp_path``.  Returns the phase's
    launch counts and the objects it wrote."""
    import chip_smoke

    from ceph_tpu_torch.ops import gf_cuda, gf_torch
    from ceph_tpu_torch.utils import native

    monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)
    for name, fn in (("gf_matmul", "gf_matmul_u32"), ("bitmatrix_xor", "bitmatrix_matmul_u32")):
        plain = getattr(gf_torch, fn)

        def counted(*a, _plain=plain, _name=name, **kw):
            with gf_cuda._LAUNCHES_LOCK:
                gf_cuda.launches[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(gf_torch, fn, counted)
    monkeypatch.setattr(chip_smoke, "OSD_OBJECT_SIZE", PHASE12_OBJECT)
    launches = chip_smoke.run_osd_stores(torch.device("cpu"),
                                         np.random.default_rng(PHASE12_SEED),
                                         root=str(tmp_path))
    rng = np.random.default_rng(PHASE12_SEED)
    objs = [rng.integers(0, 256, size=PHASE12_OBJECT, dtype=np.uint8)
            for _ in range(chip_smoke.STORE_OBJECTS + chip_smoke.STORE_CRASH_OBJECTS)]
    return launches, objs, chip_smoke


def _ref_shard_stores(root, objs, cs, crash=False):
    """The reference's side of phase 12 for the same objects: the
    reference's ISA codec and ``ec_util.encode``, each shard's
    transaction as the reference OSD's ``_ec_commit`` builds it, committed
    into reference BlueStores (and for ``crash``, shard 2's writes into a
    reference WalStore that crashes at the same write)."""
    from ceph_tpu.models import registry as ref_registry
    from ceph_tpu.osd import ec_transaction, ec_util
    from ceph_tpu.osd.ec_util import StripeHashes
    from ceph_tpu.osd.pg_log import Eversion, PGLogEntry, add_log_entry_to_txn, stash_name
    from ceph_tpu.osd.recovery import OI_KEY
    from ceph_tpu.store import BlueStore as RefBlue
    from ceph_tpu.store import CollectionId as RefCid
    from ceph_tpu.store import CrashPoint as RefCrash
    from ceph_tpu.store import ObjectId as RefOid
    from ceph_tpu.store import Transaction as RefTxn
    from ceph_tpu.store import WalStore as RefWal

    plugin, profile, chunk = cs.POOL_A
    codec = ref_registry.instance().factory(plugin, dict(profile))
    sinfo = ec_util.StripeInfo(8 * chunk, chunk)
    stores = {s: RefBlue(os.path.join(root, f"osd.{s}"), sync="none") for s in range(11)}
    for st in stores.values():
        st.mkfs()
        st.mount()
    wal = None
    if crash:
        wal = RefWal(os.path.join(root, "wal"), sync="none")
        wal.mkfs()
        wal.mount()
        wal.crash_after = cs.STORE_CRASH_AFTER
    n_objs = cs.STORE_OBJECTS + (cs.STORE_CRASH_OBJECTS if crash else 0)
    for i in range(n_objs):
        oid = cs.store_oid(i)
        shards = ec_util.encode(sinfo, codec, objs[i])
        plan = ec_transaction.plan_write_full(sinfo, 0, objs[i].size)
        hashes = StripeHashes(11, chunk)
        hashes.set_range(0, shards)
        version = Eversion(cs.STORE_EPOCH, i + 1)
        sname = stash_name(oid, version)
        entry = PGLogEntry("modify", oid, version, Eversion(), stash=sname)
        for s, buf in shards.items():
            cid, soid = RefCid(f"{cs.STORE_PG}s{s}"), RefOid(oid, s)
            txn = (RefTxn().create_collection(cid).try_stash(cid, soid, RefOid(sname, s))
                   .truncate(cid, soid, plan.shard_truncate)
                   .write(cid, soid, 0, buf.tobytes())
                   .setattr(cid, soid, StripeHashes.XATTR_KEY,
                            json.dumps(hashes.to_dict()).encode())
                   .setattr(cid, soid, OI_KEY, json.dumps(
                       {"size": plan.new_size, "version": version.to_list()}).encode()))
            add_log_entry_to_txn(txn, cid, s, entry)
            if i >= cs.STORE_OBJECTS and s == cs.STORE_WAL_SHARD:
                if wal._mounted:
                    try:
                        wal.queue_transaction(txn)
                    except RefCrash:
                        wal.crash_close()
            elif i < cs.STORE_OBJECTS or s != cs.STORE_WAL_SHARD:
                stores[s].queue_transaction(txn)
    return stores, wal


def test_phase12_flow_on_the_cpu_equals_the_reference_stores(phase12_on_the_cpu, tmp_path):
    """The phase-12 flow at 64 KiB objects on the CPU: its restart, its
    three lost shards and its WalStore crash pass (the phase asserts
    them); then every shard store it left holds the bytes, xattrs and PG
    log the reference's stores hold for the same inputs (but object 0 on
    the two shards the phase damaged), and its WalStore what a reference
    WalStore that crashed at the same write replays."""
    from ceph_tpu.store import CollectionId as RefCid
    from ceph_tpu.store import WalStore as RefWal
    from ceph_tpu_torch.store import BlueStore, CollectionId, ObjectId, WalStore

    launches, objs, cs = phase12_on_the_cpu
    assert launches["gf_matmul"] > 0
    ref_root = tmp_path / "ref"
    ref, _ = _ref_shard_stores(str(ref_root), objs, cs, crash=True)
    damaged = {(cs.STORE_BITROT_SHARD, cs.store_oid(0)), (cs.STORE_BAD_CRC_SHARD, cs.store_oid(0))}
    compared = 0
    for s in range(11):
        mine = BlueStore(str(tmp_path / f"osd.{s}"), sync="none")
        mine.mount()
        cid = CollectionId(f"{cs.STORE_PG}s{s}")
        names = sorted(o.name for o in mine.list_objects(cid))
        ref_cid = RefCid(f"{cs.STORE_PG}s{s}")
        assert names == sorted(o.name for o in ref[s].list_objects(ref_cid))
        for o in ref[s].list_objects(ref_cid):
            if (s, o.name) in damaged:
                continue
            oid = ObjectId(o.name, s)
            assert mine.read(cid, oid) == ref[s].read(ref_cid, o)
            assert mine.getattrs(cid, oid) == ref[s].getattrs(ref_cid, o)
            assert mine.omap_get(cid, oid) == ref[s].omap_get(ref_cid, o)
            compared += 1
        assert mine.fsck()["objects"] == ref[s].fsck()["objects"]
        mine.umount()
        ref[s].umount()
    # every shard's objects and its pgmeta (shard 2's BlueStore missed the
    # crash step's writes, which went to its WalStore), less the damaged two
    per_shard = cs.STORE_OBJECTS + cs.STORE_CRASH_OBJECTS + 1
    assert compared == 10 * per_shard + (cs.STORE_OBJECTS + 1) - len(damaged)
    mine = WalStore(str(tmp_path / f"osd.{cs.STORE_WAL_SHARD}.wal"), sync="none")
    mine.mount()
    theirs = RefWal(str(ref_root / "wal"), sync="none")
    theirs.mount()
    assert _contents(mine) == _contents(theirs)
    assert len(_contents(mine)) == cs.STORE_CRASH_AFTER + 1  # the journaled objects, pgmeta
