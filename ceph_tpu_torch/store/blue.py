"""BlueStore-class local object store: raw block file + KV metadata.

Re-expression of the reference's flagship store
(reference:src/os/bluestore/BlueStore.cc): object DATA lives in a single
block file carved up by an :class:`Allocator`; object METADATA (onodes:
size, extent map, xattrs, omap) lives in the KV tier
(:class:`ceph_tpu_torch.store.kv.FileKVDB` standing in for RocksDB).  The
properties that make it BlueStore-class rather than FileStore-class:

- **at-rest checksums** — every blob carries a crc32 computed at write
  time and verified on EVERY read (reference BlueStore per-blob csum,
  ``_verify_csum``); bitrot in the block file is caught by the *store*,
  independent of any replica/EC-level comparison, and surfaces as
  :class:`BitrotError` (the OSD maps it to -EIO, routing the shard into
  scrub/repair).
- **block allocation** — extents are allocated from a free list at
  ``min_alloc`` granularity and reclaimed on overwrite/remove/truncate
  (reference ``Allocator``); the free list is rebuilt from the onode
  extent maps on mount, so blobs written by a transaction that crashed
  before its KV commit simply leak until the next mount (the same
  data-first / metadata-commit ordering BlueStore gets from deferring
  the RocksDB txn).
- **blob compression** — data blobs are optionally compressed through
  the compressor plugin family when it actually saves space
  (reference ``_do_write_data`` compression path); the algorithm rides
  in the extent record so the setting may change between mounts.

Commit point: the KV transaction carrying the onode updates.  Block-file
writes happen first and are fsync'd before the KV commit, so a crash at
any point leaves either the old metadata (pointing at the old, intact
blobs) or the new metadata (pointing at fully-written new blobs).

Partial overwrites are store-level read-modify-write at blob
granularity: overlapped old blobs are read (verified), their kept pieces
re-written as fresh blobs.  The reference tracks csums per csum-block to
avoid this; collapsing to per-blob keeps the checksum contract with far
less machinery, and this framework's write patterns (EC chunks, whole
objects) rarely split blobs.

Counterpart of ``ceph_tpu/store/blue.py``, whole: the same block file
layout, onode JSON and KV keys, so a store written by one package
mounts in the other with ``fsck()`` clean.
"""

from __future__ import annotations

import json
import os
import threading
import zlib

from .kv import FileKVDB, KVTransaction
from .memstore import MemStore  # noqa: F401  (api parity import)
from .objectstore import (
    CollectionId,
    NeedsMkfs,
    ObjectId,
    ObjectStore,
    Transaction,
    omap_range_page,
)

_SEP = "\x1f"


class BitrotError(IOError):
    """A blob's stored bytes no longer match their write-time crc."""


class Allocator:
    """First-fit free-extent allocator over the block file
    (reference:src/os/bluestore/Allocator.h, collapsed to its job:
    hand out disjoint extents, take them back, grow the file)."""

    def __init__(self, min_alloc: int = 4096):
        self.min_alloc = min_alloc
        self.free: list[list[int]] = []  # sorted [offset, length]
        self.end = 0  # high-water mark of the block file

    def _round(self, n: int) -> int:
        m = self.min_alloc
        return (n + m - 1) // m * m

    def init_from_used(self, used: list[tuple[int, int]]) -> None:
        """Rebuild free space as the complement of the committed extent
        map — the mount-time scan that also reclaims blobs leaked by a
        pre-KV-commit crash."""
        self.free = []
        self.end = 0
        spans = sorted(
            (off, self._round(length)) for off, length in used if length > 0
        )
        cur = 0
        for off, length in spans:
            if off > cur:
                self.free.append([cur, off - cur])
            cur = max(cur, off + length)
        self.end = cur

    def alloc(self, length: int) -> int:
        need = self._round(max(length, 1))
        for i, (off, flen) in enumerate(self.free):
            if flen >= need:
                if flen == need:
                    self.free.pop(i)
                else:
                    self.free[i] = [off + need, flen - need]
                return off
        off = self.end
        self.end += need
        return off

    def release(self, off: int, length: int) -> None:
        need = self._round(max(length, 1))
        self.free.append([off, need])
        self.free.sort()
        # merge adjacent spans
        merged: list[list[int]] = []
        for o, l in self.free:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1][1] += l
            else:
                merged.append([o, l])
        self.free = merged


class _Onode:
    """size + extent map + xattrs + omap (reference bluestore_onode_t).

    extents: sorted [logical_off, logical_len, block_off, stored_len,
    crc32, compression] — stored_len is the on-disk byte count (differs
    from logical_len when compressed)."""

    __slots__ = ("size", "extents", "xattrs", "omap")

    def __init__(self):
        self.size = 0
        self.extents: list[list] = []
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}

    def to_json(self) -> bytes:
        return json.dumps({
            "size": self.size,
            "extents": self.extents,
            "xattrs": {k: v.hex() for k, v in self.xattrs.items()},
            "omap": {k: v.hex() for k, v in self.omap.items()},
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "_Onode":
        d = json.loads(raw)
        o = cls()
        o.size = d["size"]
        o.extents = [list(e) for e in d["extents"]]
        o.xattrs = {k: bytes.fromhex(v) for k, v in d["xattrs"].items()}
        o.omap = {k: bytes.fromhex(v) for k, v in d["omap"].items()}
        return o

    def copy(self) -> "_Onode":
        o = _Onode()
        o.size = self.size
        o.extents = [list(e) for e in self.extents]
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        return o


def _okey(cid: CollectionId, oid: ObjectId) -> str:
    """Onode KV key.  The name is escaped so a client-controlled object
    name containing the separator cannot collide with another key or
    break the split in list_objects."""
    name = oid.name.replace("%", "%25").replace(_SEP, "%1F")
    return f"{cid.pg}{_SEP}{name}{_SEP}{oid.shard}"


def _okey_name(escaped: str) -> str:
    return escaped.replace("%1F", _SEP).replace("%25", "%")


class BlueStore(ObjectStore):
    """See module docstring.  Directory layout::

        <path>/block   raw data file (Allocator-managed extents)
        <path>/db/     FileKVDB: "coll" collection set, "onode" metadata
    """

    MIN_COMPRESS = 128  # don't bother compressing tiny blobs

    def __init__(self, path: str, sync: str = "fsync",
                 compression: str = "none", min_alloc: int = 4096):
        if sync not in ("fsync", "flush", "none"):
            raise ValueError(f"bad sync mode {sync!r}")
        self.path = path
        self.sync = sync
        self.compression = compression
        if compression != "none":
            from ..compressor import create as _create_compressor

            _create_compressor(compression)  # validate eagerly
        self.alloc = Allocator(min_alloc)
        self._db: FileKVDB | None = None
        self._block_fd: int | None = None
        self._lock = threading.RLock()
        self._mounted = False
        # onode cache: key -> _Onode (authoritative copy of the KV row)
        self._onodes: dict[str, _Onode] = {}
        self._colls: set[str] = set()
        # perf counters (BlueStore l_bluestore_*)
        self.stats = {
            "reads": 0, "writes": 0, "csum_errors": 0,
            "compressed_blobs": 0, "compressed_saved": 0,
        }

    # -- lifecycle ----------------------------------------------------------
    @property
    def _block_path(self) -> str:
        return os.path.join(self.path, "block")

    def formatted(self) -> bool:
        """True if mkfs already ran on this path (mount will succeed)."""
        return os.path.exists(self._block_path)

    def crash_close(self) -> None:
        """Abandon the live store WITHOUT umount (no KV checkpoint):
        free the fds so a fresh instance can re-open the same path —
        the harness's simulated process death."""
        if self._db is not None:
            self._db.crash_close()
            self._db = None
        if self._block_fd is not None:
            os.close(self._block_fd)
            self._block_fd = None
        self._mounted = False

    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(self._block_path, "wb"):
            pass
        # wipe any previous KV state: a truncated block file with stale
        # onodes would turn every old object into a BitrotError instead
        # of simply being gone (WalStore.mkfs unlinks its files likewise)
        dbdir = os.path.join(self.path, "db")
        for fname in ("journal", "checkpoint"):
            fp = os.path.join(dbdir, fname)
            if os.path.exists(fp):
                os.unlink(fp)
        db = FileKVDB(dbdir, sync=self.sync)
        db.open()
        db.close()

    def mount(self) -> None:
        with self._lock:
            if self._mounted:
                return
            if not os.path.exists(self._block_path):
                raise NeedsMkfs(f"BlueStore {self.path}: no fs (mkfs first)")
            self._db = FileKVDB(os.path.join(self.path, "db"), sync=self.sync)
            self._db.open()
            self._onodes = {
                k: _Onode.from_json(v) for k, v in self._db.iterate("onode")
            }
            self._colls = set(self._db.keys("coll"))
            used = [
                (e[2], e[3])
                for o in self._onodes.values() for e in o.extents
            ]
            self.alloc.init_from_used(used)
            self._block_fd = os.open(self._block_path, os.O_RDWR)
            self._mounted = True

    def umount(self) -> None:
        with self._lock:
            if not self._mounted:
                return
            self._db.close()
            self._db = None
            os.close(self._block_fd)
            self._block_fd = None
            self._mounted = False

    def _assert_mounted(self) -> None:
        if not self._mounted:
            raise RuntimeError("BlueStore is not mounted")

    # -- block I/O ----------------------------------------------------------
    def _write_blob(self, data: bytes) -> list:
        """Write one blob; returns the extent record fields
        [block_off, stored_len, crc, compression]."""
        alg = "none"
        stored = data
        if self.compression != "none" and len(data) >= self.MIN_COMPRESS:
            from ..compressor import create as _create_compressor

            cand = _create_compressor(self.compression).compress(data)
            if len(cand) < len(data):
                stored, alg = cand, self.compression
                self.stats["compressed_blobs"] += 1
                self.stats["compressed_saved"] += len(data) - len(cand)
        off = self.alloc.alloc(len(stored))
        os.pwrite(self._block_fd, stored, off)
        self.stats["writes"] += 1
        return [off, len(stored), zlib.crc32(stored), alg]

    def _read_blob(self, ext: list, what: str) -> bytes:
        _lofs, llen, boff, stored_len, crc, alg = ext
        raw = os.pread(self._block_fd, stored_len, boff)
        self.stats["reads"] += 1
        if len(raw) != stored_len or zlib.crc32(raw) != crc:
            self.stats["csum_errors"] += 1
            raise BitrotError(
                f"BlueStore {self.path}: checksum mismatch reading {what} "
                f"(block {boff}+{stored_len}): stored crc {crc:#x}, "
                f"got {zlib.crc32(raw):#x}"
            )
        if alg != "none":
            from ..compressor import create as _create_compressor

            raw = _create_compressor(alg).decompress(raw)
        if len(raw) != llen:
            raise BitrotError(
                f"BlueStore {self.path}: blob length mismatch for {what}"
            )
        return raw

    # -- transaction apply (the write path) ---------------------------------
    def apply(self, txn: Transaction) -> None:
        """Stage everything, write data blobs, then commit ONE KV txn.

        Atomic: an op failure before commit discards the staging and
        releases the freshly-written blobs; nothing becomes visible."""
        if txn.empty():
            return
        with self._lock:
            self._assert_mounted()
            staged: dict[str, _Onode | None] = {}
            staged_colls: dict[str, bool] = {}  # name -> exists
            new_extents: list[tuple[int, int]] = []  # rollback on failure
            freed: list[tuple[int, int]] = []  # released only on commit

            try:
                for op in txn.ops:
                    self._stage_op(op, staged, staged_colls, new_extents, freed)
            except Exception:
                for off, length in new_extents:
                    self.alloc.release(off, length)
                raise
            if self.sync == "fsync" and new_extents:
                # order data before the KV commit; in "flush" mode the KV
                # side is page-cache-only too, so an fsync here would buy
                # nothing and serialize every apply behind the disk
                os.fsync(self._block_fd)
            kv = self._db.transaction()
            for name, exists in staged_colls.items():
                if exists:
                    kv.set("coll", name, b"1")
                else:
                    kv.rmkey("coll", name)
            for key, onode in staged.items():
                if onode is None:
                    kv.rmkey("onode", key)
                else:
                    kv.set("onode", key, onode.to_json())
            self._db.submit(kv, sync=self.sync == "fsync")
            # commit succeeded: adopt staging, reclaim replaced space
            for name, exists in staged_colls.items():
                (self._colls.add if exists else self._colls.discard)(name)
            for key, onode in staged.items():
                if onode is None:
                    self._onodes.pop(key, None)
                else:
                    self._onodes[key] = onode
            for off, length in freed:
                self.alloc.release(off, length)

    # staging helpers --------------------------------------------------------
    def _get_staged(
        self, staged: dict, cid: CollectionId, oid: ObjectId,
        create: bool,
    ) -> _Onode:
        key = _okey(cid, oid)
        if key in staged:
            onode = staged[key]
            if onode is None:
                if not create:
                    raise KeyError(f"no object {oid} in {cid}")
                onode = staged[key] = _Onode()
            return onode
        cur = self._onodes.get(key)
        if cur is None:
            if not create:
                raise KeyError(f"no object {oid} in {cid}")
            onode = _Onode()
        else:
            onode = cur.copy()
        staged[key] = onode
        return onode

    def _coll_exists(self, staged_colls: dict, name: str) -> bool:
        if name in staged_colls:
            return staged_colls[name]
        return name in self._colls

    def _punch(
        self, onode: _Onode, offset: int, length: int,
        new_extents: list, freed: list,
    ) -> None:
        """Drop [offset, offset+length) from the extent map, rewriting
        partially-overlapped blobs' kept pieces as new blobs (store-level
        RMW; see module docstring)."""
        end = offset + length
        keep: list[list] = []
        for ext in onode.extents:
            lofs, llen = ext[0], ext[1]
            eend = lofs + llen
            if eend <= offset or lofs >= end:
                keep.append(ext)
                continue
            # some overlap: read old blob once, re-write kept pieces
            data = self._read_blob(ext, "rmw")
            freed.append((ext[2], ext[3]))
            if lofs < offset:  # head piece survives
                piece = data[: offset - lofs]
                rec = self._write_blob(piece)
                new_extents.append((rec[0], rec[1]))
                keep.append([lofs, len(piece), *rec])
            if eend > end:  # tail piece survives
                piece = data[end - lofs:]
                rec = self._write_blob(piece)
                new_extents.append((rec[0], rec[1]))
                keep.append([end, len(piece), *rec])
        onode.extents = sorted(keep)

    def _stage_write(
        self, onode: _Onode, offset: int, data: bytes,
        new_extents: list, freed: list,
    ) -> None:
        if data:
            self._punch(onode, offset, len(data), new_extents, freed)
            rec = self._write_blob(bytes(data))
            new_extents.append((rec[0], rec[1]))
            onode.extents.append([offset, len(data), *rec])
            onode.extents.sort()
        onode.size = max(onode.size, offset + len(data))

    def _stage_op(
        self, op: tuple, staged: dict, staged_colls: dict,
        new_extents: list, freed: list,
    ) -> None:
        name = op[0]
        if name == "create_collection":
            staged_colls[op[1].pg] = True
            return
        if name == "remove_collection":
            cname = op[1].pg
            staged_colls[cname] = False
            for key in set(self._onodes) | set(staged):
                if key.split(_SEP, 1)[0] != cname:
                    continue
                onode = staged[key] if key in staged else self._onodes.get(key)
                if onode is not None:
                    freed.extend((e[2], e[3]) for e in onode.extents)
                staged[key] = None
            return
        cid, oid = op[1], op[2]
        if not self._coll_exists(staged_colls, cid.pg):
            raise KeyError(f"no collection {cid}")
        if name == "touch":
            self._get_staged(staged, cid, oid, create=True)
        elif name == "write":
            onode = self._get_staged(staged, cid, oid, create=True)
            _n, _c, _o, offset, data = op
            self._stage_write(onode, offset, data, new_extents, freed)
        elif name == "zero":
            onode = self._get_staged(staged, cid, oid, create=True)
            _n, _c, _o, offset, length = op
            self._punch(onode, offset, length, new_extents, freed)
            onode.size = max(onode.size, offset + length)
        elif name == "truncate":
            onode = self._get_staged(staged, cid, oid, create=True)
            size = op[3]
            if size < onode.size:
                self._punch(
                    onode, size, onode.size - size, new_extents, freed
                )
            onode.size = size
        elif name == "remove":
            key = _okey(cid, oid)
            # `key in staged` (not `or`): a staged None means an earlier
            # op in THIS txn already removed it and freed its extents —
            # falling through to the committed onode would double-free
            # the blocks
            onode = staged[key] if key in staged else self._onodes.get(key)
            if onode is not None:
                freed.extend((e[2], e[3]) for e in onode.extents)
            staged[key] = None
        elif name in ("clone", "try_stash", "stash_restore"):
            # tuples: (clone, cid, src, dst) / (try_stash, cid, src,
            # stash) / (stash_restore, cid, stash, dst) — MemStore's
            # exact semantics, incl. restore consuming the stash and a
            # missing stash meaning "remove dst"
            src_oid, dst_oid = op[2], op[3]
            skey, dkey = _okey(cid, src_oid), _okey(cid, dst_oid)
            src = staged[skey] if skey in staged else self._onodes.get(skey)
            if name == "try_stash":
                dst_exists = (
                    staged[dkey] is not None if dkey in staged
                    else dkey in self._onodes
                )
                if dst_exists:
                    # stash-if-absent (see Transaction.try_stash): a
                    # re-sent sub-write keeps the true pre-write stash
                    return
            if src is None:
                if name == "clone":
                    raise KeyError(f"no object {src_oid} in {cid}")
                if name == "try_stash":
                    return  # absent source: no-op by contract
                # stash_restore with no stash: the mutation created dst
                old = (
                    staged[dkey] if dkey in staged
                    else self._onodes.get(dkey)
                )
                if old is not None:
                    freed.extend((e[2], e[3]) for e in old.extents)
                staged[dkey] = None
                return
            # materialize the source data (verifying crcs) and write the
            # copy as one fresh blob — simplest correct sharing-free copy
            data = self._materialize(src)
            dst = _Onode()
            dst.size = src.size
            dst.xattrs = dict(src.xattrs)
            dst.omap = dict(src.omap)
            old = staged[dkey] if dkey in staged else self._onodes.get(dkey)
            if old is not None:
                freed.extend((e[2], e[3]) for e in old.extents)
            if data:
                rec = self._write_blob(data)
                new_extents.append((rec[0], rec[1]))
                dst.extents = [[0, len(data), *rec]]
            staged[dkey] = dst
            if name == "stash_restore":
                # restore consumes the stash (src IS the stash here); its
                # blobs are still referenced by dst's fresh copy? no —
                # dst got its own blob above, so the stash blobs free
                freed.extend((e[2], e[3]) for e in src.extents)
                staged[skey] = None
        elif name == "setattr":
            onode = self._get_staged(staged, cid, oid, create=True)
            onode.xattrs[op[3]] = bytes(op[4])
        elif name == "rmattr":
            onode = self._get_staged(staged, cid, oid, create=False)
            onode.xattrs.pop(op[3], None)
        elif name == "omap_setkeys":
            onode = self._get_staged(staged, cid, oid, create=True)
            onode.omap.update({k: bytes(v) for k, v in op[3].items()})
        elif name == "omap_rmkeys":
            onode = self._get_staged(staged, cid, oid, create=False)
            for k in op[3]:
                onode.omap.pop(k, None)
        elif name == "omap_clear":
            onode = self._get_staged(staged, cid, oid, create=False)
            onode.omap.clear()
        else:
            raise ValueError(f"unknown op {name!r}")

    def _materialize(self, onode: _Onode) -> bytes:
        """Whole-object bytes, crc-verified, holes zero-filled."""
        buf = bytearray(onode.size)
        for ext in onode.extents:
            data = self._read_blob(ext, "object")
            buf[ext[0] : ext[0] + len(data)] = data
        return bytes(buf)

    # -- read path -----------------------------------------------------------
    def _onode(self, cid: CollectionId, oid: ObjectId) -> _Onode:
        if cid.pg not in self._colls:
            raise KeyError(f"no collection {cid}")
        onode = self._onodes.get(_okey(cid, oid))
        if onode is None:
            raise KeyError(f"no object {oid} in {cid}")
        return onode

    def exists(self, cid: CollectionId, oid: ObjectId) -> bool:
        with self._lock:
            return (
                cid.pg in self._colls
                and _okey(cid, oid) in self._onodes
            )

    def read(
        self, cid: CollectionId, oid: ObjectId,
        offset: int = 0, length: int = -1,
    ) -> bytes:
        with self._lock:
            self._assert_mounted()
            onode = self._onode(cid, oid)
            if length < 0:
                length = max(onode.size - offset, 0)
            end = min(offset + length, onode.size)
            if end <= offset:
                return b""
            buf = bytearray(end - offset)
            for ext in onode.extents:
                lofs, llen = ext[0], ext[1]
                if lofs + llen <= offset or lofs >= end:
                    continue
                data = self._read_blob(ext, f"{oid} in {cid}")
                s = max(offset, lofs)
                e = min(end, lofs + llen)
                buf[s - offset : e - offset] = data[s - lofs : e - lofs]
            return bytes(buf)

    def stat(self, cid: CollectionId, oid: ObjectId) -> int:
        with self._lock:
            return self._onode(cid, oid).size

    def getattr(self, cid: CollectionId, oid: ObjectId, key: str) -> bytes:
        with self._lock:
            xattrs = self._onode(cid, oid).xattrs
            if key not in xattrs:
                raise KeyError(f"no xattr {key!r} on {oid}")
            return xattrs[key]

    def getattrs(self, cid: CollectionId, oid: ObjectId) -> dict[str, bytes]:
        with self._lock:
            return dict(self._onode(cid, oid).xattrs)

    def omap_get(self, cid: CollectionId, oid: ObjectId) -> dict[str, bytes]:
        with self._lock:
            return dict(self._onode(cid, oid).omap)

    def omap_get_keys(
        self, cid: CollectionId, oid: ObjectId, keys: list[str]
    ) -> dict[str, bytes]:
        with self._lock:
            omap = self._onode(cid, oid).omap
            return {k: omap[k] for k in keys if k in omap}

    def omap_get_range(
        self, cid: CollectionId, oid: ObjectId, *,
        start_after: str = "", prefix: str = "", max_entries: int = 1000,
    ) -> tuple[dict[str, bytes], bool]:
        with self._lock:
            return omap_range_page(
                self._onode(cid, oid).omap, start_after, prefix,
                max_entries,
            )

    def list_collections(self) -> list[CollectionId]:
        with self._lock:
            return [CollectionId(c) for c in sorted(self._colls)]

    def collection_exists(self, cid: CollectionId) -> bool:
        with self._lock:
            return cid.pg in self._colls

    def list_objects(self, cid: CollectionId) -> list[ObjectId]:
        with self._lock:
            if cid.pg not in self._colls:
                raise KeyError(f"no collection {cid}")
            out = []
            for key in self._onodes:
                c, name, shard = key.split(_SEP)
                if c == cid.pg:
                    out.append(ObjectId(_okey_name(name), int(shard)))
            return sorted(out, key=lambda o: (o.name, o.shard))

    # -- fsck (BlueStore fsck analog) ----------------------------------------
    def fsck(self) -> dict:
        """Verify every blob's checksum; returns a report.  The scrub
        tier re-reads through read() anyway — this is the offline
        whole-store sweep (reference BlueStore::fsck)."""
        with self._lock:
            self._assert_mounted()
            report = {"objects": 0, "blobs": 0, "errors": []}
            for key, onode in self._onodes.items():
                report["objects"] += 1
                for ext in onode.extents:
                    report["blobs"] += 1
                    try:
                        self._read_blob(ext, key)
                    except BitrotError as e:
                        report["errors"].append({"onode": key, "error": str(e)})
            return report
