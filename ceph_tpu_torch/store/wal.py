"""WalStore: durable ObjectStore = in-memory state + write-ahead journal.

The reference's FileStore pairs a file-per-object backend with a
write-ahead FileJournal whose records are replayed on mount
(reference:src/os/filestore/FileJournal.h:39 "write ahead journaling,
applied to FileStore"); BlueStore gets the same contract from the RocksDB
WAL.  The framework's local store keeps the MemStore working set (host
RAM is the staging area for device batches) and makes it durable the same
way: every transaction is serialized into an append-only journal record
(crc-guarded, length-prefixed) and fsync'd BEFORE being applied to memory;
mount() rebuilds memory from the newest checkpoint snapshot plus journal
replay, discarding a torn tail.  Periodic checkpoints (atomic
write-tmp/fsync/rename) bound journal growth, mirroring FileStore's
journal trim on sync_entry.

Commit point: a transaction is durable iff its journal record hit the
journal file (mode "fsync": and the disk).  A crash between the journal
append and the in-memory apply re-applies the record on mount — the
write-ahead semantics the recovery design assumes (the ``crash_after``
test hook exercises exactly that window, the filestore_kill_at analog,
reference:src/test/objectstore/ tests).

Counterpart of ``ceph_tpu/store/wal.py``, whole: the same journal
records, transaction codec and checkpoint file, so a store written by
one package mounts in the other.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import BinaryIO

from .memstore import MemStore, _Object
from .objectstore import CollectionId, NeedsMkfs, ObjectId, Transaction

_MAGIC = 0x57414C31  # "WAL1"
_HDR = struct.Struct("<IQII")  # magic, seq, payload_len, crc32(payload)
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")

# (frozen tag, field spec) per op: C=collection, O=object id, S=string,
# B=bytes, I=int(u64), M={str:bytes}, K=[str].  Tags are part of the
# on-disk format — NEVER renumber; new ops take the next free tag.
_OP_SPEC: dict[str, tuple[int, str]] = {
    "create_collection": (0, "C"),
    "remove_collection": (1, "C"),
    "touch": (2, "CO"),
    "write": (3, "COIB"),
    "zero": (4, "COII"),
    "truncate": (5, "COI"),
    "remove": (6, "CO"),
    "clone": (7, "COO"),
    "try_stash": (8, "COO"),
    "stash_restore": (9, "COO"),
    "setattr": (10, "COSB"),
    "rmattr": (11, "COS"),
    "omap_setkeys": (12, "COM"),
    "omap_rmkeys": (13, "COK"),
    "omap_clear": (14, "CO"),
}
assert len({t for t, _ in _OP_SPEC.values()}) == len(_OP_SPEC)
_TAG_OPS = {tag: name for name, (tag, _) in _OP_SPEC.items()}


def _w_str(out: bytearray, s: str) -> None:
    b = s.encode()
    out += _U32.pack(len(b))
    out += b


def _w_bytes(out: bytearray, b: bytes) -> None:
    out += _U32.pack(len(b))
    out += b


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u32(self) -> int:
        (v,) = _U32.unpack_from(self.buf, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        (v,) = _I32.unpack_from(self.buf, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.buf, self.pos)
        self.pos += 8
        return v

    def raw(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        if len(v) != n:
            raise ValueError("short read")
        self.pos += n
        return v

    def str_(self) -> str:
        return self.raw(self.u32()).decode()

    def bytes_(self) -> bytes:
        return self.raw(self.u32())


def encode_txn(txn: Transaction) -> bytes:
    out = bytearray()
    out += _U32.pack(len(txn.ops))
    for op in txn.ops:
        name = op[0]
        tag, spec = _OP_SPEC[name]
        out.append(tag)
        for kind, val in zip(spec, op[1:]):
            if kind == "C":
                _w_str(out, val.pg)
            elif kind == "O":
                _w_str(out, val.name)
                out += _I32.pack(val.shard)
            elif kind == "S":
                _w_str(out, val)
            elif kind == "B":
                _w_bytes(out, val)
            elif kind == "I":
                out += struct.pack("<Q", val)
            elif kind == "M":
                out += _U32.pack(len(val))
                for k, v in val.items():
                    _w_str(out, k)
                    _w_bytes(out, v)
            elif kind == "K":
                out += _U32.pack(len(val))
                for k in val:
                    _w_str(out, k)
    return bytes(out)


def decode_txn(payload: bytes) -> Transaction:
    rd = _Reader(payload)
    n = rd.u32()
    txn = Transaction()
    for _ in range(n):
        tag = rd.raw(1)[0]
        name = _TAG_OPS[tag]
        args: list = []
        for kind in _OP_SPEC[name][1]:
            if kind == "C":
                args.append(CollectionId(rd.str_()))
            elif kind == "O":
                nm = rd.str_()
                args.append(ObjectId(nm, rd.i32()))
            elif kind == "S":
                args.append(rd.str_())
            elif kind == "B":
                args.append(rd.bytes_())
            elif kind == "I":
                args.append(rd.u64())
            elif kind == "M":
                cnt = rd.u32()
                args.append({rd.str_(): rd.bytes_() for _ in range(cnt)})
            elif kind == "K":
                cnt = rd.u32()
                args.append([rd.str_() for _ in range(cnt)])
        txn.ops.append((name, *args))
    return txn


class CrashPoint(Exception):
    """Raised by the crash_after test hook (filestore_kill_at analog)."""


class WalStore(MemStore):
    """Durable MemStore: write-ahead journal + checkpoint snapshots.

    Directory layout::

        <path>/journal      append-only records: [magic seq len crc][payload]
        <path>/checkpoint   full snapshot {seq, collections} (atomic rename)

    ``sync`` modes: "fsync" (default — record survives host power loss),
    "flush" (record reaches the OS page cache: survives process death,
    the mini-cluster harness default), "none" (tests only).
    """

    def __init__(self, path: str, sync: str = "fsync",
                 checkpoint_bytes: int = 64 << 20,
                 compression: str = "none"):
        super().__init__()
        if sync not in ("fsync", "flush", "none"):
            raise ValueError(f"bad sync mode {sync!r}")
        self.path = path
        self.sync = sync
        self.checkpoint_bytes = checkpoint_bytes
        # checkpoint compression via the compressor plugin family (the
        # BlueStore blob-compression analog, reference:src/compressor/);
        # decompression keys off the header, so the setting may change
        # between mounts
        self.compression = compression
        if compression != "none":
            from ..compressor import create as _create_compressor

            _create_compressor(compression)  # validate at construction
        self._journal: BinaryIO | None = None
        self._seq = 0  # last journaled seq
        self.crash_after: int | None = None  # journal appends until CrashPoint

    # -- paths
    @property
    def _journal_path(self) -> str:
        return os.path.join(self.path, "journal")

    @property
    def _checkpoint_path(self) -> str:
        return os.path.join(self.path, "checkpoint")

    def formatted(self) -> bool:
        """True if mkfs already ran on this path (mount will succeed)."""
        return os.path.exists(self._journal_path)

    def crash_close(self) -> None:
        """Abandon the live store WITHOUT umount (no checkpoint): free
        the fds so a fresh instance can re-open the same path — the
        harness's simulated process death."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        self._mounted = False

    # -- lifecycle
    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        for name in ("journal", "checkpoint"):
            p = os.path.join(self.path, name)
            if os.path.exists(p):
                os.unlink(p)
        with open(self._journal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        self._dir_sync()
        with self._lock:
            self._colls.clear()
            self._seq = 0

    def mount(self) -> None:
        with self._lock:
            if self._mounted:
                return
            if not os.path.isdir(self.path) or not os.path.exists(
                self._journal_path
            ):
                # the ONLY mount failure that means "fresh store, mkfs me";
                # any other exception (corrupt checkpoint schema, I/O error
                # during torn-tail truncate, ...) must propagate — callers
                # reacting to it with mkfs() would format a durable store
                raise NeedsMkfs(f"WalStore {self.path}: no fs (mkfs first)")
            self._colls.clear()
            self._seq = self._load_checkpoint()
            self._mounted = True  # MemStore.apply asserts mounted during replay
            try:
                self._replay_journal()
            except Exception:
                self._mounted = False
                raise
            self._journal = open(self._journal_path, "ab")

    def umount(self) -> None:
        with self._lock:
            if not self._mounted:
                return
            if os.path.getsize(self._journal_path) > 0:
                # an empty journal means the state is already exactly the
                # checkpoint: skip the O(store) re-snapshot
                self._checkpoint()
            if self._journal is not None:
                self._journal.close()
                self._journal = None
            self._mounted = False

    # -- journaling
    def apply(self, txn: Transaction) -> None:
        """Journal the record (the commit point), then apply to memory."""
        if txn.empty():
            return
        with self._lock:
            self._assert_mounted()
            payload = encode_txn(txn)
            self._append_record(payload)
            if self.crash_after is not None:
                self.crash_after -= 1
                if self.crash_after <= 0:
                    # the filestore_kill_at window: journaled but not applied
                    raise CrashPoint(
                        f"crash_after hook fired at seq {self._seq}"
                    )
            super().apply(txn)
            if self._journal.tell() >= self.checkpoint_bytes:
                self._checkpoint()

    def _append_record(self, payload: bytes) -> None:
        self._seq += 1
        self._journal.write(
            _HDR.pack(_MAGIC, self._seq, len(payload), zlib.crc32(payload))
        )
        self._journal.write(payload)
        if self.sync == "fsync":
            self._journal.flush()
            os.fsync(self._journal.fileno())
        elif self.sync == "flush":
            self._journal.flush()

    def _replay_journal(self) -> None:
        """Apply journal records newer than the checkpoint; truncate a torn
        tail (short/corrupt trailing record) like FileJournal's read_entry
        stopping at a bad header."""
        good_end = 0
        with open(self._journal_path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                magic, seq, plen, crc = _HDR.unpack(hdr)
                if magic != _MAGIC:
                    break
                payload = f.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    break
                good_end = f.tell()
                if seq <= self._seq:
                    continue  # already folded into the checkpoint
                try:
                    super().apply(decode_txn(payload))
                except Exception:  # pragma: no cover - replay is idempotent
                    # a record that failed mid-apply was rolled back by
                    # MemStore.apply; it can only be a programming error
                    # (the OSD never acked it) — skip, keep replaying
                    import logging

                    logging.getLogger(__name__).exception(
                        "WalStore %s: journal seq %d failed to replay",
                        self.path, seq,
                    )
                self._seq = max(self._seq, seq)
        size = os.path.getsize(self._journal_path)
        if size > good_end:
            with open(self._journal_path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())

    # -- checkpointing
    def _checkpoint(self) -> None:
        """Snapshot all collections at the current seq, then reset the
        journal (write-tmp / fsync / atomic-rename, then truncate)."""
        out = bytearray()
        out += struct.pack("<Q", self._seq)
        out += _U32.pack(len(self._colls))
        for cid in sorted(self._colls):
            _w_str(out, cid.pg)
            coll = self._colls[cid]
            out += _U32.pack(len(coll))
            for oid in sorted(coll):
                obj = coll[oid]
                _w_str(out, oid.name)
                out += _I32.pack(oid.shard)
                _w_bytes(out, bytes(obj.data))
                out += _U32.pack(len(obj.xattrs))
                for k, v in obj.xattrs.items():
                    _w_str(out, k)
                    _w_bytes(out, v)
                out += _U32.pack(len(obj.omap))
                for k, v in obj.omap.items():
                    _w_str(out, k)
                    _w_bytes(out, v)
        blob = bytes(out)
        if self.compression != "none":
            from ..compressor import create as _create_compressor

            comp = _create_compressor(self.compression)
            name = self.compression.encode()
            blob = b"CMP1" + bytes([len(name)]) + name + comp.compress(blob)
        tmp = self._checkpoint_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_U32.pack(zlib.crc32(blob)))
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._checkpoint_path)
        self._dir_sync()
        # journal restarts empty; records <= _seq live in the checkpoint now
        if self._journal is not None:
            self._journal.close()
        with open(self._journal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        if self._mounted:
            self._journal = open(self._journal_path, "ab")
        else:
            self._journal = None

    def _load_checkpoint(self) -> int:
        if not os.path.exists(self._checkpoint_path):
            return 0
        with open(self._checkpoint_path, "rb") as f:
            raw = f.read()
        if len(raw) < 4:
            return 0
        (crc,) = _U32.unpack_from(raw, 0)
        blob = raw[4:]
        if zlib.crc32(blob) != crc:
            # half-written checkpoint never happens (atomic rename), but a
            # corrupt one must not take the store down: fall back to replay
            return 0
        if blob[:4] == b"CMP1":
            nlen = blob[4]
            name = blob[5 : 5 + nlen].decode()
            from ..compressor import create as _create_compressor

            blob = _create_compressor(name).decompress(blob[5 + nlen :])
        rd = _Reader(blob)
        seq = rd.u64()
        n_colls = rd.u32()
        for _ in range(n_colls):
            cid = CollectionId(rd.str_())
            coll: dict[ObjectId, _Object] = {}
            self._colls[cid] = coll
            n_objs = rd.u32()
            for _ in range(n_objs):
                nm = rd.str_()
                shard = rd.i32()
                obj = _Object()
                obj.data = bytearray(rd.bytes_())
                for _ in range(rd.u32()):
                    k = rd.str_()
                    obj.xattrs[k] = rd.bytes_()
                for _ in range(rd.u32()):
                    k = rd.str_()
                    obj.omap[k] = rd.bytes_()
                coll[ObjectId(nm, shard)] = obj
        return seq

    def _dir_sync(self) -> None:
        if self.sync == "none":
            return
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
