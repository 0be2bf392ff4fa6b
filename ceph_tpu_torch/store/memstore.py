"""In-memory ObjectStore (reference:src/os/memstore/MemStore.h:32).

The reference uses MemStore to run OSD logic in unit tests without disks;
here it is additionally the default store for the asyncio mini-cluster —
the framework's durability story for benchmarks is per-write + PG-log
resume, not local disk persistence.

Counterpart of ``ceph_tpu/store/memstore.py``, whole.
"""

from __future__ import annotations

import threading
from typing import Iterable

from .objectstore import (
    CollectionId,
    ObjectId,
    ObjectStore,
    Transaction,
    omap_range_page,
)


class _Object:
    __slots__ = ("data", "xattrs", "omap")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}

    def clone_from(self, src: "_Object") -> None:
        self.data = bytearray(src.data)
        self.xattrs = dict(src.xattrs)
        self.omap = dict(src.omap)


class MemStore(ObjectStore):
    def __init__(self):
        self._colls: dict[CollectionId, dict[ObjectId, _Object]] = {}
        self._lock = threading.RLock()
        self._mounted = False

    # -- lifecycle
    def mkfs(self) -> None:
        with self._lock:
            self._colls.clear()

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    def _assert_mounted(self) -> None:
        if not self._mounted:
            raise RuntimeError("MemStore is not mounted")

    # -- mutation
    def apply(self, txn: Transaction) -> None:
        """Atomic replay: on a failing op, every prior op is rolled back
        (undo snapshots are taken lazily per touched collection/object)."""
        with self._lock:
            self._assert_mounted()
            # ordered undo log, one entry per first touch; rollback replays it
            # in reverse so a later snapshot never clobbers an earlier one
            # (e.g. remove_collection + create_collection + write of an oid
            # that existed in the old collection)
            undo: list[tuple] = []
            seen_colls: set[CollectionId] = set()
            seen_objs: set[tuple[CollectionId, ObjectId]] = set()

            def snap_coll(cid: CollectionId) -> None:
                if cid in seen_colls:
                    return
                seen_colls.add(cid)
                coll = self._colls.get(cid)
                undo.append(("coll", cid, dict(coll) if coll is not None else None))

            def snap_obj(cid: CollectionId, oid: ObjectId) -> None:
                key = (cid, oid)
                if key in seen_objs:
                    return
                seen_objs.add(key)
                coll = self._colls.get(cid)
                obj = coll.get(oid) if coll is not None else None
                if obj is None:
                    undo.append(("obj", cid, oid, None))
                else:
                    cp = _Object()
                    cp.clone_from(obj)
                    undo.append(("obj", cid, oid, cp))

            try:
                for op in txn.ops:
                    name = op[0]
                    if name in ("create_collection", "remove_collection"):
                        snap_coll(op[1])
                    else:
                        snap_obj(op[1], op[2])
                        if name in ("clone", "try_stash", "stash_restore"):
                            snap_obj(op[1], op[3])
                    self._apply_op(op)
            except Exception:
                for entry in reversed(undo):
                    if entry[0] == "coll":
                        _, cid, members = entry
                        if members is None:
                            self._colls.pop(cid, None)
                        else:
                            self._colls[cid] = members
                    else:
                        _, cid, oid, obj = entry
                        coll = self._colls.get(cid)
                        if coll is None:
                            continue
                        if obj is None:
                            coll.pop(oid, None)
                        else:
                            coll[oid] = obj
                raise

    def _coll(self, cid: CollectionId) -> dict[ObjectId, _Object]:
        try:
            return self._colls[cid]
        except KeyError:
            raise KeyError(f"no collection {cid}") from None

    def _obj(self, cid: CollectionId, oid: ObjectId, create: bool) -> _Object:
        coll = self._coll(cid)
        obj = coll.get(oid)
        if obj is None:
            if not create:
                raise KeyError(f"no object {cid}/{oid}")
            obj = coll[oid] = _Object()
        return obj

    def _apply_op(self, op: tuple) -> None:
        name = op[0]
        if name == "create_collection":
            (_, cid) = op
            self._colls.setdefault(cid, {})
        elif name == "remove_collection":
            (_, cid) = op
            self._colls.pop(cid, None)
        elif name == "touch":
            (_, cid, oid) = op
            self._obj(cid, oid, create=True)
        elif name == "write":
            (_, cid, oid, offset, data) = op
            obj = self._obj(cid, oid, create=True)
            end = offset + len(data)
            if len(obj.data) < end:
                obj.data.extend(b"\x00" * (end - len(obj.data)))
            obj.data[offset:end] = data
        elif name == "zero":
            (_, cid, oid, offset, length) = op
            obj = self._obj(cid, oid, create=True)
            end = offset + length
            if len(obj.data) < end:
                obj.data.extend(b"\x00" * (end - len(obj.data)))
            obj.data[offset:end] = b"\x00" * length
        elif name == "truncate":
            (_, cid, oid, size) = op
            obj = self._obj(cid, oid, create=True)
            if len(obj.data) > size:
                del obj.data[size:]
            else:
                obj.data.extend(b"\x00" * (size - len(obj.data)))
        elif name == "remove":
            (_, cid, oid) = op
            self._coll(cid).pop(oid, None)
        elif name == "clone":
            (_, cid, src, dst) = op
            obj = self._obj(cid, src, create=False)
            self._obj(cid, dst, create=True).clone_from(obj)
        elif name == "try_stash":
            (_, cid, src, dst) = op
            coll = self._coll(cid)
            obj = coll.get(src)
            if obj is not None and dst not in coll:
                # stash-if-absent: a re-applied (re-sent) sub-write must
                # not overwrite the true pre-write copy
                self._obj(cid, dst, create=True).clone_from(obj)
        elif name == "stash_restore":
            (_, cid, stash, dst) = op
            coll = self._coll(cid)
            obj = coll.get(stash)
            if obj is not None:
                self._obj(cid, dst, create=True).clone_from(obj)
                coll.pop(stash, None)
            else:
                coll.pop(dst, None)
        elif name == "setattr":
            (_, cid, oid, key, value) = op
            # materialize at the retention boundary: the value may be a
            # borrowed view of a receive frame (zero-copy messenger),
            # and a tiny xattr must not pin a multi-MB frame for the
            # object's lifetime
            self._obj(cid, oid, create=True).xattrs[key] = bytes(value)
        elif name == "rmattr":
            (_, cid, oid, key) = op
            self._obj(cid, oid, create=False).xattrs.pop(key, None)
        elif name == "omap_setkeys":
            (_, cid, oid, kv) = op
            self._obj(cid, oid, create=True).omap.update(
                {k: bytes(v) for k, v in kv.items()}
            )
        elif name == "omap_rmkeys":
            (_, cid, oid, keys) = op
            omap = self._obj(cid, oid, create=False).omap
            for k in keys:
                omap.pop(k, None)
        elif name == "omap_clear":
            (_, cid, oid) = op
            self._obj(cid, oid, create=False).omap.clear()
        else:
            raise ValueError(f"unknown transaction op {name!r}")

    # -- reads
    def exists(self, cid: CollectionId, oid: ObjectId) -> bool:
        with self._lock:
            self._assert_mounted()
            return cid in self._colls and oid in self._colls[cid]

    def read(
        self, cid: CollectionId, oid: ObjectId, offset: int = 0, length: int = -1
    ) -> bytes:
        with self._lock:
            self._assert_mounted()
            data = self._obj(cid, oid, create=False).data
            if length < 0:
                return bytes(data[offset:])
            return bytes(data[offset : offset + length])

    def stat(self, cid: CollectionId, oid: ObjectId) -> int:
        with self._lock:
            self._assert_mounted()
            return len(self._obj(cid, oid, create=False).data)

    def getattr(self, cid: CollectionId, oid: ObjectId, key: str) -> bytes:
        with self._lock:
            self._assert_mounted()
            return self._obj(cid, oid, create=False).xattrs[key]

    def getattrs(self, cid: CollectionId, oid: ObjectId) -> dict[str, bytes]:
        with self._lock:
            self._assert_mounted()
            return dict(self._obj(cid, oid, create=False).xattrs)

    def omap_get(self, cid: CollectionId, oid: ObjectId) -> dict[str, bytes]:
        with self._lock:
            self._assert_mounted()
            return dict(self._obj(cid, oid, create=False).omap)

    def omap_get_keys(
        self, cid: CollectionId, oid: ObjectId, keys: Iterable[str]
    ) -> dict[str, bytes]:
        with self._lock:
            self._assert_mounted()
            omap = self._obj(cid, oid, create=False).omap
            return {k: omap[k] for k in keys if k in omap}

    def omap_get_range(
        self, cid: CollectionId, oid: ObjectId, *,
        start_after: str = "", prefix: str = "", max_entries: int = 1000,
    ) -> tuple[dict[str, bytes], bool]:
        with self._lock:
            self._assert_mounted()
            return omap_range_page(
                self._obj(cid, oid, create=False).omap,
                start_after, prefix, max_entries,
            )

    # -- enumeration
    def list_collections(self) -> list[CollectionId]:
        with self._lock:
            self._assert_mounted()
            return sorted(self._colls)

    def collection_exists(self, cid: CollectionId) -> bool:
        with self._lock:
            self._assert_mounted()
            return cid in self._colls

    def list_objects(self, cid: CollectionId) -> list[ObjectId]:
        with self._lock:
            self._assert_mounted()
            return sorted(self._coll(cid))
