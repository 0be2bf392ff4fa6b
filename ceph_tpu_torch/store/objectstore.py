"""ObjectStore types: collections, objects, transactions.

Counterpart of the types of ceph_tpu/store/objectstore.py
(ObjectId, CollectionId, Transaction), which the messenger's
message types carry.  The ObjectStore interface and its stores come
with their own slice.

The reference's ObjectStore (reference:src/os/ObjectStore.h) is a
transactional API over collections of objects, where each object carries a
byte payload (sparse extents), xattrs, and an omap (sorted key/value map).
Writes are grouped into Transactions applied atomically.  Object
identity: ObjectId(name, shard) inside CollectionId(pg, shard) —
the (g)hobject_t / coll_t essentials (pool+hash live in the collection's
pg string, e.g. "1.3s2" mirroring spg_t).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

NO_SHARD = -1  # shard_id_t::NO_SHARD — replicated pools / whole objects


@dataclasses.dataclass(frozen=True, order=True)
class ObjectId:
    """Object name within a collection (hobject_t essentials)."""

    name: str
    shard: int = NO_SHARD

    def __str__(self) -> str:
        return self.name if self.shard == NO_SHARD else f"{self.name}s{self.shard}"


@dataclasses.dataclass(frozen=True, order=True)
class CollectionId:
    """Collection = one PG shard's objects, or the 'meta' collection
    (coll_t, reference:src/osd/osd_types.h coll_t)."""

    pg: str  # "1.3" (replicated), "1.3s2" (EC shard), or "meta"

    def __str__(self) -> str:
        return self.pg


META_COLL = CollectionId("meta")


class Transaction:
    """Ordered op list applied atomically (reference:ObjectStore.h Transaction).

    Op encoding is (opname, args...) tuples; ``ObjectStore.apply`` replays
    them. The subset implemented is what the OSD data path uses: collection
    lifecycle, object write/zero/truncate/remove/clone, xattr and omap ops.
    """

    def __init__(self):
        self.ops: list[tuple] = []

    # -- collection lifecycle
    def create_collection(self, cid: CollectionId) -> "Transaction":
        self.ops.append(("create_collection", cid))
        return self

    def remove_collection(self, cid: CollectionId) -> "Transaction":
        self.ops.append(("remove_collection", cid))
        return self

    # -- object data
    def touch(self, cid: CollectionId, oid: ObjectId) -> "Transaction":
        self.ops.append(("touch", cid, oid))
        return self

    def write(
        self, cid: CollectionId, oid: ObjectId, offset: int, data: bytes
    ) -> "Transaction":
        self.ops.append(("write", cid, oid, offset, bytes(data)))
        return self

    def zero(
        self, cid: CollectionId, oid: ObjectId, offset: int, length: int
    ) -> "Transaction":
        self.ops.append(("zero", cid, oid, offset, length))
        return self

    def truncate(self, cid: CollectionId, oid: ObjectId, size: int) -> "Transaction":
        self.ops.append(("truncate", cid, oid, size))
        return self

    def remove(self, cid: CollectionId, oid: ObjectId) -> "Transaction":
        self.ops.append(("remove", cid, oid))
        return self

    def clone(
        self, cid: CollectionId, src: ObjectId, dst: ObjectId
    ) -> "Transaction":
        self.ops.append(("clone", cid, src, dst))
        return self

    # -- rollback stashes (EC overwrite safety)
    def try_stash(
        self, cid: CollectionId, src: ObjectId, stash: ObjectId
    ) -> "Transaction":
        """Clone ``src`` (data+attrs+omap) to ``stash`` iff src exists
        AND the stash does not already exist, else no-op.  The EC write
        path stashes the pre-write object in the same transaction as the
        overwrite so an interrupted fan-out can roll back (the role of
        the reference's pg-log rollback info, reference:doc/dev/
        osd_internals/erasure_coding/ecbackend.rst).

        The stash-if-absent rule is what makes sub-write transactions
        idempotent under re-send (osd_subop_retries): stash names are
        version-unique (snap clones snapid-unique), so on a re-applied
        txn the stash already holds the true PRE-write copy and must not
        be clobbered with post-write data (r4 review finding)."""
        self.ops.append(("try_stash", cid, src, stash))
        return self

    def stash_restore(
        self, cid: CollectionId, stash: ObjectId, dst: ObjectId
    ) -> "Transaction":
        """Undo a stashed mutation: if ``stash`` exists, restore it over
        ``dst`` and drop the stash; if not (the mutation created the
        object), remove ``dst``."""
        self.ops.append(("stash_restore", cid, stash, dst))
        return self

    # -- xattrs
    def setattr(
        self, cid: CollectionId, oid: ObjectId, key: str, value: bytes
    ) -> "Transaction":
        self.ops.append(("setattr", cid, oid, key, bytes(value)))
        return self

    def rmattr(self, cid: CollectionId, oid: ObjectId, key: str) -> "Transaction":
        self.ops.append(("rmattr", cid, oid, key))
        return self

    # -- omap
    def omap_setkeys(
        self, cid: CollectionId, oid: ObjectId, kv: Mapping[str, bytes]
    ) -> "Transaction":
        self.ops.append(
            ("omap_setkeys", cid, oid, {k: bytes(v) for k, v in kv.items()})
        )
        return self

    def omap_rmkeys(
        self, cid: CollectionId, oid: ObjectId, keys: Sequence[str]
    ) -> "Transaction":
        self.ops.append(("omap_rmkeys", cid, oid, list(keys)))
        return self

    def omap_clear(self, cid: CollectionId, oid: ObjectId) -> "Transaction":
        self.ops.append(("omap_clear", cid, oid))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    def empty(self) -> bool:
        return not self.ops

    def __len__(self) -> int:
        return len(self.ops)

