"""ObjectStore contract: collections, objects, transactions.

The reference's ``ObjectStore`` (reference:src/os/ObjectStore.h) is a
transactional API over collections of objects, where each object carries a
byte payload (sparse extents), xattrs, and an omap (sorted key/value map).
Writes are grouped into ``Transaction``s applied atomically with
on_applied/on_commit callbacks (reference:ObjectStore.h queue_transactions).

Design choices:

- Object payloads are held as contiguous ``bytearray``s (host memory is the
  staging area for device batches; the EC backend hands whole shard extents
  to one device call, so sparse-extent trees buy nothing here).
- Transactions are an op list replayed under a single store lock —
  sequencers collapse to that lock because the asyncio runtime already
  serializes the OSD's apply path.
- Object identity: ``ObjectId(name, shard)`` inside ``CollectionId(pg,
  shard)`` — the (g)hobject_t / coll_t essentials (pool+hash live in the
  collection's pg string, e.g. "1.3s2" mirroring spg_t).

Counterpart of ``ceph_tpu/store/objectstore.py``, whole: the messenger
carries these types, and the stores (``memstore``, ``wal``, ``blue``)
implement :class:`ObjectStore`.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Iterable, Mapping, Sequence

NO_SHARD = -1  # shard_id_t::NO_SHARD — replicated pools / whole objects


class NeedsMkfs(RuntimeError):
    """mount() on a store that was never mkfs'd — the ONE mount failure a
    daemon may answer with mkfs(); anything else (corruption, I/O errors)
    must propagate rather than be 'fixed' by formatting."""


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


def omap_range_page(
    omap: dict[str, bytes], start_after: str, prefix: str,
    max_entries: int,
) -> tuple[dict[str, bytes], bool]:
    """The single range-page semantics shared by every store and the
    cls MethodContext fallback: sorted keys strictly after
    ``start_after`` under ``prefix``, one page + truncated flag.  Store
    overrides call this under their lock on the live dict (no full
    value copy)."""
    keys = sorted(
        k for k in omap
        if k > start_after and (not prefix or k.startswith(prefix))
    )
    page = keys[:max_entries]
    return {k: omap[k] for k in page}, len(keys) > max_entries


class ObjectStore(abc.ABC):
    """Transactional object store (reference:src/os/ObjectStore.h).

    Reads are immediate; mutations go through :meth:`queue_transaction`.
    """

    # -- lifecycle
    @abc.abstractmethod
    def mount(self) -> None: ...

    @abc.abstractmethod
    def umount(self) -> None: ...

    @abc.abstractmethod
    def mkfs(self) -> None: ...

    # -- mutation
    @abc.abstractmethod
    def apply(self, txn: Transaction) -> None:
        """Apply every op atomically; raise on the first failing op."""

    def queue_transaction(
        self,
        txn: Transaction,
        on_applied: Callable[[], None] | None = None,
        on_commit: Callable[[], None] | None = None,
    ) -> None:
        """Apply + fire callbacks (reference queue_transactions contract;
        backends with a real journal may defer on_commit)."""
        self.apply(txn)
        if on_applied:
            on_applied()
        if on_commit:
            on_commit()

    # -- reads
    @abc.abstractmethod
    def exists(self, cid: CollectionId, oid: ObjectId) -> bool: ...

    @abc.abstractmethod
    def read(
        self, cid: CollectionId, oid: ObjectId, offset: int = 0, length: int = -1
    ) -> bytes:
        """length == -1 means to end of object; raises KeyError if absent."""

    @abc.abstractmethod
    def stat(self, cid: CollectionId, oid: ObjectId) -> int:
        """Object size in bytes; raises KeyError if absent."""

    @abc.abstractmethod
    def getattr(self, cid: CollectionId, oid: ObjectId, key: str) -> bytes: ...

    @abc.abstractmethod
    def getattrs(self, cid: CollectionId, oid: ObjectId) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def omap_get(self, cid: CollectionId, oid: ObjectId) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def omap_get_keys(
        self, cid: CollectionId, oid: ObjectId, keys: Iterable[str]
    ) -> dict[str, bytes]: ...

    def omap_get_range(
        self, cid: CollectionId, oid: ObjectId, *,
        start_after: str = "", prefix: str = "", max_entries: int = 1000,
    ) -> tuple[dict[str, bytes], bool]:
        """One sorted page of omap entries strictly after ``start_after``
        under ``prefix``: (page, truncated).  The analog of the
        reference's get_omap_iterator + bounded iteration
        (reference:src/os/ObjectStore.h omap iterators) — pagers (the
        rgw index class) must use this instead of copying the whole
        omap per page.  Default walks the full map once (no per-page
        value copy in the overrides); a sorted-index store can override
        with a seek."""
        return omap_range_page(
            self.omap_get(cid, oid), start_after, prefix, max_entries
        )

    # -- enumeration
    @abc.abstractmethod
    def list_collections(self) -> list[CollectionId]: ...

    @abc.abstractmethod
    def collection_exists(self, cid: CollectionId) -> bool: ...

    @abc.abstractmethod
    def list_objects(self, cid: CollectionId) -> list[ObjectId]:
        """Sorted object listing (collection_list)."""
