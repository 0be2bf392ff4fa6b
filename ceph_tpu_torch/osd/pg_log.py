"""PG log: per-PG ordered mutation record.

Re-expression of the reference pg log (reference:src/osd/PGLog.{h,cc},
``pg_log_entry_t`` in reference:src/osd/osd_types.h): every mutation the
primary applies gets a monotonically increasing ``eversion_t``
(map-epoch, version) and is recorded on every shard in the same
ObjectStore transaction as the data (reference:src/osd/ECBackend.cc:908-938)
— this is what makes divergence detectable and resumable after restarts
(design: reference:doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27).

The log lives in the omap of the per-shard ``_pgmeta_`` object, keyed so
lexicographic omap order == version order.

Counterpart of ``ceph_tpu/osd/pg_log.py``, whole: the same omap keys
and entry JSON.
"""

from __future__ import annotations

import dataclasses
import json

from ..store import CollectionId, ObjectId, Transaction

PGMETA_NAME = "_pgmeta_"


def meta_oid(shard: int) -> ObjectId:
    return ObjectId(PGMETA_NAME, shard)


@dataclasses.dataclass(frozen=True, order=True)
class Eversion:
    """(map epoch, version) — reference eversion_t."""

    epoch: int = 0
    version: int = 0

    def key(self) -> str:
        return f"{self.epoch:010d}.{self.version:012d}"

    def to_list(self) -> list[int]:
        return [self.epoch, self.version]

    @classmethod
    def from_list(cls, v) -> "Eversion":
        return cls(int(v[0]), int(v[1]))


@dataclasses.dataclass
class PGLogEntry:
    """reference pg_log_entry_t essentials: op, object, version chain.

    ``stash`` names the rollback stash object the sub-write created in
    the same transaction (the role of the reference's per-entry rollback
    info, reference:doc/dev/osd_internals/erasure_coding/ecbackend.rst):
    while the stash exists the entry can be rolled back; the primary's
    trim watermark deletes stashes once every present shard committed.
    """

    op: str  # "modify" | "delete"
    oid: str
    version: Eversion
    prior_version: Eversion
    stash: str | None = None

    def to_dict(self) -> dict:
        d = {
            "op": self.op,
            "oid": self.oid,
            "version": self.version.to_list(),
            "prior_version": self.prior_version.to_list(),
        }
        if self.stash:
            d["stash"] = self.stash
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PGLogEntry":
        return cls(
            op=d["op"],
            oid=d["oid"],
            version=Eversion.from_list(d["version"]),
            prior_version=Eversion.from_list(d["prior_version"]),
            stash=d.get("stash"),
        )


def add_log_entry_to_txn(
    txn: Transaction, cid: CollectionId, shard: int, entry: PGLogEntry
) -> None:
    """Record the entry in the shard's pgmeta omap inside ``txn`` — same
    transaction as the data writes, the crash-consistency contract."""
    txn.omap_setkeys(
        cid,
        meta_oid(shard),
        {entry.version.key(): json.dumps(entry.to_dict()).encode()},
    )


STASH_SEP = "\x00stash\x00"


def stash_name(oid: str, version: Eversion) -> str:
    """Rollback stash object name for ``oid`` at ``version`` — derivable
    by recovery without consulting the log entry."""
    return f"{oid}{STASH_SEP}{version.key()}"


def is_stash_name(name: str) -> bool:
    return STASH_SEP in name


TRIM_MARKER_KEY = "_stash_trimmed_to"


def trim_stashes_to_txn(
    store, cid: CollectionId, shard: int, trim_to: Eversion, txn: Transaction
) -> None:
    """Drop rollback stashes for entries ≤ ``trim_to`` (they are fully
    committed on every present shard — the primary's watermark says so).
    A marker key bounds the scan so repeated watermarks are O(new entries).
    The removals join ``txn`` so trim is atomic with the op carrying it.
    """
    moid = meta_oid(shard)
    try:
        omap = store.omap_get(cid, moid)
    except KeyError:
        return
    marker = omap.get(TRIM_MARKER_KEY, b"").decode()
    upper = trim_to.key()
    if upper <= marker:
        return
    for key in sorted(omap):
        if "." not in key or key <= marker or key > upper:
            continue
        entry = PGLogEntry.from_dict(json.loads(omap[key]))
        if entry.stash:
            txn.remove(cid, ObjectId(entry.stash, shard))
    txn.omap_setkeys(cid, moid, {TRIM_MARKER_KEY: upper.encode()})


def read_log(store, cid: CollectionId, shard: int) -> list[PGLogEntry]:
    """Load the shard's log in version order (mount/peering path)."""
    try:
        omap = store.omap_get(cid, meta_oid(shard))
    except KeyError:
        return []
    return [
        PGLogEntry.from_dict(json.loads(v))
        for k, v in sorted(omap.items())
        if "." in k
    ]
