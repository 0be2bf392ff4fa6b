"""Peering: per-shard PG metadata, past intervals, authoritative-log
selection, and divergent-entry computation.

Re-expression of the reference peering machinery
(reference:src/osd/PG.h:1654-2025 RecoveryMachine
GetInfo/GetLog/GetMissing; reference:src/osd/PGLog.cc merge_log /
_merge_divergent_entries; reference:src/osd/osd_types.h pg_info_t /
pg_history_t / PastIntervals) for the asyncio OSD:

- :class:`PGShardInfo` — the ``pg_info_t`` essentials each shard
  persists in its pgmeta omap: ``last_epoch_started`` (the newest
  interval this shard peered into) plus the log-derived ``last_update``.
- :class:`PastIntervals` — acting-set history records each OSD appends
  locally whenever a map change alters a PG's acting set
  (reference:src/osd/osd_types.cc PastIntervals::check_new_interval).
  The primary unions every reachable member's records to build the
  PRIOR SET: past-interval participants that must be consulted before
  the log can be declared authoritative.
- :func:`find_best_info` — authoritative-info selection
  (reference:src/osd/PG.cc find_best_info): max last_epoch_started
  first (a shard that kept accepting writes from a stale-interval
  primary loses to any shard of the newer interval regardless of its
  version numbers), then max last_update, then longest log, then the
  lowest shard key for determinism.
- :func:`divergent_entries` — the GetMissing comparison: entries on a
  peer strictly newer than the authoritative head are divergent and
  must be rolled back from their stashes
  (reference:doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27),
  never merged.

A "peering-lite" that collapsed all of this to last-writer-wins
across every member's log would break exactly across primary flips
and partitions — the cases this module exists for.

Counterpart of ``ceph_tpu/osd/peering.py``, whole: the same info and
past-interval JSON, and the same choices.
"""

from __future__ import annotations

import dataclasses
import json

from .pg_log import Eversion, PGLogEntry

CRUSH_ITEM_NONE = 0x7FFFFFFF  # vacant acting slot (crush/map.py)

# pgmeta omap keys (no "." so read_log's entry filter skips them)
INFO_KEY = "_peer_info"
PAST_INTERVALS_KEY = "_past_intervals"
MAX_INTERVALS = 64  # bounded history (reference bounds via last_epoch_clean)


@dataclasses.dataclass
class PGShardInfo:
    """pg_info_t essentials for one shard's copy of a PG."""

    last_epoch_started: int = 0
    last_update: Eversion = dataclasses.field(default_factory=Eversion)
    log_len: int = 0

    def to_dict(self) -> dict:
        return {
            "les": self.last_epoch_started,
            "last_update": self.last_update.to_list(),
            "log_len": self.log_len,
        }

    @classmethod
    def from_dict(cls, d: dict | None) -> "PGShardInfo":
        if not d:
            return cls()
        return cls(
            last_epoch_started=int(d.get("les", 0)),
            last_update=Eversion.from_list(d.get("last_update", [0, 0])),
            log_len=int(d.get("log_len", 0)),
        )


@dataclasses.dataclass(frozen=True)
class Interval:
    """One acting-set interval of a PG (reference pg_interval_t)."""

    first: int  # first map epoch of the interval
    last: int   # last epoch (the epoch BEFORE the change that ended it)
    acting: tuple[int, ...]
    primary: int

    def to_list(self) -> list:
        return [self.first, self.last, list(self.acting), self.primary]

    @classmethod
    def from_list(cls, v) -> "Interval":
        return cls(int(v[0]), int(v[1]), tuple(int(a) for a in v[2]), int(v[3]))


class PastIntervals:
    """Bounded acting-set history for one PG on one OSD."""

    def __init__(self, intervals: list[Interval] | None = None):
        self.intervals: list[Interval] = list(intervals or [])

    def note_change(
        self, first: int, last: int, acting: list[int], primary: int
    ) -> None:
        self.intervals.append(
            Interval(first, last, tuple(acting), primary)
        )
        if len(self.intervals) > MAX_INTERVALS:
            del self.intervals[: len(self.intervals) - MAX_INTERVALS]

    def to_json(self) -> bytes:
        return json.dumps([iv.to_list() for iv in self.intervals]).encode()

    @classmethod
    def from_json(cls, raw: bytes | None) -> "PastIntervals":
        if not raw:
            return cls()
        return cls([Interval.from_list(v) for v in json.loads(raw)])

    def merged_with(self, other: "PastIntervals") -> "PastIntervals":
        """Union of two members' records (dedup by (first, last))."""
        seen = {(iv.first, iv.last): iv for iv in self.intervals}
        for iv in other.intervals:
            seen.setdefault((iv.first, iv.last), iv)
        return PastIntervals(
            sorted(seen.values(), key=lambda iv: (iv.first, iv.last))
        )


def find_best_info(
    infos: dict[int, PGShardInfo]
) -> int | None:
    """Authoritative shard selection (reference:src/osd/PG.cc
    find_best_info): the shard whose log history is allowed to win.

    Ordering: max last_epoch_started >> max last_update >> longest log
    >> lowest shard key.  A stale-interval shard (les below the
    maximum) can NEVER be authoritative, whatever versions its log
    claims — this is the invariant last-writer-wins lacked."""
    if not infos:
        return None
    max_les = max(i.last_epoch_started for i in infos.values())
    candidates = {
        k: i for k, i in infos.items() if i.last_epoch_started == max_les
    }
    return min(
        candidates,
        key=lambda k: (
            # negate for "max wins" under min()
            tuple(-v for v in candidates[k].last_update.to_list()),
            -candidates[k].log_len,
            k,
        ),
    )


def divergent_entries_per_object(
    auth_versions: dict[str, Eversion], peer_log: list[PGLogEntry]
) -> list[PGLogEntry]:
    """Per-object divergence: a stale peer's entry is divergent when it
    is newer than everything the authoritative history knows about THAT
    object (or touches an object the history never saw).  A global-head
    cap would let a stale write at a numerically lower version slip
    through; the reference compares against the
    authoritative log per object in merge_log."""
    div = [
        e for e in peer_log
        if e.version > auth_versions.get(e.oid, Eversion())
    ]
    return sorted(div, key=lambda e: e.version, reverse=True)


def derive_info(
    stored_info: dict | None, log: list[PGLogEntry]
) -> PGShardInfo:
    """A shard's current PGShardInfo: les from the stored record,
    last_update/log_len derived from the log it just scanned."""
    info = PGShardInfo.from_dict(stored_info)
    if log:
        info.last_update = max(e.version for e in log)
        info.log_len = len(log)
    return info
