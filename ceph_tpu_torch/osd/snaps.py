"""Object snapshots: SnapContext, SnapSet, clone naming, resolution.

The reference's snapshot machinery (reference:src/osd/PrimaryLogPG.cc
make_writeable, find_object_context; types in reference:src/osd/
osd_types.h SnapSet/SnapContext, reference:src/include/rados.h):

- writes carry a **SnapContext** {seq, snaps[]} — the newest snap id and
  the set of existing snaps, newest first;
- the OSD **clones on first write after a snap**: if the object's
  SnapSet.seq is older than the write's snapc.seq, the pre-write object
  is cloned and the clone records which snap ids it serves;
- reads at a snap id resolve through the SnapSet to the covering clone
  (or the head when the object hasn't been written since the snap);
- removed snaps propagate via the pool's ``removed_snaps`` and a
  trimmer deletes clones whose snap set became empty.

The SnapSet is stored as a JSON xattr on the head object (every EC
shard carries it, like object_info_t).  Clones are ordinary objects
named ``<oid>\\x00snap\\x00<cloneid>`` — the same internal-name trick the
pg-log rollback stashes use, so recovery/scrub/pgls machinery treats
them uniformly.

Counterpart of ``ceph_tpu/osd/snaps.py``, whole: the same names and
SnapSet JSON.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

SS_KEY = "_ss"  # SnapSet xattr (reference: SS_ATTR "snapset")
CLONE_SEP = "\x00snap\x00"


def clone_name(oid: str, cloneid: int) -> str:
    return f"{oid}{CLONE_SEP}{cloneid}"


def is_clone_name(name: str) -> bool:
    return CLONE_SEP in name


def clone_parent(name: str) -> str:
    """Head object name for a clone (identity for non-clones)."""
    return name.split(CLONE_SEP, 1)[0]


def snapdir_name(oid: str) -> str:
    """Where the SnapSet lives while the head is deleted but clones
    remain (the reference's snapdir object,
    reference:src/osd/PrimaryLogPG.cc get_snapdir)."""
    return f"{oid}{CLONE_SEP}dir"


@dataclass
class SnapContext:
    """The write-side snap state (reference:osd_types.h SnapContext):
    ``seq`` = most recent snap id, ``snaps`` = existing snap ids, newest
    first."""

    seq: int = 0
    snaps: list[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "snaps": list(self.snaps)}

    @classmethod
    def from_dict(cls, d: dict | None) -> "SnapContext | None":
        if not d:
            return None
        return cls(int(d.get("seq", 0)), [int(s) for s in d.get("snaps", [])])

    def valid(self) -> bool:
        """seq must be >= every snap id (reference SnapContext::is_valid)."""
        return all(s <= self.seq for s in self.snaps)


@dataclass
class Clone:
    cloneid: int          # snapc.seq at clone time
    snaps: list[int]      # snap ids this clone serves (ascending)
    size: int


@dataclass
class SnapSet:
    """Per-object snapshot history (reference:osd_types.h SnapSet),
    persisted as the head's ``SS_KEY`` xattr."""

    seq: int = 0
    clones: list[Clone] = field(default_factory=list)  # ascending cloneid

    def to_json(self) -> bytes:
        return json.dumps({
            "seq": self.seq,
            "clones": [
                {"cloneid": c.cloneid, "snaps": c.snaps, "size": c.size}
                for c in self.clones
            ],
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes | None) -> "SnapSet":
        if not raw:
            return cls()
        d = json.loads(raw)
        return cls(
            seq=int(d.get("seq", 0)),
            clones=[
                Clone(int(c["cloneid"]), [int(s) for s in c["snaps"]],
                      int(c["size"]))
                for c in d.get("clones", [])
            ],
        )

    # -- write side ----------------------------------------------------------
    def needs_clone(self, snapc: SnapContext) -> bool:
        """A write under ``snapc`` must preserve the pre-write object iff
        a snap was taken since the object last changed
        (reference:PrimaryLogPG.cc make_writeable 'snapc.seq > ...seq')."""
        return snapc.seq > self.seq

    def make_clone(self, snapc: SnapContext, size: int) -> Clone:
        """Record the clone a write under ``snapc`` creates: it serves
        every existing snap newer than the previous seq."""
        serves = sorted(s for s in snapc.snaps if s > self.seq)
        c = Clone(cloneid=snapc.seq, snaps=serves, size=size)
        self.clones.append(c)
        self.clones.sort(key=lambda cl: cl.cloneid)
        self.seq = snapc.seq
        return c

    def advance(self, snapc: SnapContext) -> None:
        """Write with no pre-existing object: nothing to clone, but the
        seq still advances so later snaps compare correctly."""
        self.seq = max(self.seq, snapc.seq)

    # -- read side -----------------------------------------------------------
    HEAD = -1      # resolution: read the head object
    MISSING = -2   # resolution: object did not exist at that snap

    def resolve(self, snapid: int) -> int:
        """Which object serves a read at ``snapid``: a cloneid, HEAD, or
        MISSING (reference:PrimaryLogPG.cc find_object_context snapdir
        walk): the first clone at-or-after snapid serves it iff its
        recorded snaps reach down to snapid; past the last clone the
        head serves it only if the object hasn't been written since the
        snap (snapid > seq) — otherwise the snap's state is gone
        (removed + trimmed, or never existed)."""
        for c in self.clones:
            if c.cloneid >= snapid:
                if c.snaps and min(c.snaps) <= snapid:
                    return c.cloneid
                return self.MISSING
        return self.HEAD if snapid > self.seq else self.MISSING

    def clone(self, cloneid: int) -> Clone | None:
        for c in self.clones:
            if c.cloneid == cloneid:
                return c
        return None

    # -- trim side -----------------------------------------------------------
    def trim(self, removed: set[int]) -> list[int]:
        """Drop removed snap ids; return cloneids whose snap set became
        empty (their objects must be deleted — SnapTrimmer's job,
        reference:src/osd/PrimaryLogPG.cc TrimmingObjects)."""
        dead: list[int] = []
        kept: list[Clone] = []
        for c in self.clones:
            c.snaps = [s for s in c.snaps if s not in removed]
            if c.snaps:
                kept.append(c)
            else:
                dead.append(c.cloneid)
        self.clones = kept
        return dead

    def empty(self) -> bool:
        return not self.clones and self.seq == 0


def plan_clone(
    ss: SnapSet, snapc: SnapContext | None, head_exists: bool,
    size: int, oid: str,
) -> str | None:
    """THE make_writeable decision, shared by every mutation path (EC
    data/xattr/delete and the replicated op engine): mutates ``ss`` and
    returns the clone object name when the pre-write head must be
    preserved, else None (reference:PrimaryLogPG.cc make_writeable)."""
    if snapc is None or not snapc.valid():
        return None
    if head_exists and ss.needs_clone(snapc):
        cl = ss.make_clone(snapc, size)
        return clone_name(oid, cl.cloneid)
    ss.advance(snapc)
    return None
