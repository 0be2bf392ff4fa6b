"""AccelMap: the mon-published accelerator fleet map.

The port's own copy of ``ceph_tpu/accel/accelmap.py``.  The map rides
inside the OSDMap's wire dict, so both packages read and write the same
form.  This package holds the map only, not the accelerator daemons
that register in it.

RADOS tracks OSDs through the mon-owned, epoch-versioned OSDMap; the
shared EC accelerators get the same treatment.  The :class:`AccelMap`
is an epoch-versioned registry of accelerator daemons — id, address,
locality label, stripe capacity, up/down — owned by the Monitor
**alongside the OSDMap**: it rides inside the OSDMap's wire dict
(``to_dict()["accelmap"]``), so Paxos replication, store persistence,
incremental diffs, and subscriber pushes all come from the one
map-distribution machinery.  Accel daemons register on boot (re-sent as
a registration beacon); the mon marks an accelerator down on beacon
loss or connection reset and bumps the epoch, and every subscribed OSD
sees the change on the next map push.

This module is deliberately dependency-free (dataclasses only).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class AccelEntry:
    """One registered accelerator daemon."""

    aid: int
    name: str
    addr: str
    locality: str = ""
    capacity: int = 0
    up: bool = True


@dataclass
class AccelMap:
    """Epoch-versioned fleet membership (see module doc).

    ``epoch`` starts at 0 (no fleet has ever registered) and bumps on
    every MUTATION — registration, address/locality/capacity change,
    up/down transitions.  Re-registration beacons that change nothing
    do not bump it (no map churn from steady-state beacons).
    """

    epoch: int = 0
    accels: dict[int, AccelEntry] = field(default_factory=dict)
    _next_id: int = 1

    # -- mutation (mon side; every True return means "publish") --------------

    def note_boot(self, name: str, addr: str, locality: str = "",
                  capacity: int = 0) -> bool:
        """Register (or refresh) the accelerator named ``name``.  Ids
        are stable per name across re-registrations — a restarted
        accelerator keeps its id, so per-accel counter series and
        sticky router state stay attributable.  Returns True when the
        map actually changed (the caller bumps/publishes)."""
        e = self.by_name(name)
        if e is None:
            e = AccelEntry(aid=self._next_id, name=name, addr=addr,
                           locality=locality, capacity=int(capacity))
            self._next_id += 1
            self.accels[e.aid] = e
            self.epoch += 1
            return True
        changed = (not e.up or e.addr != addr or e.locality != locality
                   or e.capacity != int(capacity))
        e.up = True
        e.addr = addr
        e.locality = locality
        e.capacity = int(capacity)
        if changed:
            self.epoch += 1
        return changed

    def mark_down(self, name: str) -> bool:
        e = self.by_name(name)
        if e is None or not e.up:
            return False
        e.up = False
        self.epoch += 1
        return True

    def remove(self, name: str) -> bool:
        e = self.by_name(name)
        if e is None:
            return False
        del self.accels[e.aid]
        self.epoch += 1
        return True

    # -- lookups -------------------------------------------------------------

    def by_name(self, name: str) -> AccelEntry | None:
        for e in self.accels.values():
            if e.name == name:
                return e
        return None

    def up_entries(self) -> list[AccelEntry]:
        return [e for e in self.accels.values() if e.up]

    def __len__(self) -> int:
        return len(self.accels)

    # -- wire form (rides OSDMap.to_dict / from_dict) ------------------------

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "next_id": self._next_id,
            "accels": {str(a): asdict(e) for a, e in self.accels.items()},
        }

    @classmethod
    def from_dict(cls, d: dict | None) -> "AccelMap":
        m = cls()
        if not d:
            return m
        m.epoch = int(d.get("epoch", 0))
        m._next_id = int(d.get("next_id", 1))
        for aid, ed in (d.get("accels") or {}).items():
            e = AccelEntry(**{k: ed[k] for k in (
                "aid", "name", "addr", "locality", "capacity", "up",
            ) if k in ed})
            m.accels[int(aid)] = e
        return m
