"""MonitorDBStore: the mon's durable state over KeyValueDB
(reference:src/mon/MonitorDBStore.h — paxos versions and service maps
in one transactional KV store).

The port's own copy of ``ceph_tpu/mon/store.py``: the same keys and
values, so a store written by one package reads in the other.

Keys: ``osdmap/<epoch:010d>`` full map CHECKPOINTS (every
``CHECKPOINT_EVERY`` epochs, plus whenever delta continuity breaks),
``osdmap_inc/<epoch:010d>`` per-epoch deltas (reference:src/osd/
OSDMap.h:111 Incremental — the mon stores inc + periodic full exactly
like the reference's OSDMonitor), ``meta/last_committed``,
``meta/election_epoch``.  Store growth per epoch is O(churn); reads
reconstruct any retained epoch from the nearest checkpoint + deltas.
"""

from __future__ import annotations

import json
import os

from ..store.kv import FileKVDB, KeyValueDB

KEEP_EPOCHS = 500  # reference: mon_min_osdmap_epochs
CHECKPOINT_EVERY = 32  # full-map snapshot cadence between delta runs


class MonitorDBStore:
    def __init__(self, path: str, db: KeyValueDB | None = None):
        legacy = None
        if db is None and os.path.isfile(path):
            # pre-KV single-JSON store: migrate in place (the mon's
            # durable state must survive the format change)
            with open(path) as f:
                legacy = json.load(f)
            os.replace(path, path + ".legacy")
        self.db = db or FileKVDB(path)
        self.db.open()
        if legacy is not None and self.last_committed() == 0:
            self.save(
                legacy["osdmap"], int(legacy.get("election_epoch", 0))
            )

    def close(self) -> None:
        self.db.close()

    # -- write
    def save(self, osdmap_dict: dict, election_epoch: int,
             committed_epoch: int = 0, inc: dict | None = None) -> None:
        """Persist one committed epoch.  With a delta whose base is the
        previously stored epoch, only the delta is written (O(churn));
        a full snapshot is written at checkpoint cadence, on continuity
        breaks, and for foreign-map adoptions (inc=None)."""
        epoch = int(osdmap_dict["epoch"])
        prev = self.last_committed()
        last_full = self._last_full()
        txn = self.db.transaction()
        as_delta = (
            inc is not None
            and int(inc.get("base", -1)) == prev
            and last_full > 0
            and epoch - last_full < CHECKPOINT_EVERY
        )
        if as_delta:
            txn.set("osdmap_inc", f"{epoch:010d}", json.dumps(inc).encode())
        else:
            txn.set(
                "osdmap", f"{epoch:010d}", json.dumps(osdmap_dict).encode()
            )
            txn.set("meta", "last_full", str(epoch).encode())
        txn.set("meta", "last_committed", str(epoch).encode())
        txn.set("meta", "election_epoch", str(election_epoch).encode())
        txn.set("meta", "committed_epoch", str(committed_epoch).encode())
        for k in self.db.keys("osdmap_inc"):
            if int(k) <= epoch - KEEP_EPOCHS:
                txn.rmkey("osdmap_inc", k)
        for k in self.db.keys("osdmap"):
            # checkpoints outlive the delta window by one cadence so the
            # oldest retained delta can still find its base snapshot
            if int(k) <= epoch - KEEP_EPOCHS - CHECKPOINT_EVERY:
                txn.rmkey("osdmap", k)
        self.db.submit(txn)

    def _last_full(self) -> int:
        raw = self.db.get("meta", "last_full")
        if raw:
            return int(raw)
        fulls = self.db.keys("osdmap")
        return max((int(k) for k in fulls), default=0)

    # -- read
    def last_committed(self) -> int:
        raw = self.db.get("meta", "last_committed")
        return int(raw) if raw else 0

    def election_epoch(self) -> int:
        raw = self.db.get("meta", "election_epoch")
        return int(raw) if raw else 0

    def committed_epoch(self) -> int:
        """Election epoch the stored map was committed in (orders
        recovery candidates as (epoch, version))."""
        raw = self.db.get("meta", "committed_epoch")
        return int(raw) if raw else 0

    # -- accepted register (Paxos uncommitted value; the reference
    # persists it so an acked-but-uncommitted proposal survives the
    # acceptor's restart — reference:src/mon/Paxos.cc store_state)
    def set_accepted(self, accepted: dict | None) -> None:
        txn = self.db.transaction()
        if accepted is None:
            txn.rmkey("meta", "accepted")
        else:
            txn.set("meta", "accepted", json.dumps(accepted).encode())
        self.db.submit(txn)

    def accepted(self) -> dict | None:
        raw = self.db.get("meta", "accepted")
        return json.loads(raw) if raw else None

    def get_map(self, epoch: int | None = None) -> dict | None:
        """Reconstruct the map at ``epoch``: nearest checkpoint at or
        below it, plus the stored delta chain up to it."""
        if epoch is None:
            epoch = self.last_committed()
        raw = self.db.get("osdmap", f"{epoch:010d}")
        if raw:
            return json.loads(raw)
        fulls = [int(k) for k in self.db.keys("osdmap") if int(k) <= epoch]
        if not fulls:
            return None
        from ..osd.osdmap import Incremental

        d = json.loads(self.db.get("osdmap", f"{max(fulls):010d}"))
        for e in range(max(fulls) + 1, epoch + 1):
            raw = self.db.get("osdmap_inc", f"{e:010d}")
            if raw is None:
                return None  # chain broken (trimmed): epoch unavailable
            Incremental.from_dict(json.loads(raw)).apply_to_dict(d)
        return d

    def get_incrementals(self, since: int, to: int) -> list[dict] | None:
        """Contiguous stored delta chain (since, to]; None on any gap."""
        out = []
        for e in range(since + 1, to + 1):
            raw = self.db.get("osdmap_inc", f"{e:010d}")
            if raw is None:
                return None
            out.append(json.loads(raw))
        return out

    def versions(self) -> list[int]:
        return sorted(
            {int(k) for k in self.db.keys("osdmap")}
            | {int(k) for k in self.db.keys("osdmap_inc")}
        )
