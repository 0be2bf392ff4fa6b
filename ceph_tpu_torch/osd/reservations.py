"""Recovery/backfill admission control.

The reference throttles data movement (never peering) with two
mechanisms this module re-expresses for the asyncio OSD:

- ``AsyncReserver`` (reference:src/common/AsyncReserver.h): a per-OSD
  counting reserver.  Each recovering PG takes one slot; at most
  ``osd_max_backfills`` slots are granted concurrently
  (reference:src/common/config_opts.h:621, default 1) and the rest queue
  FIFO by priority.  Every OSD runs TWO independent reservers — local
  (as primary) and remote (as push target) — exactly because sharing one
  pool between the two roles deadlocks when two primaries reserve
  toward each other (reference:src/osd/OSD.h local_reserver /
  remote_reserver; PG.h WaitLocalRecoveryReserved /
  WaitRemoteRecoveryReserved states).

- ``osd_recovery_max_active`` (config_opts.h:801, default 3): a cap on
  concurrent object recovery operations once a PG holds its
  reservations; enforced in RecoveryManager with a semaphore.

Both capacities are runtime-tunable: ``set_max`` re-evaluates the queue
so raising the limit immediately grants waiters (the reference's
config-observer path on osd_max_backfills).

Priority preemption (reference AsyncReserver.h ``preempt_by_prio`` /
the on_preempt callback on request_reservation): a grant registered
with an ``on_preempt`` callback is revocable — when the pool is full
and a strictly higher-priority request queues, the lowest-priority
revocable grant below it is cancelled (callback fired) and its slot
granted onward.  Grants without a callback keep the old non-revocable
semantics, so existing reservation flows are unchanged.  The OSD
serves the state via the ``dump_reservations`` admin command.

Counterpart of ``ceph_tpu/osd/reservations.py``, whole.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Hashable


class AsyncReserver:
    """Counting reserver with priority-FIFO queueing and optional
    priority preemption (see module docstring).

    ``request`` returns an awaitable that resolves when the slot is
    granted; ``cancel`` releases a granted slot *or* withdraws a queued
    request (the reference's cancel_reservation, which callers invoke on
    both paths).  ``max_granted`` is a high-water mark for tests and
    perf dumps.
    """

    def __init__(self, max_allowed: int):
        self._max = max(0, int(max_allowed))
        self.granted: set[Hashable] = set()
        # granted key -> (priority it was granted at, on_preempt|None)
        self._granted_info: dict[
            Hashable, tuple[int, Callable[[], None] | None]
        ] = {}
        # queue of (priority, seq, key, future, on_preempt);
        # lower seq = older
        self._queue: list[
            tuple[int, int, Hashable, asyncio.Future,
                  Callable[[], None] | None]
        ] = []
        self._seq = 0
        self.max_granted = 0
        self.preemptions = 0  # lifetime victim count (dumps/tests)

    @property
    def max_allowed(self) -> int:
        return self._max

    def set_max(self, n: int) -> None:
        self._max = max(0, int(n))
        self._do_queued()

    def request(self, key: Hashable, prio: int = 0,
                on_preempt: Callable[[], None] | None = None,
                ) -> asyncio.Future:
        """Queue a reservation; the future resolves to True on grant.
        A key already granted or queued resolves/raises consistently:
        duplicate requests return the existing state (idempotent, like
        the reference's assert-free re-request after an interval
        change).  ``on_preempt`` (no-arg callable) marks the eventual
        grant revocable: a full pool preempts the lowest-priority
        revocable grant strictly below a new request's priority."""
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        if key in self.granted:
            fut.set_result(True)
            return fut
        for i, (p, s, k, f, cb) in enumerate(self._queue):
            if k == key:
                if prio != p or on_preempt is not None:
                    # priority UPGRADE on re-request (the reference's
                    # update_priority): re-sort the queue and let the
                    # new priority preempt — a stale low prio must not
                    # pin the request behind work it now outranks
                    self._queue[i] = (
                        prio, s, k, f,
                        on_preempt if on_preempt is not None else cb,
                    )
                    self._do_queued()
                    if not f.done():
                        self._try_preempt(prio)
                return f
        self._queue.append((prio, self._seq, key, fut, on_preempt))
        self._seq += 1
        self._do_queued()
        if not fut.done():
            # still queued against a full pool: try to evict a
            # lower-priority revocable grant (reference preempt path)
            self._try_preempt(prio)
        return fut

    def cancel_where(self, pred) -> None:
        """Cancel every granted AND queued key matching ``pred`` — the
        peer-death path must free queued requests too, or a slot granted
        to a dead primary after its reset leaks forever (its release
        will never arrive and the grant send is a silent no-op on the
        closed connection)."""
        # queue first: releasing a granted slot promotes the next queued
        # request, which could be another key of the same dead peer
        for key in [k for _p, _s, k, _f, _cb in list(self._queue)
                    if pred(k)]:
            self.cancel(key)
        for key in [k for k in list(self.granted) if pred(k)]:
            self.cancel(key)

    def cancel(self, key: Hashable) -> None:
        if key in self.granted:
            self.granted.discard(key)
            self._granted_info.pop(key, None)
            self._do_queued()
            return
        for i, (_p, _s, k, f, _cb) in enumerate(self._queue):
            if k == key:
                del self._queue[i]
                if not f.done():
                    f.cancel()
                return

    def _try_preempt(self, prio: int) -> None:
        """Pool full with a priority-``prio`` request queued: evict the
        lowest-priority REVOCABLE grant strictly below it.  The
        victim's callback runs after its slot has been re-granted, so
        the callback may immediately re-request (it re-queues at its
        own priority, behind its preemptor)."""
        victim: Hashable | None = None
        victim_prio: int | None = None
        for key, (gprio, cb) in self._granted_info.items():
            if cb is None or gprio >= prio:
                continue
            if victim_prio is None or gprio < victim_prio:
                victim, victim_prio = key, gprio
        if victim is None:
            return
        _gprio, cb = self._granted_info.pop(victim)
        self.granted.discard(victim)
        self.preemptions += 1
        self._do_queued()  # the freed slot goes to the queue's best
        try:
            cb()
        except Exception:
            pass  # a broken preempt callback must not wedge the reserver

    def _do_queued(self) -> None:
        # higher priority first, then request order
        self._queue.sort(key=lambda e: (-e[0], e[1]))
        while self._queue and len(self.granted) < self._max:
            prio, _s, key, fut, cb = self._queue.pop(0)
            self.granted.add(key)
            self._granted_info[key] = (prio, cb)
            self.max_granted = max(self.max_granted, len(self.granted))
            if not fut.done():
                fut.set_result(True)

    def dump(self) -> dict:
        """Admin-socket body (the OSD's ``dump_reservations``): granted
        slots with their priorities/revocability plus the waiting
        queue, mirroring the reference's reserver dump."""
        return {
            "max_allowed": self._max,
            "max_granted": self.max_granted,
            "preemptions": self.preemptions,
            "granted": [
                {
                    "key": repr(key),
                    "prio": info[0],
                    "preemptible": info[1] is not None,
                }
                # stable order for tests/operators: by priority desc
                for key, info in sorted(
                    self._granted_info.items(),
                    key=lambda e: (-e[1][0], repr(e[0])),
                )
            ],
            "queued": [
                {"key": repr(k), "prio": p}
                for p, _s, k, _f, _cb in self._queue
            ],
        }
