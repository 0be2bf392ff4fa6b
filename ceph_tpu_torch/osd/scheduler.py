"""QoS op scheduler: dmClock-style class-based scheduling.

Counterpart of ``ceph_tpu/osd/scheduler.py``, whole: ``OpScheduler``
with its mclock / wpq / fifo policies, ``QosSpec`` and ``CLASSES``.

The reference OSD never feeds ops straight from the wire into
execution: everything flows through a pluggable priority queue
(reference:src/common/mClockPriorityQueue.h, WeightedPriorityQueue.h,
src/dmclock/, selected by ``osd_op_queue``) so client I/O, recovery,
scrub and snap-trim each get a reservation/weight/limit share of the
device — the dmClock model of Gulati et al., "mClock: Handling
Throughput Variability for Hypervisor IO Scheduling" (OSDI 2010).

Same shape here, for the asyncio OSD.  Five traffic classes::

    client         foreground client ops (MOSDOp intake)
    recovery       object pushes (RecoveryManager)
    scrub          scheduled deep scrubs (ScrubManager loop)
    snaptrim       clone trimming (the SnapTrimmer passes)
    ec_background  background EC device math (recovery/scrub stripes
                   entering the microbatch dispatcher)

Each class carries a :class:`QosSpec` — ``reservation`` (units/s
guaranteed under contention), ``weight`` (proportional share above the
reservation), ``limit`` (units/s hard cap, 0 = unlimited) — and the
scheduler hands out **grants** from a bounded slot pool (``slots``, the
capacity model: a grant is "the device/CPU is working on this").  When
every slot is busy, waiters queue per class and the configured policy
picks who runs next:

- ``mclock`` (default): two-phase dmClock tag scheduling.  Classes
  behind on their reservation (R tag <= now) are served first, by R
  tag; otherwise limit-eligible classes are served by proportional tag
  (P += cost/weight per grant).  Classes at their limit wait for real
  time to catch up (a timer re-runs the dispatch loop).
- ``wpq``: weight-only fair queueing (the reference's
  WeightedPriorityQueue fallback) — no reservations, no limits.
- ``fifo``: arrival order across all classes (scheduling disabled; the
  pre-QoS behavior, kept so the starvation gate can prove the
  subsystem earns its keep).

Two more mechanisms ride along:

- **pacing** (:meth:`OpScheduler.pace`): a tag-only wait with no slot
  held, used at the EC microbatch dispatcher boundary where the caller
  may already hold a grant (a recovery push encoding its shards) —
  nesting slot acquisitions there could deadlock the pool.  Pacing
  throttles background stripes to the class limit, and squeezes them
  down to the class *reservation* rate while client ops are queued
  (client stripes preempt recovery stripes exactly when the device is
  the bottleneck).  Bounded wait, never sheds.
- **overload shedding**: once the scheduler's TOTAL backlog reaches
  ``osd_op_queue_cut_off`` queued entries, best-effort classes
  (scrub/snaptrim/ec_background) get :class:`QosDeferred` instead of
  queueing — background managers defer the pass and retry later, so
  background work never piles onto a pool that is already drowning in
  client traffic (the signal is total pressure, not the class's own
  queue depth: background managers admit serially and would never
  build one).

Observability: per-class ``qos.*`` counters (admitted/deferred/
preempted/paced), per-class grant-wait histograms, a share-attainment
gauge (attained rate over reservation, refreshed off the OSD tick),
and ``dump_op_pq_state`` on the admin socket serving :meth:`dump`.
All knobs are live via config observers (``osd_op_queue`` switches
policy on a running OSD without dropping queued waiters).
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from collections import deque
from dataclasses import dataclass

# the canonical class set (order matters only for dumps)
CLASSES = ("client", "recovery", "scrub", "snaptrim", "ec_background")

# classes that shed past the cut-off instead of queueing unbounded
# (client and recovery keep their queue: clients must never be dropped,
# recovery is already bounded by osd_max_backfills reservations)
BEST_EFFORT = frozenset(("scrub", "snaptrim", "ec_background"))

POLICIES = ("mclock", "wpq", "fifo")

# pace() debt horizon: the pacing tag may run at most this far ahead of
# now.  Without the cap, one huge paced cost at a squeezed rate (a
# 1000-stripe rebuild at the 16/s reservation) would bank minutes of
# debt that the NEXT background caller sleeps out — while holding a
# recovery/scrub grant slot — long after the contention that justified
# the squeeze has passed.  Bounded debt = bounded slot-hold time; the
# trade is that oversized bursts pay at most this much, which matches
# pace()'s contract (bounded backpressure, not exact accounting).
PACE_DEBT_CAP_S = 2.0


class QosDeferred(Exception):
    """Admission refused under overload: the caller must defer the work
    and retry later (the reference's cut-off behavior — best-effort ops
    past osd_op_queue_cut_off don't get to build unbounded queues)."""


@dataclass
class QosSpec:
    """One class's dmClock parameters (reservation/weight/limit)."""

    reservation: float = 0.0  # units/s guaranteed (0 = none)
    weight: float = 1.0       # proportional share above the reservation
    limit: float = 0.0        # units/s hard cap (0 = unlimited)

    def to_dict(self) -> dict:
        return {"reservation": self.reservation, "weight": self.weight,
                "limit": self.limit}


class _Waiter:
    __slots__ = ("fut", "cost", "seq", "t_enq")

    def __init__(self, fut: asyncio.Future, cost: float, seq: int):
        self.fut = fut
        self.cost = cost
        self.seq = seq
        self.t_enq = time.monotonic()


class _ClassState:
    __slots__ = ("spec", "queue", "r_tag", "p_tag", "l_tag", "pace_tag",
                 "admitted", "deferred", "preempted", "paced",
                 "pace_calls", "win_served", "wait_sum", "wait_max",
                 "batch_members")

    def __init__(self, spec: QosSpec):
        self.spec = spec
        self.queue: deque[_Waiter] = deque()
        # dmClock per-class tags (virtual deadlines in monotonic time);
        # max(tag, now) clamping on every bump means idle classes never
        # hoard credit
        self.r_tag = 0.0
        self.p_tag = 0.0
        self.l_tag = 0.0
        self.pace_tag = 0.0  # the no-slot pacing lane (see pace())
        self.admitted = 0
        self.deferred = 0
        self.preempted = 0
        self.paced = 0       # pace() calls that actually slept
        self.pace_calls = 0  # every pace() admission of this class —
        # the end-to-end proof a background class (e.g. recovery math
        # shipped to the accelerator) reached THIS scheduler,
        # independent of whether its rate forced a delay
        self.win_served = 0.0  # cost granted in the current share window
        self.wait_sum = 0.0
        self.wait_max = 0.0
        self.batch_members = 0  # admissions that arrived inside a
        # multi-op request frame (msg.from_batch) — the OSD-side proof
        # the client aggregator's bursts survive to QoS intake in
        # member order, not just onto the wire


class OpScheduler:
    """Class-based QoS admission for one OSD (see module docstring).

    ``perf`` is the owning daemon's ``qos`` PerfCounters (None for a
    standalone scheduler — tests and bench.py drive it bare; dump()
    carries its own totals either way).
    """

    def __init__(self, specs: dict[str, QosSpec] | None = None, *,
                 policy: str = "mclock", slots: int = 32,
                 cut_off: int = 256, perf=None):
        if policy not in POLICIES:
            raise ValueError(
                f"osd_op_queue must be one of {POLICIES}, got {policy!r}"
            )
        self.policy = policy
        self.slots = max(1, int(slots))
        self.cut_off = max(1, int(cut_off))
        self._perf = perf
        self._state: dict[str, _ClassState] = {
            k: _ClassState((specs or {}).get(k) or QosSpec())
            for k in CLASSES
        }
        self._inflight = 0
        self._seq = 0
        self._timer: asyncio.TimerHandle | None = None
        self._stopping = False
        self._win_t0 = time.monotonic()
        # capacity-degraded signal (osd/ec_failover): while the EC
        # device engine is TRIPPED the host fallback serves the data
        # path at a fraction of device rate — background pacing
        # squeezes to reservation rate even with no client queued,
        # exactly as it does under client contention (capacity shrank;
        # the same squeeze pace() already knows)
        self.capacity_degraded = False

    # -- configuration (all live via config observers) -----------------------

    def set_policy(self, policy: str) -> None:
        if policy not in POLICIES:
            raise ValueError(
                f"osd_op_queue must be one of {POLICIES}, got {policy!r}"
            )
        self.policy = policy
        self._dispatch()  # queued waiters re-order under the new policy

    def set_slots(self, n: int) -> None:
        self.slots = max(1, int(n))
        self._dispatch()  # raising the pool must grant waiters now

    def set_spec(self, klass: str, *, reservation: float | None = None,
                 weight: float | None = None,
                 limit: float | None = None) -> None:
        spec = self._state[klass].spec
        if reservation is not None:
            spec.reservation = max(0.0, float(reservation))
        if weight is not None:
            spec.weight = max(0.0, float(weight))
        if limit is not None:
            spec.limit = max(0.0, float(limit))
        self._dispatch()

    def stop(self) -> None:
        """Daemon shutdown: later admits pass straight through (their
        tasks are being cancelled anyway) and the wakeup timer dies."""
        self._stopping = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        # wake everything still queued — the owning tasks are being
        # cancelled, but a waiter nobody cancels must not wedge
        for st in self._state.values():
            while st.queue:
                w = st.queue.popleft()
                if not w.fut.done():
                    w.fut.set_result(None)

    # -- admission -----------------------------------------------------------

    def note_batch_member(self, klass: str) -> None:
        """Tally an admission whose message rode a multi-op request
        frame (decode set ``from_batch``); called by the op intake
        next to ``admit`` so ``dump_op_pq_state`` can show how much of
        the admitted load arrived pre-batched."""
        self._state[klass].batch_members += 1

    async def admit(self, klass: str, cost: float = 1.0) -> float:
        """Wait for a grant; returns the queue wait in seconds.  The
        caller MUST pair this with :meth:`complete` (or use
        :meth:`grant`).  Best-effort classes past the cut-off raise
        :class:`QosDeferred` instead of queueing."""
        st = self._state[klass]
        cost = max(1e-9, float(cost))
        if self._stopping:
            self._inflight += 1
            return 0.0
        # overload shedding on TOTAL scheduler backlog, not this class's
        # own queue: background managers admit serially (one grant per
        # PG/object at a time), so their per-class depth never grows —
        # the pressure that should shed them is the hundreds of CLIENT
        # ops queued ahead of the pool when the device is drowning
        queued_total = self.queued()
        if klass in BEST_EFFORT and queued_total >= self.cut_off:
            st.deferred += 1
            self._count(f"deferred_{klass}")
            raise QosDeferred(
                f"{klass}: {queued_total} ops queued >= "
                f"osd_op_queue_cut_off {self.cut_off}"
            )
        if not self._anyone_queued() and self._inflight < self.slots \
                and not self._limit_blocked(st):
            self._note_grant(st, klass, cost, wait=0.0)
            return 0.0
        loop = asyncio.get_running_loop()
        self._seq += 1
        w = _Waiter(loop.create_future(), cost, self._seq)
        st.queue.append(w)
        self._dispatch()
        try:
            await w.fut
        except asyncio.CancelledError:
            if w.fut.done() and not w.fut.cancelled():
                # granted AND cancelled: the slot is ours — release it
                self.complete(klass, cost)
            else:
                try:
                    st.queue.remove(w)
                except ValueError:
                    pass
            raise
        return time.monotonic() - w.t_enq

    def complete(self, klass: str, cost: float = 1.0) -> None:
        """Release a grant (one unit of work finished)."""
        self._inflight = max(0, self._inflight - 1)
        self._dispatch()

    @contextlib.asynccontextmanager
    async def grant(self, klass: str, cost: float = 1.0):
        """``async with scheduler.grant("recovery"):`` — admit/complete
        pairing that cannot leak a slot."""
        await self.admit(klass, cost)
        try:
            yield
        finally:
            self.complete(klass, cost)

    async def pace(self, klass: str, cost: float = 1.0) -> float:
        """Tag-only pacing (no slot held): wait until this class's rate
        allows ``cost`` more units, then return the delay slept.

        Used where the caller may already hold a grant (the EC
        dispatcher admitting background stripes) — acquiring a second
        slot there could deadlock the pool, so the device-boundary
        admission is time-based only.  The pace rate is the class
        limit; while client ops are QUEUED (the device is the
        bottleneck) it drops to the class reservation, so client
        stripes preempt background stripes exactly under contention.
        Never sheds — bounded backpressure, not failure."""
        if self._stopping or self.policy == "fifo":
            return 0.0
        st = self._state[klass]
        st.pace_calls += 1
        spec = st.spec
        rate = spec.limit
        if (
            (self._state["client"].queue or self.capacity_degraded)
            and spec.reservation > 0
        ):
            rate = (spec.reservation if rate <= 0
                    else min(rate, spec.reservation))
        if rate <= 0:
            return 0.0
        now = time.monotonic()
        start = max(st.pace_tag, now)
        st.pace_tag = min(
            start + max(1e-9, float(cost)) / rate,
            now + PACE_DEBT_CAP_S,
        )
        delay = start - now
        if delay > 0:
            st.paced += 1
            self._count(f"paced_{klass}")
            self._hist(klass, delay)
            await asyncio.sleep(delay)
        return max(0.0, delay)

    # -- views ---------------------------------------------------------------

    def queued(self, klass: str | None = None) -> int:
        if klass is not None:
            return len(self._state[klass].queue)
        return sum(len(st.queue) for st in self._state.values())

    @property
    def inflight(self) -> int:
        return self._inflight

    def share_attainment(self, klass: str) -> float | None:
        """Attained grant rate over the reservation, measured over the
        current share window; None when the class reserves nothing."""
        st = self._state[klass]
        if st.spec.reservation <= 0:
            return None
        dt = max(1e-9, time.monotonic() - self._win_t0)
        return (st.win_served / dt) / st.spec.reservation

    def refresh_gauges(self, window: float = 10.0) -> None:
        """Recompute the per-class share-attainment gauges (called off
        the OSD tick, like the slow-op gauges); the window resets once
        it exceeds ``window`` seconds so the gauge tracks the recent
        past, not daemon-lifetime averages."""
        now = time.monotonic()
        dt = now - self._win_t0
        if self._perf is not None:
            for klass in self._state:
                share = self.share_attainment(klass)
                self._perf.set(
                    f"share_{klass}",
                    -1.0 if share is None else round(share, 4),
                )
        if dt > window:
            self._win_t0 = now
            for st in self._state.values():
                st.win_served = 0.0

    def dump(self) -> dict:
        """Admin-socket body (``dump_op_pq_state``) — the analog of the
        reference's dump_op_pq_state: policy, pool occupancy, and every
        class's spec, queue and tag state."""
        now = time.monotonic()
        classes = {}
        for klass, st in self._state.items():
            head_wait = (
                round(now - st.queue[0].t_enq, 6) if st.queue else 0.0
            )
            classes[klass] = {
                "spec": st.spec.to_dict(),
                "queued": len(st.queue),
                "oldest_wait_s": head_wait,
                # tags relative to now (negative = credit available);
                # None when the axis is unconfigured for the class —
                # its raw tag never advances and "tag - now" would
                # print a meaningless -uptime
                "tags": {
                    "r": (round(st.r_tag - now, 6)
                          if st.spec.reservation > 0 else None),
                    "p": round(st.p_tag - now, 6),
                    "l": (round(st.l_tag - now, 6)
                          if st.spec.limit > 0 else None),
                },
                "admitted": st.admitted,
                # of those, how many arrived inside a multi-op request
                # frame (client aggregator + writer-loop op batching)
                "batch_members": st.batch_members,
                "deferred": st.deferred,
                "preempted": st.preempted,
                "paced": st.paced,
                "pace_calls": st.pace_calls,
                "wait_avg_s": round(
                    st.wait_sum / st.admitted, 6
                ) if st.admitted else 0.0,
                "wait_max_s": round(st.wait_max, 6),
                "share_attainment": self.share_attainment(klass),
            }
        return {
            "policy": self.policy,
            "slots": self.slots,
            "inflight": self._inflight,
            "cut_off": self.cut_off,
            "queued_total": self.queued(),
            "capacity_degraded": self.capacity_degraded,
            "classes": classes,
        }

    # -- internals -----------------------------------------------------------

    def _anyone_queued(self) -> bool:
        return any(st.queue for st in self._state.values())

    def _limit_blocked(self, st: _ClassState) -> bool:
        return (self.policy == "mclock" and st.spec.limit > 0
                and st.l_tag > time.monotonic())

    def _count(self, key: str, by: int = 1) -> None:
        if self._perf is not None:
            self._perf.inc(key, by)

    def _hist(self, klass: str, wait: float) -> None:
        if self._perf is not None:
            self._perf.hist(f"wait_{klass}_histogram", max(wait, 1e-9))
            self._perf.observe("grant_latency", wait)

    def _note_grant(self, st: _ClassState, klass: str, cost: float,
                    wait: float) -> None:
        """Common accounting + tag bumping for every grant path."""
        now = time.monotonic()
        spec = st.spec
        # class-level dmClock: serving a request advances all three
        # tags (per-request tag lists collapse to per-class scalars)
        if spec.reservation > 0:
            st.r_tag = max(st.r_tag, now) + cost / spec.reservation
        st.p_tag = max(st.p_tag, now) + cost / max(spec.weight, 1e-9)
        if spec.limit > 0:
            st.l_tag = max(st.l_tag, now) + cost / spec.limit
        st.admitted += 1
        st.win_served += cost
        st.wait_sum += wait
        st.wait_max = max(st.wait_max, wait)
        self._inflight += 1
        self._count(f"admitted_{klass}")
        self._hist(klass, wait)

    def _pick(self) -> tuple[str, str] | None:
        """(class, phase) to grant next, or None (idle / all capped)."""
        backlogged = [
            (k, st) for k, st in self._state.items() if st.queue
        ]
        if not backlogged:
            return None
        if self.policy == "fifo":
            k, _st = min(backlogged, key=lambda e: e[1].queue[0].seq)
            return k, "fifo"
        if self.policy == "wpq":
            k, _st = min(backlogged, key=lambda e: e[1].p_tag)
            return k, "prop"
        now = time.monotonic()
        # mclock phase 1: reservation — classes behind their guaranteed
        # rate run first, earliest deadline wins
        resv = [
            (k, st) for k, st in backlogged
            if st.spec.reservation > 0 and st.r_tag <= now
        ]
        if resv:
            k, _st = min(resv, key=lambda e: e[1].r_tag)
            return k, "resv"
        # phase 2: proportional among limit-eligible classes
        prop = [
            (k, st) for k, st in backlogged
            if st.spec.limit <= 0 or st.l_tag <= now
        ]
        if prop:
            k, _st = min(prop, key=lambda e: e[1].p_tag)
            return k, "prop"
        return None  # everyone limit-capped: the timer re-runs us

    def _dispatch(self) -> None:
        """Grant queued waiters while slots and tags allow."""
        if self._stopping:
            return
        while self._inflight < self.slots:
            pick = self._pick()
            if pick is None:
                break
            klass, _phase = pick
            st = self._state[klass]
            w = st.queue.popleft()
            if w.fut.done():
                continue  # cancelled while queued
            # preemption visibility: an older waiter of another class
            # just got bypassed by this grant (reservation/weight order
            # beat arrival order) — that's the scheduler doing its job,
            # counted so share fights are diagnosable
            if self.policy != "fifo":
                for other, ost in self._state.items():
                    if other != klass and ost.queue \
                            and ost.queue[0].seq < w.seq:
                        ost.preempted += 1
                        self._count(f"preempted_{other}")
            self._note_grant(st, klass, w.cost,
                             wait=time.monotonic() - w.t_enq)
            w.fut.set_result(None)
        self._arm_timer()

    def _arm_timer(self) -> None:
        """When work is queued but every backlogged class is capped by
        its limit (or reservation deadline), wake the dispatch loop at
        the earliest tag instead of waiting for the next complete()."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._stopping or self.policy != "mclock":
            return
        if not self._anyone_queued() or self._inflight >= self.slots:
            return
        now = time.monotonic()
        wake: float | None = None
        for _k, st in self._state.items():
            if not st.queue:
                continue
            cands = []
            if st.spec.reservation > 0:
                cands.append(st.r_tag)
            if st.spec.limit > 0:
                cands.append(st.l_tag)
            for t in cands:
                if t > now and (wake is None or t < wake):
                    wake = t
        if wake is None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync test poking at state): next admit arms
        self._timer = loop.call_later(
            max(0.0, wake - now), self._on_timer
        )

    def _on_timer(self) -> None:
        self._timer = None
        self._dispatch()
