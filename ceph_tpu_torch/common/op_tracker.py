"""In-flight op tracking (reference:src/common/TrackedOp.{h,cc}).

The reference's OpTracker wraps every client op in a TrackedOp carrying
typed state transitions (queued -> dequeued -> sub_op_sent ->
sub_op_applied -> replied), serves ``dump_ops_in_flight`` /
``dump_historic_ops`` / ``dump_historic_ops_by_duration`` over the
admin socket, and flags ops older than ``osd_op_complaint_time`` so the
health system can raise SLOW_OPS.  Same shape here: a dict-backed
TrackedOp per op, a recency ring plus a duration-sorted ring for
history, and an index by trace id so sub-op replies (which arrive on a
different dispatch context) can mark progress on the op they belong to.

Counterpart of ``ceph_tpu/common/op_tracker.py``, whole.  A daemon that
owns an EC dispatcher sets ``OpTracker.launch_lookup`` to the
dispatcher's ``flight.lookup`` (``ops/device_trace.FlightRecorder``), so
an op's dump names the device launch that carried it.
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Any

# the canonical state sequence (reference OpRequest flag names;
# queued_for_qos brackets the wait in the QoS op scheduler — the
# reference's queued_for_pg span in the op queue)
STATES = ("queued", "queued_for_qos", "dequeued", "sub_op_sent",
          "sub_op_applied", "replied")


class TrackedOp:
    """One op's lifetime record."""

    __slots__ = ("seq", "trace", "desc", "initiated_at", "events",
                 "duration")

    def __init__(self, seq: int, trace: str | None, desc: dict):
        self.seq = seq
        self.trace = trace
        self.desc = dict(desc)          # tid/oid/pool/ops, json-able
        self.initiated_at = time.monotonic()
        self.events: list[tuple[str, float]] = [
            ("queued", self.initiated_at)
        ]
        self.duration: float | None = None  # set on finish

    def mark(self, state: str) -> None:
        self.events.append((state, time.monotonic()))

    @property
    def state(self) -> str:
        return self.events[-1][0]

    def age(self, now: float | None = None) -> float:
        return (now if now is not None else time.monotonic()) \
            - self.initiated_at

    def state_durations(self, now: float | None = None) -> dict[str, float]:
        """Seconds spent in each typed state: consecutive transition
        deltas, with the current state charged up to ``now`` (in-flight)
        or to the recorded duration (historic).  The waterfall's coarse
        shape for UNSAMPLED ops — queued_for_qos -> dequeued is the QoS
        wait, dequeued -> replied the execute wall — readable straight
        off dump_ops_in_flight / dump_historic_ops."""
        if now is None:
            now = time.monotonic()
        end = (self.initiated_at + self.duration
               if self.duration is not None else now)
        durs: dict[str, float] = {}
        for i, (state, ts) in enumerate(self.events):
            nxt = (self.events[i + 1][1] if i + 1 < len(self.events)
                   else end)
            durs[state] = durs.get(state, 0.0) + max(0.0, nxt - ts)
        return durs

    def dominant_state(self, now: float | None = None,
                       durs: "dict[str, float] | None" = None
                       ) -> str | None:
        """The state this op spent longest in — a slow op's coarse
        'dominant hop' (the SLOW_OPS dump names it).  ``durs`` lets a
        caller that already computed :meth:`state_durations` reuse it
        (dump() does) so the dominance rule lives in ONE place."""
        if durs is None:
            durs = self.state_durations(now)
        if not durs:
            return None
        return max(durs.items(), key=lambda kv: kv[1])[0]

    def dump(self, now: float | None = None) -> dict:
        out = dict(self.desc)
        out["trace"] = self.trace
        out["state"] = self.state
        t0 = self.initiated_at
        # per-stage timestamps relative to op start (stable under dump)
        out["events"] = [
            {"event": ev, "at": round(ts - t0, 6)} for ev, ts in self.events
        ]
        durs = self.state_durations(now)
        out["state_durations"] = {
            st: round(d, 6) for st, d in durs.items()
        }
        if durs:
            out["dominant_state"] = self.dominant_state(durs=durs)
        if self.duration is not None:
            out["duration"] = self.duration
        else:
            out["age"] = self.age(now)
        return out


class OpTracker:
    """Per-daemon op registry (OpTracker + OpHistory analog)."""

    def __init__(self, history_size: int = 20):
        self.history_size = max(1, int(history_size))
        self._seq = 0
        self._inflight: dict[int, TrackedOp] = {}
        self._by_trace: dict[str, TrackedOp] = {}
        self._historic: deque[TrackedOp] = deque(maxlen=self.history_size)
        # longest-duration ring (OpHistory's duration-sorted set): kept
        # sorted descending, bounded to history_size
        self._slowest: list[TrackedOp] = []
        # optional trace-id -> device-launch lookup (the EC flight
        # recorder, ops.device_trace.FlightRecorder.lookup): when set,
        # op dumps carry the launch that carried the op — a SLOW_OPS
        # investigation names the lane/batch/QoS class directly instead
        # of leaving the operator to correlate timestamps by hand
        self.launch_lookup = None

    # -- lifecycle
    def create(self, trace: str | None = None, **desc: Any) -> TrackedOp:
        self._seq += 1
        op = TrackedOp(self._seq, trace, desc)
        self._inflight[op.seq] = op
        if trace is not None:
            self._by_trace[trace] = op
        return op

    def mark(self, op: TrackedOp, state: str) -> None:
        op.mark(state)

    def mark_by_trace(self, trace: str | None, state: str) -> None:
        """Progress an op from a different dispatch context (a sub-op
        reply carries the op's trace id, not its tracker seq)."""
        if trace is None:
            return
        op = self._by_trace.get(trace)
        if op is not None:
            op.mark(state)

    def finish(self, op: TrackedOp, completed: bool = True) -> None:
        """Retire an op; only COMPLETED ops (a reply actually left) go
        to history — cancelled ops must not masquerade as served."""
        self._inflight.pop(op.seq, None)
        if op.trace is not None and self._by_trace.get(op.trace) is op:
            del self._by_trace[op.trace]
        if not completed:
            return
        op.duration = time.monotonic() - op.initiated_at
        self._historic.append(op)
        # duration-sorted ring maintenance on the hot path: one ordered
        # insert (the list stays sorted descending), not a re-sort, and
        # an op slower than nothing in a full ring costs O(1)
        if (len(self._slowest) >= self.history_size
                and op.duration <= (self._slowest[-1].duration or 0.0)):
            return
        bisect.insort(self._slowest, op,
                      key=lambda o: -(o.duration or 0.0))
        del self._slowest[self.history_size:]

    # -- views
    def oldest_start(self) -> float | None:
        if not self._inflight:
            return None
        return min(o.initiated_at for o in self._inflight.values())

    def slow_ops(self, complaint_time: float,
                 now: float | None = None) -> list[TrackedOp]:
        """In-flight ops older than the complaint threshold (the
        reference's check_ops_in_flight / SLOW_OPS input)."""
        if complaint_time <= 0:
            return []
        now = now if now is not None else time.monotonic()
        return [
            o for o in self._inflight.values()
            if now - o.initiated_at > complaint_time
        ]

    # -- admin-socket command bodies
    def _dump_op(self, op: TrackedOp, now: float | None = None) -> dict:
        out = op.dump(now)
        lookup = self.launch_lookup
        if lookup is not None and op.trace is not None:
            try:
                launch = lookup(op.trace)
            except Exception:  # pragma: no cover - observability only
                launch = None
            if launch is not None:
                out["launch"] = launch
        return out

    def dump_ops_in_flight(self) -> dict:
        now = time.monotonic()
        ops = [self._dump_op(o, now) for o in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        return {"num_ops": len(self._historic),
                "ops": [self._dump_op(o) for o in self._historic]}

    def dump_historic_ops_by_duration(self) -> dict:
        return {"num_ops": len(self._slowest),
                "ops": [self._dump_op(o) for o in self._slowest]}

    def register_admin(self, asok) -> None:
        """The three reference dump commands, on any daemon's socket."""
        asok.register(
            "dump_ops_in_flight", lambda req: self.dump_ops_in_flight(),
            "client ops currently executing",
        )
        asok.register(
            "dump_historic_ops", lambda req: self.dump_historic_ops(),
            "recently completed client ops (newest last)",
        )
        asok.register(
            "dump_historic_ops_by_duration",
            lambda req: self.dump_historic_ops_by_duration(),
            "recently completed client ops, slowest first",
        )
