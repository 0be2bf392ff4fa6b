"""The device-launch flight recorder.

Counterpart of ``FlightRecorder`` in ``ceph_tpu/ops/device_trace.py``,
whole; the trace windows of that module (``DeviceTracer``) are not
ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterable


class FlightRecorder:
    """Ring buffer of the last N device launches (the black box the
    reference keeps for ops via OpHistory, applied to LAUNCHES): lane,
    batch key, QoS class, queue-wait vs device wall, and the trace id
    of the slowest member op.  ``lookup(trace_id)`` answers "which
    launch carried this op?" — the SLOW_OPS dump path consults it so a
    slow op's record names its launch instead of leaving the operator
    to correlate timestamps by hand."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._inflight: dict[int, dict] = {}
        self._seq = 0

    def begin(self, *, traces: Iterable[str | None] = (),
              **info: Any) -> int:
        """Open a launch record (visible to lookup/dump while the
        device call is in flight — a wedged launch must be findable
        BEFORE it completes).  Returns the token for :meth:`end`."""
        with self._lock:
            self._seq += 1
            token = self._seq
            self._inflight[token] = {
                "seq": token,
                "t": time.time(),
                "_traces": {t for t in traces if t},
                **info,
            }
            return token

    def end(self, token: int, *, device_wall_s: float | None = None,
            served: str | None = None, error: str | None = None,
            origin: str | None = None,
            remote_served: str | None = None,
            remote_queue_wait_s: float | None = None) -> None:
        """``origin`` names the lane whose FAULT caused a
        fallback-served batch ("remote" = accelerator/network trip,
        "device" = local device trip) — without it an operator reading
        ``dump_launch_history`` cannot tell which fault domain the
        replay answered for.  ``remote_served`` names the engine the
        ACCELERATOR served a remote-lane batch from (device /
        native_direct / fallback — the reply piggybacks it), so the
        client-side record shows whether the shared device, or its host
        fallback, actually produced the bytes."""
        with self._lock:
            rec = self._inflight.pop(token, None)
            if rec is None:
                return
            if device_wall_s is not None:
                rec["device_wall_s"] = round(device_wall_s, 6)
            if served is not None:
                rec["served"] = served
            if error is not None:
                rec["error"] = error
            if origin is not None:
                rec["origin"] = origin
            if remote_served is not None:
                rec["remote_served"] = remote_served
            if remote_queue_wait_s is not None:
                # accel-side coalesce wait (reply piggyback): keeps
                # the queue-wait-vs-device split honest for remote
                # launches
                rec["remote_queue_wait_s"] = round(remote_queue_wait_s, 6)
            self._ring.append(rec)

    @staticmethod
    def _public(rec: dict, in_flight: bool = False) -> dict:
        out = {k: v for k, v in rec.items() if not k.startswith("_")}
        if in_flight:
            out["in_flight"] = True
            out["age_s"] = round(time.time() - rec["t"], 3)
        return out

    def lookup(self, trace: str | None) -> dict | None:
        """The newest launch (in-flight first) that carried this trace
        id, or None."""
        if not trace:
            return None
        with self._lock:
            for rec in self._inflight.values():
                if trace in rec["_traces"]:
                    return self._public(rec, in_flight=True)
            for rec in reversed(self._ring):
                if trace in rec["_traces"]:
                    return self._public(rec)
        return None

    def dump(self) -> dict:
        """``dump_launch_history`` admin-socket body (newest last)."""
        with self._lock:
            return {
                "capacity": self._ring.maxlen,
                "in_flight": [
                    self._public(r, in_flight=True)
                    for r in self._inflight.values()
                ],
                "launches": [self._public(r) for r in self._ring],
            }
