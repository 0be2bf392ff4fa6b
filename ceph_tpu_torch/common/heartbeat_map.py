"""Worker-liveness watchdog (reference:src/common/HeartbeatMap.{h,cc}).

Counterpart of ``ceph_tpu/common/heartbeat_map.py``, whole.

The reference gives every ThreadPool worker a ``heartbeat_handle_d``
with a (timeout, suicide_timeout) pair; workers call ``reset_timeout``
at the top of each work item, ``is_healthy()`` is polled by the daemon's
heartbeat, a missed timeout marks the daemon unhealthy (so it stops
answering heartbeats and gets failed by peers), and a missed
*suicide* timeout aborts the process (``ceph_abort`` in ``_check``) —
a wedged thread must kill the daemon rather than wedge the cluster.

Here workers are asyncio tasks/loops.  Same contract: long-running
loops register a handle, touch it every iteration, and the daemon's
heartbeat loop polls ``is_healthy()``; a blown suicide timeout invokes
the ``on_suicide`` callback (by default raising SystemExit in the
daemon, the asyncio analog of abort).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

logger = logging.getLogger("ceph_tpu_torch.heartbeat")


class HeartbeatHandle:
    """One worker's deadline pair (``heartbeat_handle_d`` analog)."""

    def __init__(self, name: str, grace: float, suicide_grace: float):
        self.name = name
        self.grace = grace
        self.suicide_grace = suicide_grace
        self.timeout = 0.0          # absolute deadline; 0 = idle
        self.suicide_timeout = 0.0

    def reset_timeout(self) -> None:
        """Start/refresh the deadlines — call at the top of each work
        item (reference:HeartbeatMap.cc reset_timeout).  Grace <= 0
        means no deadline (the reference's grace-0 semantics)."""
        now = time.monotonic()
        self.timeout = now + self.grace if self.grace > 0 else 0.0
        self.suicide_timeout = (
            now + self.suicide_grace if self.suicide_grace > 0 else 0.0
        )

    def clear_timeout(self) -> None:
        """Mark idle — call when the work item completes."""
        self.timeout = 0.0
        self.suicide_timeout = 0.0

    def pin(self, start: float | None) -> None:
        """Pin the deadlines to a work item that STARTED at ``start``
        (monotonic); None marks idle.  reset_timeout/clear_timeout fit
        workers that touch once per iteration; pin() fits supervisors
        tracking the OLDEST of several in-flight items (the OSD op
        engine, the EC launch watchdog) where fresh traffic must never
        mask a wedged item."""
        if start is None or self.grace <= 0:
            self.clear_timeout()
            return
        self.timeout = start + self.grace
        self.suicide_timeout = (
            start + self.suicide_grace if self.suicide_grace > 0 else 0.0
        )


class HeartbeatMap:
    def __init__(self, name: str = "", on_suicide: Callable[[str], None] | None = None):
        self.name = name
        self._handles: list[HeartbeatHandle] = []
        self._on_suicide = on_suicide or self._default_suicide

    @staticmethod
    def _default_suicide(worker: str) -> None:
        raise SystemExit(f"heartbeat_map {worker} suicide timeout blown")

    def add_worker(
        self, name: str, grace: float, suicide_grace: float = 0.0
    ) -> HeartbeatHandle:
        h = HeartbeatHandle(name, grace, suicide_grace)
        self._handles.append(h)
        return h

    def remove_worker(self, h: HeartbeatHandle) -> None:
        self._handles.remove(h)

    def is_healthy(self) -> bool:
        """Poll all workers; False if any deadline is blown.  A blown
        suicide deadline fires ``on_suicide`` (reference: _check abort)."""
        now = time.monotonic()
        healthy = True
        for h in self._handles:
            if h.timeout and now > h.timeout:
                healthy = False
                logger.warning(
                    "%s: worker %r missed heartbeat (%.1fs grace)",
                    self.name, h.name, h.grace,
                )
            if h.suicide_timeout and now > h.suicide_timeout:
                logger.error(
                    "%s: worker %r blew suicide timeout (%.1fs)",
                    self.name, h.name, h.suicide_grace,
                )
                self._on_suicide(h.name)
        return healthy

    def dump(self) -> dict:
        now = time.monotonic()
        return {
            "workers": [
                {
                    "name": h.name,
                    "grace": h.grace,
                    "suicide_grace": h.suicide_grace,
                    "idle": h.timeout == 0.0,
                    "overdue": bool(h.timeout) and now > h.timeout,
                    "suicide_overdue": (
                        bool(h.suicide_timeout)
                        and now > h.suicide_timeout
                    ),
                }
                for h in self._handles
            ]
        }
