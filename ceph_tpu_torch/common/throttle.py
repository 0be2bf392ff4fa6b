"""Byte/count budgets (reference:src/common/Throttle.{h,cc}).

Counterpart of ``ceph_tpu/common/throttle.py``, whole.

The reference throttles in-flight bytes at every boundary — messenger
dispatch, objecter ops, recovery — blocking producers when the budget
is exhausted.  Same contract for asyncio: ``acquire(n)`` waits until
``n`` fits, ``release(n)`` wakes waiters strictly FIFO (a multi-unit
release never lets a small later request overtake a large older one —
the head blocks the line until it fits, exactly the reference's
cond-var-per-waiter ordering); a zero limit means unthrottled (the
reference's convention)."""

from __future__ import annotations

import asyncio
import time
from collections import deque


class Throttle:
    def __init__(self, name: str, limit: int = 0):
        self.name = name
        self.limit = int(limit)
        self.current = 0
        # (need, future, enqueue monotonic time) strictly in arrival
        # order — _wake only ever grants from the head
        self._waiters: deque[tuple[int, asyncio.Future, float]] = deque()

    def _would_fit(self, n: int) -> bool:
        # an oversized request (> limit) is admitted alone, like the
        # reference (_should_wait lets c > max through when current==0)
        return (
            self.current + n <= self.limit
            or (self.current == 0 and n > self.limit)
        )

    async def acquire(self, n: int = 1) -> None:
        if self.limit <= 0:
            self.current += n
            return
        if not self._waiters and self._would_fit(n):
            self.current += n
            return
        fut = asyncio.get_running_loop().create_future()
        entry = (n, fut, time.monotonic())
        self._waiters.append(entry)
        try:
            await fut
        except asyncio.CancelledError:
            if not fut.done() or fut.cancelled():
                try:
                    self._waiters.remove(entry)
                except ValueError:
                    pass
                # a cancelled HEAD may have been the only thing blocking
                # the line: re-run the wake loop or the waiters behind
                # it sleep until the next unrelated release (a wedge
                # when that release never comes)
                self._wake()
            else:
                # woken AND cancelled: hand the grant back
                self.release(n)
            raise

    def release(self, n: int = 1) -> None:
        self.current = max(0, self.current - n)
        self._wake()

    def _wake(self) -> None:
        """Grant from the head while it fits — strictly FIFO: the first
        waiter that does NOT fit stops the scan, so a multi-unit
        release can wake several waiters in order but never lets a
        later small request overtake an older large one."""
        while self._waiters:
            need, fut, _t = self._waiters[0]
            if fut.done():
                # cancelled while queued (remove() raced us): drop it
                self._waiters.popleft()
                continue
            if self.limit > 0 and not self._would_fit(need):
                break
            self._waiters.popleft()
            self.current += need
            fut.set_result(None)

    def get_current(self) -> int:
        return self.current

    def waiters(self) -> int:
        return len(self._waiters)

    def oldest_waiter_age(self) -> float:
        """Seconds the head (oldest) waiter has been queued; 0.0 when
        nobody waits — the starvation signal ``dump()`` reports."""
        if not self._waiters:
            return 0.0
        return time.monotonic() - self._waiters[0][2]

    def dump(self) -> dict:
        return {"name": self.name, "limit": self.limit,
                "current": self.current, "waiters": len(self._waiters),
                "oldest_waiter_age": round(self.oldest_waiter_age(), 6)}
