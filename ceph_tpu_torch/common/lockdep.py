"""Lock-order cycle detection (reference:src/common/lockdep.cc).

The reference's lockdep registers every named Mutex, records the
held-set at each acquire into a global order matrix
(``follows[a][b]`` = "b was taken while a was held"), and asserts on
the first acquisition that would close a cycle — catching ABBA
deadlocks on the path that *would* deadlock only under a rare
interleaving.

Here the locks are asyncio locks, keyed per-task instead of
per-thread.  ``LockdepLock`` wraps ``asyncio.Lock``; enable globally
with ``lockdep_enable()`` (the reference's ``lockdep = true`` config).
Violations raise :class:`LockOrderViolation` — tests assert on it the
way the reference asserts in ``lockdep_will_lock``.

Counterpart of ``ceph_tpu/common/lockdep.py``, whole.
"""

from __future__ import annotations

import asyncio
import weakref
from collections import defaultdict

_enabled = False
# follows[a] = set of lock names observed taken while `a` was held
_follows: dict[str, set[str]] = defaultdict(set)
# per-task held lock names, in acquisition order. Weak-keyed by the task
# object: entries vanish with their task, so millions of short-lived op
# tasks don't accrete (and a recycled id() can't alias a dead task's
# held-set into a spurious violation).
_held: "weakref.WeakKeyDictionary[asyncio.Task, list[str]]" = (
    weakref.WeakKeyDictionary()
)
_NO_TASK: list[str] = []  # held-set for lock use outside any task


class LockOrderViolation(RuntimeError):
    pass


def lockdep_enable(on: bool = True) -> None:
    global _enabled
    _enabled = on
    if not on:
        lockdep_reset()


def lockdep_reset() -> None:
    _follows.clear()
    _held.clear()
    del _NO_TASK[:]


def _held_list() -> list[str]:
    task = asyncio.current_task()
    if task is None:
        return _NO_TASK
    lst = _held.get(task)
    if lst is None:
        lst = _held[task] = []
    return lst


def _path_exists(src: str, dst: str) -> bool:
    """DFS over the order graph: does src reach dst?"""
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_follows[n])
    return False


def _will_lock(name: str) -> None:
    """reference:lockdep.cc lockdep_will_lock — record edges held->name,
    refusing any edge that closes a cycle."""
    for h in _held_list():
        if h == name:
            raise LockOrderViolation(f"recursive lock of {name!r}")
        if name in _follows and _path_exists(name, h):
            raise LockOrderViolation(
                f"lock order violation: acquiring {name!r} while holding "
                f"{h!r}, but {name!r} -> {h!r} order was seen before"
            )
        _follows[h].add(name)


def _locked(name: str) -> None:
    _held_list().append(name)


def _will_unlock(name: str) -> None:
    held = _held_list()
    if name in held:
        held.remove(name)


class LockdepLock:
    """asyncio.Lock with lock-order tracking when lockdep is enabled."""

    def __init__(self, name: str):
        self.name = name
        self._lock = asyncio.Lock()

    def locked(self) -> bool:
        return self._lock.locked()

    async def acquire(self) -> bool:
        if _enabled:
            _will_lock(self.name)
        await self._lock.acquire()
        if _enabled:
            _locked(self.name)
        return True

    def release(self) -> None:
        if _enabled:
            _will_unlock(self.name)
        self._lock.release()

    async def __aenter__(self) -> "LockdepLock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()
