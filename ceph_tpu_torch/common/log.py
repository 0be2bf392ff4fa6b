"""In-memory ring-buffer logging (reference:src/log/Log.cc).

Counterpart of ``ceph_tpu/common/log.py``, whole; the ring hangs off
this package's own logger tree.

The reference keeps a bounded ring of recent log entries per daemon at
a much finer level than what reaches disk, and dumps it on crash
("recent events") or on demand via the admin socket (``log dump``).
Same shape here: a logging.Handler holding the newest N records across
the ``ceph_tpu_torch`` subsystems, dumpable as structured entries, with a
crash-dump hook the daemons call on abort.
"""

from __future__ import annotations

import logging
from collections import deque
from datetime import datetime

_handler: "MemoryLog | None" = None


class MemoryLog(logging.Handler):
    """Ring of recent records (the reference's m_recent)."""

    def __init__(self, capacity: int = 10000, level: int = logging.DEBUG):
        super().__init__(level)
        self.capacity = capacity
        self._ring: deque[dict] = deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._ring.append({
                "ts": record.created,
                "level": record.levelname,
                "levelno": record.levelno,
                "subsys": record.name,
                "msg": record.getMessage(),
            })
        except Exception:
            pass  # the logger must never take the daemon down

    def recent(self, n: int | None = None,
               level: str | None = None) -> list[dict]:
        out = list(self._ring)
        if level is not None:
            want = getattr(logging, str(level).upper(), None)
            if not isinstance(want, int):
                raise ValueError(f"unknown log level {level!r}")
            out = [e for e in out if e["levelno"] >= want]
        if n is not None and n > 0:
            return out[-n:]
        return out

    def clear(self) -> None:
        self._ring.clear()


def install(capacity: int = 10000) -> MemoryLog:
    """Attach the ring to the ``ceph_tpu_torch`` logger tree (idempotent;
    a different ``capacity`` resizes the existing ring in place).

    Logger LEVELS are left alone: the ring records whatever the
    configured levels let through — overriding them to DEBUG here
    would flood the operator's console handlers and clobber explicit
    configuration (the reference sizes its gather level separately
    because its handlers filter independently; python logging's don't).
    """
    global _handler
    if _handler is None:
        _handler = MemoryLog(capacity)
        logging.getLogger("ceph_tpu_torch").addHandler(_handler)
    elif capacity != _handler._ring.maxlen:
        _handler._ring = deque(_handler._ring, maxlen=capacity)
        _handler.capacity = capacity
    return _handler


def memory_log() -> "MemoryLog | None":
    return _handler


def dump_recent(n: int = 200) -> list[str]:
    """Crash-time dump (reference: dump_recent on assert): formatted
    lines of the newest entries, newest last.

    Timestamps are full ISO-8601 with milliseconds (local time): a
    bare %H:%M:%S had no date and no subsecond precision, so crash
    dumps could not be correlated with trace events or prometheus
    scrapes across a midnight boundary or within one busy second.
    """
    if _handler is None:
        return []
    return [
        f"{datetime.fromtimestamp(e['ts']).isoformat(timespec='milliseconds')} "
        f"{e['level']:<8} {e['subsys']}: {e['msg']}"
        for e in _handler.recent(n)
    ]
