"""The trace context the messenger and the EC dispatcher share.

Counterpart of the two contextvars and ``new_trace_id`` of
``ceph_tpu/common/tracing.py``: the op path sets them once, and every
task and call below inherits them, so a flight record names the trace
and the client of each op it carried without any parameter threading.
The messenger stamps ``current_trace`` into every outbound frame (minting
an id where none is set) and restores it before it dispatches an inbound
one, so one op's id follows it across processes — an OSD's dispatcher,
the wire, the accelerator daemon's dispatcher.  These are the port's own
variables, not the reference's: a process that hosts the port's
dispatcher must set these.  The tracepoint rings and the op waterfall of
the reference module are not ported yet.
"""

from __future__ import annotations

import contextvars
import itertools

# the active trace id for this task tree (None = untraced work)
current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "ceph_tpu_torch_trace", default=None
)
# the originating client id for this task tree (None = not attributed)
current_client: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "ceph_tpu_torch_client", default=None
)
_trace_seq = itertools.count(1)


def new_trace_id(origin: str) -> str:
    """Mint an origin-stamped trace id (``client.1:t17`` style) — unique
    per process, readable in dumps."""
    return f"{origin}:t{next(_trace_seq)}"
