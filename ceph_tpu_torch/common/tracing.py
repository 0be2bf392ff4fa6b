"""The trace context the EC dispatcher reads.

Counterpart of the two contextvars of ``ceph_tpu/common/tracing.py``
that ``osd.ec_dispatch`` reads: the op path sets them once, and every
task and call below inherits them, so a flight record names the trace
and the client of each op it carried without any parameter threading.
These are the port's own variables, not the reference's: a process that
hosts the port's dispatcher must set these.
"""

from __future__ import annotations

import contextvars

# the active trace id for this task tree (None = untraced work)
current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "ceph_tpu_torch_trace", default=None
)
# the originating client id for this task tree (None = not attributed)
current_client: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "ceph_tpu_torch_client", default=None
)
