"""Daemon-wide plumbing: the config table, perf counters, the admin
socket, the op tracker, tracepoints and the trace context, the watchdog,
and the messenger's runtime helpers (throttle, frame and receive pools,
clock sync, the ``stack.*`` ledger, the memory log).  Counterpart of
``ceph_tpu/common``; lockdep is not ported yet."""

from .config import OPTIONS, Config, Option
from .perf_counters import (
    PerfCounters,
    PerfCountersCollection,
    PerfHistogram,
    PerfHistogramAxis,
    latency_axis,
    size_latency_axes,
)
from .admin_socket import AdminSocket, admin_command, register_common
from .heartbeat_map import HeartbeatHandle, HeartbeatMap
from .op_tracker import OpTracker, TrackedOp
from .tracing import (
    TraceProvider,
    current_client,
    current_trace,
    events_for_trace,
    new_trace_id,
    tracepoint_provider,
)

__all__ = [
    "Config",
    "Option",
    "OPTIONS",
    "PerfCounters",
    "PerfCountersCollection",
    "PerfHistogram",
    "PerfHistogramAxis",
    "latency_axis",
    "size_latency_axes",
    "AdminSocket",
    "admin_command",
    "register_common",
    "HeartbeatHandle",
    "HeartbeatMap",
    "OpTracker",
    "TrackedOp",
    "TraceProvider",
    "current_client",
    "current_trace",
    "events_for_trace",
    "new_trace_id",
    "tracepoint_provider",
]
