"""Daemon-wide plumbing: the config table, perf counters, the trace
context, the watchdog, and the messenger's runtime helpers (throttle,
frame and receive pools, clock sync, the ``stack.*`` ledger, the memory
log).  Counterpart of ``ceph_tpu/common``; the admin socket, lockdep and
the op tracker are not ported yet."""

from .config import OPTIONS, Config, Option
from .heartbeat_map import HeartbeatHandle, HeartbeatMap
from .perf_counters import (
    PerfCounters,
    PerfCountersCollection,
    PerfHistogram,
    PerfHistogramAxis,
    latency_axis,
    size_latency_axes,
)
from .tracing import current_client, current_trace, new_trace_id

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
    "HeartbeatHandle",
    "HeartbeatMap",
    "current_client",
    "current_trace",
    "new_trace_id",
]
