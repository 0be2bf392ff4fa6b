"""Typed performance counters (reference:src/common/perf_counters.{h,cc}).

Counterpart of ``ceph_tpu/common/perf_counters.py``, copied so that the
port needs nothing of the JAX package: the same types, the same
``dump()`` / ``dump_histograms()`` / ``schema()`` shapes.

The reference registers per-subsystem ``PerfCounters`` objects (built
with PerfCountersBuilder: u64 counters, gauges, time/long-run averages,
and 1D/2D log2 histograms — src/common/perf_histogram.h) in a
per-daemon collection, dumpable via the admin socket as ``perf dump``
(scalars) and ``dump_histograms`` (bucketed distributions), with
``perf schema`` describing every key and ``perf reset`` clearing the
accumulated state between measurement windows.  Same shape here.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any

COUNTER = "counter"   # monotonically increasing u64
GAUGE = "gauge"       # set to arbitrary values
AVG = "avg"           # (sum, count[, min, max]) pairs
TIME_AVG = "time_avg"  # avg over elapsed seconds
HISTOGRAM = "histogram"  # log2/linear-bucketed 1D or 2D distribution


class PerfHistogramAxis:
    """One bucketed axis (reference perf_histogram axis_config_d).

    ``log2`` scale: bucket 0 catches values below ``min``; bucket i
    (1 <= i < buckets-1) covers [min * 2^(i-1), min * 2^i); the last
    bucket is the overflow [min * 2^(buckets-2), +inf).  ``linear``
    scale replaces the doubling with a fixed ``quant`` step.
    """

    def __init__(self, name: str, *, scale: str = "log2",
                 min: float = 1.0, buckets: int = 16,
                 quant: float = 1.0, unit: str = ""):
        if scale not in ("log2", "linear"):
            raise ValueError(f"axis scale must be log2/linear, got {scale!r}")
        if buckets < 2:
            raise ValueError(f"axis needs >= 2 buckets, got {buckets}")
        if min <= 0:
            raise ValueError(f"axis min must be positive, got {min}")
        self.name = name
        self.scale = scale
        self.min = float(min)
        self.buckets = int(buckets)
        self.quant = float(quant)
        self.unit = unit

    def bucket(self, value: float) -> int:
        """Bucket index for one sample (clamped into [0, buckets-1])."""
        if value < self.min:
            return 0
        if self.scale == "log2":
            idx = 1 + int(math.floor(math.log2(value / self.min)))
        else:
            idx = 1 + int(math.floor((value - self.min) / self.quant))
        return idx if idx < self.buckets else self.buckets - 1

    def upper(self, idx: int) -> float:
        """Upper bound of bucket ``idx`` (+inf for the overflow bucket)
        — the prometheus ``le`` label value."""
        if idx >= self.buckets - 1:
            return math.inf
        if self.scale == "log2":
            return self.min * (2 ** idx)
        return self.min + idx * self.quant

    def schema(self) -> dict:
        return {
            "name": self.name, "scale": self.scale, "min": self.min,
            "buckets": self.buckets, "quant": self.quant,
            "unit": self.unit,
        }


def size_latency_axes(*, size_min: float = 256.0, size_buckets: int = 16,
                      lat_min: float = 1e-4, lat_buckets: int = 16,
                      ) -> "list[PerfHistogramAxis]":
    """The canonical 2D (request size x latency) axes the reference's
    OSD histograms use (op_rw_latency_*_bytes_histogram): log2 request
    bytes from ``size_min``, log2 seconds from ``lat_min`` (100 us up
    to ~55 min with the defaults)."""
    return [
        PerfHistogramAxis("request_bytes", min=size_min,
                          buckets=size_buckets, unit="bytes"),
        PerfHistogramAxis("latency", min=lat_min,
                          buckets=lat_buckets, unit="seconds"),
    ]


def latency_axis(*, lat_min: float = 1e-4,
                 buckets: int = 16) -> "list[PerfHistogramAxis]":
    return [PerfHistogramAxis("latency", min=lat_min, buckets=buckets,
                              unit="seconds")]


class PerfHistogram:
    """1D or 2D bucket-count grid (reference:src/common/perf_histogram.h).

    The LAST axis is the exposition axis: prometheus flattening sums
    the other axis away and serves the last axis's buckets as the
    ``le`` series, so (size, latency) axes export a latency histogram.
    """

    def __init__(self, axes: "list[PerfHistogramAxis]"):
        if not 1 <= len(axes) <= 2:
            raise ValueError(f"1 or 2 axes supported, got {len(axes)}")
        self.axes = list(axes)
        self._lock = threading.Lock()
        self._reset_grid()

    def _reset_grid(self) -> None:
        if len(self.axes) == 1:
            self._values: Any = [0] * self.axes[0].buckets
        else:
            self._values = [
                [0] * self.axes[1].buckets
                for _ in range(self.axes[0].buckets)
            ]
        self._count = 0
        self._sums = [0.0] * len(self.axes)

    def sample(self, *values: float) -> None:
        if len(values) != len(self.axes):
            raise ValueError(
                f"histogram has {len(self.axes)} axes, got "
                f"{len(values)} values"
            )
        with self._lock:
            self._count += 1
            for i, v in enumerate(values):
                self._sums[i] += v
            if len(values) == 1:
                self._values[self.axes[0].bucket(values[0])] += 1
            else:
                self._values[self.axes[0].bucket(values[0])][
                    self.axes[1].bucket(values[1])
                ] += 1

    def reset(self) -> None:
        with self._lock:
            self._reset_grid()

    def dump(self) -> dict:
        """JSON-able snapshot; ``sum`` is the last (exposition) axis's
        value sum so prometheus ``_sum``/``_count`` cohere with the
        bucket series."""
        with self._lock:
            values = (
                [list(row) for row in self._values]
                if len(self.axes) == 2 else list(self._values)
            )
            return {
                "axes": [a.schema() for a in self.axes],
                "values": values,
                "count": self._count,
                "sum": self._sums[-1],
                "sums": list(self._sums),
            }


class PerfCounters:
    """One subsystem's counters (e.g. 'osd', 'ec', 'messenger')."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._types: dict[str, str] = {}
        self._vals: dict[str, Any] = {}
        self._descs: dict[str, str] = {}

    # -- builder (PerfCountersBuilder analog)
    def add_counter(self, key: str, desc: str = "") -> "PerfCounters":
        self._types[key] = COUNTER
        self._vals[key] = 0
        self._descs[key] = desc
        return self

    def add_gauge(self, key: str, desc: str = "") -> "PerfCounters":
        self._types[key] = GAUGE
        self._vals[key] = 0
        self._descs[key] = desc
        return self

    def add_avg(self, key: str, desc: str = "") -> "PerfCounters":
        self._types[key] = AVG
        self._vals[key] = [0.0, 0, None, None]  # sum, count, min, max
        self._descs[key] = desc
        return self

    def add_time_avg(self, key: str, desc: str = "") -> "PerfCounters":
        self._types[key] = TIME_AVG
        self._vals[key] = [0.0, 0, None, None]
        self._descs[key] = desc
        return self

    def add_histogram(
        self, key: str, desc: str = "",
        axes: "list[PerfHistogramAxis] | None" = None,
    ) -> "PerfCounters":
        """Register a bucketed distribution (PerfHistogram); default
        axes are the 2D request-size x latency grid."""
        self._types[key] = HISTOGRAM
        self._vals[key] = PerfHistogram(axes or size_latency_axes())
        self._descs[key] = desc
        return self

    # -- updates
    def inc(self, key: str, by: int = 1) -> None:
        with self._lock:
            if self._types[key] != COUNTER:
                raise TypeError(f"{key} is not a counter")
            self._vals[key] += by

    def inc_pair(self, key_a: str, by_a, key_b: str, by_b) -> None:
        """Two counter incs under ONE lock round trip — the per-frame
        ledger feed (stack_ledger) pays this on every message, and two
        separate acquisitions measurably widen the small-op path on
        slow hosts."""
        with self._lock:
            types = self._types
            if types[key_a] != COUNTER or types[key_b] != COUNTER:
                raise TypeError(f"{key_a}/{key_b}: not counters")
            vals = self._vals
            vals[key_a] += by_a
            vals[key_b] += by_b

    def set(self, key: str, value) -> None:
        with self._lock:
            if self._types[key] != GAUGE:
                raise TypeError(f"{key} is not a gauge")
            self._vals[key] = value

    def observe(self, key: str, value: float) -> None:
        with self._lock:
            v = self._vals[key]
            if self._types[key] not in (AVG, TIME_AVG):
                raise TypeError(f"{key} is not an average")
            v[0] += value
            v[1] += 1
            v[2] = value if v[2] is None else min(v[2], value)
            v[3] = value if v[3] is None else max(v[3], value)

    def hist(self, key: str, *values: float) -> None:
        """Sample into a registered histogram (one value per axis)."""
        h = self._vals[key]
        if self._types[key] != HISTOGRAM:
            raise TypeError(f"{key} is not a histogram")
        h.sample(*values)  # PerfHistogram carries its own lock

    def time(self, key: str):
        """Context manager observing elapsed seconds into a time_avg."""
        counters = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                counters.observe(key, time.perf_counter() - self.t0)

        return _Timer()

    # -- read
    def get(self, key: str):
        with self._lock:
            v = self._vals[key]
            return list(v) if isinstance(v, list) else v

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for key, t in self._types.items():
                v = self._vals[key]
                if t in (AVG, TIME_AVG):
                    s, c, lo, hi = v
                    out[key] = {
                        "avgcount": c,
                        "sum": s,
                        "avg": (s / c) if c else 0.0,
                        "min": lo,
                        "max": hi,
                    }
                elif t == HISTOGRAM:
                    # marker key the prometheus module and the mgr's
                    # JSON transport both key on — histograms ride the
                    # same per-daemon report as the scalars
                    out[key] = {"histogram": v.dump()}
                else:
                    out[key] = v
            return out

    def dump_histograms(self) -> dict:
        """Only the bucketed distributions (``dump_histograms``)."""
        with self._lock:
            return {
                key: v.dump() for key, v in self._vals.items()
                if self._types[key] == HISTOGRAM
            }

    def schema(self) -> dict:
        """Per-key type + description (``perf schema``); histograms
        include their axis configs."""
        with self._lock:
            out = {}
            for key, t in self._types.items():
                entry: dict = {"type": t, "description": self._descs[key]}
                if t == HISTOGRAM:
                    entry["axes"] = [
                        a.schema() for a in self._vals[key].axes
                    ]
                out[key] = entry
            return out

    def reset(self) -> None:
        """Zero every accumulator (``perf reset``): counters, gauges,
        avg/time_avg sum/count/min/max, and histogram grids — so a
        measurement window (a bench phase, a load test) starts clean
        instead of averaging into everything since daemon boot."""
        with self._lock:
            for key, t in self._types.items():
                if t in (AVG, TIME_AVG):
                    self._vals[key] = [0.0, 0, None, None]
                elif t == HISTOGRAM:
                    self._vals[key].reset()
                else:
                    self._vals[key] = 0


class PerfCountersCollection:
    """Per-daemon registry of PerfCounters (perf_counters_collection_t)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subsystems: dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            if name in self._subsystems:
                return self._subsystems[name]
            pc = PerfCounters(name)
            self._subsystems[name] = pc
            return pc

    def attach(self, pc: PerfCounters) -> PerfCounters:
        """Adopt counters built elsewhere (the messenger builds its own
        at construction time, before any daemon collection exists) so
        they ride the daemon's ``perf dump`` / mgr report like native
        subsystems (reference: logger registration in
        perf_counters_collection_t::add)."""
        with self._lock:
            self._subsystems[pc.name] = pc
            return pc

    def get(self, name: str) -> PerfCounters | None:
        return self._subsystems.get(name)

    def dump(self) -> dict:
        with self._lock:
            return {
                name: pc.dump() for name, pc in sorted(
                    self._subsystems.items()
                )
            }

    def dump_histograms(self) -> dict:
        """{subsystem: {key: histogram dump}} for subsystems that
        registered any (``dump_histograms`` admin command body)."""
        with self._lock:
            out = {}
            for name, pc in sorted(self._subsystems.items()):
                h = pc.dump_histograms()
                if h:
                    out[name] = h
            return out

    def schema(self) -> dict:
        with self._lock:
            return {
                name: pc.schema() for name, pc in sorted(
                    self._subsystems.items()
                )
            }

    def reset(self, name: str = "all") -> list[str]:
        """``perf reset <subsystem|all>``: returns the subsystem names
        reset; unknown names raise KeyError (surfaces as an admin-
        socket error)."""
        with self._lock:
            if name == "all":
                targets = list(self._subsystems.values())
            elif name in self._subsystems:
                targets = [self._subsystems[name]]
            else:
                raise KeyError(
                    f"no perf subsystem {name!r} "
                    f"(have: {sorted(self._subsystems)} or 'all')"
                )
        for pc in targets:
            pc.reset()
        return [pc.name for pc in targets]
