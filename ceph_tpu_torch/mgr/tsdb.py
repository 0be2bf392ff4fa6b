"""Mgr time-series store: rate-resampled ring-buffer history over
every daemon-reported counter family.

Counterpart of ``ceph_tpu/mgr/tsdb.py``, whole: the same rings, derived
series and query bodies, so the two packages' ``metrics`` outputs are
equal for the same reports.

The prometheus module flattens counters to instantaneous scrapes; this
store is the mgr-side history that makes "is p99 degrading RIGHT NOW,
and for whom" answerable at runtime — the MgrStatMonitor/iostat analog,
and the substrate the SLO burn-rate health check evaluates over.

Design points, each load-bearing:

- **Fixed-step buckets, bounded rings.**  Every series is a ring of at
  most ``retention`` points at ``step`` spacing — memory per series is
  a constant, full stop.  Reports landing inside the same bucket
  overwrite it (last write wins), so a fast-reporting daemon cannot
  inflate history.

- **Reset-safe delta accounting at insert.**  Scalars store BOTH the
  raw value and a monotonized cumulative: ``delta = raw - last_raw``,
  and a negative delta (daemon restart, ``perf reset``) re-bases as
  ``delta = raw`` instead of going negative.  Rates are cumulative
  deltas over the queried window, so a mid-window reset costs at most
  the pre-reset accumulation — it never produces a negative or
  divide-by-restart spike.

- **Derivation at insert, not at query.**  Avg pairs split into
  ``.sum``/``.count`` cumulative series (windowed average = Δsum /
  Δcount).  Histograms derive ``.p99`` (upper-edge quantile estimate
  over the windowed bucket deltas) and ``.slow_frac`` (fraction of
  in-window ops in buckets at/above ``slow_threshold``) as gauge
  series — the full grid is never retained, only the last bucket
  counts for the next delta.

- **A hard series cap.**  Past ``max_series`` new names are counted in
  ``tsdb.dropped_series`` and ignored — cardinality pressure is
  visible, never fatal.

Series are keyed ``(daemon, "<subsys>.<key>")``; queries aggregate
across daemons unless one is named.  Served by the mgr's ``metrics
query/ls/range`` commands and ``tools/ceph_top.py``.
"""

from __future__ import annotations

import fnmatch
import math
import time


class _Series:
    __slots__ = ("ring", "last_raw", "cum")

    def __init__(self):
        # ring entries: [bucket_ts, raw, cum]
        self.ring: list[list[float]] = []
        self.last_raw: float | None = None
        self.cum = 0.0


class TimeSeriesStore:
    def __init__(self, step: float = 1.0, retention: int = 600,
                 max_series: int = 4096, perf=None,
                 clock=time.monotonic):
        self.step = max(0.05, float(step))
        self.retention = max(2, int(retention))
        self.max_series = max(1, int(max_series))
        self.perf = perf
        self._clock = clock
        self._series: dict[tuple[str, str], _Series] = {}
        # per-histogram last bucket counts (flattened to the exposition
        # axis) for windowed deltas — NOT ring-buffered: one list per
        # histogram, replaced each insert
        self._hist_last: dict[tuple[str, str], list[float]] = {}
        self.dropped_series = 0
        self.samples = 0
        # ops at/above this latency count as slow in .slow_frac
        # derivation — the mgr keeps it synced to the SLO p99 target
        self.slow_threshold = 0.5

    # -- ingestion ------------------------------------------------------
    def ingest(self, daemon: str, perf: dict, ts: float | None = None
               ) -> None:
        """Fold one daemon's PerfCountersCollection dump into the
        store.  Unknown shapes are skipped — ingestion must never fail
        a stats report."""
        now = self._clock() if ts is None else float(ts)
        for subsys, counters in (perf or {}).items():
            if not isinstance(counters, dict):
                continue
            for key, val in counters.items():
                name = f"{subsys}.{key}"
                if isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    self._insert(daemon, name, float(val), now)
                elif isinstance(val, dict) and "avgcount" in val:
                    self._insert(daemon, f"{name}.sum",
                                 float(val.get("sum", 0.0)), now)
                    self._insert(daemon, f"{name}.count",
                                 float(val.get("avgcount", 0)), now)
                elif isinstance(val, dict) and "histogram" in val:
                    self._ingest_histogram(daemon, name,
                                           val["histogram"], now)

    def _insert(self, daemon: str, name: str, raw: float,
                now: float) -> None:
        key = (daemon, name)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                if self.perf is not None:
                    self.perf.inc("dropped_series")
                return
            s = self._series[key] = _Series()
        if s.last_raw is None:
            # first sight: the whole value predates our window — the
            # cumulative starts at 0 so rates cover observed time only
            delta = 0.0
        else:
            delta = raw - s.last_raw
            if delta < 0:
                # daemon restart / perf reset: re-base on the raw value
                # (everything since the reset is new accumulation)
                delta = raw
        s.last_raw = raw
        s.cum += delta
        bucket = math.floor(now / self.step) * self.step
        if s.ring and s.ring[-1][0] == bucket:
            s.ring[-1][1] = raw
            s.ring[-1][2] = s.cum
        else:
            s.ring.append([bucket, raw, s.cum])
            if len(s.ring) > self.retention:
                del s.ring[0]
        self.samples += 1
        if self.perf is not None:
            self.perf.inc("samples")

    # -- histogram derivation -------------------------------------------
    @staticmethod
    def _axis_edges(axis: dict) -> list[float]:
        """Upper edges per bucket (last = +inf) from an axis schema."""
        amin = float(axis.get("min", 1.0))
        n = int(axis.get("buckets", 2))
        scale = axis.get("scale", "log2")
        quant = float(axis.get("quant", 1.0))
        edges = []
        for i in range(n):
            if i == n - 1:
                edges.append(math.inf)
            elif scale == "log2":
                edges.append(amin * (2 ** i))
            else:
                # mirrors PerfHistogramAxis.upper(): min + idx*quant
                edges.append(amin + i * quant)
        return edges

    def _ingest_histogram(self, daemon: str, name: str, hist: dict,
                          now: float) -> None:
        axes = hist.get("axes") or []
        values = hist.get("values") or []
        if not axes:
            return
        # flatten to the EXPOSITION axis (the last one): 2D grids
        # column-sum over the leading axis, exactly like the
        # prometheus module's le series
        if len(axes) == 2:
            cols = len(values[0]) if values else 0
            counts = [
                float(sum(row[j] for row in values))
                for j in range(cols)
            ]
            edges = self._axis_edges(axes[-1])
        else:
            counts = [float(v) for v in values]
            edges = self._axis_edges(axes[0])
        if len(counts) != len(edges):
            return
        key = (daemon, name)
        last = self._hist_last.get(key)
        if last is None or len(last) != len(counts) or any(
                c < p for c, p in zip(counts, last)):
            # first sight or reset: this report's counts are the window
            deltas = counts
        else:
            deltas = [c - p for c, p in zip(counts, last)]
        self._hist_last[key] = counts
        # lifetime totals as COUNTER series: windowed burn rates read
        # rate(.slow_total)/rate(.total) — reset-safe via _insert's
        # delta re-basing (a slow_threshold change re-bases the same
        # way; it is a rare operator action, not a hot path)
        self._insert(daemon, f"{name}.total", sum(counts), now)
        self._insert(daemon, f"{name}.slow_total", sum(
            c for c, e in zip(counts, edges) if e > self.slow_threshold
        ), now)
        total = sum(deltas)
        if total > 0:
            p99 = self._quantile(deltas, edges, 0.99)
            slow = sum(
                d for d, e in zip(deltas, edges)
                if e > self.slow_threshold
            )
            self._insert(daemon, f"{name}.p99", p99, now)
            self._insert(daemon, f"{name}.slow_frac",
                         slow / total, now)

    @staticmethod
    def _quantile(deltas: list[float], edges: list[float],
                  q: float) -> float:
        total = sum(deltas)
        want = q * total
        seen = 0.0
        for d, e in zip(deltas, edges):
            seen += d
            if seen >= want:
                if math.isinf(e):
                    # overflow bucket: report the last finite edge
                    finite = [x for x in edges if not math.isinf(x)]
                    return finite[-1] if finite else 0.0
                return e
        return 0.0

    # -- queries --------------------------------------------------------
    def ls(self, pattern: str | None = None) -> list[dict]:
        """Distinct metric names (+ reporting daemon counts), glob-
        filterable — the ``metrics ls`` body."""
        agg: dict[str, int] = {}
        for (_daemon, name) in self._series:
            if pattern and not fnmatch.fnmatch(name, pattern):
                continue
            agg[name] = agg.get(name, 0) + 1
        return [{"metric": m, "daemons": n}
                for m, n in sorted(agg.items())]

    def _matching(self, metric: str, daemon: str | None
                  ) -> list[tuple[str, _Series]]:
        return [
            (d, s) for (d, name), s in self._series.items()
            if name == metric and (daemon is None or d == daemon)
        ]

    @staticmethod
    def _window_points(s: _Series, t0: float) -> list[list[float]]:
        return [p for p in s.ring if p[0] >= t0]

    def query(self, metric: str, *, window: float = 10.0,
              daemon: str | None = None, derive: str = "rate"
              ) -> dict:
        """One number per matching daemon series plus the aggregate.

        ``derive``: ``rate`` = Δcumulative/Δt over the window (the
        counter semantic; survives resets), ``value`` = latest raw
        (gauges and derived series), ``avg`` = windowed Δsum/Δcount
        over the ``.sum``/``.count`` pair of an avg family.
        Aggregation: rates and avgs sum/recombine across daemons;
        values sum (gauge totals) — query one daemon when a sum is
        meaningless."""
        now = self._clock()
        t0 = now - max(self.step, float(window))
        if derive == "avg":
            num = self.query(f"{metric}.sum", window=window,
                             daemon=daemon, derive="rate")
            den = self.query(f"{metric}.count", window=window,
                             daemon=daemon, derive="rate")
            val = (num["value"] / den["value"]) if den["value"] else 0.0
            return {"metric": metric, "derive": "avg",
                    "window_s": window, "value": round(val, 9),
                    "daemons": den["daemons"]}
        per: dict[str, float] = {}
        for d, s in self._matching(metric, daemon):
            pts = self._window_points(s, t0)
            if not pts:
                continue
            if derive == "value":
                per[d] = pts[-1][1]
            else:
                if len(pts) < 2:
                    per[d] = 0.0
                else:
                    dt = pts[-1][0] - pts[0][0]
                    per[d] = ((pts[-1][2] - pts[0][2]) / dt) if dt \
                        else 0.0
        return {
            "metric": metric,
            "derive": derive,
            "window_s": window,
            "value": round(sum(per.values()), 9),
            "daemons": {d: round(v, 9) for d, v in sorted(per.items())},
        }

    def range(self, metric: str, *, window: float = 60.0,
              daemon: str | None = None, derive: str = "rate"
              ) -> dict:
        """Per-bucket samples over the window — the ``ceph_top``
        substrate.  Buckets align across daemons; rate buckets are the
        per-step cumulative delta over the step."""
        now = self._clock()
        t0 = now - max(self.step, float(window))
        buckets: dict[float, float] = {}
        matched = 0
        for _d, s in self._matching(metric, daemon):
            pts = self._window_points(s, t0)
            if not pts:
                continue
            matched += 1
            if derive == "value":
                for p in pts:
                    buckets[p[0]] = buckets.get(p[0], 0.0) + p[1]
            else:
                for prev, cur in zip(pts, pts[1:]):
                    dt = cur[0] - prev[0]
                    if dt <= 0:
                        continue
                    buckets[cur[0]] = buckets.get(cur[0], 0.0) + (
                        (cur[2] - prev[2]) / dt
                    )
        return {
            "metric": metric,
            "derive": derive,
            "window_s": window,
            "series": matched,
            "points": [
                [round(t, 3), round(v, 9)]
                for t, v in sorted(buckets.items())
            ],
        }

    def stats(self) -> dict:
        return {
            "series": len(self._series),
            "max_series": self.max_series,
            "dropped_series": self.dropped_series,
            "points": sum(len(s.ring) for s in self._series.values()),
            "retention": self.retention,
            "step_s": self.step,
            "samples": self.samples,
        }
