"""The mgr's kept-trace collector: a bounded ring of
tail-sampled op waterfalls shipped by the OSDs on MPGStats.

Counterpart of ``ceph_tpu/mgr/trace_store.py``, whole.

The keep decision already happened at the source (osd/daemon.py
``_trace_keep_reason``: slow / error / replay / 1-in-N baseline), so
everything that lands here is worth an operator's attention.  The
store's job is retrieval: ``trace show <id>`` for one waterfall,
``trace top`` for the slowest in a window, ``trace summary`` for the
dominant-hop histogram over kept traces (the hop re-rank table ROADMAP
item 1c wants), and exemplar lookup so SLO_BURN and the prometheus
``ceph_stack_lat_*`` buckets can cite concrete trace ids instead of
aggregates.

Memory is O(capacity * hops): a hard ring (``mgr_trace_store_capacity``)
evicts oldest-first and counts ``trace.store_evictions`` — a trace
storm degrades retention, never the mgr.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any


class TraceStore:
    """Bounded kept-trace ring with by-id, by-client, by-pool and
    by-dominant-hop retrieval.

    One ``OrderedDict`` keyed by trace id is both the ring (insertion
    order = eviction order) and the index; the secondary filters are
    linear scans — at the default 512-trace capacity a scan is cheaper
    than maintaining four indexes through evictions.
    """

    def __init__(self, capacity: int = 512, perf=None):
        self.capacity = max(1, int(capacity))
        self._perf = perf  # mgr's "trace" family: store_evictions/size
        self._ring: OrderedDict[str, dict] = OrderedDict()
        self.ingested = 0
        self.evictions = 0

    # -- ingest ---------------------------------------------------------------
    def ingest(self, wf: dict) -> None:
        """Fold one shipped waterfall in.  Re-ingest of a known trace id
        (the same op kept by two reporting OSDs, or a resent report)
        replaces in place and refreshes recency rather than double
        counting."""
        trace = wf.get("trace")
        if not trace:
            return
        rec = dict(wf)
        rec["_ts"] = time.monotonic()  # ingest stamp: the window clock
        if trace in self._ring:
            del self._ring[trace]
        self._ring[trace] = rec
        self.ingested += 1
        while len(self._ring) > self.capacity:
            self._ring.popitem(last=False)
            self.evictions += 1
            if self._perf is not None:
                self._perf.inc("store_evictions")
        if self._perf is not None:
            self._perf.set("store_size", len(self._ring))

    # -- retrieval ------------------------------------------------------------
    def get(self, trace: str) -> dict | None:
        rec = self._ring.get(trace)
        return dict(rec) if rec is not None else None

    def _window(self, window: float | None) -> list[dict]:
        """Records inside the lookback window, oldest first."""
        if window is None or window <= 0:
            return list(self._ring.values())
        cut = time.monotonic() - float(window)
        return [r for r in self._ring.values() if r["_ts"] >= cut]

    def ls(self, client: str | None = None, pool: Any = None,
           hop: str | None = None, limit: int = 64) -> list[dict]:
        """Newest-first one-line summaries, optionally filtered by
        client id, pool, or dominant hop."""
        out: list[dict] = []
        for rec in reversed(self._ring.values()):
            if client is not None and rec.get("client") != client:
                continue
            if pool is not None and rec.get("pool") != pool:
                continue
            if hop is not None and rec.get("dominant_hop") != hop:
                continue
            out.append(self._summary_row(rec))
            if len(out) >= max(1, int(limit)):
                break
        return out

    def top(self, n: int = 10, window: float | None = None) -> list[dict]:
        """The n slowest kept traces in the window — the pane the
        operator scans first when SLO_BURN names an exemplar."""
        rows = self._window(window)
        rows.sort(key=lambda r: r.get("wall_s") or 0.0, reverse=True)
        return [self._summary_row(r) for r in rows[: max(1, int(n))]]

    def summary(self, window: float | None = None) -> dict:
        """Dominant-hop histogram over kept traces: where do the ops
        the keep policy condemned actually spend their time?  Baseline
        keeps are tallied separately so an anomaly-hop row is not
        diluted by healthy 1-in-N samples."""
        hops: dict[str, dict] = {}
        reasons: dict[str, int] = {}
        rows = self._window(window)
        for rec in rows:
            reasons[rec.get("reason") or "?"] = (
                reasons.get(rec.get("reason") or "?", 0) + 1
            )
            hop = rec.get("dominant_hop") or "?"
            h = hops.setdefault(
                hop, {"count": 0, "wall_sum_s": 0.0, "wall_max_s": 0.0}
            )
            h["count"] += 1
            wall = float(rec.get("wall_s") or 0.0)
            h["wall_sum_s"] = round(h["wall_sum_s"] + wall, 6)
            h["wall_max_s"] = round(max(h["wall_max_s"], wall), 6)
        ranked = sorted(
            hops.items(), key=lambda kv: kv[1]["wall_sum_s"], reverse=True
        )
        return {
            "traces": len(rows),
            "reasons": reasons,
            "dominant_hops": [{"hop": k, **v} for k, v in ranked],
        }

    def exemplars(self, n: int = 3,
                  window: float | None = None) -> list[str]:
        """Trace ids SLO_BURN should cite: anomaly-kept (non-baseline)
        first, slowest first within a class — the operator gets the op
        that burned the budget, not a lucky median."""
        rows = self._window(window)
        rows.sort(
            key=lambda r: (r.get("reason") != "baseline",
                           r.get("wall_s") or 0.0),
            reverse=True,
        )
        return [r["trace"] for r in rows[: max(1, int(n))]]

    def exemplar_for(self, hop: str, lo: float,
                     hi: float) -> tuple[str, float] | None:
        """Most recent kept trace whose ``hop`` span duration lands in
        [lo, hi) — the OpenMetrics exemplar for that histogram bucket.
        Returns (trace_id, duration) or None."""
        for rec in reversed(self._ring.values()):
            for span in rec.get("hops") or []:
                if span.get("hop") != hop:
                    continue
                dur = float(span.get("dur_s") or 0.0)
                if lo <= dur < hi:
                    return rec["trace"], dur
        return None

    def stats(self) -> dict:
        return {
            "size": len(self._ring),
            "capacity": self.capacity,
            "ingested": self.ingested,
            "evictions": self.evictions,
        }

    @staticmethod
    def _summary_row(rec: dict) -> dict:
        return {
            "trace": rec.get("trace"),
            "client": rec.get("client"),
            "pool": rec.get("pool"),
            "class": rec.get("klass"),
            "reason": rec.get("reason"),
            "wall_s": rec.get("wall_s"),
            "dominant_hop": rec.get("dominant_hop"),
            "hops": len(rec.get("hops") or []),
            "max_uncertainty_s": rec.get("max_uncertainty_s"),
            "osd": rec.get("osd"),
        }
