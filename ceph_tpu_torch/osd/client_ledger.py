"""Per-tenant op ledger: a bounded sliding-window heavy-hitter
aggregator.

The OSD op path accounts every client op into this table keyed by
``(client, pool, class)`` — IOPS, bytes in/out, errors, and a compact
log2 latency histogram for p99 estimation.  Two properties matter and
both are structural, not best-effort:

- **O(K) memory no matter how many tenants exist.**  The table is a
  space-saving top-K sketch (Metwally et al.): at capacity the
  minimum-count entry is evicted and the newcomer INHERITS its count
  as an error bound, so a true heavy hitter entering late still climbs
  past the noise floor instead of being re-evicted every op.  Evicted
  mass (and every op that never earns a slot) accumulates into one
  ``other`` bucket, so totals — and therefore shares — stay exact even
  though per-tenant counts are approximate for the tail.

- **A sliding window, not since-boot totals.**  Two half-window
  buckets rotate: queries merge ``previous + current``, so a dump
  reflects the last one-to-two windows of traffic and an idle tenant
  ages out instead of haunting the top-K forever.  Rotation keeps the
  space-saving counts per half-window, which also bounds the error
  inherited through eviction.

``dump()`` serves the ``dump_client_ledger`` admin command; ``series()``
is the compact row list MPGStats ships to the mgr, where the prometheus
module emits it as ``ceph_client_*`` with the cardinality already
bounded at this source.

Counterpart of ``ceph_tpu/osd/client_ledger.py``, whole.
"""

from __future__ import annotations

import time

# log2 latency buckets: bucket i covers [BASE * 2^i, BASE * 2^(i+1)),
# 1us granularity at the bottom, ~1 hour at the top — p99 reads the
# upper edge of the bucket where the cumulative count crosses 99%
_LAT_BASE = 1e-6
_LAT_BUCKETS = 32


def _lat_bucket(lat: float) -> int:
    n = int(lat / _LAT_BASE)
    if n <= 0:
        return 0
    return min(_LAT_BUCKETS - 1, n.bit_length() - 1)


def _hist_quantile(hist: list[int], q: float) -> float:
    total = sum(hist)
    if total <= 0:
        return 0.0
    want = q * total
    seen = 0
    for i, c in enumerate(hist):
        seen += c
        if seen >= want:
            return _LAT_BASE * (2 ** (i + 1))
    return _LAT_BASE * (2 ** _LAT_BUCKETS)


class _Entry:
    __slots__ = ("ops", "error", "bytes_in", "bytes_out", "errs",
                 "lat_sum", "lat_hist")

    def __init__(self, inherited: int = 0):
        # space-saving: ``ops`` includes the inherited floor; ``error``
        # records how much of it is the predecessor's, so dumps can say
        # "at most this overcounted"
        self.ops = inherited
        self.error = inherited
        self.bytes_in = 0
        self.bytes_out = 0
        self.errs = 0
        self.lat_sum = 0.0
        self.lat_hist = [0] * _LAT_BUCKETS

    def merged(self, other: "_Entry | None") -> "_Entry":
        if other is None:
            return self
        m = _Entry()
        m.ops = self.ops + other.ops
        m.error = self.error + other.error
        m.bytes_in = self.bytes_in + other.bytes_in
        m.bytes_out = self.bytes_out + other.bytes_out
        m.errs = self.errs + other.errs
        m.lat_sum = self.lat_sum + other.lat_sum
        m.lat_hist = [a + b for a, b in zip(self.lat_hist,
                                            other.lat_hist)]
        return m


class ClientLedger:
    """Space-saving top-K per-(client, pool, class) op accounting with
    a two-bucket sliding window.  ``perf`` (optional) is the OSD's
    ``client`` PerfCounters family — evictions/rotations tick there so
    the sketch's health is itself observable."""

    def __init__(self, topk: int = 128, window: float = 10.0,
                 perf=None, clock=time.monotonic):
        self.topk = max(1, int(topk))
        self.window = max(0.1, float(window))
        self.perf = perf
        self._clock = clock
        self._cur: dict[tuple, _Entry] = {}
        self._prev: dict[tuple, _Entry] = {}
        self._cur_other = _Entry()
        self._prev_other = _Entry()
        self._cur_start = clock()
        self._prev_start = self._cur_start
        self.evictions = 0

    # -- live reconfiguration (osd_client_ledger_topk observer) -------
    def set_topk(self, k: int) -> None:
        self.topk = max(1, int(k))
        for table, other in ((self._cur, self._cur_other),
                             (self._prev, self._prev_other)):
            while len(table) > self.topk:
                victim = min(table, key=lambda kk: table[kk].ops)
                self._fold_into(other, table.pop(victim))

    def _fold_into(self, other: _Entry, e: _Entry) -> None:
        # only the REAL mass folds into the tail bucket: the inherited
        # error floor was already counted when ITS predecessor folded,
        # and double-counting it would inflate totals every eviction
        other.ops += max(0, e.ops - e.error)
        other.bytes_in += e.bytes_in
        other.bytes_out += e.bytes_out
        other.errs += e.errs
        other.lat_sum += e.lat_sum
        other.lat_hist = [a + b for a, b in zip(other.lat_hist,
                                                e.lat_hist)]

    def _rotate(self, now: float) -> None:
        # half-window rotation: queries merge prev+cur, so the visible
        # window slides between 1x and 2x ``window/2``… keeping the
        # arithmetic simple, each bucket spans window/2
        half = self.window / 2.0
        if now - self._cur_start < half:
            return
        if now - self._cur_start >= 2 * half:
            # idle long enough that both buckets are stale
            self._prev = {}
            self._prev_other = _Entry()
            self._prev_start = now - half
        else:
            self._prev = self._cur
            self._prev_other = self._cur_other
            self._prev_start = self._cur_start
        self._cur = {}
        self._cur_other = _Entry()
        self._cur_start = now

    # -- the hot-path entry point --------------------------------------
    def account(self, client, pool, klass: str = "client", *,
                ops: int = 1, bytes_in: int = 0, bytes_out: int = 0,
                lat: float | None = None, err: bool = False) -> None:
        now = self._clock()
        self._rotate(now)
        key = (client, pool, klass)
        e = self._cur.get(key)
        if e is None:
            if len(self._cur) >= self.topk:
                victim = min(self._cur,
                             key=lambda kk: self._cur[kk].ops)
                floor = self._cur[victim].ops
                self._fold_into(self._cur_other,
                                self._cur.pop(victim))
                e = _Entry(inherited=floor)
                self.evictions += 1
                if self.perf is not None:
                    self.perf.inc("ledger_evictions")
            else:
                e = _Entry()
            self._cur[key] = e
        e.ops += ops
        e.bytes_in += bytes_in
        e.bytes_out += bytes_out
        if err:
            e.errs += 1
        if lat is not None:
            e.lat_sum += lat
            e.lat_hist[_lat_bucket(lat)] += 1
        if self.perf is not None:
            self.perf.inc("accounted_ops", ops)

    # -- window-merged views -------------------------------------------
    def _merged(self, now: float) -> tuple[dict[tuple, _Entry],
                                           _Entry, float]:
        self._rotate(now)
        merged: dict[tuple, _Entry] = {}
        for key, e in self._cur.items():
            merged[key] = e.merged(self._prev.get(key))
        for key, e in self._prev.items():
            if key not in merged:
                merged[key] = e
        other = self._cur_other.merged(self._prev_other)
        elapsed = max(1e-9, now - self._prev_start)
        return merged, other, elapsed

    def series(self) -> list[dict]:
        """Bounded row list for MPGStats -> mgr prometheus: absolute
        in-window totals plus derived rates.  ``client`` is the u64
        tenant id (or the string ``"other"`` for the evicted tail —
        the ONLY non-enumerated label value, and it is a constant)."""
        now = self._clock()
        merged, other, elapsed = self._merged(now)
        rows = []
        for (client, pool, klass), e in merged.items():
            rows.append(self._row(client, pool, klass, e, elapsed))
        rows.sort(key=lambda r: r["ops"], reverse=True)
        if other.ops or other.bytes_in or other.bytes_out:
            rows.append(self._row("other", -1, "other", other, elapsed))
        return rows

    @staticmethod
    def _row(client, pool, klass, e: _Entry, elapsed: float) -> dict:
        return {
            "client": client,
            "pool": pool,
            "class": klass,
            "ops": e.ops,
            "error": e.error,
            "bytes_in": e.bytes_in,
            "bytes_out": e.bytes_out,
            "errs": e.errs,
            "ops_per_sec": round(e.ops / elapsed, 3),
            "bytes_per_sec": round(
                (e.bytes_in + e.bytes_out) / elapsed, 1),
            "lat_avg_s": round(e.lat_sum / e.ops, 9) if e.ops else 0.0,
            "p99_s": round(_hist_quantile(e.lat_hist, 0.99), 9),
        }

    def dump(self) -> dict:
        """The ``dump_client_ledger`` admin-command body: rows with
        share-of-window, the tail bucket, and sketch health."""
        now = self._clock()
        merged, other, elapsed = self._merged(now)
        total_ops = sum(e.ops for e in merged.values()) + other.ops
        rows = []
        for (client, pool, klass), e in sorted(
                merged.items(), key=lambda kv: kv[1].ops,
                reverse=True):
            row = self._row(client, pool, klass, e, elapsed)
            row["share"] = round(e.ops / total_ops, 4) if total_ops \
                else 0.0
            rows.append(row)
        orow = self._row("other", -1, "other", other, elapsed)
        orow["share"] = round(other.ops / total_ops, 4) if total_ops \
            else 0.0
        return {
            "window_s": self.window,
            "topk": self.topk,
            "entries": len(merged),
            "evictions": self.evictions,
            "total_ops": total_ops,
            "clients": rows,
            "other": orow,
        }

    def top_client(self) -> tuple[object, float] | None:
        """(client id, share) of the heaviest tenant in-window, tail
        bucket included in the denominator — None when idle."""
        now = self._clock()
        merged, other, elapsed = self._merged(now)
        if not merged:
            return None
        per_client: dict = {}
        for (client, _pool, _klass), e in merged.items():
            per_client[client] = per_client.get(client, 0) + e.ops
        total = sum(per_client.values()) + other.ops
        if total <= 0:
            return None
        top = max(per_client, key=lambda c: per_client[c])
        return top, per_client[top] / total

    def entry_count(self) -> int:
        """Live table size (both half-window buckets) — the number the
        O(K) memory-bound test pins."""
        return len(self._cur) + len(self._prev)
