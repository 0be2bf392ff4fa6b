"""The port's mgr against the reference's.

- **Twins** of the reference's own unit tests that need no
  ``MiniCluster``: every test of ``tests/test_tsdb.py``, ``TestTraceStore``
  and ``TestPrometheusExemplars`` of ``tests/test_trace_tail.py``, and the
  three unit tests of ``tests/test_prometheus.py``, on the port's
  ``TimeSeriesStore``, ``TraceStore`` and ``PrometheusModule``.
- **Module outputs**: a port and a reference ``MgrDaemon`` fed the same
  ``MPGStats`` / ``MDaemonStats`` messages (and the same map) answer
  ``status``, ``df``, ``osd df``, ``pg dump``, ``pg query``, ``metrics
  query|ls|stats``, ``client ledger``, ``trace ls|summary`` and the
  prometheus ``metrics`` with equal bodies; the clocks of both are one
  test clock, and the mgr names are masked.
- **The mgr with a port mon** (twins of ``tests/test_mgr.py``'s
  ``test_beacon_makes_active``, ``test_failover_to_standby`` and
  ``test_operator_mgr_fail``, on the mon and the mgrs alone): a beacon
  makes a mgr active and a second one standby; a dead active mgr's
  standby takes over and a daemon's reports follow it; ``mgr fail``
  leaves no active mgr.  The cases that need OSDs wait for the port's
  OSD (ROADMAP).

Tolerances: exact, as in the reference's tests.  Every async body runs
under ``asyncio.wait_for``.
"""

import asyncio
import json
import math

import pytest

from ceph_tpu_torch.common import PerfCountersCollection
from ceph_tpu_torch.mgr.modules import PrometheusModule, _prom_escape
from ceph_tpu_torch.mgr.trace_store import TraceStore
from ceph_tpu_torch.mgr.tsdb import TimeSeriesStore

ASYNC_LIMIT_S = 60.0


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, ASYNC_LIMIT_S)

    return asyncio.run(bounded())


# -- twins of tests/test_tsdb.py -------------------------------------------------


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _mk(step=1.0, retention=600, max_series=4096, clock=None):
    return TimeSeriesStore(step=step, retention=retention,
                           max_series=max_series,
                           clock=clock or _Clock())


def _hist(counts, *, lat_min=1e-4):
    """A 1D latency PerfHistogram dump with the given bucket counts."""
    return {"histogram": {
        "axes": [{"name": "latency", "scale": "log2", "min": lat_min,
                  "buckets": len(counts), "quant": 1.0,
                  "unit": "seconds"}],
        "values": list(counts),
        "count": sum(counts), "sum": 0.0, "sums": [0.0],
    }}


class TestRates:
    def test_rate_matches_hand_computed_delta(self):
        """The acceptance pin: `metrics query` rate == counter
        delta / elapsed, exactly."""
        clk = _Clock(100.0)
        ts = _mk(clock=clk)
        ts.ingest("osd.0", {"osd": {"op": 100}})
        clk.t = 110.0
        ts.ingest("osd.0", {"osd": {"op": 160}})
        clk.t = 110.5
        q = ts.query("osd.op", window=30.0)
        assert q["value"] == (160 - 100) / (110.0 - 100.0)
        assert q["daemons"] == {"osd.0": 6.0}

    def test_first_sight_contributes_no_rate(self):
        """A counter's entire pre-observation value must not read as a
        burst at first ingest."""
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.ingest("osd.0", {"osd": {"op": 1_000_000}})
        clk.t += 5.0
        ts.ingest("osd.0", {"osd": {"op": 1_000_010}})
        q = ts.query("osd.op", window=30.0)
        assert q["value"] == 10 / 5.0

    def test_survives_perf_reset(self):
        """A mid-window reset (counter drops) re-bases instead of
        producing a negative rate; post-reset accumulation counts."""
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.ingest("osd.0", {"osd": {"op": 100}})
        clk.t += 10.0
        ts.ingest("osd.0", {"osd": {"op": 160}})   # +60
        clk.t += 10.0
        ts.ingest("osd.0", {"osd": {"op": 40}})    # reset: +40
        clk.t += 10.0
        ts.ingest("osd.0", {"osd": {"op": 70}})    # +30
        q = ts.query("osd.op", window=60.0)
        assert math.isclose(q["value"], (60 + 40 + 30) / 30.0,
                            rel_tol=1e-6)
        assert q["value"] > 0

    def test_aggregates_across_daemons(self):
        clk = _Clock()
        ts = _mk(clock=clk)
        for d in ("osd.0", "osd.1"):
            ts.ingest(d, {"osd": {"op": 0}})
        clk.t += 10.0
        ts.ingest("osd.0", {"osd": {"op": 100}})
        ts.ingest("osd.1", {"osd": {"op": 50}})
        q = ts.query("osd.op", window=30.0)
        assert q["value"] == 15.0
        assert ts.query("osd.op", window=30.0,
                        daemon="osd.1")["value"] == 5.0

    def test_avg_derivation(self):
        """Avg pairs split at insert; derive=avg recombines the
        windowed deltas: Δsum/Δcount, not the lifetime average."""
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.ingest("osd.0", {"osd": {"op_latency": {
            "avgcount": 100, "sum": 10.0, "avg": 0.1}}})
        clk.t += 10.0
        ts.ingest("osd.0", {"osd": {"op_latency": {
            "avgcount": 150, "sum": 60.0, "avg": 0.4}}})
        q = ts.query("osd.op_latency", window=30.0, derive="avg")
        # windowed: Δsum=50 over Δcount=50 -> 1.0s (lifetime avg 0.4)
        assert q["value"] == 1.0

    def test_value_derive_reads_latest_raw(self):
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.ingest("osd.0", {"osd": {"numpg": 8}})
        clk.t += 2.0
        ts.ingest("osd.0", {"osd": {"numpg": 6}})
        q = ts.query("osd.numpg", window=30.0, derive="value")
        assert q["value"] == 6


class TestHistograms:
    def test_p99_and_slow_frac_derived_at_insert(self):
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.slow_threshold = 0.05
        # first sight: counts ARE the window
        counts = [0] * 16
        counts[2] = 98   # fast bucket (upper 4e-4)
        counts[12] = 2   # slow bucket (upper 1e-4 * 2^12 = 0.4096)
        ts.ingest("osd.0", {"osd": {"op_latency_histogram":
                                    _hist(counts)}})
        q = ts.query("osd.op_latency_histogram.slow_frac",
                     window=30.0, derive="value")
        assert math.isclose(q["value"], 2 / 100)
        p99 = ts.query("osd.op_latency_histogram.p99",
                       window=30.0, derive="value")
        assert math.isclose(p99["value"], 1e-4 * 2 ** 12)

    def test_cumulative_totals_feed_burn_rates(self):
        """.total/.slow_total are counter series over the lifetime
        bucket sums — the burn-rate substrate."""
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.slow_threshold = 0.05
        c1 = [0] * 16
        c1[2] = 100
        ts.ingest("osd.0", {"osd": {"op_latency_histogram": _hist(c1)}})
        clk.t += 10.0
        c2 = list(c1)
        c2[2] = 150
        c2[12] = 10   # 10 new slow ops
        ts.ingest("osd.0", {"osd": {"op_latency_histogram": _hist(c2)}})
        tot = ts.query("osd.op_latency_histogram.total", window=30.0)
        slow = ts.query("osd.op_latency_histogram.slow_total",
                        window=30.0)
        assert tot["value"] == 60 / 10.0
        assert slow["value"] == 10 / 10.0

    def test_2d_grid_flattens_to_last_axis(self):
        clk = _Clock()
        ts = _mk(clock=clk)
        ts.slow_threshold = 0.05
        hist = {"histogram": {
            "axes": [
                {"name": "request_bytes", "scale": "log2", "min": 256.0,
                 "buckets": 2, "quant": 1.0, "unit": "bytes"},
                {"name": "latency", "scale": "log2", "min": 1e-4,
                 "buckets": 16, "quant": 1.0, "unit": "seconds"},
            ],
            "values": [[0] * 16, [0] * 16],
            "count": 4, "sum": 0.0, "sums": [0.0, 0.0],
        }}
        hist["histogram"]["values"][0][2] = 3
        hist["histogram"]["values"][1][12] = 1
        ts.ingest("osd.0", {"osd": {"op_latency_histogram": hist}})
        q = ts.query("osd.op_latency_histogram.slow_frac",
                     window=30.0, derive="value")
        assert math.isclose(q["value"], 1 / 4)


class TestBounds:
    def test_ring_bounded_by_retention(self):
        clk = _Clock()
        ts = _mk(step=1.0, retention=5, clock=clk)
        for i in range(50):
            ts.ingest("osd.0", {"osd": {"op": i}})
            clk.t += 1.0
        s = ts.stats()
        assert s["points"] <= 5

    def test_series_cap_counts_drops(self):
        ts = _mk(max_series=3)
        ts.ingest("osd.0", {"osd": {"a": 1, "b": 2, "c": 3, "d": 4,
                                    "e": 5}})
        s = ts.stats()
        assert s["series"] == 3
        assert s["dropped_series"] == 2

    def test_same_bucket_overwrites(self):
        """Reports landing inside one step bucket must not grow the
        ring — a fast reporter cannot inflate history."""
        clk = _Clock()
        ts = _mk(step=1.0, clock=clk)
        for _ in range(100):
            ts.ingest("osd.0", {"osd": {"op": 1}})
            clk.t += 0.001
        assert ts.stats()["points"] == 1


class TestQueriesMisc:
    def test_ls_globs(self):
        ts = _mk()
        ts.ingest("osd.0", {"osd": {"op": 1, "op_err": 0},
                            "scrub": {"passes": 2}})
        names = {e["metric"] for e in ts.ls("osd.*")}
        assert names == {"osd.op", "osd.op_err"}

    def test_range_buckets(self):
        clk = _Clock()
        ts = _mk(step=1.0, clock=clk)
        for i in range(5):
            ts.ingest("osd.0", {"osd": {"op": i * 10}})
            clk.t += 1.0
        r = ts.range("osd.op", window=60.0)
        assert r["series"] == 1
        # consecutive-bucket rates: 10 ops per 1s step
        assert [v for _t, v in r["points"]] == [10.0] * 4

    def test_non_numeric_and_bool_skipped(self):
        ts = _mk()
        ts.ingest("osd.0", {"osd": {"state": "active", "flag": True,
                                    "op": 1}})
        names = {e["metric"] for e in ts.ls()}
        assert names == {"osd.op"}


# -- twins of tests/test_trace_tail.py ------------------------------------------


def _wf(trace, wall=0.01, reason="slow", client=10, pool=1,
        hop="execute", dur=None):
    """One shipped-waterfall record, in the shape the OSD assembles
    (common/tracing.op_waterfall keys + the keep metadata)."""
    return {
        "trace": trace, "client": client, "pool": pool,
        "klass": "client", "reason": reason, "wall_s": wall,
        "path_sum_s": wall, "span_s": wall, "max_uncertainty_s": 0.0,
        "dominant_hop": hop,
        "hops": [{"hop": hop, "entity": "osd.0", "start_s": 0.0,
                  "dur_s": dur if dur is not None else wall}],
    }


class TestTraceStore:
    def test_ring_evicts_oldest_and_counts(self):
        ts = TraceStore(capacity=3)
        for i in range(5):
            ts.ingest(_wf(f"t{i}"))
        assert ts.stats() == {"size": 3, "capacity": 3,
                              "ingested": 5, "evictions": 2}
        assert ts.get("t0") is None and ts.get("t1") is None
        assert ts.get("t4")["trace"] == "t4"

    def test_reingest_replaces_and_refreshes_recency(self):
        """The same op kept by two reporting OSDs (or a resent report)
        must not double count or age out early."""
        ts = TraceStore(capacity=2)
        ts.ingest(_wf("a", wall=0.01))
        ts.ingest(_wf("b"))
        ts.ingest(_wf("a", wall=0.02))  # replace in place, refresh
        assert ts.stats()["size"] == 2
        assert ts.stats()["evictions"] == 0
        assert ts.get("a")["wall_s"] == 0.02
        ts.ingest(_wf("c"))  # b is now the oldest, not a
        assert ts.get("b") is None and ts.get("a") is not None

    def test_ls_filters_newest_first(self):
        ts = TraceStore()
        ts.ingest(_wf("t1", client=1, pool=1, hop="execute"))
        ts.ingest(_wf("t2", client=2, pool=1, hop="wire"))
        ts.ingest(_wf("t3", client=1, pool=2, hop="execute"))
        assert [r["trace"] for r in ts.ls()] == ["t3", "t2", "t1"]
        assert [r["trace"] for r in ts.ls(client=1)] == ["t3", "t1"]
        assert [r["trace"] for r in ts.ls(pool=1)] == ["t2", "t1"]
        assert [r["trace"] for r in ts.ls(hop="wire")] == ["t2"]
        assert [r["trace"] for r in ts.ls(limit=1)] == ["t3"]

    def test_top_is_slowest_first(self):
        ts = TraceStore()
        for trace, wall in (("a", 0.01), ("b", 0.5), ("c", 0.1)):
            ts.ingest(_wf(trace, wall=wall))
        assert [r["trace"] for r in ts.top(2)] == ["b", "c"]

    def test_summary_reasons_and_dominant_hops(self):
        ts = TraceStore()
        ts.ingest(_wf("a", wall=0.2, reason="slow", hop="execute"))
        ts.ingest(_wf("b", wall=0.3, reason="slow", hop="execute"))
        ts.ingest(_wf("c", wall=0.1, reason="baseline", hop="wire"))
        s = ts.summary()
        assert s["traces"] == 3
        assert s["reasons"] == {"slow": 2, "baseline": 1}
        assert s["dominant_hops"][0]["hop"] == "execute"
        assert s["dominant_hops"][0]["count"] == 2
        assert s["dominant_hops"][0]["wall_max_s"] == 0.3

    def test_exemplars_prefer_anomalies_over_baseline(self):
        """A slow baseline sample must not displace anomaly keeps —
        SLO_BURN should cite the op that burned the budget."""
        ts = TraceStore()
        ts.ingest(_wf("base", wall=1.0, reason="baseline"))
        ts.ingest(_wf("slow", wall=0.1, reason="slow"))
        ts.ingest(_wf("err", wall=0.05, reason="error"))
        assert ts.exemplars(3) == ["slow", "err", "base"]
        assert ts.exemplars(1) == ["slow"]

    def test_exemplar_for_matches_bucket_bounds(self):
        ts = TraceStore()
        ts.ingest(_wf("t1", hop="execute", dur=0.003))
        assert ts.exemplar_for("execute", 0.002, 0.004) == ("t1", 0.003)
        assert ts.exemplar_for("execute", 0.004, 0.008) is None
        assert ts.exemplar_for("wire", 0.0, 1.0) is None


class TestPrometheusExemplars:
    def test_bucket_lines_carry_trace_exemplars(self):
        """stack.lat_* bucket series gain OpenMetrics exemplar
        annotations keyed by trace id when the mgr's store holds a
        kept trace whose span lands in that bucket."""
        from ceph_tpu_torch.common import stack_ledger

        stack_ledger.feed_hop("execute", 0.003)
        mgr = _FakeMgr(osd_stats={
            0: {"perf": {"stack": stack_ledger.stack_perf().dump()}},
        })
        mgr.trace_store = TraceStore()
        mgr.trace_store.ingest(_wf("wf-ex-1", hop="execute", dur=0.003))
        lines = _metrics(mgr).splitlines()
        annotated = [
            ln for ln in lines
            if ln.startswith("ceph_stack_lat_execute_bucket")
            and '# {trace_id="wf-ex-1"}' in ln
        ]
        assert annotated, "no exemplar-annotated execute bucket"
        # the annotation rides AFTER the sample value, OpenMetrics-style
        assert annotated[0].split(" # ")[0].split()[-1].replace(
            ".", "").isdigit()
        # non-stack families stay annotation-free
        assert not any(
            "trace_id=" in ln for ln in lines
            if not ln.startswith("ceph_stack_lat_")
        )


# -- twins of tests/test_prometheus.py ------------------------------------------


class _FakeMgr:
    """Just enough MgrDaemon surface for PrometheusModule.metrics."""

    def __init__(self, osd_stats=None, daemon_stats=None):
        self.osdmap = None
        self.name = "mgr.fake"
        self.perf = PerfCountersCollection()
        self._osd = osd_stats or {}
        self._daemon = daemon_stats or {}

    def live_osd_stats(self):
        return self._osd

    def live_daemon_stats(self):
        return self._daemon

    def pg_summary(self):
        return {}


def _metrics(mgr) -> str:
    _code, _status, out = PrometheusModule().metrics(mgr, {})
    return out


def test_label_escaping():
    assert _prom_escape('a"b') == 'a\\"b'
    assert _prom_escape("a\\b") == "a\\\\b"
    assert _prom_escape("a\nb") == "a\\nb"
    mgr = _FakeMgr(daemon_stats={
        'rgw."zone\\one"\n': {"perf": {"rgw": {"req_get": 3}}},
    })
    out = _metrics(mgr)
    assert ('ceph_rgw_req_get{daemon="rgw.\\"zone\\\\one\\"\\n"} 3'
            in out.splitlines())


def test_avg_pairs_flatten_to_sum_count_avg():
    mgr = _FakeMgr(osd_stats={
        0: {"perf": {"osd": {
            # dump form (dict) and legacy raw-pair form (list)
            "op_latency": {"avgcount": 4, "sum": 2.0, "avg": 0.5,
                           "min": 0.1, "max": 0.9},
            "old_pair": [6.0, 3, 1.0, 3.0],
            "zero_avg": {"avgcount": 0, "sum": 0.0},
        }}},
    })
    lines = _metrics(mgr).splitlines()
    assert 'ceph_osd_op_latency_sum{daemon="osd.0"} 2.0' in lines
    assert 'ceph_osd_op_latency_count{daemon="osd.0"} 4' in lines
    assert 'ceph_osd_op_latency{daemon="osd.0"} 0.5' in lines
    assert 'ceph_osd_old_pair{daemon="osd.0"} 2.0' in lines
    # an empty average exports 0.0, never a ZeroDivisionError
    assert 'ceph_osd_zero_avg{daemon="osd.0"} 0.0' in lines


def test_non_numeric_values_skipped():
    mgr = _FakeMgr(daemon_stats={
        "mon.0": {"perf": {"mon": {"commands": 2, "flavor": "classic"}}},
    })
    out = _metrics(mgr)
    assert 'ceph_mon_commands{daemon="mon.0"} 2' in out
    assert "flavor" not in out


# -- module outputs equal the reference's ------------------------------------------


class _TestClock:
    """One clock for both mgrs: ``time.monotonic`` of their modules."""

    def __init__(self, t: float = 5000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def __getattr__(self, name):
        import time

        return getattr(time, name)


def _cluster_map():
    """Six OSDs, one down and out, a replicated and an ISA pool; the
    reference's map is the port's through the wire dict."""
    from ceph_tpu_torch.crush.map import CrushMap
    from ceph_tpu_torch.osd.osdmap import OSDMap

    m = OSDMap(CrushMap.flat(6))
    m.set_max_osd(6)
    for o in range(6):
        m.create_osd(o, f"127.0.0.1:{6800 + o}")
        m.mark_up(o, f"127.0.0.1:{6800 + o}")
        m.mark_in(o)
    m.create_replicated_pool("rbd", size=3, pg_num=8)
    m.set_erasure_code_profile("isa21", {"plugin": "isa", "k": "2", "m": "1"})
    m.create_erasure_pool("ecpool", "isa21", pg_num=8)
    m.mark_down(5)
    m.mark_out(5)
    m.epoch = 9
    return m


def _reports(m, round_):
    """(MPGStats fields per OSD, MDaemonStats fields per daemon) of one
    report round: every live OSD reports the PGs it leads."""
    from ceph_tpu_torch.osd.osdmap import PGid

    led = {}
    for pid, pool in sorted(m.pools.items()):
        for seed in range(pool.pg_num):
            pg = PGid(pid, seed)
            _up, _upp, _acting, primary = m.pg_to_up_acting_osds(pg)
            if primary >= 0:
                led.setdefault(primary, {})[str(pg)] = {
                    "objects": 3 * seed + round_, "bytes": 4096 * (seed + 1) * (round_ + 1),
                    "primary": primary, "state": "active+clean",
                }
    hist = {"histogram": {
        "axes": [{"name": "latency", "scale": "log2", "min": 1e-6, "buckets": 8,
                  "quant": 1.0, "unit": "seconds"}],
        "values": [0, 1 + round_, 4, 2 * round_, 0, 1, 0, 0],
        "count": 8 + 3 * round_, "sum": 0.01, "sums": [0.01]}}
    osds = {}
    for osd, pgs in sorted(led.items()):
        osds[osd] = dict(
            osd=osd, epoch=m.epoch, pgs=pgs,
            perf={"osd": {"op": 100 * (osd + 1) * (round_ + 1),
                          "op_in_bytes": 1 << (20 + round_ + osd % 3),
                          "op_out_bytes": 1 << (18 + round_),
                          "op_latency": {"avgcount": 4 + round_, "sum": 0.02 * (round_ + 1)},
                          "flavor": "classic"},
                  "ec": {"encode_calls": 7 * (round_ + 1), "encode_bytes": 1 << 22},
                  "stack": {"lat_execute": hist},
                  "accel@1": {"remote_batches": 3 + round_}},
            store={"bytes_used": 1000 * (osd + 1) * (round_ + 1), "objects": 10 + osd},
            ledger=[{"client": "client.4", "pool": 1, "class": "client",
                     "ops_per_sec": 12.5 + round_, "bytes_per_sec": 4096.0,
                     "p99_s": 0.004, "errs": round_}],
            traces=[{"trace": f"client.4:t{osd}{round_}", "client": 4, "pool": 1,
                     "klass": "client", "reason": "slow" if osd % 2 else "baseline",
                     "wall_s": 0.01 * (osd + 1), "path_sum_s": 0.01, "span_s": 0.01,
                     "max_uncertainty_s": 0.0, "dominant_hop": "execute",
                     "hops": [{"hop": "execute", "entity": f"osd.{osd}",
                               "start_s": 0.0, "dur_s": 0.003}]}],
        )
    daemons = {
        "mon.0": {"mon": {"commands": 4 + round_, "map_epoch": m.epoch}},
        "accel.a": {"ec": {"encode_calls": 11 + round_, "encode_bytes": 1 << 24},
                    "accel": {"beacons": 20 + round_, "clients": 4}},
    }
    return osds, daemons


def _mgr_of(pkg_daemon, pkg_messages, pkg_config, osdmap_cls, m, clock, monkeypatch):
    for mod in (pkg_daemon,) + tuple(
            __import__(f"{pkg_daemon.__package__}.{n}", fromlist=["x"])
            for n in ("modules", "trace_store")):
        monkeypatch.setattr(mod, "time", clock)
    mgr = pkg_daemon.MgrDaemon("mgr.x", "127.0.0.1:1", config=pkg_config(env=""))
    mgr.tsdb._clock = clock.monotonic
    mgr.osdmap = osdmap_cls.from_dict(json.loads(json.dumps(m.to_dict())))
    mgr.osdmap.mgr_name = "mgr.x"
    mgr.active = True
    return mgr


MGR_COMMANDS = [
    {"prefix": "status"},
    {"prefix": "health"},
    {"prefix": "df"},
    {"prefix": "osd df"},
    {"prefix": "pg dump"},
    {"prefix": "pg query", "pgid": "1.3"},
    {"prefix": "pg query", "pgid": "1.99"},
    {"prefix": "pg ls", "pool": "ecpool"},
    {"prefix": "metrics ls"},
    {"prefix": "metrics ls", "pattern": "osd.*"},
    {"prefix": "metrics query", "metric": "osd.op", "window": 30},
    {"prefix": "metrics query", "metric": "stack.lat_execute.p99", "derive": "value"},
    {"prefix": "metrics range", "metric": "osd.op", "window": 30},
    {"prefix": "metrics stats"},
    {"prefix": "client ledger"},
    {"prefix": "trace ls"},
    {"prefix": "trace top"},
    {"prefix": "trace summary"},
    {"prefix": "trace show", "trace": "client.4:t11"},
    {"prefix": "metrics"},
    {"prefix": "mgr module ls"},
    {"prefix": "no such command"},
]


@pytest.mark.parametrize("cmd", MGR_COMMANDS, ids=[
    " ".join(str(v) for v in c.values()) for c in MGR_COMMANDS])
def test_module_outputs_equal_the_references(cmd, monkeypatch):
    """The same map and the same two report rounds, one second apart,
    into a port and a reference mgr: every module's body is equal."""
    from ceph_tpu.common.config import Config as RefConfig
    from ceph_tpu.mgr import daemon as ref_daemon
    from ceph_tpu.msg import messages as ref_messages
    from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap

    from ceph_tpu_torch.common import Config
    from ceph_tpu_torch.mgr import daemon
    from ceph_tpu_torch.msg import messages
    from ceph_tpu_torch.osd.osdmap import OSDMap

    m = _cluster_map()
    clock = _TestClock()
    port = _mgr_of(daemon, messages, Config, OSDMap, m, clock, monkeypatch)
    ref = _mgr_of(ref_daemon, ref_messages, RefConfig, RefOSDMap, m, clock, monkeypatch)

    async def feed():
        for round_ in range(2):
            osds, daemons = _reports(m, round_)
            for mgr, msgs in ((port, messages), (ref, ref_messages)):
                for fields in osds.values():
                    await mgr.ms_dispatch(None, msgs.MPGStats(**json.loads(json.dumps(fields))))
                for name, perf in daemons.items():
                    await mgr.ms_dispatch(None, msgs.MDaemonStats(name=name, perf=perf))
            clock.t += 1.0

    run(feed())
    got = port.handle_command(dict(cmd))
    want = ref.handle_command(dict(cmd))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    if cmd["prefix"] == "metrics":
        # every reported ec counter of accel.a exactly once
        lines = got[2].splitlines()
        for key in ("encode_calls", "encode_bytes"):
            assert sum(ln.startswith(f'ceph_ec_{key}{{daemon="accel.a"}} ')
                       for ln in lines) == 1
    elif cmd["prefix"] == "status":
        assert got[0] == 0 and got[2]["pgmap"]["num_objects"] > 0


# -- the mgr with a port mon (twins of tests/test_mgr.py) ------------------------------


async def _mon_and(n_mgrs, mgr_overrides=None):
    from ceph_tpu_torch.common import Config
    from ceph_tpu_torch.mgr import MgrDaemon
    from ceph_tpu_torch.mon import Monitor

    mon = Monitor(config=Config(env=""))
    await mon.start()
    mgrs = {}
    for i in range(n_mgrs):
        name = ("mgr.x", "mgr.y")[i]
        mgrs[name] = MgrDaemon(name, mon.addr,
                               config=Config(mgr_overrides or {}, env=""))
    return mon, mgrs


async def _wait(pred, timeout=15.0):
    async with asyncio.timeout(timeout):
        while not pred():
            await asyncio.sleep(0.01)


async def _active(mon, mgrs, timeout=10.0):
    await _wait(lambda: mon.osdmap.mgr_name in mgrs
                and mgrs[mon.osdmap.mgr_name].active, timeout)
    return mon.osdmap.mgr_name


class TestMgrLifecycle:
    def test_beacon_makes_active(self):
        async def main():
            mon, mgrs = await _mon_and(2)
            try:
                mgr = mgrs["mgr.x"]
                await mgr.start()
                assert await _active(mon, mgrs) == "mgr.x"
                assert mon.osdmap.mgr_addr == mgr.addr
                # a second mgr becomes a standby
                await mgrs["mgr.y"].start()
                await _wait(lambda: [n for n, _ in mon.osdmap.mgr_standbys] == ["mgr.y"])
                await asyncio.sleep(0.3)
                assert mon.osdmap.mgr_name == "mgr.x"
                assert not mgrs["mgr.y"].active
            finally:
                for m in mgrs.values():
                    await m.stop()
                await mon.stop()

        run(main())

    def test_failover_to_standby(self):
        """A dead active mgr: the mon's beacon-staleness tick promotes
        the standby, and a daemon's reports re-target it."""
        from ceph_tpu_torch.accel import AccelDaemon
        from ceph_tpu_torch.common import Config

        async def main():
            mon, mgrs = await _mon_and(2)
            acc = AccelDaemon("accel.7", mon_addr=mon.addr, device="cpu",
                              config=Config({"accel_mgr_report_interval": 0.1}, env=""))
            try:
                await mgrs["mgr.x"].start()
                await _active(mon, mgrs)
                await mgrs["mgr.y"].start()
                await acc.start()
                await _wait(lambda: "accel.7" in mgrs["mgr.x"].daemon_stats)
                await mgrs.pop("mgr.x").stop()
                await _wait(lambda: mon.osdmap.mgr_name == "mgr.y")
                assert await _active(mon, mgrs) == "mgr.y"
                await _wait(lambda: "accel.7" in mgrs["mgr.y"].daemon_stats)
                perf = mgrs["mgr.y"].daemon_stats["accel.7"]["perf"]
                assert "ec" in perf and "accel" in perf
            finally:
                await acc.stop()
                for m in mgrs.values():
                    await m.stop()
                await mon.stop()

        run(main())

    def test_operator_mgr_fail(self):
        from tests.test_torch_mon import Client

        async def main():
            # one beacon, at start: none can re-register the mgr
            # between the fail and the read of the map
            mon, mgrs = await _mon_and(1, {"mgr_beacon_interval": 30.0})
            cl = Client("client.admin")
            try:
                await mgrs["mgr.x"].start()
                await _active(mon, mgrs)
                conn = await cl.messenger.connect(mon.addr, "mon")
                code, _s, _o = await cl.command(conn, {"prefix": "mgr fail"})
                assert code == 0
                assert mon.osdmap.mgr_name == ""
            finally:
                await cl.messenger.shutdown()
                for m in mgrs.values():
                    await m.stop()
                await mon.stop()

        run(main())
