"""Built-in mgr modules (reference:src/pybind/mgr/ — status, df,
prometheus; pg dump comes from the reference's PGMap served via mgr).

Counterpart of ``ceph_tpu/mgr/modules.py``, whole: every module's body
equals the reference's for the same reports."""

from __future__ import annotations

import time
from typing import Any

from .daemon import MgrDaemon, MgrModule


_SEVERITIES = ("HEALTH_OK", "HEALTH_WARN", "HEALTH_ERR")


def _pg_state(pool, acting: list) -> str:
    """The pg state string both `pg ls` and `pg query` report — one
    derivation, or the two commands drift."""
    _alive, degraded, below = _pg_redundancy(pool, acting)
    if below:
        return "down"
    if degraded:
        return "active+undersized+degraded"
    return "active+clean"


def _pg_redundancy(pool, acting: list) -> tuple[int, bool, bool]:
    """(alive, degraded, below_min_size) for one pg's acting set — the
    SINGLE copy of the classification `ceph health` and `ceph pg
    query` share.  Replicated acting DROPS down osds; EC acting keeps
    NONE holes — in both cases alive < pool.size is degraded."""
    from ..osd.osdmap import CRUSH_ITEM_NONE

    alive = sum(1 for o in acting if o != CRUSH_ITEM_NONE)
    return alive, alive < pool.size, alive < pool.min_size


def _worst_severity(checks: list[dict]) -> str:
    return max((c["severity"] for c in checks),
               key=_SEVERITIES.index, default="HEALTH_OK")


def _cluster_health(mgr) -> tuple[str, list[dict]]:
    """(overall, checks) for the current map + reports; the single
    source for `ceph status`, `ceph health` and the prometheus gauge."""
    m = mgr.osdmap
    checks = _health_checks(
        m, mgr,
        up=sum(1 for o in range(m.max_osd) if m.is_up(o)),
        inn=sum(1 for o in range(m.max_osd) if m.is_in(o)),
        exists=sum(1 for o in range(m.max_osd) if m.exists(o)),
    )
    return _worst_severity(checks), checks


def _health_checks(m, mgr, *, up: int, inn: int, exists: int) -> list[dict]:
    """Structured health checks (the reference's health system: mon/
    PGMonitor summaries at this version, reported with the later
    stable check codes — OSD_DOWN, PG_DEGRADED, PG_AVAILABILITY,
    OSD_SCRUB_ERRORS).  Each check: {code, severity, summary}."""
    checks: list[dict] = []
    down = exists - up
    if down > 0:
        checks.append({
            "code": "OSD_DOWN", "severity": "HEALTH_WARN",
            "summary": f"{down} osds down",
        })
    if m.cluster_flags:
        # `osd set pause/noscrub/...` changes cluster behavior — the
        # operator must see it in health, not just the scrolled-away
        # clog line (reference: OSDMAP_FLAGS check)
        checks.append({
            "code": "OSDMAP_FLAGS", "severity": "HEALTH_WARN",
            "summary": (
                f"{','.join(sorted(m.cluster_flags))} flag(s) set"
            ),
        })
    from ..osd.osdmap import FLAG_FULL_QUOTA

    full_pools = [p.name for p in m.pools.values()
                  if p.flags & FLAG_FULL_QUOTA]
    if full_pools:
        checks.append({
            "code": "POOL_FULL", "severity": "HEALTH_WARN",
            "summary": (
                f"pool(s) {', '.join(sorted(full_pools))} full (quota)"
            ),
        })
    degraded = 0
    unavailable = 0
    for pid, pool in m.pools.items():
        for pg in m.pgs_of_pool(pid):
            _up, _upp, acting, _ap = m.pg_to_up_acting_osds(pg)
            _alive, deg, below = _pg_redundancy(pool, acting)
            if deg:
                degraded += 1
            if below:
                unavailable += 1
    if unavailable:
        checks.append({
            "code": "PG_AVAILABILITY", "severity": "HEALTH_ERR",
            "summary": f"reduced data availability: {unavailable} pgs "
                       "below min_size",
        })
    if degraded:
        checks.append({
            "code": "PG_DEGRADED", "severity": "HEALTH_WARN",
            "summary": f"degraded redundancy: {degraded} pgs degraded",
        })
    outstanding = 0
    slow_ops = 0
    slow_oldest = 0.0
    accel_tripped = 0
    accel_unreachable = 0
    accel_fleet_degraded = 0
    for st in mgr.live_osd_stats().values():
        perf = st.get("perf") or {}
        scrub = perf.get("scrub") or {}
        # the CURRENT-inconsistency gauge, not lifetime counters: the
        # cumulative errors counter re-counts a bad shard every pass
        outstanding += int(scrub.get("unrepaired", 0) or 0)
        osd_perf = perf.get("osd") or {}
        slow_ops += int(osd_perf.get("slow_ops", 0) or 0)
        slow_oldest = max(
            slow_oldest,
            float(osd_perf.get("slow_ops_oldest_sec", 0) or 0),
        )
        # ec.engine_state >= 2 is TRIPPED/PROBING (osd/ec_failover): the
        # OSD serves EC from the host fallback engine — correct bytes,
        # a fraction of device throughput; the operator must see it
        # cluster-wide, not find it in one daemon's log
        ec_perf = perf.get("ec") or {}
        if int(ec_perf.get("engine_state", 0) or 0) >= 2:
            accel_tripped += 1
        # accel.remote_unreachable (osd/ec_perf.py client half): the
        # OSD's shared-accelerator lane is configured but the daemon
        # cannot be reached — EC serves on the local lanes, correct
        # bytes, none of the shared-device amortization the operator
        # deployed the accelerator FOR (accel/daemon.py)
        accel_perf = perf.get("accel") or {}
        if int(accel_perf.get("remote_unreachable", 0) or 0) >= 1:
            accel_unreachable += 1
        # fleet summary (accel/router.py): some — but not
        # all — of this OSD's accelerator fleet is sticky-down.  EC
        # still rides the surviving accels (inter-accel failover), so
        # this is a capacity warning, not the ACCEL_UNREACHABLE outage
        elif (int(accel_perf.get("fleet_down", 0) or 0) >= 1
                and int(accel_perf.get("fleet_up", 0) or 0) >= 1):
            accel_fleet_degraded += 1
    if outstanding:
        checks.append({
            "code": "OSD_SCRUB_ERRORS", "severity": "HEALTH_ERR",
            "summary": f"{outstanding} unrepaired scrub errors",
        })
    if slow_ops:
        # ops past osd_op_complaint_time, from the OSDs' OpTracker
        # gauges (the reference's SLOW_OPS health check fed by
        # check_ops_in_flight)
        checks.append({
            "code": "SLOW_OPS", "severity": "HEALTH_WARN",
            "summary": (
                f"{slow_ops} slow ops, oldest one blocked for "
                f"{slow_oldest:.0f} sec"
            ),
        })
    if accel_tripped:
        checks.append({
            "code": "ACCEL_DEGRADED", "severity": "HEALTH_WARN",
            "summary": (
                f"{accel_tripped} osd(s) serving EC on the fallback "
                "engine (accelerator circuit breaker tripped)"
            ),
        })
    if accel_unreachable:
        checks.append({
            "code": "ACCEL_UNREACHABLE", "severity": "HEALTH_WARN",
            "summary": (
                f"{accel_unreachable} osd(s) cannot reach their shared "
                "EC accelerator (serving EC on local lanes)"
            ),
        })
    if accel_fleet_degraded:
        checks.append({
            "code": "ACCEL_FLEET_DEGRADED", "severity": "HEALTH_WARN",
            "summary": (
                f"{accel_fleet_degraded} osd(s) report part of their "
                "accelerator fleet down (EC riding the surviving "
                "accels)"
            ),
        })
    slo = _slo_burn_check(mgr)
    if slo is not None:
        checks.append(slo)
    return checks


def _dominant_tenant(mgr) -> tuple[object, float] | None:
    """(client id, share-of-window) of the heaviest attributed tenant
    across every OSD's ledger rows — the tail bucket counts in the
    denominator so a diffuse load can't crown a minor client."""
    totals: dict[object, int] = {}
    all_ops = 0
    for st in mgr.live_osd_stats().values():
        for row in st.get("ledger") or []:
            ops = int(row.get("ops", 0) or 0)
            all_ops += ops
            if row.get("class") == "other":
                continue
            c = row.get("client")
            totals[c] = totals.get(c, 0) + ops
    if not totals or all_ops <= 0:
        return None
    top = max(totals, key=lambda c: totals[c])
    return top, totals[top] / all_ops


def _worst_hop(mgr, window: float) -> tuple[str | None, float]:
    """(hop name, windowed slow fraction) of the worst pipeline hop
    from the stack.lat_* histogram-derived counter series — names the
    stage burning the latency budget, not just that it burns."""
    best, best_frac = None, 0.0
    for ent in mgr.tsdb.ls("stack.lat_*.slow_total"):
        m = ent["metric"]
        base = m[: -len(".slow_total")]
        tot = mgr.tsdb.query(f"{base}.total", window=window)["value"]
        if tot <= 0:
            continue
        frac = mgr.tsdb.query(m, window=window)["value"] / tot
        if frac > best_frac:
            best, best_frac = base[len("stack.lat_"):], frac
    return best, best_frac


def _slo_burn_check(mgr) -> dict | None:
    """Multi-window SLO burn-rate evaluation (the SRE-workbook fast/
    slow pattern): both the fast AND slow window must burn budget
    faster than ``mgr_slo_burn_threshold``x before SLO_BURN raises —
    the fast window alone is too noisy, the slow window alone pages
    long after the storm.  Burns also land in the ``slo.*`` gauges so
    prometheus can graph the approach to the threshold."""
    cfg = getattr(mgr, "config", None)
    if cfg is None or getattr(mgr, "tsdb", None) is None:
        # partial mgr (health evaluated against a map-only view, as
        # some callers/fixtures do): no history, no SLO verdict
        return None
    fast = float(cfg.mgr_slo_fast_window)
    slow = float(cfg.mgr_slo_slow_window)
    lat_budget = max(1e-9, float(cfg.mgr_slo_slow_frac_budget))
    fail_budget = max(1e-9, float(cfg.mgr_slo_failure_rate_target))

    def lat_burn(window: float) -> float:
        tot = mgr.tsdb.query("osd.op_latency_histogram.total",
                             window=window)["value"]
        if tot <= 0:
            return 0.0
        sl = mgr.tsdb.query("osd.op_latency_histogram.slow_total",
                            window=window)["value"]
        return (sl / tot) / lat_budget

    def fail_burn(window: float) -> float:
        ops = mgr.tsdb.query("osd.op", window=window)["value"]
        if ops <= 0:
            return 0.0
        errs = mgr.tsdb.query("osd.op_err", window=window)["value"]
        return (errs / ops) / fail_budget

    lf, ls = lat_burn(fast), lat_burn(slow)
    ff, fs = fail_burn(fast), fail_burn(slow)
    pslo = mgr.perf.get("slo")
    if pslo is not None:
        pslo.set("latency_burn_fast", round(lf, 6))
        pslo.set("latency_burn_slow", round(ls, 6))
        pslo.set("failure_burn_fast", round(ff, 6))
        pslo.set("failure_burn_slow", round(fs, 6))
    thr = float(cfg.mgr_slo_burn_threshold)
    lat_hot = lf > thr and ls > thr
    fail_hot = ff > thr and fs > thr
    if not lat_hot and not fail_hot:
        return None
    parts = []
    if lat_hot:
        parts.append(
            f"latency budget burning {lf:.1f}x (fast) / {ls:.1f}x "
            "(slow)"
        )
    if fail_hot:
        parts.append(
            f"failure budget burning {ff:.1f}x (fast) / {fs:.1f}x "
            "(slow)"
        )
    detail = "; ".join(parts)
    dom = _dominant_tenant(mgr)
    if dom is not None:
        detail += (
            f"; dominant client {dom[0]} ({dom[1]:.0%} of ops)"
        )
    hop, frac = _worst_hop(mgr, fast)
    if hop is not None and frac > 0:
        detail += f"; worst hop {hop} ({frac:.0%} slow)"
    ts = getattr(mgr, "trace_store", None)
    if ts is not None:
        # exemplar linkage: name concrete ops from the
        # burning window — anomaly-kept traces first, slowest first —
        # so the operator's next command is `ceph trace show <id>`,
        # not a fishing expedition
        ids = ts.exemplars(3, window=fast)
        if ids:
            detail += f"; exemplar traces {', '.join(map(str, ids))}"
    return {
        "code": "SLO_BURN", "severity": "HEALTH_WARN",
        "summary": detail,
    }


class StatusModule(MgrModule):
    """`ceph -s` body: cluster health + services + data + io summary."""

    NAME = "status"
    COMMANDS = {"status": "status", "health": "status"}

    def status(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        m = mgr.osdmap
        if m is None:
            return 0, "", {"health": "HEALTH_WARN", "detail": "no map yet"}
        up = sum(1 for o in range(m.max_osd) if m.is_up(o))
        inn = sum(1 for o in range(m.max_osd) if m.is_in(o))
        exists = sum(1 for o in range(m.max_osd) if m.exists(o))
        pgs = mgr.pg_summary()
        objects = sum(p.get("objects", 0) for p in pgs.values())
        data = sum(p.get("bytes", 0) for p in pgs.values())
        checks = _health_checks(m, mgr, up=up, inn=inn, exists=exists)
        health = _worst_severity(checks)
        io = {
            "op_per_sec": sum(
                r.get("op_per_sec", 0) for r in mgr.io_rates.values()
            ),
            "rd_bytes_sec": sum(
                r.get("rd_bytes_sec", 0) for r in mgr.io_rates.values()
            ),
            "wr_bytes_sec": sum(
                r.get("wr_bytes_sec", 0) for r in mgr.io_rates.values()
            ),
        }
        return 0, "", {
            "health": health,
            "checks": checks,
            "monmap_epoch": m.epoch,
            "osdmap": {"epoch": m.epoch, "num_osds": exists,
                       "num_up_osds": up, "num_in_osds": inn,
                       "flags": sorted(m.cluster_flags)},
            "mgrmap": {"active": m.mgr_name,
                       "standbys": [n for n, _ in m.mgr_standbys]},
            "mdsmap": {
                # "" = vacant rank (failed, or awaiting a standby):
                # surfaced as-is so the renderer can count ACTIVE ranks
                # honestly instead of branding unfilled slots "failed"
                "ranks": [n for n, _a in m.mds_rank_table()],
                "max_mds": m.mds_max,
                "standbys": [n for n, _ in m.mds_standbys],
            },
            "pgmap": {
                "num_pgs": len(pgs),
                "num_objects": objects,
                "data_bytes": data,
                "num_pools": len(m.pools),
            },
            "io": io,
        }


class OsdDfModule(MgrModule):
    """`ceph osd df`: per-OSD usage + pg count
    (reference:src/mon/OSDMonitor.cc 'osd df' -> print_osd_utilization)."""

    NAME = "osd_df"
    COMMANDS = {"osd df": "osd_df"}

    def osd_df(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        """Per-OSD HOSTED footprint, computed from the map + the
        primaries' per-PG byte counts: every acting member of a PG
        hosts it (replicated: a full copy; EC: ~bytes/k per shard).
        OSD reports alone can't answer this — each OSD reports only
        the PGs it LEADS (counting those made a balanced cluster look
        wildly imbalanced)."""
        import math

        from ..osd.osdmap import CRUSH_ITEM_NONE

        m = mgr.osdmap
        if m is None:
            return 0, "", {"nodes": []}
        pgsum = mgr.pg_summary()
        hosted_pgs: dict[int, int] = {}
        hosted_bytes: dict[int, int] = {}
        for pid, pool in m.pools.items():
            k = 1
            if pool.is_erasure:
                prof = m.erasure_code_profiles.get(
                    pool.erasure_code_profile, {}
                )
                k = max(1, int(prof.get("k", 2)))
            for pg in m.pgs_of_pool(pid):
                _u, _up, acting, _ap = m.pg_to_up_acting_osds(pg)
                pgb = pgsum.get(str(pg), {}).get("bytes", 0)
                share = math.ceil(pgb / k)
                for o in acting:
                    if o == CRUSH_ITEM_NONE:
                        continue
                    hosted_pgs[o] = hosted_pgs.get(o, 0) + 1
                    hosted_bytes[o] = hosted_bytes.get(o, 0) + share
        rows = []
        for osd in range(m.max_osd):
            if not m.exists(osd):
                continue
            used = hosted_bytes.get(osd, 0)
            rows.append({
                "id": osd,
                "name": f"osd.{osd}",
                "status": "up" if m.is_up(osd) else "down",
                "reweight": round(
                    (m.osd_weight[osd] / 0x10000)
                    if osd < len(m.osd_weight) else 0.0, 5
                ),
                "kb_used": used // 1024,
                "bytes_used": used,
                "pgs": hosted_pgs.get(osd, 0),
            })
        return 0, "", {
            "nodes": rows,
            "summary": {
                "total_bytes_used": sum(r["bytes_used"] for r in rows),
                "total_pgs": sum(r["pgs"] for r in rows),
            },
        }


class PgQueryModule(MgrModule):
    """`ceph pg query` for one pgid: mapping + the primary's latest
    report; `ceph pg ls [state-filter]` lists every pg with its state
    (reference:src/mon/PGMap + the OSD's pg query)."""

    NAME = "pg_query"
    COMMANDS = {"pg query": "pg_query", "pg ls": "pg_ls"}

    def pg_ls(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        m = mgr.osdmap
        if m is None:
            return 0, "", {"pgs": []}
        want = cmd.get("states")  # substring filter, e.g. "degraded"
        pgsum = mgr.pg_summary()
        rows = []
        for pid in sorted(m.pools):
            pool = m.pools[pid]
            for pg in m.pgs_of_pool(pid):
                _u, _upp, acting, ap = m.pg_to_up_acting_osds(pg)
                state = _pg_state(pool, acting)
                if want and want not in state:
                    continue
                pst = pgsum.get(str(pg), {})
                rows.append({
                    "pgid": str(pg), "state": state,
                    "acting": acting, "acting_primary": ap,
                    "objects": pst.get("objects", 0),
                    "bytes": pst.get("bytes", 0),
                })
        return 0, "", {"pgs": rows}

    def pg_query(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        m = mgr.osdmap
        pgid = str(cmd.get("pgid", ""))
        if m is None or not pgid:
            return -22, "need pgid", None
        from ..osd.osdmap import PGid

        try:
            pg = PGid.parse(pgid)
        except (ValueError, TypeError):
            return -22, f"bad pgid {pgid!r}", None
        if pg.pool not in m.pools:
            return -2, f"no pool {pg.pool}", None
        if not 0 <= pg.seed < m.pools[pg.pool].pg_num:
            # pg_to_up_acting_osds would silently FOLD an out-of-range
            # seed onto a real PG and answer for the wrong one
            # real ceph answers ENOENT
            return -2, f"no pg {pgid}", None
        up, up_primary, acting, acting_primary = m.pg_to_up_acting_osds(pg)
        pst = mgr.pg_summary().get(str(pg), {})
        state = _pg_state(m.pools[pg.pool], acting)
        return 0, "", {
            "pgid": str(pg),
            "state": state,
            "up": up, "up_primary": up_primary,
            "acting": acting, "acting_primary": acting_primary,
            "epoch": m.epoch,
            "stats": {
                "objects": pst.get("objects", 0),
                "bytes": pst.get("bytes", 0),
                "reported_by": pst.get("reporter"),
            },
        }


class DfModule(MgrModule):
    """`ceph df`: per-pool usage from the primaries' reports."""

    NAME = "df"
    COMMANDS = {"df": "df"}

    def df(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        m = mgr.osdmap
        if m is None:
            return 0, "", {"pools": []}
        usage = mgr.pool_usage()
        per_pool: dict[int, dict] = {
            pid: {
                "name": p.name,
                "objects": usage.get(pid, {}).get("objects", 0),
                "bytes": usage.get(pid, {}).get("bytes", 0),
            }
            for pid, p in m.pools.items()
        }
        stored = sum(
            st["store"].get("bytes_used", 0)
            for st in mgr.live_osd_stats().values()
        )
        return 0, "", {
            "pools": [per_pool[pid] for pid in sorted(per_pool)],
            "total_used_bytes": stored,
            "num_osds_reporting": len(mgr.live_osd_stats()),
        }


class PGDumpModule(MgrModule):
    """`ceph pg dump`: the PGMap listing."""

    NAME = "pg_dump"
    COMMANDS = {"pg dump": "dump"}

    def dump(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        now = time.monotonic()
        pgs = mgr.pg_summary()
        return 0, "", {
            "num_pgs": len(pgs),
            "pgs": [
                {"pgid": pgid, **pst} for pgid, pst in sorted(pgs.items())
            ],
            "osd_stats": [
                {"osd": osd, "age": now - st["ts"], "epoch": st["epoch"]}
                for osd, st in sorted(mgr.live_osd_stats().items())
            ],
        }


class MetricsModule(MgrModule):
    """Query surface over the mgr's time-series store (tsdb.py):
    ``metrics ls`` lists series names, ``metrics query`` answers one
    windowed number (rate/value/avg), ``metrics range`` returns the
    per-bucket samples ``ceph_top`` renders.  Command routing is exact
    prefix match, so these coexist with the prometheus module's bare
    ``metrics`` scrape."""

    NAME = "metrics_store"
    COMMANDS = {
        "metrics query": "query",
        "metrics ls": "ls",
        "metrics range": "range_",
        "metrics stats": "stats",
        "client ledger": "client_ledger",
    }

    def query(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        metric = cmd.get("metric")
        if not metric:
            return -22, "need metric", None
        derive = str(cmd.get("derive", "rate"))
        if derive not in ("rate", "value", "avg"):
            return -22, f"bad derive {derive!r}", None
        return 0, "", mgr.tsdb.query(
            str(metric),
            window=float(cmd.get("window", 10.0)),
            daemon=cmd.get("daemon"),
            derive=derive,
        )

    def ls(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        # stats nests: its "series" key (a count) must not clobber
        # the series list
        return 0, "", {
            "series": mgr.tsdb.ls(cmd.get("pattern")),
            "stats": mgr.tsdb.stats(),
        }

    def range_(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        metric = cmd.get("metric")
        if not metric:
            return -22, "need metric", None
        derive = str(cmd.get("derive", "rate"))
        if derive not in ("rate", "value"):
            return -22, f"bad derive {derive!r}", None
        return 0, "", mgr.tsdb.range(
            str(metric),
            window=float(cmd.get("window", 60.0)),
            daemon=cmd.get("daemon"),
            derive=derive,
        )

    def stats(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", mgr.tsdb.stats()

    def client_ledger(self, mgr: MgrDaemon, cmd: dict
                      ) -> tuple[int, str, Any]:
        """Cluster-wide tenant view: every OSD's top-K ledger rows
        merged by (client, pool, class).  Share is over ALL in-window
        ops including the evicted tail, so a heavy hitter's share is
        honest even when small tenants fell off the sketch.  p99 is
        the max across OSDs (per-OSD sketches cannot be re-merged
        into one quantile)."""
        merged: dict[tuple, dict] = {}
        other = {"ops": 0, "errs": 0, "ops_per_sec": 0.0,
                 "bytes_per_sec": 0.0}
        total_ops = 0
        for st in mgr.live_osd_stats().values():
            for row in st.get("ledger") or []:
                ops = int(row.get("ops", 0) or 0)
                total_ops += ops
                if row.get("class") == "other":
                    other["ops"] += ops
                    other["errs"] += int(row.get("errs", 0) or 0)
                    other["ops_per_sec"] += float(
                        row.get("ops_per_sec", 0) or 0)
                    other["bytes_per_sec"] += float(
                        row.get("bytes_per_sec", 0) or 0)
                    continue
                key = (row.get("client"), row.get("pool"),
                       row.get("class"))
                e = merged.setdefault(key, {
                    "client": row.get("client"),
                    "pool": row.get("pool"),
                    "class": row.get("class"),
                    "ops": 0, "errs": 0, "bytes_in": 0,
                    "bytes_out": 0, "ops_per_sec": 0.0,
                    "bytes_per_sec": 0.0, "p99_s": 0.0,
                })
                e["ops"] += ops
                e["errs"] += int(row.get("errs", 0) or 0)
                e["bytes_in"] += int(row.get("bytes_in", 0) or 0)
                e["bytes_out"] += int(row.get("bytes_out", 0) or 0)
                e["ops_per_sec"] += float(row.get("ops_per_sec", 0) or 0)
                e["bytes_per_sec"] += float(
                    row.get("bytes_per_sec", 0) or 0)
                e["p99_s"] = max(e["p99_s"],
                                 float(row.get("p99_s", 0) or 0))
        rows = sorted(merged.values(), key=lambda r: -r["ops"])
        for r in rows:
            r["share"] = round(r["ops"] / total_ops, 4) \
                if total_ops else 0.0
        return 0, "", {
            "total_ops": total_ops,
            "clients": rows,
            "other": other,
        }


class TraceModule(MgrModule):
    """Query surface over the mgr's kept-trace store (trace_store.py): ``trace ls`` filters one-line summaries by client /
    pool / dominant hop, ``trace show <id>`` returns one full
    cross-daemon waterfall, ``trace top`` the slowest keeps in a
    window, ``trace summary`` the dominant-hop histogram — the
    multi-host hop re-rank table (ROADMAP item 1c) read straight off
    kept outliers instead of sampled medians."""

    NAME = "trace"
    COMMANDS = {
        "trace ls": "ls",
        "trace show": "show",
        "trace top": "top",
        "trace summary": "summary",
    }

    @staticmethod
    def _as_id(value):
        """CLI params arrive as strings; stored client/pool ids are
        ints — coerce digit-strings so ``trace ls client=123`` matches."""
        if isinstance(value, str) and value.lstrip("-").isdigit():
            return int(value)
        return value

    def ls(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", {
            "traces": mgr.trace_store.ls(
                client=self._as_id(cmd.get("client")),
                pool=self._as_id(cmd.get("pool")),
                hop=cmd.get("hop"),
                limit=int(cmd.get("limit", 64)),
            ),
            "stats": mgr.trace_store.stats(),
        }

    def show(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        trace = cmd.get("trace")
        if not trace:
            return -22, "need trace id", None
        rec = mgr.trace_store.get(str(trace))
        if rec is None:
            return -2, f"no kept trace {trace!r} (evicted or dropped)", None
        rec.pop("_ts", None)  # store-internal window clock
        return 0, "", rec

    def top(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", {
            "traces": mgr.trace_store.top(
                n=int(cmd.get("n", 10)),
                window=float(cmd.get("window", 0) or 0) or None,
            ),
        }

    def summary(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", mgr.trace_store.summary(
            window=float(cmd.get("window", 0) or 0) or None,
        )


def _prom_escape(value) -> str:
    """Prometheus label-value escaping (exposition format: backslash,
    double-quote and newline must be escaped inside label values)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class PrometheusModule(MgrModule):
    """Prometheus-style exposition of every reported counter
    (reference:src/pybind/mgr/prometheus).

    Series naming: ``ceph_<subsystem>_<counter>{daemon="..."}``.  Avg /
    time-avg counters flatten to the histogram-style triplet
    ``_sum`` / ``_count`` / plain (the running average) — the shape the
    reference module exports for longrunavgs."""

    NAME = "prometheus"
    COMMANDS = {"metrics": "metrics"}

    @staticmethod
    def _emit_histogram(lines: list[str], base: str, labels: str,
                        hist: dict, exemplar=None) -> None:
        """One PerfHistogram dump -> prometheus histogram series:
        ``<base>_bucket{le=...}`` cumulative counts plus ``_sum`` /
        ``_count``.  The LAST axis is the ``le`` axis; a 2D (size x
        latency) grid is flattened by summing the size axis away —
        a pure column sum, so the flattening is deterministic and the
        +Inf bucket always equals ``_count``.

        ``exemplar``: an optional ``(lo, hi) -> (trace_id,
        value) | None`` lookup; a hit appends an OpenMetrics exemplar
        annotation to that bucket line, linking the histogram's shape
        to one concrete kept trace."""
        axes = hist.get("axes") or []
        values = hist.get("values") or []
        if not axes:
            return
        le_axis = axes[-1]
        if len(axes) == 1:
            counts = [int(v) for v in values]
        else:
            counts = [
                sum(int(row[j]) for row in values)
                for j in range(le_axis["buckets"])
            ]
        # bucket uppers mirror PerfHistogramAxis.upper()
        amin, quant = float(le_axis["min"]), float(le_axis.get("quant", 1))
        log2 = le_axis.get("scale", "log2") == "log2"
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if i >= len(counts) - 1:
                le, hi = "+Inf", float("inf")
            elif log2:
                le = format(amin * (2 ** i), "g")
                hi = amin * (2 ** i)
            else:
                le = format(amin + i * quant, "g")
                hi = amin + i * quant
            line = (
                # cardinality-ok: le edges are the fixed axis schema
                f'{base}_bucket{{{labels},le="{le}"}} {cum}'
            )
            if exemplar is not None and c > 0:
                if log2:
                    lo = 0.0 if i == 0 else amin * (2 ** (i - 1))
                else:
                    lo = 0.0 if i == 0 else amin + (i - 1) * quant
                ex = exemplar(lo, hi)
                if ex is not None:
                    # OpenMetrics exemplar: `# {trace_id="..."} value`
                    # cardinality-ok: exemplar annotation, not a label
                    line += f' # {{trace_id="{_prom_escape(ex[0])}"}} ' \
                            f'{ex[1]}'
            lines.append(line)
        lines.append(
            f'{base}_sum{{{labels}}} '
            f'{float(hist.get("sum") or 0.0)}'
        )
        lines.append(
            f'{base}_count{{{labels}}} '
            f'{int(hist.get("count") or 0)}'
        )

    @classmethod
    def _emit_daemon(cls, lines: list[str], daemon: str, perf: dict,
                     trace_store=None) -> None:
        """One daemon's full counter dump -> exposition lines; every
        registered counter appears exactly once per daemon.  A
        subsystem named ``<base>@<label>`` (the per-accel families,
        osd/ec_perf.py create_accel_target_perf) emits onto the BASE
        subsystem's series names with an extra identifying label —
        ``ceph_accel_remote_batches{daemon=...,accel="3"}`` — so a
        fleet's per-target skew is one labelled query, not N series
        name variants.

        ``trace_store``: when given, ``stack.lat_<hop>``
        histogram buckets that hold a kept trace get an exemplar
        annotation keyed by its trace id."""
        esc = _prom_escape(daemon)
        for subsys, counters in sorted((perf or {}).items()):
            # cardinality-ok: one value per reporting daemon
            labels = f'daemon="{esc}"'
            if "@" in subsys:
                subsys, instance = subsys.split("@", 1)
                # cardinality-ok: one value per configured accel target
                labels += f',{subsys}="{_prom_escape(instance)}"'
            lab = f"{{{labels}}}"
            for key, val in sorted(counters.items()):
                base = f"ceph_{subsys}_{key}"
                if isinstance(val, dict) and "histogram" in val:
                    exemplar = None
                    if (trace_store is not None and subsys == "stack"
                            and key.startswith("lat_")):
                        hop = key[len("lat_"):]
                        exemplar = (
                            lambda lo, hi, _h=hop:
                            trace_store.exemplar_for(_h, lo, hi)
                        )
                    cls._emit_histogram(lines, base, labels,
                                        val["histogram"], exemplar)
                    continue
                if isinstance(val, dict):
                    # PerfCounters avg dump: {avgcount, sum, avg, ...}
                    s = float(val.get("sum") or 0.0)
                    c = int(val.get("avgcount") or 0)
                elif isinstance(val, (list, tuple)):
                    # raw [sum, count, min, max] pairs (pre-dump form)
                    s = float(val[0]) if val else 0.0
                    c = int(val[1]) if len(val) > 1 else 0
                elif isinstance(val, bool) or not isinstance(
                    val, (int, float)
                ):
                    continue  # non-numeric: not a prometheus sample
                else:
                    lines.append(f"{base}{lab} {val}")
                    continue
                lines.append(f"{base}_sum{lab} {s}")
                lines.append(f"{base}_count{lab} {c}")
                lines.append(f"{base}{lab} {(s / c) if c else 0.0}")

    def metrics(self, mgr: MgrDaemon, cmd: dict) -> tuple[int, str, Any]:
        lines: list[str] = []
        # ceph_health_status: 0 OK / 1 WARN / 2 ERR (the reference
        # prometheus module's health gauge)
        if mgr.osdmap is not None:
            worst, _checks = _cluster_health(mgr)
            lines.append(
                f"ceph_health_status {_SEVERITIES.index(worst)}"
            )
        for osd, st in sorted(mgr.live_osd_stats().items()):
            self._emit_daemon(lines, f"osd.{osd}", st["perf"],
                              trace_store=getattr(mgr, "trace_store",
                                                  None))
            # tenant ledger rows: cardinality is bounded at
            # the SOURCE — each OSD ships at most osd_client_ledger_topk
            # rows + one "other" tail row, so the series count here is
            # O(osds * topk) no matter how many tenants exist
            for row in st.get("ledger") or []:
                labels = (
                    f'daemon="osd.{osd}",'
                    # cardinality-ok: top-K ledger rows, <= topk+other
                    f'client="{_prom_escape(row.get("client"))}",'
                    # cardinality-ok: pools are operator-created, few
                    f'pool="{_prom_escape(row.get("pool"))}",'
                    # cardinality-ok: fixed op-class enum + "other"
                    f'class="{_prom_escape(row.get("class"))}"'
                )
                for col, series in (
                    ("ops_per_sec", "ceph_client_ops_per_sec"),
                    ("bytes_per_sec", "ceph_client_bytes_per_sec"),
                    ("p99_s", "ceph_client_p99_seconds"),
                    ("errs", "ceph_client_errors"),
                ):
                    lines.append(
                        f"{series}{{{labels}}} {row.get(col, 0) or 0}"
                    )
        # non-OSD daemons (mon elections/map publishes, rgw verbs) ride
        # MDaemonStats reports; the mgr exports its own counters too
        for name, st in sorted(mgr.live_daemon_stats().items()):
            self._emit_daemon(lines, name, st["perf"])
        self._emit_daemon(lines, mgr.name, mgr.perf.dump())
        for pgid, pst in sorted(mgr.pg_summary().items()):
            lines.append(
                # cardinality-ok: pg count is fixed by pool pg_num
                f'ceph_pg_objects{{pgid="{_prom_escape(pgid)}"}} '
                f'{pst.get("objects", 0)}'
            )
        return 0, "", "\n".join(lines) + "\n"
