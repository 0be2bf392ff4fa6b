"""The mgr daemon: beacon, stats ingest, module host
(reference:src/mgr/Mgr.cc, MgrStandby.cc, DaemonServer.cc).

Counterpart of ``ceph_tpu/mgr/daemon.py``, whole.  The mgr holds no
card: it aggregates what the OSDs (``MPGStats``) and the other daemons
(``MDaemonStats``: the mon, the accelerator daemons) report, and its
wire is the reference's, so a mgr of either package serves daemons of
both."""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from ..msg import AsyncMessenger, Connection, Dispatcher, messages
from ..msg.message import Message
from ..osd.osdmap import OSDMap

logger = logging.getLogger("ceph_tpu_torch.mgr")

EINVAL = 22


class MgrModule:
    """One hosted module (the MgrPyModule analog,
    reference:src/mgr/MgrPyModule.cc): ``COMMANDS`` maps command
    prefixes to handler names; handlers see the mgr's aggregated
    state."""

    NAME = ""
    COMMANDS: dict[str, str] = {}

    def handle_command(
        self, mgr: "MgrDaemon", cmd: dict
    ) -> tuple[int, str, Any]:
        handler = getattr(self, self.COMMANDS[cmd["prefix"]])
        return handler(mgr, cmd)


class MgrDaemon(Dispatcher):
    """Active-or-standby manager.  Beacons keep it registered with the
    mon; the map says which mgr is active, and OSDs report stats to
    that one (reference:src/mgr/MgrStandby.cc)."""

    def __init__(self, name: str, mon_addr: "str | list[str]",
                 config=None, modules: list[MgrModule] | None = None):
        from ..common import Config, PerfCountersCollection

        self.config = config or Config()
        self.name = name
        self.mon_addr = mon_addr
        self.messenger = AsyncMessenger(name, self)
        self.messenger.apply_config(self.config)
        from ..auth import daemon_auth_context

        self.messenger.auth = daemon_auth_context(self.config, name)
        self.osdmap: OSDMap | None = None
        self.addr = ""
        self.active = False
        # per-osd last report: {osd: {"pgs", "perf", "store", "ts", "epoch"}}
        self.osd_stats: dict[int, dict] = {}
        # non-OSD daemon reports (mon/rgw via MDaemonStats):
        # {name: {"perf", "ts"}}
        self.daemon_stats: dict[str, dict] = {}
        self._prev_perf: dict[int, tuple[float, dict]] = {}  # io-rate basis
        self.io_rates: dict[int, dict[str, float]] = {}
        self.perf = PerfCountersCollection()
        self.perf.attach(self.messenger.perf)
        pm = self.perf.create("mgr")
        pm.add_counter("stats_received", "MPGStats ingested")
        pm.add_counter("daemon_stats_received",
                       "non-OSD daemon reports ingested")
        pm.add_counter("commands", "module commands served")
        # time-series store: every daemon report folds into
        # bounded ring-buffer history; its own health is a perf family
        # so series-cap pressure shows in prometheus like anything else
        ptsdb = self.perf.create("tsdb")
        ptsdb.add_counter("samples", "series points ingested")
        ptsdb.add_counter("dropped_series",
                          "new series refused past mgr_tsdb_max_series")
        ptsdb.add_gauge("series", "distinct series tracked")
        ptsdb.add_gauge("points", "ring points held across all series")
        from .tsdb import TimeSeriesStore

        self.tsdb = TimeSeriesStore(
            step=self.config.mgr_tsdb_step,
            retention=self.config.mgr_tsdb_retention,
            max_series=self.config.mgr_tsdb_max_series,
            perf=ptsdb,
        )
        self.tsdb.slow_threshold = self.config.mgr_slo_op_p99_target
        # SLO burn-rate state: gauges survive scrapes; the
        # health check itself is computed on demand in _health_checks
        pslo = self.perf.create("slo")
        pslo.add_gauge("latency_burn_fast",
                       "latency error-budget burn rate, fast window")
        pslo.add_gauge("latency_burn_slow",
                       "latency error-budget burn rate, slow window")
        pslo.add_gauge("failure_burn_fast",
                       "failure-rate budget burn, fast window")
        pslo.add_gauge("failure_burn_slow",
                       "failure-rate budget burn, slow window")
        # tail-sampled trace collector: kept waterfalls ride
        # MPGStats into a bounded ring; eviction pressure is a counter
        # so an undersized store shows up in prometheus, not in silence
        ptrace = self.perf.create("trace")
        ptrace.add_counter("store_evictions",
                           "kept traces evicted oldest-first at capacity")
        ptrace.add_gauge("store_size", "kept traces currently held")
        from .trace_store import TraceStore

        self.trace_store = TraceStore(
            capacity=self.config.mgr_trace_store_capacity, perf=ptrace,
        )
        from .modules import (
            DfModule,
            MetricsModule,
            OsdDfModule,
            PGDumpModule,
            PgQueryModule,
            PrometheusModule,
            StatusModule,
            TraceModule,
        )

        self.modules: list[MgrModule] = modules or [
            StatusModule(), DfModule(), OsdDfModule(), PgQueryModule(),
            PGDumpModule(), PrometheusModule(), MetricsModule(),
            TraceModule(),
        ]
        self._routes: dict[str, MgrModule] = {}
        for mod in self.modules:
            for prefix in mod.COMMANDS:
                self._routes[prefix] = mod
        self._mon_conn: Connection | None = None
        self._redirect_addr: str | None = None  # leader hint from a peon
        self._beacon_task: asyncio.Task | None = None
        self._admin = None
        self._stopping = False

    # -- lifecycle -----------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self.addr = await self.messenger.bind(host, port)
        await self._connect_mon()
        self._beacon_task = asyncio.ensure_future(self._beacon_loop())
        path = self.config.admin_socket
        if path:
            from ..common import AdminSocket, register_common

            self._admin = AdminSocket(path.replace("{name}", self.name))
            register_common(self._admin, perf=self.perf,
                            config=self.config)
            self._admin.register(
                "status",
                lambda req: {"name": self.name, "addr": self.addr,
                             "active": self.active},
                "daemon identity and active/standby role",
            )
            await self._admin.start()
        return self.addr

    async def stop(self) -> None:
        self._stopping = True
        if self._beacon_task:
            self._beacon_task.cancel()
        if self._admin is not None:
            await self._admin.stop()
            self._admin = None
        await self.messenger.shutdown()

    @property
    def _mon_addrs(self) -> list[str]:
        if isinstance(self.mon_addr, str):
            return [self.mon_addr]
        return list(self.mon_addr)

    async def _connect_mon(self) -> Connection:
        last: Exception | None = None
        addrs = self._mon_addrs
        if self._redirect_addr:
            addrs = [self._redirect_addr, *addrs]
            self._redirect_addr = None
        for addr in addrs:
            try:
                conn = await self.messenger.connect(addr, "mon")
                conn.send(messages.MMonGetMap(have=0))
                self._mon_conn = conn
                return conn
            except (ConnectionError, OSError) as e:
                last = e
        raise ConnectionError(f"no mon reachable: {last}")

    async def _beacon_loop(self) -> None:
        """reference:MgrStandby::send_beacon — stay registered, learn
        whether we are the active mgr."""
        interval = self.config.mgr_beacon_interval
        tid = 0
        try:
            while not self._stopping:
                tid += 1
                try:
                    conn = self._mon_conn or await self._connect_mon()
                    conn.send(messages.MMonCommand(
                        tid=tid,
                        cmd={"prefix": "mgr beacon", "name": self.name,
                             "addr": self.addr},
                    ))
                    if self.active:
                        tid = self._check_pool_quotas(conn, tid)
                except (ConnectionError, OSError):
                    self._mon_conn = None
                # the mgr's OWN counters ride the same history as any
                # reporting daemon — msgr clock-sync
                # uncertainty included
                self.tsdb.ingest(self.name, self.perf.dump())
                await asyncio.sleep(interval)
        except asyncio.CancelledError:
            pass

    def _check_pool_quotas(self, conn: Connection, tid: int) -> int:
        """Flip FLAG_FULL_QUOTA through the mon when a pool's usage
        (the primaries' reports) crosses its quota — the stats
        authority drives the flag, like the reference's PGMonitor
        (reference:src/mon/PGMonitor.cc check_full_osd_health analog
        for pool quotas).  Approximate by design: stats lag writes."""
        from ..osd.osdmap import FLAG_FULL_QUOTA

        m = self.osdmap
        if m is None:
            return tid
        if not any(p.quota_max_objects or p.quota_max_bytes
                   for p in m.pools.values()):
            return tid  # no quotas anywhere: skip the aggregation
        usage = self.pool_usage()
        for pid, pool in m.pools.items():
            if not (pool.quota_max_objects or pool.quota_max_bytes):
                continue
            u = usage.get(pid, {"objects": 0, "bytes": 0})
            over = (
                (pool.quota_max_objects
                 and u["objects"] >= pool.quota_max_objects)
                or (pool.quota_max_bytes
                    and u["bytes"] >= pool.quota_max_bytes)
            )
            have = bool(pool.flags & FLAG_FULL_QUOTA)
            if bool(over) != have:
                tid += 1
                conn.send(messages.MMonCommand(tid=tid, cmd={
                    "prefix": "osd pool quota-full",
                    "pool": pool.name, "full": bool(over),
                }))
        return tid

    # -- dispatch ------------------------------------------------------------
    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, messages.MOSDMapMsg):
            if self.osdmap is None or msg.epoch > self.osdmap.epoch:
                from ..osd.osdmap import advance_map

                m = advance_map(
                    self.osdmap, msg.epoch, msg.osdmap, msg.incrementals
                )
                if m is None:
                    conn.send(messages.MMonGetMap(have=None))
                    return
                self.osdmap = m
                was = self.active
                self.active = self.osdmap.mgr_name == self.name
                if self.active and not was:
                    logger.info("%s: now the ACTIVE mgr", self.name)
        elif isinstance(msg, messages.MMonCommandReply):
            # a peon redirect: re-home the beacon at the leader
            if (msg.code == -11 and isinstance(msg.out, dict)
                    and msg.out.get("addr")):
                self._redirect_addr = msg.out["addr"]
                self._mon_conn = None
        elif isinstance(msg, messages.MPGStats):
            self._ingest_stats(msg)
        elif isinstance(msg, messages.MDaemonStats):
            self.perf.get("mgr").inc("daemon_stats_received")
            self.daemon_stats[msg.name] = {
                "perf": dict(msg.perf or {}), "ts": time.monotonic(),
            }
            self.tsdb.ingest(msg.name, msg.perf or {})
        elif isinstance(msg, messages.MMonCommand):
            code, status, out = self.handle_command(msg.cmd)
            conn.send(messages.MMonCommandReply(
                tid=msg.tid, code=code, status=status, out=out,
            ))

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._mon_conn:
            self._mon_conn = None

    # -- stats ingest (reference:DaemonServer::handle_pg_stats) --------------
    def _ingest_stats(self, msg: messages.MPGStats) -> None:
        self.perf.get("mgr").inc("stats_received")
        now = time.monotonic()
        self.osd_stats[msg.osd] = {
            "pgs": dict(msg.pgs or {}),
            "perf": dict(msg.perf or {}),
            "store": dict(msg.store or {}),
            "ledger": list(msg.ledger or []),
            "epoch": msg.epoch,
            "ts": now,
        }
        # tail-sampled keeps: already decided at the source,
        # so ingest is unconditional — stamp the reporter for `trace ls`
        for wf in msg.traces or []:
            if isinstance(wf, dict):
                self.trace_store.ingest({**wf, "osd": msg.osd})
        # fold the report into history: rates/quantiles
        # derive at insert; the slow threshold tracks the SLO target
        # so slow_frac and the burn rate measure the same thing
        self.tsdb.slow_threshold = self.config.mgr_slo_op_p99_target
        self.tsdb.ingest(f"osd.{msg.osd}", msg.perf or {})
        st = self.tsdb.stats()
        ptsdb = self.perf.get("tsdb")
        ptsdb.set("series", st["series"])
        ptsdb.set("points", st["points"])
        # client io rates from op-counter deltas
        prev = self._prev_perf.get(msg.osd)
        osd_perf = (msg.perf or {}).get("osd", {})
        if prev is not None:
            dt = now - prev[0]
            if dt > 0:
                p = prev[1].get("osd", {})
                self.io_rates[msg.osd] = {
                    "op_per_sec": max(
                        0.0, (osd_perf.get("op", 0) - p.get("op", 0)) / dt
                    ),
                    "rd_bytes_sec": max(
                        0.0,
                        (osd_perf.get("op_out_bytes", 0)
                         - p.get("op_out_bytes", 0)) / dt,
                    ),
                    "wr_bytes_sec": max(
                        0.0,
                        (osd_perf.get("op_in_bytes", 0)
                         - p.get("op_in_bytes", 0)) / dt,
                    ),
                }
        self._prev_perf[msg.osd] = (now, dict(msg.perf or {}))

    # -- module host ---------------------------------------------------------
    def handle_command(self, cmd: dict) -> tuple[int, str, Any]:
        prefix = cmd.get("prefix", "")
        if prefix == "mgr module ls":
            return 0, "", [m.NAME for m in self.modules]
        mod = self._routes.get(prefix)
        if mod is None:
            return -EINVAL, f"mgr: unknown command {prefix!r}", None
        self.perf.get("mgr").inc("commands")
        try:
            return mod.handle_command(self, cmd)
        except Exception as e:
            logger.exception("%s: module %s failed on %r",
                             self.name, mod.NAME, prefix)
            return -EINVAL, str(e), None

    # -- aggregate views the modules share -----------------------------------
    STALE_AFTER = 30.0  # seconds without a report -> entry dropped

    def live_osd_stats(self) -> dict[int, dict]:
        """Reports worth aggregating: the OSD is up in the map and its
        report is fresh — a dead primary's frozen counts must not shadow
        the remapped PG's new primary (reference: PGMap ages out stats
        of down OSDs)."""
        now = time.monotonic()
        live: dict[int, dict] = {}
        for osd, st in list(self.osd_stats.items()):
            if now - st["ts"] > self.STALE_AFTER:
                del self.osd_stats[osd]  # long-dead: drop for good
                self._prev_perf.pop(osd, None)
                self.io_rates.pop(osd, None)
                continue
            if self.osdmap is not None and not self.osdmap.is_up(osd):
                continue
            live[osd] = st
        return live

    def live_daemon_stats(self) -> dict[str, dict]:
        """Fresh non-OSD daemon reports (mon/rgw); stale entries age
        out like OSD stats do."""
        now = time.monotonic()
        live: dict[str, dict] = {}
        for name, st in list(self.daemon_stats.items()):
            if now - st["ts"] > self.STALE_AFTER:
                del self.daemon_stats[name]
                continue
            live[name] = st
        return live

    def pool_usage(self) -> dict[int, dict]:
        """{pool_id: {"objects", "bytes"}} aggregated from the per-PG
        summary — the single copy of the pgid->pool keying (shared by
        `ceph df` and the quota checker)."""
        usage: dict[int, dict] = {}
        for pgid, pst in self.pg_summary().items():
            pid = int(pgid.split(".", 1)[0])
            u = usage.setdefault(pid, {"objects": 0, "bytes": 0})
            u["objects"] += pst.get("objects", 0)
            u["bytes"] += pst.get("bytes", 0)
        return usage

    def pg_summary(self) -> dict[str, dict]:
        """Authoritative per-PG view: the primary's report wins
        (reference: pg stats keyed by the primary's report)."""
        pgs: dict[str, dict] = {}
        for osd, st in self.live_osd_stats().items():
            for pgid, pst in st["pgs"].items():
                if pst.get("primary") == osd or pgid not in pgs:
                    pgs[pgid] = {**pst, "reporter": osd}
        return pgs
