"""Monitor: authoritative OSDMap service, single- or multi-mon.

Counterpart of ``ceph_tpu/mon/monitor.py``, whole, its admin socket
(``admin_socket``: ``status``, ``quorum_status`` and the common set)
included.  The mon has no card: its ``kernel trace`` windows are
host-only.  The EC profile check builds
the codec on the host (``device="cpu"``): it only proves the profile
valid, and the mon encodes nothing.  Its wire, its store and its map
are the reference's, so port and reference mons, daemons and clients
interoperate (one quorum may mix them).

Re-expression of the reference control plane for the mini-cluster:

- map mutations bump the epoch and are pushed to every subscriber
  (reference OSDMonitor maintains the map inside Paxos and clients
  subscribe via MMonSubscribe — reference:src/mon/OSDMonitor.cc).
- OSD boot reports mark the osd up (reference:src/mon/OSDMonitor.cc
  prepare_boot); failure reports from peers mark it down once enough
  distinct reporters agree (reference:src/mon/OSDMonitor.cc
  prepare_failure / check_failure, reporter aggregation).
- EC profile commands validate by instantiating the codec before
  accepting the profile (reference:src/mon/OSDMonitor.cc:4305-4341 set/
  get/ls/rm, validation :4590-4600).
- a connection reset from a booted OSD is treated as an immediate
  failure signal (the mini-cluster analog of heartbeat-grace expiry —
  the TCP FIN arrives faster than any ping schedule on loopback).

Multi-mon (reference:src/mon/Paxos.cc + Elector.cc, collapsed to a
leader-driven majority-ack log over full-map snapshots — "Paxos-lite"):

- election: lowest reachable rank wins (the reference Elector's rule).
  A proposer gathers acks; acks carry the responder's committed map so
  the winner adopts the newest state before taking over (the Paxos
  recovery phase); victory broadcasts the adopted map.
- commits: the leader proposes the new map to its peers and applies it
  only after a MAJORITY of the monmap (counting itself) acked — then
  broadcasts the commit, and every mon pushes the map to its own
  subscribers.  No quorum -> mutations fail with -EAGAIN (CP behavior).
- leases: the leader pings peons every mon_lease_interval; silence past
  mon_election_timeout starts a new election.
- forwarding: OSD boot/failure reports arriving at a peon are forwarded
  to the leader; client commands at a peon are redirected (the reply
  names the leader and the client re-targets).
- durability: with ``store_path`` every committed map is written
  write-tmp/rename (MonitorDBStore-lite) and reloaded on restart, so
  pools/profiles survive a full-cluster restart.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from ..crush.map import CrushMap
from ..models import registry
from ..msg import AsyncMessenger, Connection, Dispatcher, messages
from ..msg.message import Message
from ..osd.osdmap import (
    FLAG_FULL_QUOTA,
    Incremental,
    OSDMap,
    POOL_TYPE_REPLICATED,
)

logger = logging.getLogger("ceph_tpu_torch.mon")

EINVAL = 22
ENOENT = 2
EEXIST = 17
EAGAIN = 11

MON_REPORTER_BASE = 1_000_000  # synthetic reporter ids for forwarding mons

INC_CACHE_EPOCHS = 500  # in-memory delta window for subscriber catch-up

# the MDS ino-allocation stripe (``ceph_tpu/mds/daemon.py``'s
# MAX_MDS_RANKS, copied: the port keeps its own constants): rank r
# allocates r mod 16, so max_mds may not exceed it
MAX_MDS_RANKS = 16

DEFAULT_EC_PROFILE = {
    # reference:src/common/config_opts.h:677 osd_pool_default_erasure_code_profile
    "plugin": "jerasure",
    "technique": "reed_sol_van",
    "k": "2",
    "m": "1",
}



def _bg(coro) -> asyncio.Task:
    """Fire-and-forget task that logs (instead of leaking or raising on
    cancellation) its terminal exception."""
    t = asyncio.ensure_future(coro)

    def _done(t: asyncio.Task) -> None:
        if not t.cancelled() and t.exception() is not None:
            logger.error("mon background task failed", exc_info=t.exception())

    t.add_done_callback(_done)
    return t


class Monitor(Dispatcher):
    """Single-process map authority + command endpoint."""

    def __init__(
        self,
        name: str = "mon.0",
        max_osds: int = 16,
        failure_min_reporters: int | None = None,
        config=None,
        rank: int = 0,
        store_path: str | None = None,
        crush: CrushMap | None = None,
    ):
        from ..common import Config

        self.config = config or Config()
        from ..common.log import install as _install_memlog

        _install_memlog()
        self.name = name
        self.messenger = AsyncMessenger(name, self)
        self.messenger.apply_config(self.config)
        # observability (the reference mon's l_mon_* / paxos counters +
        # rocksdb perf): elections, map publishes, command volume —
        # dumped over the admin socket and reported to the active mgr
        from ..common import PerfCountersCollection

        self.perf = PerfCountersCollection()
        self.perf.attach(self.messenger.perf)
        pmon = self.perf.create("mon")
        (pmon
         .add_counter("election_calls", "elections this mon started")
         .add_counter("election_wins", "elections this mon won")
         .add_counter("map_publishes", "osdmap epochs committed+pushed")
         .add_counter("commands", "mon commands handled")
         .add_counter("failure_reports", "MOSDFailure reports ingested")
         .add_counter("clog_entries", "cluster-log entries appended")
         .add_gauge("map_epoch", "current osdmap epoch")
         .add_gauge("subscribers", "map subscription connections")
         .add_gauge("is_leader", "1 when this mon leads the quorum")
         # the accelerator fleet map: registration volume +
         # the published fleet state, next to the osdmap numbers
         .add_counter("accel_boots",
                      "AccelMap registrations/refresh beacons handled")
         .add_gauge("accelmap_epoch", "current accelmap epoch")
         .add_gauge("accels_up", "registered accelerators currently up"))
        self._mgr_report_last = 0.0
        self._admin = None
        self.failure_min_reporters = (
            self.config.mon_failure_min_reporters
            if failure_min_reporters is None else failure_min_reporters
        )
        # live knob: admin-socket `config set` must change failure-quorum
        # behavior, not just `config show` (as the OSD's observers
        # do); unobserved in stop() — a shared Config must not
        # keep firing on dead daemons
        self._observers = [
            ("mon_failure_min_reporters",
             lambda _n, v: setattr(self, "failure_min_reporters", v)),
        ]
        for opt, cb in self._observers:
            self.config.observe(opt, cb)
        self.osdmap = OSDMap(crush or CrushMap.flat(max_osds))
        self.osdmap.set_max_osd(max_osds)
        self.osdmap.epoch = 1
        self.osdmap.set_erasure_code_profile("default", DEFAULT_EC_PROFILE)
        self._subs: set[Connection] = set()
        # epoch deltas (reference:src/osd/OSDMap.h:111 Incremental):
        # epoch -> wire dict, kept for INC_CACHE_EPOCHS so subscriber
        # pushes and catch-up ranges cost O(churn) instead of O(map)
        self._inc_cache: dict[int, dict] = {}
        self._last_map_dict: dict | None = self.osdmap.to_dict()
        self._sub_epochs: dict[Connection, int] = {}  # last epoch sent
        self._boot_conns: dict[int, Connection] = {}  # osd id -> its conn
        self._failure_reports: dict[int, set[int]] = {}  # target -> reporters
        # accelerator fleet liveness: registration conn +
        # last-beacon clock per accel name; the pending set stops a
        # slow markdown commit from queueing duplicates off the tick
        self._accel_conns: dict[str, Connection] = {}
        self._accel_beacons: dict[str, float] = {}
        self._accel_down_pending: set[str] = set()
        self.addr = ""
        # -- quorum state
        self.rank = rank
        self.monmap: list[str] = []  # addrs by rank ([] / [self] = solo)
        self.leader_rank: int | None = 0 if rank == 0 else None
        self.election_epoch = 0
        self.store_path = store_path
        # version -> (election epoch of the proposal, map value): the
        # ACCEPTED register of Paxos — survives into elections so an
        # acked-but-uncommitted value can be adopted (see _handle_election)
        self._pending_commit: dict[int, tuple[int, dict]] = {}
        # election epoch the current committed map was chosen in; orders
        # committed vs accepted state during recovery as (epoch, version)
        self.map_committed_epoch = 0
        self._lease_task: asyncio.Task | None = None
        self._watch_task: asyncio.Task | None = None
        self._last_lease = time.monotonic()
        self._election_acks: dict[int, messages.MMonElection] = {}
        # epoch of the election I last WON (vs election_epoch, which can
        # be absorbed from overheard proposals without winning): the
        # deposition rule in _handle_lease compares against this
        self._victory_epoch = 0
        self._quorum_ranks: list[int] = [rank]  # last victory's quorum
        self._lease_ok: dict[int, bool] = {}  # leader's live peer view
        # monmap version for quorum_status (NOT the election epoch).
        # Runtime monmap mutation (mon add/rm) is not a feature here —
        # set_monmap runs once at boot with the static deployment — so
        # the counter is interface parity, not durable state; it is
        # deliberately not persisted
        self._monmap_epoch = 1
        self._paxos_acks: dict[int, set[int]] = {}  # version -> ranks
        self._paxos_events: dict[int, asyncio.Event] = {}
        self._electing = False
        self._election_task: asyncio.Task | None = None
        self._commit_lock = asyncio.Lock()
        # cluster log (reference:src/mon/LogMonitor.cc + LogClient):
        # severity-tagged events from every daemon, bounded ring,
        # surfaced by `ceph log last`.  The reference paxos-commits log
        # summaries; here the ring is mon-local (mirroring the memory
        # log's crash semantics) with a best-effort append to the store
        # path for post-mortem reads
        from collections import deque

        self._cluster_log: deque = deque(
            maxlen=int(self.config.mon_cluster_log_max)
        )
        self._clog_buf: list[str] = []
        self._clog_flush_scheduled = False
        self._log_subs: set[Connection] = set()  # `ceph -w` followers
        # serializes the file op itself: two overlapping flushes on the
        # multi-threaded default executor could rotate concurrently
        import threading

        self._clog_file_lock = threading.Lock()
        # (svc, name) -> last beacon; svc in ("mgr", "mds")
        self._svc_beacons: dict[tuple[str, str], float] = {}
        self._svc_fail_pending = {"mgr": False, "mds": False}
        self._tick_task: asyncio.Task | None = None
        # -- auth (reference:src/mon/AuthMonitor.cc + CephX service)
        self._keyring = None
        if self.config.auth_supported == "cephx":
            from ..auth import AuthContext, Keyring

            self._keyring = Keyring.load(self.config.keyring)
            self.messenger.auth = AuthContext(
                name, cluster_secret=self._keyring.cluster_secret,
                require=True,
            )
            self.messenger.auth_mon_mode = True
        self._db_store = None
        if store_path:
            from .store import MonitorDBStore

            self._db_store = MonitorDBStore(store_path)
            self._load_store()

    # -- quorum helpers -------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.leader_rank == self.rank

    @property
    def solo(self) -> bool:
        return len(self.monmap) <= 1

    def _majority(self) -> int:
        return len(self.monmap) // 2 + 1

    def _peer_ranks(self):
        return [r for r in range(len(self.monmap)) if r != self.rank]

    async def _peer_conn(self, r: int) -> Connection:
        return await self.messenger.connect(self.monmap[r], f"mon.{r}")

    async def _send_peer(self, r: int, msg: Message) -> bool:
        try:
            (await self._peer_conn(r)).send(msg)
            return True
        except (ConnectionError, OSError):
            return False

    def set_monmap(self, addrs: list[str]) -> None:
        if self.monmap and addrs != self.monmap:
            self._monmap_epoch += 1
        self.monmap = list(addrs)
        if self.solo:
            self.leader_rank = self.rank
        else:
            self.leader_rank = None

    # -- lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self.addr = await self.messenger.bind(host, port)
        self._tick_task = _bg(self._tick_loop())
        await self._start_admin_socket()
        return self.addr

    async def _start_admin_socket(self) -> None:
        """`ceph daemon mon.N <cmd>` surface (the mon has the same
        admin-socket contract as the OSD in the reference)."""
        path = self.config.admin_socket
        if not path:
            return
        from ..common import AdminSocket, register_common

        self._admin = AdminSocket(path.replace("{name}", self.name))
        register_common(self._admin, perf=self.perf, config=self.config,
                        device="cpu")
        self._admin.register(
            "status",
            lambda req: {
                "name": self.name, "addr": self.addr, "rank": self.rank,
                "epoch": self.osdmap.epoch, "leader": self.is_leader,
            },
            "daemon identity, rank and map epoch",
        )
        self._admin.register(
            "quorum_status", lambda req: self._cmd_quorum_status({})[2],
            "quorum membership and leader",
        )
        await self._admin.start()

    async def _tick_loop(self) -> None:
        """Periodic housekeeping (Monitor::tick): mgr-beacon staleness
        (leader-only mutations) + this mon's perf report to the active
        mgr (the reference's mon->mgr MMgrReport path)."""
        try:
            while True:
                # the tick must wake at least as often as the mgr report
                # period, or mon_mgr_report_interval below the lease
                # interval silently quantizes up to it (_report_to_mgr
                # self-throttles, so extra wakes cost nothing)
                lease = self.config.mon_lease_interval
                rep = self.config.mon_mgr_report_interval
                await asyncio.sleep(min(lease, rep) if rep > 0 else lease)
                if self.is_leader:
                    for svc in ("mgr", "mds"):
                        self.check_svc_beacons(
                            svc, grace=self.config.mon_lease_interval * 3
                        )
                    self._check_accel_beacons()
                await self._report_to_mgr()
        except asyncio.CancelledError:
            pass

    async def _report_to_mgr(self) -> None:
        """Push this mon's counters to the active mgr so the prometheus
        module can export mon series (elections, map publishes) next to
        the OSDs' — best-effort, a dead mgr costs nothing."""
        interval = self.config.mon_mgr_report_interval
        if interval <= 0 or not self.osdmap.mgr_addr:
            return
        now = time.monotonic()
        if now - self._mgr_report_last < interval:
            return
        self._mgr_report_last = now
        pmon = self.perf.get("mon")
        pmon.set("map_epoch", self.osdmap.epoch)
        pmon.set("subscribers", len(self._subs))
        pmon.set("is_leader", 1 if self.is_leader else 0)
        from ..msg.messenger import send_daemon_stats

        await send_daemon_stats(
            self.messenger, self.osdmap, self.name, self.perf.dump()
        )

    async def start_quorum(self) -> None:
        """Begin elections/lease-watching (call once every mon is bound
        and set_monmap ran).  Solo mons lead immediately; multi-mon
        elections run in the background (a partitioned mon keeps
        retrying forever — callers must not block on that)."""
        if self.solo:
            self.leader_rank = self.rank
            return
        self._watch_task = asyncio.ensure_future(self._lease_watchdog())
        self._election_task = _bg(self._start_election())

    async def stop(self) -> None:
        for opt, cb in self._observers:
            self.config.unobserve(opt, cb)
        for t in (self._lease_task, self._watch_task, self._election_task,
                  self._tick_task):
            if t is not None:
                t.cancel()
        self._lease_task = self._watch_task = self._election_task = None
        self._tick_task = None
        if self._admin is not None:
            await self._admin.stop()
            self._admin = None
        await self.messenger.shutdown()
        if self._clog_buf and self.store_path:
            # a clean shutdown must not drop the batch window's worth of
            # entries — the crash-adjacent ones matter most post-mortem
            #
            buf, self._clog_buf = self._clog_buf, []
            self._write_clog("\n".join(buf) + "\n")
        if self._db_store is not None:
            self._db_store.close()
            self._db_store = None

    # -- persistence (MonitorDBStore-lite) -----------------------------------

    def _save_store(self, inc: dict | None = None) -> None:
        if self._db_store is None:
            return
        self._db_store.save(
            self.osdmap.to_dict(), self.election_epoch,
            self.map_committed_epoch, inc=inc,
        )

    def _load_store(self) -> None:
        if self._db_store is None:
            return
        data = self._db_store.get_map()
        if data is None:
            return
        self.osdmap = OSDMap.from_dict(data)
        self._last_map_dict = data
        # re-arm the in-memory delta cache from the stored chain so
        # subscriber catch-up stays O(churn) across a mon restart (a
        # fresh cache would make every post-restart push a full
        # map).  Walk backwards until the stored chain ends.
        epoch = int(data["epoch"])
        for e in range(epoch, max(0, epoch - INC_CACHE_EPOCHS), -1):
            chain = self._db_store.get_incrementals(e - 1, e)
            if not chain:
                break
            self._inc_cache[e] = chain[0]
        self.election_epoch = self._db_store.election_epoch()
        self.map_committed_epoch = self._db_store.committed_epoch()
        acc = self._db_store.accepted()
        if acc is not None and acc["version"] > self.osdmap.epoch:
            # an accepted-but-uncommitted proposal survived our restart;
            # re-arm the register so election recovery can surface it
            self._pending_commit[acc["version"]] = (acc["epoch"], acc["value"])
        logger.info(
            "%s: restored map epoch %d from %s",
            self.name, self.osdmap.epoch, self.store_path,
        )

    # -- dispatch
    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        # mutating handlers run as tasks: dispatch is serialized per
        # connection, and a handler awaiting a Paxos ack that arrives on
        # the SAME connection (forwarded reports ride the mon-peer conn)
        # would deadlock the reader loop
        if isinstance(msg, messages.MAuth):
            self._handle_auth(conn, msg)
            return
        if not conn.authenticated:
            # unauthenticated conns exist only for the MAuth bootstrap
            logger.warning("%s: dropping %s from unauthenticated %s",
                           self.name, msg.TYPE, conn.peer_name)
            return
        if isinstance(msg, messages.MOSDBoot):
            _bg(self._handle_boot(conn, msg))
        elif isinstance(msg, messages.MAccelBoot):
            _bg(self._handle_accel_boot(conn, msg))
        elif isinstance(msg, messages.MOSDFailure):
            _bg(self._handle_failure(msg))
        elif isinstance(msg, messages.MLog):
            # the ring lives where leadership lives (the reference
            # paxos-commits log entries): a peon forwards, like
            # MOSDBoot/MOSDFailure, or `log last` at the leader would
            # silently miss entries from OSDs homed at peons
            if self.is_leader or self.solo:
                self._handle_clog(msg)
            elif self.leader_rank is not None:
                _bg(self._send_peer(self.leader_rank, msg))
        elif isinstance(msg, messages.MLogSub):
            # follow the ring where it lives: clients pin the leader
            # with a command round-trip before subscribing (ceph -w).
            # Always ACK/NACK — a silent discard on a mid-election mon
            # left the watcher blocked forever
            ok = bool(msg.sub) and (self.is_leader or self.solo)
            if ok:
                self._log_subs.add(conn)
            else:
                self._log_subs.discard(conn)
            if msg.sub:
                conn.send(messages.MLogSub(sub=ok))
        elif isinstance(msg, messages.MMonGetMap):
            self._subs.add(conn)
            if msg.have is None:
                # explicit full-map request (bootstrap or a receiver that
                # could not bridge a delta chain): never answer with incs
                self._sub_epochs.pop(conn, None)
                self._send_map(conn)
            elif msg.have < self.osdmap.epoch:
                self._send_map(conn, have=msg.have)
            else:
                self._sub_epochs[conn] = msg.have
        elif isinstance(msg, messages.MOSDMapMsg):
            # a newer committed map from the leader (peon catch-up).
            # Stamp the SENDER's commit epoch — stamping our own
            # election_epoch (which election loops can ratchet far past
            # the quorum's) would let this map out-rank genuinely newer
            # commits in a later recovery
            if msg.epoch > self.osdmap.epoch:
                from ..osd.osdmap import advance_map

                m = advance_map(
                    self.osdmap, msg.epoch, msg.osdmap, msg.incrementals
                )
                if m is None:
                    # delta chain does not reach us: ask for the full map
                    conn.send(messages.MMonGetMap(have=None))
                    return
                self.osdmap = m
                self._last_map_dict = self.osdmap.to_dict()
                # accepted values at or below the adopted COMMITTED
                # epoch are superseded: keeping them would let a later
                # delta propose seed from the dead branch
                for v in [v for v in self._pending_commit
                          if v <= self.osdmap.epoch]:
                    del self._pending_commit[v]
                self._sync_accepted()
                if msg.committed_epoch is not None:
                    self.map_committed_epoch = msg.committed_epoch
                self._save_store()
                self._publish_subs()
        elif isinstance(msg, messages.MMonCommand):
            if not self.is_leader and not self.solo:
                # redirect: the client re-targets the leader (reference
                # forwards via PaxosService; a redirect keeps the mon lean)
                lr = self.leader_rank
                conn.send(messages.MMonCommandReply(
                    tid=msg.tid, code=-EAGAIN, status="not leader",
                    out={
                        "leader": lr,
                        "addr": self.monmap[lr] if lr is not None else None,
                    },
                ))
                return
            _bg(self._command_and_reply(conn, msg))
        elif isinstance(msg, messages.MMonElection):
            await self._handle_election(msg)
        elif isinstance(msg, messages.MMonPaxos):
            await self._handle_paxos(msg)
        elif isinstance(msg, messages.MMonLease):
            self._handle_lease(msg)
        elif isinstance(msg, messages.MPing):
            conn.send(messages.MPingReply(stamp=msg.stamp, epoch=self.osdmap.epoch))

    def ms_handle_reset(self, conn: Connection) -> None:
        self._subs.discard(conn)
        self._log_subs.discard(conn)
        self._sub_epochs.pop(conn, None)
        for osd, c in list(self._boot_conns.items()):
            if c is conn:
                del self._boot_conns[osd]
                if self.osdmap.is_up(osd):
                    logger.info("%s: osd.%d connection reset -> down", self.name, osd)
                    _bg(self._report_down(osd, MON_REPORTER_BASE + self.rank))
        for name, c in list(self._accel_conns.items()):
            if c is conn:
                # the accelerator's registration link died: the TCP FIN
                # is the fastest death signal on loopback (the same rule
                # the OSD boot conns follow) — mark it down in the
                # AccelMap and publish, so routers shed it immediately
                del self._accel_conns[name]
                entry = self.osdmap.accelmap.by_name(name)
                if entry is not None and entry.up:
                    logger.info("%s: accel %s connection reset -> down",
                                self.name, name)
                    _bg(self._accel_mark_down(name))

    async def _report_down(self, osd: int, reporter: int) -> None:
        """Route a locally-observed OSD death like any failure report:
        handled if we lead, forwarded to the leader if not."""
        await self._handle_failure(
            messages.MOSDFailure(
                target_osd=osd, reporter=reporter, epoch=self.osdmap.epoch
            )
        )

    # -- accelerator fleet (AccelMap) ------------------------------

    def _accel_gauges(self) -> None:
        pmon = self.perf.get("mon")
        pmon.set("accelmap_epoch", self.osdmap.accelmap.epoch)
        pmon.set("accels_up", len(self.osdmap.accelmap.up_entries()))

    async def _handle_accel_boot(self, conn: Connection,
                                 msg: messages.MAccelBoot) -> None:
        """Register/refresh (or, with ``down=True``, deregister) one
        accelerator in the AccelMap — the MOSDBoot analog: handled at
        the leader, forwarded from peons (the accel's map subscription
        keeps being served locally), published on actual change only
        (steady-state registration beacons cost no epoch churn)."""
        name = str(msg.name or "")
        if not name:
            return
        self.perf.get("mon").inc("accel_boots")
        if not msg.down:
            # any registration word — forwarded ones included — feeds
            # the staleness clock: an accel homed at a peon beacons
            # through forwarding, and the leader must not grace it out
            self._accel_beacons[name] = time.monotonic()
        if not msg.down and not conn.peer_name.startswith("mon."):
            # only the accelerator's OWN connection is its liveness
            # conn (the _handle_boot rule: a forwarded registration
            # rides the peon's mon-peer link)
            self._accel_conns[name] = conn
            self._subs.add(conn)
        if not self.is_leader:
            if self.leader_rank is not None:
                await self._send_peer(self.leader_rank, msg)
            return
        if msg.down:
            await self._accel_mark_down(name)
            return
        async with self._commit_lock:
            changed = self.osdmap.accelmap.note_boot(
                name, str(msg.addr or ""), str(msg.locality or ""),
                int(msg.capacity or 0),
            )
            self._accel_gauges()
            if changed:
                logger.info(
                    "%s: accel %s registered at %s (locality=%r, "
                    "accelmap e%d)", self.name, name, msg.addr,
                    msg.locality, self.osdmap.accelmap.epoch,
                )
                self.clog_append(
                    self.name, "info",
                    f"accel {name} registered ({msg.addr})",
                )
                await self._publish()

    async def _accel_mark_down(self, name: str) -> None:
        """Mark one accelerator down and publish (leader), or forward
        the markdown to the leader (peon) — beacon loss and connection
        resets both land here."""
        if not self.is_leader:
            if self.leader_rank is not None:
                await self._send_peer(self.leader_rank, messages.MAccelBoot(
                    name=name, addr="", locality="", capacity=0, down=True,
                ))
            return
        self._accel_down_pending.add(name)
        try:
            async with self._commit_lock:
                if self.osdmap.accelmap.mark_down(name):
                    self._accel_gauges()
                    self.clog_append(self.name, "warn",
                                     f"accel {name} marked down")
                    await self._publish()
        finally:
            self._accel_down_pending.discard(name)

    def _check_accel_beacons(self) -> None:
        """Leader tick: a registered, up accelerator silent past
        ``mon_accel_beacon_grace`` is marked down (the beacon-loss
        path; a freshly-elected leader starts every clock on its first
        tick, like the mgr/mds beacon checks)."""
        grace = self.config.mon_accel_beacon_grace
        now = time.monotonic()
        for e in self.osdmap.accelmap.up_entries():
            last = self._accel_beacons.get(e.name)
            if last is None:
                self._accel_beacons[e.name] = now
                continue
            if now - last > grace and e.name not in self._accel_down_pending:
                logger.warning(
                    "%s: accel %s beacon silent for %.1fs -> down",
                    self.name, e.name, now - last,
                )
                _bg(self._accel_mark_down(e.name))

    def _cmd_accel_ls(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph accel ls``: the published fleet map."""
        return 0, "", self.osdmap.accelmap.to_dict()

    # -- election (reference:src/mon/Elector.cc, lowest rank wins) -----------

    async def _start_election(self) -> None:
        if self._electing:
            return
        self._electing = True
        try:
            if self.rank:
                # stagger by rank: give lower ranks' proposals time to
                # arrive so we defer instead of racing to a dual victory
                # at the same epoch (the defer path cancels this task
                # mid-sleep).  The reference Elector gets the same effect
                # from its propose/defer timing.
                await asyncio.sleep(
                    min(0.05 * self.rank, self.config.mon_election_timeout / 4)
                )
            while True:
                self.election_epoch += 1
                self.perf.get("mon").inc("election_calls")
                self.leader_rank = None
                self._election_acks = {}
                epoch = self.election_epoch
                logger.info(
                    "%s: starting election epoch %d", self.name, epoch
                )
                for r in self._peer_ranks():
                    # proposals carry our state summary so an incumbent
                    # leader can tell a routine timeout election (we hold
                    # nothing newer -> it safely reasserts) from a
                    # post-partition one (we hold newer committed or
                    # accepted state -> it must run recovery)
                    await self._send_peer(r, messages.MMonElection(
                        op="propose", epoch=epoch, rank=self.rank,
                        map_epoch=self.osdmap.epoch, osdmap=None,
                        committed_epoch=self.map_committed_epoch,
                        accepted=self._accepted_register(),
                    ))
                await asyncio.sleep(self.config.mon_election_timeout / 2)
                if self.leader_rank is not None:
                    return  # lost to a lower rank (victory arrived)
                acks = dict(self._election_acks)
                if 1 + len(acks) >= self._majority():
                    # acks may carry higher epochs from peers that saw later
                    # elections: adopt the max so our victory outranks every
                    # stale view (otherwise a rejoining rank-0 mon's victory
                    # is ignored and the quorum split-brains)
                    self.election_epoch = max(
                        [self.election_epoch]
                        + [a.epoch for a in acks.values()]
                    )
                    await self._declare_victory(self.election_epoch, acks)
                    return
                # no quorum reachable: keep trying (cluster is down anyway)
                await asyncio.sleep(self.config.mon_election_timeout / 2)
        finally:
            self._electing = False

    def _sync_accepted(self) -> None:
        """Mirror the in-memory accepted register to the durable store
        (reference Paxos persists the uncommitted value)."""
        if self._db_store is not None:
            self._db_store.set_accepted(self._accepted_register())

    def _accepted_register(self) -> dict | None:
        """This mon's highest accepted-but-uncommitted proposal, for the
        election ack (Paxos 'last' message uncommitted-value carry)."""
        if not self._pending_commit:
            return None
        version = max(self._pending_commit)
        pepoch, value = self._pending_commit[version]
        return {"epoch": pepoch, "version": version, "value": value}

    async def _declare_victory(self, epoch: int, acks) -> None:
        self.perf.get("mon").inc("election_wins")
        # Paxos recovery over full-map snapshots: adopt the newest
        # COMMITTED map in the quorum, then — the collect/last phase —
        # the highest ACCEPTED proposal (ordered by (election epoch,
        # version)) if it is newer than every committed map.  This closes
        # the lost-acked-write window: a leader that got majority acks,
        # applied, replied to the client, and died before broadcasting
        # the commit leaves the value in its peons' accepted registers,
        # and the new leader must surface it
        # (reference:src/mon/Paxos.cc handle_last uncommitted handling).
        committed = (self.map_committed_epoch, self.osdmap.epoch)
        for ack in acks.values():
            ce = ack.committed_epoch or 0
            if ack.osdmap and (ce, ack.map_epoch) > committed:
                self._adopt_map(ack.osdmap)
                self.map_committed_epoch = ce
                committed = (ce, ack.map_epoch)
        best = self._accepted_register()
        for ack in acks.values():
            acc = ack.accepted
            if acc and (
                best is None
                or (acc["epoch"], acc["version"])
                > (best["epoch"], best["version"])
            ):
                best = acc
        if best is not None and (
            (best["epoch"], best["version"]) > committed
            and best["version"] > self.osdmap.epoch
        ):
            logger.info(
                "%s: adopting accepted-but-uncommitted map v%d from "
                "election epoch %d (dead leader's in-flight commit)",
                self.name, best["version"], best["epoch"],
            )
            self._adopt_map(best["value"])
        self._pending_commit.clear()
        self._sync_accepted()
        # whatever we now hold is chosen at THIS election's epoch: the
        # victory broadcast below is its commit
        self.map_committed_epoch = epoch
        self._victory_epoch = epoch
        self.leader_rank = self.rank
        # the quorum this victory was formed over (ceph quorum_status);
        # the lease loop refreshes the live view from scratch
        self._quorum_ranks = sorted({self.rank, *acks.keys()})
        self._lease_ok = {}
        self._save_store()
        logger.info(
            "%s: won election epoch %d (map epoch %d)",
            self.name, epoch, self.osdmap.epoch,
        )
        for r in self._peer_ranks():
            await self._send_peer(r, messages.MMonElection(
                op="victory", epoch=epoch, rank=self.rank,
                map_epoch=self.osdmap.epoch, osdmap=self.osdmap.to_dict(),
            ))
        if self._lease_task is None:
            self._lease_task = asyncio.ensure_future(self._lease_loop())
        self._publish_subs()

    async def _handle_election(self, msg: messages.MMonElection) -> None:
        if msg.op == "propose":
            if msg.rank < self.rank:
                # defer to the lower rank; the ack carries our committed
                # map (recovery) and our election epoch (the proposer
                # adopts the max, so its victory outranks stale views)
                self.election_epoch = max(self.election_epoch, msg.epoch)
                self.leader_rank = None
                self._stop_leading()
                self._last_lease = time.monotonic()  # give it time to win
                if self._electing and self._election_task is not None:
                    # stand down our own in-flight election: acking the
                    # lower rank while still collecting our own acks
                    # produces dual victories at the same epoch (the
                    # lease watchdog re-elects if the winner dies)
                    self._election_task.cancel()
                    self._election_task = None
                    self._electing = False
                await self._send_peer(msg.rank, messages.MMonElection(
                    op="ack", epoch=self.election_epoch, rank=self.rank,
                    map_epoch=self.osdmap.epoch,
                    osdmap=self.osdmap.to_dict(),
                    committed_epoch=self.map_committed_epoch,
                    accepted=self._accepted_register(),
                ))
            else:
                # a higher rank proposing: we should lead instead
                if self.is_leader:
                    mine = (self.map_committed_epoch, self.osdmap.epoch)
                    theirs = (msg.committed_epoch or 0, msg.map_epoch or 0)
                    acc = msg.accepted
                    theirs_acc = (
                        (acc["epoch"], acc["version"]) if acc else (0, 0)
                    )
                    if theirs <= mine and theirs_acc <= mine:
                        # routine timeout election: the proposer holds
                        # nothing newer than us (committed OR accepted),
                        # so reasserting our leadership at its epoch is
                        # safe — remind it who leads (else it ignores the
                        # victory as stale and loops forever).  Any state
                        # committed since our victory lives on a majority
                        # (that's what commit means), so a proposer with
                        # nothing newer cannot be fronting for a newer
                        # quorum we missed.
                        self.election_epoch = max(
                            self.election_epoch, msg.epoch
                        )
                        self._victory_epoch = self.election_epoch
                        await self._send_peer(msg.rank, messages.MMonElection(
                            op="victory", epoch=self.election_epoch,
                            rank=self.rank, map_epoch=self.osdmap.epoch,
                            osdmap=self.osdmap.to_dict(),
                        ))
                    else:
                        # the proposer holds NEWER committed/accepted
                        # state: another quorum ran while we were
                        # partitioned (and its leader may be dead — no
                        # lease will depose us).  Reasserting would
                        # reimpose a stale map; step down and run a real
                        # election whose recovery phase adopts the newer
                        # state before we lead again.
                        logger.warning(
                            "%s: proposer mon.%d holds newer state "
                            "(%s/%s > %s) — stepping down for recovery",
                            self.name, msg.rank, theirs, theirs_acc, mine,
                        )
                        self.leader_rank = None
                        self._stop_leading()
                        self.election_epoch = max(
                            self.election_epoch, msg.epoch
                        )
                        if not self._electing:
                            self._election_task = _bg(self._start_election())
                elif not self._electing:
                    self._election_task = _bg(self._start_election())
        elif msg.op == "ack":
            if msg.epoch >= self.election_epoch:
                self._election_acks[msg.rank] = msg
        elif msg.op == "victory":
            if msg.rank <= self.rank and msg.epoch >= self.election_epoch:
                self.election_epoch = msg.epoch
                self.leader_rank = msg.rank
                self._stop_leading()
                self._last_lease = time.monotonic()
                # our accepted register is resolved: the new leader either
                # adopted its value (it arrives in this victory / a later
                # commit) or superseded it
                self._pending_commit.clear()
                self._sync_accepted()
                if msg.map_epoch > self.osdmap.epoch and msg.osdmap:
                    self._adopt_map(msg.osdmap)
                    self.map_committed_epoch = msg.epoch
                    self._save_store()
                    self._publish_subs()
                elif msg.map_epoch == self.osdmap.epoch:
                    # we already hold the chosen map: re-stamp it at the
                    # winning election's epoch, or a deposed leader's
                    # locally-applied (-EAGAIN'd) mutation could out-rank
                    # it in a later recovery
                    self.map_committed_epoch = msg.epoch
                    self._save_store()
                logger.info(
                    "%s: mon.%d leads (election epoch %d)",
                    self.name, msg.rank, msg.epoch,
                )

    def _stop_leading(self) -> None:
        if self._lease_task is not None:
            self._lease_task.cancel()
            self._lease_task = None

    # -- leases ---------------------------------------------------------------

    async def _lease_loop(self) -> None:
        try:
            while self.is_leader:
                for r in self._peer_ranks():
                    ok = await self._send_peer(r, messages.MMonLease(
                        epoch=self.election_epoch, rank=self.rank,
                        map_epoch=self.osdmap.epoch,
                    ))
                    # live reachability view for quorum_status: the
                    # victory-time membership alone goes stale the
                    # moment a peon dies
                    self._lease_ok[r] = ok
                await asyncio.sleep(self.config.mon_lease_interval)
        except asyncio.CancelledError:
            pass

    def _handle_lease(self, msg: messages.MMonLease) -> None:
        if (
            self.is_leader and msg.rank != self.rank
            and (
                msg.epoch > self._victory_epoch
                or (msg.epoch == self._victory_epoch
                    and msg.rank < self.rank)
            )
        ):
            # another mon is leading at an epoch we never WON (the quorum
            # elected it while we were partitioned — we may have absorbed
            # its epoch from an overheard propose without winning it), or
            # a lower rank won the same epoch in a startup race: our
            # leadership is stale.  Step down and call a new election —
            # as the lowest reachable rank we may well win it, but the
            # recovery phase makes us adopt the newer quorum's state
            # first (the reference Elector bootstraps on any message
            # from a higher election epoch).
            logger.warning(
                "%s: mon.%d is leading at election epoch %d (mine %d) — "
                "deposed, re-electing", self.name, msg.rank, msg.epoch,
                self.election_epoch,
            )
            self.leader_rank = None
            self._stop_leading()
            self.election_epoch = msg.epoch
            self._last_lease = time.monotonic()
            if not self._electing:
                self._election_task = _bg(self._start_election())
            return
        if msg.rank == self.leader_rank or (
            self.leader_rank is None
            and msg.epoch >= self.election_epoch
            and msg.rank <= self.rank
        ):
            # a live lease from the (or a credible) leader: adopt + renew
            self.leader_rank = msg.rank
            self.election_epoch = max(self.election_epoch, msg.epoch)
            self._last_lease = time.monotonic()
            if msg.map_epoch > self.osdmap.epoch:
                # we missed a commit (transient partition): pull the map
                # from the leader — its MMonGetMap path replies with the
                # full snapshot and keeps us subscribed
                _bg(self._send_peer(msg.rank, messages.MMonGetMap(
                    have=self.osdmap.epoch
                )))

    async def _lease_watchdog(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.config.mon_election_timeout / 2)
                if self.is_leader or self._electing:
                    continue
                if (
                    time.monotonic() - self._last_lease
                    > self.config.mon_election_timeout
                ):
                    logger.warning(
                        "%s: leader mon.%s lease expired",
                        self.name, self.leader_rank,
                    )
                    await self._start_election()
        except asyncio.CancelledError:
            pass

    # -- replicated commit (Paxos-lite) ---------------------------------------

    def _paxos_decode_value(self, msg: messages.MMonPaxos) -> "dict | None":
        """Materialize the FULL map dict a propose carries: snapshot,
        legacy bare dict, or a delta applied to this mon's own state
        (the O(churn) wire form).  None = cannot derive (caller answers
        need_full).  The accepted REGISTER always stores full maps, so
        election recovery is untouched by the wire encoding."""
        import json as _json

        val = msg.value
        if not isinstance(val, dict):
            return None
        if "inc" in val and "epoch" not in val:
            inc_d = val["inc"]
            base_epoch = int(inc_d["base"])
            base_dict = None
            # COMMITTED state first: an accepted-but-uncommitted value
            # at the base version may have been superseded by another
            # quorum's commit we later caught up to (seeding
            # the delta from the stale register would fork the map)
            if self.osdmap.epoch == base_epoch:
                base_dict = self._last_map_dict or self.osdmap.to_dict()
            else:
                pend = self._pending_commit.get(base_epoch)
                if pend is not None and (
                    int(pend[1].get("epoch", -1)) == base_epoch
                ):
                    base_dict = pend[1]
            if base_dict is None:
                return None
            full = _json.loads(_json.dumps(base_dict))  # private copy
            Incremental.from_dict(inc_d).apply_to_dict(full)
            return full
        if "full" in val and "epoch" not in val:
            return val["full"]
        return val  # legacy bare map dict

    async def _handle_paxos(self, msg: messages.MMonPaxos) -> None:
        if msg.op == "propose":
            if msg.rank != self.leader_rank or msg.epoch < self.election_epoch:
                # stale leader (by identity or by election epoch): a
                # deposed leader racing across a partition heal must not
                # get its proposal accepted (reference Paxos rejects
                # lower proposal numbers in the accept phase)
                return
            full = self._paxos_decode_value(msg)
            if full is None:
                # we lack the delta's base (restarted / lagging): ask
                # the leader to re-propose with the snapshot
                await self._send_peer(msg.rank, messages.MMonPaxos(
                    op="need_full", epoch=msg.epoch, rank=self.rank,
                    version=msg.version, value=None,
                ))
                return
            # keep only the newest pending value: uncommitted older
            # snapshots are superseded and would otherwise accumulate
            for v in [v for v in self._pending_commit if v < msg.version]:
                del self._pending_commit[v]
            self._pending_commit[msg.version] = (msg.epoch, full)
            # persist the accepted register BEFORE acking: the ack is a
            # durable promise — if we crash and restart, the election
            # recovery must still be able to surface this value
            # (reference Paxos stores the uncommitted value)
            self._sync_accepted()
            await self._send_peer(msg.rank, messages.MMonPaxos(
                op="ack", epoch=msg.epoch, rank=self.rank,
                version=msg.version, value=None,
            ))
        elif msg.op == "need_full":
            # a peon could not apply our delta: re-propose the snapshot
            # to exactly that rank (reference Paxos catch-up share)
            if (
                self.is_leader
                and msg.version == self.osdmap.epoch
                and msg.epoch >= self._victory_epoch
            ):
                await self._send_peer(msg.rank, messages.MMonPaxos(
                    op="propose", epoch=self.election_epoch,
                    rank=self.rank, version=msg.version,
                    value={"full": self._last_map_dict
                           or self.osdmap.to_dict()},
                ))
        elif msg.op == "ack":
            acks = self._paxos_acks.get(msg.version)
            if acks is not None:
                acks.add(msg.rank)
                if 1 + len(acks) >= self._majority():
                    ev = self._paxos_events.get(msg.version)
                    if ev is not None:
                        ev.set()
        elif msg.op == "commit":
            if msg.rank != self.leader_rank or msg.epoch < self.election_epoch:
                return  # a deposed leader's commit: superseded
            entry = self._pending_commit.pop(msg.version, None)
            self._sync_accepted()
            if entry is not None and msg.version > self.osdmap.epoch:
                _epoch, value = entry
                self.osdmap = OSDMap.from_dict(value)
                # consecutive commit: _record_inc keeps the peon's delta
                # chain alive so ITS subscribers also get O(churn) pushes
                inc = self._record_inc(value)
                self.map_committed_epoch = msg.epoch
                self._save_store(inc=inc)
                self._publish_subs()
            elif entry is None and msg.version > self.osdmap.epoch:
                # the quorum committed a version we never accepted (our
                # need_full round-trip raced the majority): catch up
                # from the leader instead of silently staying stale
                # (with full-value proposes this could not happen;
                # deltas opened the window)
                await self._send_peer(msg.rank, messages.MMonGetMap(
                    have=self.osdmap.epoch
                ))

    def _valid_osd_id(self, osd) -> bool:
        return isinstance(osd, int) and 0 <= osd < self.osdmap.max_osd

    # -- osd lifecycle
    async def _handle_boot(self, conn: Connection, msg: messages.MOSDBoot) -> None:
        osd = msg.osd_id
        if not self._valid_osd_id(osd):
            logger.warning("%s: rejecting boot with bad osd id %r", self.name, osd)
            return
        if not conn.peer_name.startswith("mon."):
            # only the OSD's OWN connection may be its liveness conn: a
            # forwarded boot arrives on the peon's mon-peer connection,
            # and tracking that would mark every OSD homed at the peon
            # down the moment the peon dies
            self._boot_conns[osd] = conn
            self._subs.add(conn)
        if not self.is_leader:
            # forward the report to the leader; we keep serving this
            # OSD's map subscription locally
            if self.leader_rank is not None:
                await self._send_peer(self.leader_rank, msg)
            return
        async with self._commit_lock:
            # a reboot of an operator-out osd must NOT mark it back in
            # (reference mon_osd_auto_mark_in=false semantics); only a
            # first-ever boot auto-ins the device
            first_boot = not self.osdmap.exists(osd)
            self.osdmap.mark_up(osd, addr=msg.addr)
            if first_boot or self.osdmap.is_in(osd):
                self.osdmap.mark_in(osd)
            self._failure_reports.pop(osd, None)
            logger.info("%s: osd.%d booted at %s", self.name, osd, msg.addr)
            self.clog_append(self.name, "info",
                             f"osd.{osd} boot ({msg.addr})")
            await self._publish()

    def _handle_clog(self, msg: messages.MLog) -> None:
        for e in list(msg.entries or []):
            self.clog_append(
                str(e.get("name", "?")), str(e.get("level", "info")),
                str(e.get("msg", "")), stamp=e.get("stamp"),
            )

    def clog_append(self, name: str, level: str, text: str,
                    stamp: float | None = None) -> None:
        """Append one cluster-log entry (LogMonitor ingest); the mon
        itself logs map-level events (osd down/boot) through this."""
        entry = {
            "stamp": float(stamp) if stamp is not None else time.time(),
            "name": name,
            "level": level if level in ("error", "warn", "info") else "info",
            "msg": text,
        }
        self.perf.get("mon").inc("clog_entries")
        self._cluster_log.append(entry)
        for c in list(self._log_subs):  # live followers (ceph -w)
            try:
                c.send(messages.MLog(entries=[entry]))
            except Exception:
                self._log_subs.discard(c)
        if self.store_path:
            import json as _json

            # batched + off-loop: per-entry synchronous file I/O in the
            # dispatch path would stall paxos/lease traffic under a log
            # storm
            self._clog_buf.append(_json.dumps(entry))
            if not self._clog_flush_scheduled:
                self._clog_flush_scheduled = True
                coro = self._flush_clog()
                try:
                    _bg(coro)
                except RuntimeError:  # no loop (tests poking directly)
                    coro.close()
                    self._clog_flush_scheduled = False
                    self._write_clog("\n".join(self._clog_buf) + "\n")
                    self._clog_buf.clear()

    async def _flush_clog(self) -> None:
        await asyncio.sleep(0.05)  # batch window
        self._clog_flush_scheduled = False
        buf, self._clog_buf = self._clog_buf, []
        if not buf:
            return
        data = "\n".join(buf) + "\n"
        await asyncio.get_running_loop().run_in_executor(
            None, self._write_clog, data
        )

    def _write_clog(self, data: str) -> None:
        """Append to <store>/cluster.log, rotating at 4 MiB (one .old
        generation) so the file stays bounded like the ring.  The lock
        makes rotate+append atomic across executor threads."""
        import os as _os

        path = _os.path.join(self.store_path, "cluster.log")
        try:
            with self._clog_file_lock:
                if (_os.path.exists(path)
                        and _os.path.getsize(path) > (4 << 20)):
                    _os.replace(path, path + ".old")
                with open(path, "a") as f:
                    f.write(data)
        except OSError:
            pass  # observability must never take down the mon

    def _cmd_log_last(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph log last [n] [level]`` (reference:src/mon/
        LogMonitor.cc summary dump)."""
        n = int(cmd.get("num", cmd.get("n", 20)))
        level = cmd.get("level")
        entries = list(self._cluster_log)
        if level:
            order = {"error": 2, "warn": 1, "info": 0}
            if level not in order:
                return -EINVAL, f"bad level {level!r}", None
            entries = [
                e for e in entries
                if order[e["level"]] >= order[level]
            ]
        tail = entries[-n:] if n > 0 else []
        # rendering is the CLI's job (ceph_cli._fmt_log_entry — the
        # single source of the line format); the command returns data
        return 0, "", {"entries": tail}

    def _cmd_osd_tree(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph osd tree`` (reference:src/mon/OSDMonitor.cc 'osd
        tree' -> CrushWrapper dump_tree): the CRUSH hierarchy with
        bucket weights and per-OSD status/reweight.  Shadow (device-
        class) buckets are skipped, like the reference without
        --show-shadow."""
        from ..crush.map import _item_weight_of

        crush = self.osdmap.crush
        nodes: list[dict] = []

        def walk(item: int, depth: int, weight: int) -> None:
            if item >= 0:
                reweight = (
                    self.osdmap.osd_weight[item] / 0x10000
                    if item < len(self.osdmap.osd_weight) else 0.0
                )
                nodes.append({
                    "id": item,
                    "name": crush.item_names.get(item, f"osd.{item}"),
                    "type": "osd",
                    "depth": depth,
                    "crush_weight": round(weight / 0x10000, 5),
                    "status": (
                        "up" if self.osdmap.is_up(item) else "down"
                    ),
                    "reweight": round(reweight, 5),
                    "class": crush.device_class(item),
                })
                return
            b = crush.buckets.get(item)
            if b is None:
                return
            nodes.append({
                "id": item,
                "name": crush.item_names.get(item, str(item)),
                "type": crush.type_names.get(b.type, str(b.type)),
                "depth": depth,
                "crush_weight": round(b.weight / 0x10000, 5),
            })
            for j, child in enumerate(b.items):
                walk(child, depth + 1, _item_weight_of(b, j))

        # -1 (usually "default") first
        for r in sorted(crush.tree_roots(), reverse=True):
            walk(r, 0, crush.buckets[r].weight)
        return 0, "", {"nodes": nodes}

    def _cmd_osd_map(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph osd map <pool> <object>``
        (reference:src/mon/OSDMonitor.cc 'osd map'): the object's pg
        and its current up/acting mapping."""
        pool_name = str(cmd.get("pool", ""))
        obj = str(cmd.get("object", ""))
        if not pool_name or not obj:
            return -EINVAL, "need pool + object", None
        pool = self.osdmap.lookup_pool(pool_name)
        if pool is None:
            return -ENOENT, f"no pool {pool_name!r}", None
        raw_pg = self.osdmap.object_locator_to_pg(obj, pool.id)
        pg = pool.raw_pg_to_pg(raw_pg)
        up, up_primary, acting, acting_primary = \
            self.osdmap.pg_to_up_acting_osds(pg)
        return 0, "", {
            "epoch": self.osdmap.epoch,
            "pool": pool_name,
            "pool_id": pool.id,
            "objname": obj,
            "raw_pgid": str(raw_pg),
            "pgid": str(pg),
            "up": up, "up_primary": up_primary,
            "acting": acting, "acting_primary": acting_primary,
        }

    def _cmd_quorum_status(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph quorum_status`` / ``ceph mon stat``
        (reference:src/mon/Monitor.cc handle_command quorum_status):
        the quorum the current term was formed over, the leader, and
        the monmap."""
        if self.solo:
            quorum = [self.rank]
        else:
            # victory-time members currently answering leases, plus any
            # member the lease loop has not probed yet — a live view,
            # not the stale election snapshot
            quorum = sorted(
                r for r in set(self._quorum_ranks)
                if r == self.rank or self._lease_ok.get(r, True)
            )
        return 0, "", {
            "election_epoch": self.election_epoch,
            "quorum": quorum,
            "quorum_names": [f"mon.{r}" for r in quorum],
            "quorum_leader_name": (
                f"mon.{self.leader_rank}"
                if self.leader_rank is not None else ""
            ),
            "monmap": {
                "epoch": self._monmap_epoch,
                "mons": [
                    {"rank": r, "name": f"mon.{r}", "addr": a}
                    for r, a in enumerate(self.monmap)
                ] if self.monmap else [
                    {"rank": self.rank, "name": self.name,
                     "addr": self.addr}
                ],
            },
        }

    async def _handle_failure(self, msg: messages.MOSDFailure) -> None:
        self.perf.get("mon").inc("failure_reports")
        target = msg.target_osd
        if not self._valid_osd_id(target) or not self.osdmap.is_up(target):
            return
        if not self.is_leader:
            if self.leader_rank is not None:
                await self._send_peer(self.leader_rank, msg)
            return
        reporters = self._failure_reports.setdefault(target, set())
        reporters.add(msg.reporter)
        if len(reporters) >= self.failure_min_reporters:
            async with self._commit_lock:
                if not self.osdmap.is_up(target):
                    return  # a concurrent report already committed this
                logger.info(
                    "%s: osd.%d marked down (%d reporters)",
                    self.name, target, len(reporters),
                )
                self.clog_append(
                    self.name, "warn",
                    f"osd.{target} failed ({len(reporters)} reporters "
                    f"from different hosts)",
                )
                self.osdmap.mark_down(target)
                self._failure_reports.pop(target, None)
                await self._publish()

    # -- map distribution / replication

    def _record_inc(self, new_dict: dict) -> dict | None:
        """Diff the committed map against its predecessor; cache and
        return the delta (None when continuity is unknown — e.g. right
        after adopting a foreign map)."""
        inc = None
        prev = self._last_map_dict
        if prev is not None and int(prev["epoch"]) == int(new_dict["epoch"]) - 1:
            inc = Incremental.diff(prev, new_dict).to_dict()
            self._inc_cache[int(new_dict["epoch"])] = inc
            floor = int(new_dict["epoch"]) - INC_CACHE_EPOCHS
            for e in [e for e in self._inc_cache if e <= floor]:
                del self._inc_cache[e]
        self._last_map_dict = new_dict
        return inc

    def _adopt_map(self, map_dict: dict) -> None:
        """Replace the map wholesale (election recovery / peer catch-up):
        delta continuity restarts from here."""
        self.osdmap = OSDMap.from_dict(map_dict)
        self._last_map_dict = map_dict

    def _collect_incs(self, base: int, cur: int) -> list[dict] | None:
        """Contiguous delta chain (base, cur]; None if any epoch is
        missing from the cache (sender falls back to the full map)."""
        if base >= cur:
            return []
        out = []
        for e in range(base + 1, cur + 1):
            inc = self._inc_cache.get(e)
            if inc is None or int(inc["base"]) != e - 1:
                return None
            out.append(inc)
        return out

    async def _publish(self) -> bool:
        """Commit a map mutation: bump the epoch, replicate to a majority
        (multi-mon), persist, push to subscribers.  Returns False when no
        quorum acked (the mutation stands locally but unreplicated —
        callers surface -EAGAIN; the next quorum re-syncs from the
        leader's map)."""
        self.osdmap.epoch += 1
        pmon = self.perf.get("mon")
        pmon.inc("map_publishes")
        pmon.set("map_epoch", self.osdmap.epoch)
        pmon.set("subscribers", len(self._subs))
        inc = self._record_inc(self.osdmap.to_dict())
        ok = True
        if not self.solo and self.is_leader:
            version = self.osdmap.epoch
            full_value = self._last_map_dict
            self._paxos_acks[version] = set()
            ev = self._paxos_events[version] = asyncio.Event()
            try:
                # up to 3 propose rounds: a transient re-election makes
                # peons reject the first round's (now stale) epoch; once
                # it settles — with us still leading — re-propose at the
                # new epoch instead of failing the client op (the
                # reference's Paxos waits for a writeable quorum).
                # Round 1 ships the DELTA (O(churn) wire, the multi-
                # decree-log property of the reference's Paxos over
                # MonitorDBStore); a peon that cannot apply it answers
                # need_full, and retry rounds ship the snapshot
                for round_ in range(3):
                    if round_ and not self.is_leader:
                        ok = False
                        break
                    value = (
                        {"inc": inc} if inc is not None and round_ == 0
                        else {"full": full_value}
                    )
                    for r in self._peer_ranks():
                        await self._send_peer(r, messages.MMonPaxos(
                            op="propose", epoch=self.election_epoch,
                            rank=self.rank, version=version, value=value,
                        ))
                    if self._majority() <= 1:
                        break
                    try:
                        async with asyncio.timeout(
                            self.config.mon_election_timeout
                        ):
                            await ev.wait()
                        ok = True
                        break
                    except TimeoutError:
                        logger.warning(
                            "%s: commit %d: no quorum (round %d)",
                            self.name, version, round_ + 1,
                        )
                        ok = False
                if ok:
                    self.map_committed_epoch = self.election_epoch
                    for r in self._peer_ranks():
                        await self._send_peer(r, messages.MMonPaxos(
                            op="commit", epoch=self.election_epoch,
                            rank=self.rank, version=version, value=None,
                        ))
            finally:
                self._paxos_acks.pop(version, None)
                self._paxos_events.pop(version, None)
        elif self.solo:
            self.map_committed_epoch = self.election_epoch
        self._save_store(inc=inc)
        self._publish_subs()
        return ok

    def _publish_subs(self) -> None:
        for conn in list(self._subs):
            self._send_map(conn)

    def _send_map(self, conn: Connection, have: int | None = None) -> None:
        """Push the current map: a contiguous delta chain when we know
        what the receiver holds (O(churn) bytes — the reference's
        MOSDMap incremental_maps path), else the full snapshot."""
        cur = self.osdmap.epoch
        base = have if have is not None else self._sub_epochs.get(conn)
        incs = self._collect_incs(base, cur) if base is not None else None
        if incs is not None and 0 < len(incs):
            conn.send(messages.MOSDMapMsg(
                epoch=cur, osdmap=None,
                committed_epoch=self.map_committed_epoch,
                incrementals=incs,
            ))
        elif incs is not None and not incs:
            pass  # receiver is already current
        else:
            conn.send(messages.MOSDMapMsg(
                epoch=cur, osdmap=self.osdmap.to_dict(),
                committed_epoch=self.map_committed_epoch,
            ))
        self._sub_epochs[conn] = cur

    async def _command_and_reply(
        self, conn: Connection, msg: messages.MMonCommand
    ) -> None:
        code, status, out = await self.handle_command_async(msg.cmd)
        conn.send(messages.MMonCommandReply(
            tid=msg.tid, code=code, status=status, out=out
        ))

    # -- commands (reference:src/mon/MonCommands.h subset)
    async def handle_command_async(self, cmd: dict) -> tuple[int, str, Any]:
        """Run a command; mutating handlers return an awaitable commit.
        The commit lock serializes concurrent mutations (handlers run as
        tasks, and interleaved epoch bumps would fork the map)."""
        async with self._commit_lock:
            code, status, out = self.handle_command(cmd)
            if code == 0 and self._dirty:
                self._dirty = False
                if not await self._publish():
                    return -EAGAIN, "no quorum: change not committed", None
        return code, status, out

    _dirty = False

    def _mark_dirty(self) -> None:
        """Handlers call this instead of publishing inline; the async
        wrapper commits (and replicates) once, after the mutation."""
        self._dirty = True

    def handle_command(self, cmd: dict) -> tuple[int, str, Any]:
        prefix = cmd.get("prefix", "")
        self.perf.get("mon").inc("commands")
        try:
            handler = {
                "osd erasure-code-profile set": self._cmd_ec_profile_set,
                "osd erasure-code-profile get": self._cmd_ec_profile_get,
                "osd erasure-code-profile ls": self._cmd_ec_profile_ls,
                "osd erasure-code-profile rm": self._cmd_ec_profile_rm,
                "osd pool create": self._cmd_pool_create,
                "osd pool ls": self._cmd_pool_ls,
                "osd pool rm": self._cmd_pool_rm,
                "osd pool rename": self._cmd_pool_rename,
                "osd pool set": self._cmd_pool_set,
                "osd pool get": self._cmd_pool_get,
                "osd pool set-quota": self._cmd_pool_set_quota,
                "osd pool get-quota": self._cmd_pool_get_quota,
                "osd pool quota-full": self._cmd_pool_quota_full,
                "osd reweight": self._cmd_osd_reweight,
                "osd pool mksnap": self._cmd_pool_mksnap,
                "osd pool rmsnap": self._cmd_pool_rmsnap,
                "osd pool lssnap": self._cmd_pool_lssnap,
                "osd pool selfmanaged-snap create":
                    self._cmd_selfmanaged_snap_create,
                "osd pool selfmanaged-snap rm":
                    self._cmd_selfmanaged_snap_rm,
                "osd dump": self._cmd_osd_dump,
                "mgr beacon": lambda c: self._cmd_svc_beacon("mgr", c),
                "mgr fail": lambda c: self._cmd_svc_fail("mgr", c),
                "mgr prune-standbys": lambda c: self._cmd_svc_prune("mgr", c),
                "mds beacon": lambda c: self._cmd_svc_beacon("mds", c),
                "mds fail": lambda c: self._cmd_svc_fail("mds", c),
                "fs set max_mds": self._cmd_fs_set_max_mds,
                "mds prune-standbys": lambda c: self._cmd_svc_prune("mds", c),
                "log last": self._cmd_log_last,
                "accel ls": self._cmd_accel_ls,
                "quorum_status": self._cmd_quorum_status,
                "mon stat": self._cmd_quorum_status,
                "osd tree": self._cmd_osd_tree,
                "osd map": self._cmd_osd_map,
                "osd set": self._cmd_osd_set_flag,
                "osd unset": self._cmd_osd_unset_flag,
                "osd down": self._cmd_osd_down,
                "osd out": self._cmd_osd_out,
                "osd in": self._cmd_osd_in,
                "osd crush set-device-class": self._cmd_crush_set_class,
                "osd crush rm-device-class": self._cmd_crush_rm_class,
                "osd crush class ls": self._cmd_crush_class_ls,
                "osd crush class ls-osd": self._cmd_crush_class_ls_osd,
                "osd tier add": self._cmd_tier_add,
                "osd tier remove": self._cmd_tier_remove,
                "osd tier cache-mode": self._cmd_tier_cache_mode,
                "osd tier set-overlay": self._cmd_tier_set_overlay,
                "osd tier remove-overlay": self._cmd_tier_remove_overlay,
                "status": self._cmd_status,
            }.get(prefix)
            if handler is None:
                return -EINVAL, f"unknown command {prefix!r}", None
            return handler(cmd)
        except Exception as e:  # command errors must not kill the mon
            logger.exception("%s: command %r failed", self.name, prefix)
            return -EINVAL, str(e), None

    # -- cache tiering (reference:src/mon/OSDMonitor.cc "osd tier *"
    # command family) -------------------------------------------------------

    def _tier_pools(self, cmd: dict):
        base = self.osdmap.lookup_pool(cmd["pool"])
        tier = self.osdmap.lookup_pool(cmd["tierpool"])
        if base is None or tier is None:
            raise ValueError("no such pool")
        return base, tier

    def _cmd_tier_add(self, cmd: dict) -> tuple[int, str, Any]:
        base, tier = self._tier_pools(cmd)
        if tier.tier_of >= 0 and tier.tier_of != base.id:
            return -EINVAL, f"{tier.name} is already a tier", None
        if tier.id == base.id:
            return -EINVAL, "a pool cannot tier itself", None
        if tier.type != POOL_TYPE_REPLICATED:
            # the reference requires a replicated cache in front of an
            # EC base (EC pools can't host the tiering metadata ops)
            return -EINVAL, "cache tier must be a replicated pool", None
        tier.tier_of = base.id
        if tier.id not in base.tiers:
            base.tiers.append(tier.id)
        self._mark_dirty()
        return 0, f"pool {tier.name} is now a tier of {base.name}", None

    def _cmd_tier_remove(self, cmd: dict) -> tuple[int, str, Any]:
        base, tier = self._tier_pools(cmd)
        if base.read_tier == tier.id or base.write_tier == tier.id:
            return -EINVAL, "remove the overlay first", None
        if tier.id in base.tiers:
            base.tiers.remove(tier.id)
        tier.tier_of = -1
        tier.cache_mode = "none"
        self._mark_dirty()
        return 0, "", None

    def _cmd_tier_cache_mode(self, cmd: dict) -> tuple[int, str, Any]:
        tier = self.osdmap.lookup_pool(cmd["pool"])
        mode = cmd.get("mode", "")
        if tier is None:
            return -ENOENT, "no such pool", None
        if tier.tier_of < 0:
            return -EINVAL, f"{tier.name} is not a tier", None
        if mode not in ("none", "writeback"):
            return -EINVAL, f"unsupported cache mode {mode!r}", None
        base = self.osdmap.pools.get(tier.tier_of)
        if (
            mode == "none" and base is not None
            and tier.id in (base.read_tier, base.write_tier)
        ):
            # clients still redirect to the cache while the overlay is
            # up; mode=none would stop promotion and strand every
            # non-resident object behind ENOENT
            return -EINVAL, "remove the overlay before mode none", None
        tier.cache_mode = mode
        for key in ("hit_set_count", "hit_set_period",
                    "cache_target_full_ratio", "cache_target_dirty_ratio",
                    "cache_min_flush_age", "cache_min_evict_age"):
            if key in cmd:
                setattr(tier, key, type(getattr(tier, key))(cmd[key]))
        self._mark_dirty()
        return 0, "", None

    def _cmd_tier_set_overlay(self, cmd: dict) -> tuple[int, str, Any]:
        base, tier = self._tier_pools(cmd)
        if tier.tier_of != base.id:
            return -EINVAL, f"{tier.name} is not a tier of {base.name}", None
        if tier.cache_mode == "none":
            return -EINVAL, "set a cache-mode before the overlay", None
        base.read_tier = tier.id
        base.write_tier = tier.id
        self._mark_dirty()
        return 0, f"overlay for {base.name} is now {tier.name}", None

    def _cmd_tier_remove_overlay(self, cmd: dict) -> tuple[int, str, Any]:
        base = self.osdmap.lookup_pool(cmd["pool"])
        if base is None:
            return -ENOENT, "no such pool", None
        base.read_tier = -1
        base.write_tier = -1
        self._mark_dirty()
        return 0, "", None

    def _cmd_ec_profile_set(self, cmd: dict) -> tuple[int, str, Any]:
        name = cmd["name"]
        profile = {str(k): str(v) for k, v in cmd.get("profile", {}).items()}
        if name in self.osdmap.erasure_code_profiles:
            existing = self.osdmap.erasure_code_profiles[name]
            if existing == profile:
                return 0, "", None
            # an in-use profile can never be altered, even with force —
            # pools bake size/stripe_width from it at create time
            for pool in self.osdmap.pools.values():
                if pool.erasure_code_profile == name:
                    return (
                        -EINVAL,
                        f"profile {name!r} is in use by pool {pool.name!r}",
                        None,
                    )
            if not cmd.get("force"):
                return (
                    -EEXIST,
                    f"profile {name!r} exists with different parameters",
                    None,
                )
        # validate by instantiating the codec (reference:OSDMonitor.cc:4590)
        # on the host: the mon only proves the profile valid and never
        # encodes, so it needs no card
        plugin = profile.get("plugin", "jerasure")
        try:
            registry.instance().factory(plugin, dict(profile), device="cpu")
        except Exception as e:
            return -EINVAL, f"invalid profile: {e}", None
        self.osdmap.set_erasure_code_profile(name, profile)
        self._mark_dirty()
        return 0, "", None

    def _cmd_ec_profile_get(self, cmd: dict) -> tuple[int, str, Any]:
        name = cmd["name"]
        if name not in self.osdmap.erasure_code_profiles:
            return -ENOENT, f"no profile {name!r}", None
        return 0, "", self.osdmap.get_erasure_code_profile(name)

    def _cmd_ec_profile_ls(self, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", sorted(self.osdmap.erasure_code_profiles)

    def _cmd_ec_profile_rm(self, cmd: dict) -> tuple[int, str, Any]:
        name = cmd["name"]
        if name not in self.osdmap.erasure_code_profiles:
            return -ENOENT, f"no profile {name!r}", None
        for pool in self.osdmap.pools.values():
            if pool.erasure_code_profile == name:
                return -EINVAL, f"profile {name!r} is in use by pool {pool.name!r}", None
        del self.osdmap.erasure_code_profiles[name]
        self._mark_dirty()
        return 0, "", None

    def _cmd_pool_create(self, cmd: dict) -> tuple[int, str, Any]:
        name = cmd["pool"]
        existing = self.osdmap.lookup_pool(name)
        if existing is not None:
            return 0, f"pool {name!r} already exists", {"pool_id": existing.id}
        pg_num = int(cmd.get("pg_num", 8))
        if cmd.get("pool_type", "replicated") == "erasure":
            profile = cmd.get("erasure_code_profile", "default")
            pool = self.osdmap.create_erasure_pool(
                name, profile, pg_num=pg_num,
                stripe_unit=int(cmd.get("stripe_unit", 4096)),
            )
        else:
            pool = self.osdmap.create_replicated_pool(
                name, size=int(cmd.get("size", 3)), pg_num=pg_num,
                device_class=cmd.get("device_class") or None,
            )
        self._mark_dirty()
        return 0, "", {"pool_id": pool.id}

    def _cmd_pool_ls(self, cmd: dict) -> tuple[int, str, Any]:
        if not cmd.get("detail"):
            return 0, "", sorted(
                p.name for p in self.osdmap.pools.values()
            )
        # `ceph osd pool ls detail` (reference:OSDMonitor): per-pool
        # settings, flags and quotas
        from ..osd.osdmap import POOL_TYPE_ERASURE

        out = []
        for pid in sorted(self.osdmap.pools):
            p = self.osdmap.pools[pid]
            row = {
                "pool_id": pid, "pool_name": p.name,
                "type": ("erasure" if p.type == POOL_TYPE_ERASURE
                         else "replicated"),
                "size": p.size, "min_size": p.min_size,
                "pg_num": p.pg_num,
                "crush_rule": p.crush_ruleset,
                "quota_max_objects": p.quota_max_objects,
                "quota_max_bytes": p.quota_max_bytes,
                "flags": ([
                    "full_quota"
                ] if p.flags & FLAG_FULL_QUOTA else []),
            }
            if p.type == POOL_TYPE_ERASURE:
                row["erasure_code_profile"] = p.erasure_code_profile
            if p.tier_of >= 0:
                row["tier_of"] = p.tier_of
                row["cache_mode"] = p.cache_mode
            out.append(row)
        return 0, "", out

    def _cmd_pool_rename(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph osd pool rename <src> <dst>``
        (reference:OSDMonitor 'osd pool rename')."""
        pool = self.osdmap.lookup_pool(cmd.get("srcpool", ""))
        if pool is None:
            return -ENOENT, f"no pool {cmd.get('srcpool')!r}", None
        dst = str(cmd.get("destpool", ""))
        if not dst or "/" in dst:
            return -EINVAL, f"bad pool name {dst!r}", None
        if self.osdmap.lookup_pool(dst) is not None:
            return -EEXIST, f"pool {dst!r} exists", None
        del self.osdmap.pool_name[pool.name]
        pool.name = dst
        self.osdmap.pool_name[dst] = pool.id
        self._mark_dirty()
        return 0, f"pool renamed to {dst}", None

    def _cmd_pool_rm(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        del self.osdmap.pools[pool.id]
        del self.osdmap.pool_name[pool.name]
        self._mark_dirty()
        return 0, "", None

    # pool vars an operator may tune at runtime (reference:OSDMonitor.cc
    # prepare_command 'osd pool set' — the subset this data path reads)
    _POOL_VARS = {
        "size": int, "min_size": int,
        # cache tiering knobs (reference pg_pool_t tiering options)
        "hit_set_count": int, "hit_set_period": float,
        "cache_target_full_ratio": float,
        "cache_target_dirty_ratio": float,
        "cache_min_flush_age": float, "cache_min_evict_age": float,
        "target_max_objects": int, "target_max_bytes": int,
    }

    def _cmd_pool_set(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        var = cmd.get("var", "")
        conv = self._POOL_VARS.get(var)
        if conv is None:
            return -EINVAL, f"cannot set {var!r} (supported: " \
                            f"{sorted(self._POOL_VARS)})", None
        try:
            val = conv(cmd["val"])
        except (TypeError, ValueError):
            return -EINVAL, f"bad value for {var!r}", None
        if pool.is_erasure() and var == "size":
            return -EINVAL, "EC pool size is fixed by its profile", None
        if var == "min_size" and not (1 <= val <= pool.size):
            return -EINVAL, f"min_size must be in [1, {pool.size}]", None
        if var == "size" and not (1 <= val <= self.osdmap.max_osd):
            return -EINVAL, "size out of range", None
        setattr(pool, var, val)
        if var == "size" and pool.min_size > val:
            pool.min_size = max(1, val - 1)
        self._mark_dirty()  # the epoch bump re-peers every PG
        return 0, f"set pool {pool.name} {var} = {val}", None

    def _cmd_pool_set_quota(self, cmd: dict) -> tuple[int, str, Any]:
        """``ceph osd pool set-quota <pool> max_objects|max_bytes <n>``
        (reference:src/mon/OSDMonitor.cc 'osd pool set-quota'); 0
        clears the quota."""
        pool = self.osdmap.lookup_pool(cmd.get("pool", ""))
        if pool is None:
            return -ENOENT, f"no pool {cmd.get('pool')!r}", None
        field = cmd.get("field", "")
        if field not in ("max_objects", "max_bytes"):
            return -EINVAL, "field must be max_objects|max_bytes", None
        try:
            val = int(cmd.get("val"))
        except (TypeError, ValueError):
            return -EINVAL, f"bad value {cmd.get('val')!r}", None
        if val < 0:
            return -EINVAL, "quota must be >= 0 (0 clears)", None
        setattr(pool, f"quota_{field}", val)
        if val == 0 and pool.quota_max_bytes == 0 \
                and pool.quota_max_objects == 0:
            pool.flags &= ~FLAG_FULL_QUOTA  # cleared quota unfills
        self._mark_dirty()
        return 0, f"set-quota {field} = {val} for pool {pool.name}", None

    def _cmd_pool_get_quota(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd.get("pool", ""))
        if pool is None:
            return -ENOENT, f"no pool {cmd.get('pool')!r}", None
        return 0, "", {
            "pool": pool.name,
            "max_objects": pool.quota_max_objects,
            "max_bytes": pool.quota_max_bytes,
            "full": bool(pool.flags & FLAG_FULL_QUOTA),
        }

    def _cmd_pool_quota_full(self, cmd: dict) -> tuple[int, str, Any]:
        """mgr -> mon: flip FLAG_FULL_QUOTA from the usage reports (the
        reference's PGMonitor does this map mutation itself; here the
        stats authority is the mgr, so it drives the flag)."""
        pool = self.osdmap.lookup_pool(cmd.get("pool", ""))
        if pool is None:
            return -ENOENT, f"no pool {cmd.get('pool')!r}", None
        want = bool(cmd.get("full"))
        have = bool(pool.flags & FLAG_FULL_QUOTA)
        if want == have:
            return 0, "", None  # no epoch churn on repeats
        if want:
            pool.flags |= FLAG_FULL_QUOTA
            self.clog_append(self.name, "warn",
                             f"pool '{pool.name}' is full (quota)")
        else:
            pool.flags &= ~FLAG_FULL_QUOTA
            self.clog_append(self.name, "info",
                             f"pool '{pool.name}' quota-full cleared")
        self._mark_dirty()
        return 0, "", None

    def _cmd_pool_get(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        return 0, "", {
            "pool": pool.name, "size": pool.size,
            "min_size": pool.min_size, "pg_num": pool.pg_num,
            "type": "erasure" if pool.is_erasure() else "replicated",
            "erasure_code_profile": pool.erasure_code_profile,
        }

    # -- device classes (reference:src/mon/OSDMonitor.cc
    # "osd crush set-device-class"; shadow trees in CrushWrapper) -----------

    def _cmd_crush_set_class(self, cmd: dict) -> tuple[int, str, Any]:
        """Tag OSDs with a device class and rebuild the class shadow
        trees so `take <root> class <c>` rules can target them."""
        cls = cmd.get("class", "")
        if not cls or "~" in cls:
            return -EINVAL, f"invalid class name {cls!r}", None
        ids = cmd.get("ids", [])
        if isinstance(ids, (int, str)):
            ids = [ids]
        osds = []
        for raw in ids:
            try:
                o = int(str(raw).removeprefix("osd."))
            except ValueError:
                return -EINVAL, f"invalid osd id {raw!r}", None
            if not (0 <= o < self.osdmap.max_osd):
                return -ENOENT, f"no osd.{o}", None
            osds.append(o)
        if not osds:
            return -EINVAL, "no osd ids given", None
        for o in osds:
            self.osdmap.crush.set_device_class(o, cls)
        self.osdmap.crush.populate_classes()
        self._mark_dirty()
        return 0, f"set {len(osds)} osd(s) to class {cls!r}", None

    def _cmd_crush_rm_class(self, cmd: dict) -> tuple[int, str, Any]:
        ids = cmd.get("ids", [])
        if isinstance(ids, (int, str)):
            ids = [ids]
        # validate everything BEFORE mutating: a bad id mid-list must
        # not leave a partial, never-committed class removal behind
        osds = []
        for raw in ids:
            try:
                o = int(str(raw).removeprefix("osd."))
            except ValueError:
                return -EINVAL, f"invalid osd id {raw!r}", None
            if not (0 <= o < self.osdmap.max_osd):
                return -ENOENT, f"no osd.{o}", None
            osds.append(o)
        if not osds:
            return -EINVAL, "no osd ids given", None
        for o in osds:
            self.osdmap.crush.remove_device_class(o)
        self.osdmap.crush.populate_classes()
        self._mark_dirty()
        return 0, f"removed class from {len(osds)} osd(s)", None

    def _cmd_crush_class_ls(self, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", sorted(self.osdmap.crush.class_names.values())

    def _cmd_crush_class_ls_osd(self, cmd: dict) -> tuple[int, str, Any]:
        cls = cmd.get("class", "")
        try:
            cid = self.osdmap.crush.class_id(cls)
        except KeyError:
            return -ENOENT, f"unknown class {cls!r}", None
        return 0, "", sorted(
            d for d, c in self.osdmap.crush.class_map.items() if c == cid
        )

    def _cmd_osd_reweight(self, cmd: dict) -> tuple[int, str, Any]:
        """reference:OSDMonitor 'osd reweight' — scale an osd's in-weight
        (0.0..1.0) to shift load without marking it out."""
        osd = int(cmd["id"])
        w = float(cmd["weight"])
        if not (0 <= osd < self.osdmap.max_osd):
            return -ENOENT, f"no osd.{osd}", None
        if not (0.0 <= w <= 1.0):
            return -EINVAL, "weight must be in [0, 1]", None
        self.osdmap.osd_weight[osd] = int(w * 0x10000)
        self._mark_dirty()
        return 0, f"reweighted osd.{osd} to {w}", None

    # -- snapshots (reference:src/mon/OSDMonitor.cc 'osd pool mksnap' /
    # 'rmsnap' prepare paths; self-managed ids via IoCtx selfmanaged_
    # snap_create -> mon allocation from the same pool sequence) ---------

    def _cmd_pool_mksnap(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        name = cmd["snap"]
        if name in pool.snaps.values():
            return -EEXIST, f"snap {name!r} already exists", None
        pool.snap_seq += 1
        pool.snaps[pool.snap_seq] = name
        self._mark_dirty()
        return 0, f"created pool snap {name!r}", {"snapid": pool.snap_seq}

    def _cmd_pool_rmsnap(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        name = cmd["snap"]
        snapid = next(
            (i for i, n in pool.snaps.items() if n == name), None
        )
        if snapid is None:
            return -ENOENT, f"no snap {name!r}", None
        del pool.snaps[snapid]
        pool.removed_snaps.append(snapid)
        self._mark_dirty()
        return 0, f"removed pool snap {name!r}", {"snapid": snapid}

    def _cmd_pool_lssnap(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        return 0, "", {
            "snap_seq": pool.snap_seq,
            "snaps": [
                {"snapid": i, "name": n}
                for i, n in sorted(pool.snaps.items())
            ],
            "removed_snaps": sorted(pool.removed_snaps),
        }

    def _cmd_selfmanaged_snap_create(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        pool.snap_seq += 1  # unnamed: the client owns the snap context
        self._mark_dirty()
        return 0, "", {"snapid": pool.snap_seq}

    def _cmd_selfmanaged_snap_rm(self, cmd: dict) -> tuple[int, str, Any]:
        pool = self.osdmap.lookup_pool(cmd["pool"])
        if pool is None:
            return -ENOENT, f"no pool {cmd['pool']!r}", None
        snapid = int(cmd["snapid"])
        if snapid in pool.removed_snaps or snapid > pool.snap_seq:
            return -ENOENT, f"no snap {snapid}", None
        # if the id happens to be a NAMED pool snap, retire the name too:
        # a dangling entry would keep riding every write's SnapContext
        pool.snaps.pop(snapid, None)
        pool.removed_snaps.append(snapid)
        self._mark_dirty()
        return 0, "", None

    def _cmd_osd_dump(self, cmd: dict) -> tuple[int, str, Any]:
        return 0, "", self.osdmap.to_dict()

    # `ceph osd set/unset` cluster flags (reference:OSDMonitor 'osd
    # set' -> CEPH_OSDMAP_* flags).  noout is advisory here: this
    # framework never auto-outs a down OSD, so there is nothing to
    # suppress — accepted for tooling parity, documented as a no-op.
    CLUSTER_FLAGS = ("pause", "noscrub", "nodeep-scrub", "norecover",
                     "nobackfill", "noout")

    def _cmd_osd_set_flag(self, cmd: dict) -> tuple[int, str, Any]:
        flag = str(cmd.get("flag", ""))
        if flag not in self.CLUSTER_FLAGS:
            return -EINVAL, (f"unknown flag {flag!r} "
                             f"(known: {', '.join(self.CLUSTER_FLAGS)})"), \
                None
        if flag in self.osdmap.cluster_flags:
            return 0, f"{flag} is set", None
        self.osdmap.cluster_flags.add(flag)
        self.clog_append(self.name, "warn", f"flag {flag} set")
        self._mark_dirty()
        return 0, f"{flag} is set", None

    def _cmd_osd_unset_flag(self, cmd: dict) -> tuple[int, str, Any]:
        flag = str(cmd.get("flag", ""))
        if flag not in self.CLUSTER_FLAGS:
            return -EINVAL, f"unknown flag {flag!r}", None
        if flag not in self.osdmap.cluster_flags:
            return 0, f"{flag} is unset", None
        self.osdmap.cluster_flags.discard(flag)
        self.clog_append(self.name, "info", f"flag {flag} unset")
        self._mark_dirty()
        return 0, f"{flag} is unset", None

    def _cmd_osd_down(self, cmd: dict) -> tuple[int, str, Any]:
        osd = int(cmd["id"])
        if not self._valid_osd_id(osd):
            return -EINVAL, f"bad osd id {osd}", None
        self.osdmap.mark_down(osd)
        self.clog_append(self.name, "warn",
                         f"osd.{osd} marked down (operator)")
        self._mark_dirty()
        return 0, "", None

    def _cmd_osd_out(self, cmd: dict) -> tuple[int, str, Any]:
        osd = int(cmd["id"])
        if not self._valid_osd_id(osd):
            return -EINVAL, f"bad osd id {osd}", None
        self.osdmap.mark_out(osd)
        self._mark_dirty()
        return 0, "", None

    def _cmd_osd_in(self, cmd: dict) -> tuple[int, str, Any]:
        osd = int(cmd["id"])
        if not self._valid_osd_id(osd):
            return -EINVAL, f"bad osd id {osd}", None
        self.osdmap.mark_in(osd)
        self._mark_dirty()
        return 0, "", None

    # -- CephX auth service (reference:src/mon/AuthMonitor.cc +
    # src/auth/cephx/CephxServiceHandler.cc) --------------------------------

    def _handle_auth(self, conn: Connection, msg: "messages.MAuth") -> None:
        from ..auth import Ticket, challenge_response, new_secret, seal_skey

        if self._keyring is None:
            conn.send(messages.MAuthReply(
                tid=msg.tid, result=0, nonce=None, ticket=None,
            ))  # auth off: everything is implicitly authorized
            return
        if msg.op == "get_nonce":
            conn._auth_nonce = new_secret()
            conn.send(messages.MAuthReply(
                tid=msg.tid, result=0, nonce=conn._auth_nonce, ticket=None,
            ))
            return
        if msg.op == "authenticate":
            secret = self._keyring.get(msg.entity or "")
            nonce = getattr(conn, "_auth_nonce", None)
            if (
                not secret or not nonce
                or challenge_response(secret, nonce) != msg.proof
            ):
                logger.warning("%s: auth FAILED for %r",
                               self.name, msg.entity)
                conn.send(messages.MAuthReply(
                    tid=msg.tid, result=-13, nonce=None, ticket=None,
                ))
                return
            conn._auth_nonce = None  # single use
            conn.authenticated = True
            conn.peer_name = msg.entity
            ticket = Ticket.issue(self._keyring.cluster_secret, msg.entity)
            # the session key rides sealed under the ENTITY secret: only
            # the keyholder can use the ticket in a handshake challenge
            skey = Ticket.session_key(self._keyring.cluster_secret, ticket)
            conn.send(messages.MAuthReply(
                tid=msg.tid, result=0, nonce=None, ticket=ticket,
                skey=seal_skey(secret, ticket, skey),
            ))
            return
        conn.send(messages.MAuthReply(
            tid=msg.tid, result=-EINVAL, nonce=None, ticket=None,
        ))

    # -- active/standby service lifecycle: mgr AND mds share the beacon
    # machinery (reference:src/mon/MgrMonitor.cc beacon handling,
    # src/mon/MDSMonitor.cc prepare_beacon) --------------------------------

    def _svc_fields(self, svc: str) -> tuple[str, str, list]:
        m = self.osdmap
        return (
            getattr(m, f"{svc}_name"),
            getattr(m, f"{svc}_addr"),
            getattr(m, f"{svc}_standbys"),
        )

    def _svc_set(self, svc: str, name: str, addr: str, standbys: list) -> None:
        m = self.osdmap
        setattr(m, f"{svc}_name", name)
        setattr(m, f"{svc}_addr", addr)
        setattr(m, f"{svc}_standbys", standbys)

    # -- multi-active MDS rank table (reference:src/mon/MDSMonitor.cc
    # maybe_promote_standby / MDSMap in-rank assignment) --------------------

    def _mds_ranks(self) -> list[list[str]]:
        """The rank table grown to mds_max (vacant slots are ["",""]);
        occupied slots past a shrunken mds_max are kept until they fail
        (the reference requires deactivation to shrink)."""
        m = self.osdmap
        ranks = m.mds_rank_table()
        want = max(1, int(m.mds_max))
        while len(ranks) < want:
            ranks.append(["", ""])
        while len(ranks) > want and not ranks[-1][0]:
            ranks.pop()
        return ranks

    def _mds_set_ranks(self, ranks: list[list[str]],
                       standbys: list) -> None:
        m = self.osdmap
        m.mds_ranks = [list(r) for r in ranks]
        # rank 0 mirrors into the legacy single-active fields
        m.mds_name, m.mds_addr = (
            ranks[0] if ranks and ranks[0][0] else ("", "")
        )
        m.mds_standbys = standbys
        self._mark_dirty()

    def _cmd_mds_beacon(self, cmd: dict) -> tuple[int, str, Any]:
        name, addr = cmd["name"], cmd["addr"]
        self._svc_beacons[("mds", name)] = time.monotonic()
        ranks = self._mds_ranks()
        standbys = list(self.osdmap.mds_standbys)
        for i, (n, a) in enumerate(ranks):
            if n == name:
                if a != addr:  # restarted on a new port
                    ranks[i][1] = addr
                    self._mds_set_ranks(ranks, standbys)
                return 0, "", {"active": True, "rank": i}
        for i, (n, _a) in enumerate(ranks):
            if not n:
                ranks[i] = [name, addr]
                self._mds_set_ranks(
                    ranks, [(sn, sa) for sn, sa in standbys if sn != name]
                )
                logger.info(
                    "%s: mds %s takes rank %d", self.name, name, i
                )
                return 0, "", {"active": True, "rank": i}
        known = dict(standbys)
        if known.get(name) != addr:
            known[name] = addr
            self._mds_set_ranks(ranks, sorted(known.items()))
        return 0, "", {"active": False}

    def _cmd_mds_fail(self, cmd: dict) -> tuple[int, str, Any]:
        """Vacate the named daemon's rank (or rank 0) and promote a
        FRESH standby into exactly that rank, so its journal and
        subtrees are adopted by the successor."""
        ranks = self._mds_ranks()
        target = cmd.get("name") or (ranks[0][0] if ranks else "")
        standbys = list(self.osdmap.mds_standbys)
        for i, (n, _a) in enumerate(ranks):
            if n == target and n:
                self._svc_beacons.pop(("mds", n), None)
                live = [
                    (sn, sa) for sn, sa in standbys
                    if self._svc_fresh("mds", sn)
                ]
                if live:
                    (new, new_addr), *_rest = live
                    ranks[i] = [new, new_addr]
                    standbys = [t for t in standbys if t[0] != new]
                    logger.info(
                        "%s: mds rank %d failed over %s -> %s",
                        self.name, i, target, new,
                    )
                else:
                    ranks[i] = ["", ""]
                self._mds_set_ranks(ranks, standbys)
                return 0, f"mds {target} failed", None
        return 0, f"mds {target!r} holds no rank", None

    def _cmd_fs_set_max_mds(self, cmd: dict) -> tuple[int, str, Any]:
        n = int(cmd.get("val", cmd.get("max_mds", 1)))
        if not 1 <= n <= MAX_MDS_RANKS:
            # the ino-allocation stripe has MAX_MDS_RANKS lanes; a rank
            # past it would collide with rank (r mod stripe) and corrupt
            # shared data objects
            return (
                -EINVAL,
                f"max_mds must be in [1, {MAX_MDS_RANKS}]",
                None,
            )
        self.osdmap.mds_max = n
        ranks = self._mds_ranks()
        standbys = list(self.osdmap.mds_standbys)
        for i, (rn, _a) in enumerate(ranks):
            if rn:
                continue
            live = [
                (sn, sa) for sn, sa in standbys
                if self._svc_fresh("mds", sn)
            ]
            if not live:
                break
            (new, new_addr), *_ = live
            ranks[i] = [new, new_addr]
            standbys = [t for t in standbys if t[0] != new]
        self._mds_set_ranks(ranks, standbys)
        return 0, f"max_mds = {n}", {"ranks": ranks}

    def _cmd_svc_beacon(self, svc: str, cmd: dict) -> tuple[int, str, Any]:
        if svc == "mds":
            return self._cmd_mds_beacon(cmd)
        name, addr = cmd["name"], cmd["addr"]
        active, active_addr, standbys = self._svc_fields(svc)
        self._svc_beacons[(svc, name)] = time.monotonic()
        if active == name:
            if active_addr != addr:  # restarted on a new port
                self._svc_set(svc, name, addr, standbys)
                self._mark_dirty()
            return 0, "", {"active": True}
        if not active:
            self._svc_set(
                svc, name, addr, [(n, a) for n, a in standbys if n != name]
            )
            self._mark_dirty()
            logger.info("%s: %s %s is now active", self.name, svc, name)
            return 0, "", {"active": True}
        known = dict(standbys)
        if known.get(name) != addr:  # new standby OR restarted on a new port
            known[name] = addr
            self._svc_set(svc, active, active_addr, sorted(known.items()))
            self._mark_dirty()
        return 0, "", {"active": False}

    def _svc_fresh(self, svc: str, name: str,
                   grace: float | None = None) -> bool:
        if grace is None:
            grace = self.config.mon_lease_interval * 3
        last = self._svc_beacons.get((svc, name))
        return last is not None and time.monotonic() - last <= grace

    def _cmd_svc_fail(self, svc: str, cmd: dict) -> tuple[int, str, Any]:
        """Demote the active daemon (operator command / beacon-staleness
        path); the first standby with a FRESH beacon is promoted — a
        dead standby would just re-fail a tick later."""
        if svc == "mds":
            return self._cmd_mds_fail(cmd)
        active, _addr, standbys = self._svc_fields(svc)
        if not active:
            return 0, f"no active {svc}", None
        self._svc_beacons.pop((svc, active), None)
        live = [(n, a) for n, a in standbys if self._svc_fresh(svc, n)]
        dead = [t for t in standbys if t not in live]
        if live:
            (new, new_addr), *rest = live
            self._svc_set(svc, new, new_addr, rest + dead)
            logger.info("%s: %s %s failed over to %s",
                        self.name, svc, active, new)
        else:
            self._svc_set(svc, "", "", standbys)
        self._mark_dirty()
        return 0, f"{svc} {active} failed", None

    def _cmd_svc_prune(self, svc: str, cmd: dict) -> tuple[int, str, Any]:
        active, addr, standbys = self._svc_fields(svc)
        grace = float(cmd.get("grace", self.config.mon_lease_interval * 9))
        live = [
            t for t in standbys if self._svc_fresh(svc, t[0], grace=grace)
        ]
        if live != standbys:
            self._svc_set(svc, active, addr, live)
            self._mark_dirty()
        return 0, "", None

    def check_svc_beacons(self, svc: str, grace: float = 3.0) -> None:
        """Leader-side staleness check, called from the tick path: an
        active daemon silent past the grace is failed over; long-dead
        standbys are pruned from the map."""
        if svc == "mds":
            self._check_mds_beacons(grace)
            return
        active, _addr, standbys = self._svc_fields(svc)
        now = time.monotonic()
        for n, _a in standbys:
            # freshly-elected leader: start every standby's clock too,
            # or the first tick prunes live standbys it never heard from
            self._svc_beacons.setdefault((svc, n), now)
        if any(
            not self._svc_fresh(svc, n, grace=grace * 3)
            for n, _a in standbys
        ) and not self._svc_fail_pending[svc]:
            # through the serialized command path (same reason as the
            # fail below: no interleaved epoch bumps)
            self._spawn_svc_cmd(
                svc, {"prefix": f"{svc} prune-standbys", "grace": grace * 3}
            )
        if not active:
            return
        last = self._svc_beacons.get((svc, active))
        if last is None:
            # freshly-elected leader / restart: start the clock now
            self._svc_beacons[(svc, active)] = time.monotonic()
            return
        if time.monotonic() - last > grace and not self._svc_fail_pending[svc]:
            # through the async path: _commit_lock serializes the epoch
            # bump against concurrent client commands (interleaved
            # publishes would fork the map).  The pending flag stops a
            # slow commit from queueing a SECOND fail that would demote
            # the freshly promoted standby too.
            self._spawn_svc_cmd(svc, {"prefix": f"{svc} fail"})

    def _check_mds_beacons(self, grace: float) -> None:
        """Per-rank staleness: each occupied rank is failed over
        independently (one rank's death must not demote the others)."""
        now = time.monotonic()
        for n, _a in self.osdmap.mds_standbys:
            self._svc_beacons.setdefault(("mds", n), now)
        if any(
            not self._svc_fresh("mds", n, grace=grace * 3)
            for n, _a in self.osdmap.mds_standbys
        ) and not self._svc_fail_pending["mds"]:
            self._spawn_svc_cmd(
                "mds",
                {"prefix": "mds prune-standbys", "grace": grace * 3},
            )
        for rn, _addr in self._mds_ranks():
            if not rn:
                continue
            last = self._svc_beacons.get(("mds", rn))
            if last is None:
                self._svc_beacons[("mds", rn)] = now
                continue
            if now - last > grace and not self._svc_fail_pending["mds"]:
                self._spawn_svc_cmd(
                    "mds", {"prefix": "mds fail", "name": rn}
                )
                return  # one at a time; the next tick handles the rest

    def _spawn_svc_cmd(self, svc: str, cmd: dict) -> None:
        self._svc_fail_pending[svc] = True

        async def run_and_clear():
            try:
                await self.handle_command_async(cmd)
            finally:
                self._svc_fail_pending[svc] = False

        _bg(run_and_clear())

    def _cmd_status(self, cmd: dict) -> tuple[int, str, Any]:
        m = self.osdmap
        up = sum(1 for o in range(m.max_osd) if m.is_up(o))
        inn = sum(1 for o in range(m.max_osd) if m.is_in(o))
        return 0, "", {
            "epoch": m.epoch,
            "num_osds": sum(1 for o in range(m.max_osd) if m.exists(o)),
            "num_up_osds": up,
            "num_in_osds": inn,
            "pools": sorted(p.name for p in m.pools.values()),
        }
