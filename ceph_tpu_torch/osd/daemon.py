"""The OSD daemon: client op engine + EC/replicated backends.

Re-expression of the reference OSD data path (reference:src/osd/OSD.cc,
PrimaryLogPG.cc, PGBackend.{h,cc}) for the asyncio mini-cluster:

- boot: connect to the mon, announce (MOSDBoot), subscribe to maps
  (reference:src/osd/OSD.cc:2051 init / MOSDBoot flow).
- client ops arrive as MOSDOp on the primary
  (reference:src/osd/OSD.cc:6107 ms_fast_dispatch →
  PrimaryLogPG::do_op/do_osd_ops :4150); each op runs as its own asyncio
  task — the role of the sharded op workqueue (reference:src/osd/OSD.cc:1692).
- the EC write pipeline batches ALL stripes of an object into one codec
  device call (``osd/ec_util.py`` encode), fans per-shard transactions
  out as MOSDECSubOpWrite, self-delivers its own shard, and completes the
  client op when every present shard has committed
  (reference:src/osd/ECBackend.cc:1389 submit_transaction → :1902-1926
  shard fan-out → :878 handle_sub_write → :1946 try_finish_rmw).
- EC reads pick the cheapest shard set via minimum_to_decode, verify each
  shard's cumulative crc32c against its HashInfo xattr, reconstruct if
  any data shard is missing, and retry with the remaining shards on
  error (reference:src/osd/ECBackend.cc:2187 objects_read_and_reconstruct,
  :1438 get_min_avail_to_read_shards, :941/:994-1008 handle_sub_read +
  crc check, :2239 send_all_remaining_reads).
- replicated pools fan whole transactions to the acting set
  (reference:src/osd/ReplicatedBackend.cc MOSDRepOp flow).
- heartbeats: periodic pings to peer OSDs; a silent peer past the grace
  is reported to the mon (reference:src/osd/OSD.cc:4104-4245).

Positional shard roles come from the acting set: acting[i] serves shard i
(crush_choose_indep positional stability, reference:src/crush/mapper.c:612).

Counterpart of ``ceph_tpu/osd/daemon.py``.  ``OSD(..., device=None)``
builds every pool's codec from this package's registry on ``device``:
None is the card (``DeviceUnavailableError`` without CUDA), ``"cpu"`` is
for tests.  On the card the EC write's encode, a degraded read's decode
and a backfill's re-encode run ``gf_matmul`` (``bitmatrix_xor`` for a
bit-matrix pool) through the OSD's dispatcher; there is no CPU fallback
for a CUDA codec beyond the dispatcher's own failover replay.  The wire,
the stores' contents and the PG log are the reference's, so this OSD
serves the reference's client and the reference's OSDs' frames.

Scrub and repair (``scrub.py``), cache tiering (``tiering.py``) and
object classes (``cls/``) are the reference's.  Scrub's repair decodes
run ``gf_matmul`` (``bitmatrix_xor``) straight on the pool's codec, and
a device fault there answers the ``MOSDScrub`` with the error; a cache
tier's flushes and promotes run the base pool's EC write and read.

With ``osd_ec_mesh`` on, matrix-codec EC math takes the dispatcher's
mesh lane: ``parallel.engine.get_mesh_engine(osd_ec_mesh_devices,
device=...)`` splits each batch over the lanes of a device mesh (the
cards for a CUDA OSD, CPU lanes for ``device="cpu"``), and each lane
runs ``gf_matmul`` on its card.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import time
from collections import deque
from typing import Any

import numpy as np

from ..device import resolve
from ..models import registry
from ..msg import AsyncMessenger, Connection, Dispatcher, messages
from ..msg.message import Message
from ..store import CollectionId, MemStore, ObjectId, ObjectStore, Transaction
from ..store.objectstore import NeedsMkfs
from . import ec_transaction, ec_util
from . import snaps as snaps_mod
from .ec_util import StripeHashes, StripeInfo
from .osdmap import CRUSH_ITEM_NONE, OSDMap, PGid, Pool, POOL_TYPE_ERASURE
from .pg_log import (
    Eversion,
    PGLogEntry,
    add_log_entry_to_txn,
    is_stash_name,
    meta_oid,
    stash_name,
    trim_stashes_to_txn,
)

logger = logging.getLogger("ceph_tpu_torch.osd")

# tracepoint provider wrapping op ingress/egress, the analog of
# reference:src/tracing/oprequest.tp wired at OSD.cc:6119
from ..common.tracing import tracepoint_provider  # noqa: E402

_trace = tracepoint_provider("oprequest")
# codec-boundary spans (the reference's osd/pg tracepoints around
# ECBackend encode/decode)
_trace_ec = tracepoint_provider("ec")

ENOENT = 2
EIO = 5
EAGAIN = 11
EDQUOT = 122  # pool quota full (reference: -EDQUOT on FLAG_FULL_QUOTA)
EINVAL = 22
ESTALE = 116
# a sub-op's peer connection died while the map still lists the peer
# as up (SIGKILL-before-markdown window): CONNECTION failure, not a
# store error — the op folds to -EAGAIN so the client retries on the
# post-markdown map instead of surfacing EIO (the zero-failed-ops
# invariant; the reference requeues the op through peering instead)
ENOTCONN = 107
EOPNOTSUPP = 95
# how long an op naming a pool this OSD's map lacks waits for the
# newer map its client already holds
MAP_WAIT_S = 10.0

OI_KEY = "_"  # object-info xattr (reference OI_ATTR)

class WaiterBase:
    """Gather-N-replies primitive shared by write/read/scan waiters.

    ``members`` maps each pending key to the osd serving it, so a
    connection reset can fail exactly the keys that peer owed us
    (``fail_member``); subclasses define what a failure completion is.
    """

    def __init__(self, pending: set[int], members: dict[int, int] | None = None):
        self.pending = set(pending)
        self.members = dict(members or {})
        self.event = asyncio.Event()
        if not self.pending:
            self.event.set()

    def _finish(self, key: int) -> bool:
        if key not in self.pending:
            return False
        self.pending.discard(key)
        if not self.pending:
            self.event.set()
        return True

    def fail_key(self, key: int) -> None:
        raise NotImplementedError

    def fail_member(self, osd_id: int) -> None:
        for key in list(self.pending):
            if self.members.get(key) == osd_id:
                self.fail_key(key)


class _NotifyWaiter:
    """Gathers MWatchNotifyAck from every watcher of one notify
    (reference:src/osd/Watch.cc Notify::maybe_complete_notify)."""

    def __init__(self, cookies: set[str]):
        self.pending = set(cookies)
        self.acks: dict[str, bytes] = {}
        self.event = asyncio.Event()
        if not self.pending:
            self.event.set()

    def ack(self, cookie: str, payload: bytes = b"") -> None:
        if cookie in self.pending:
            self.pending.discard(cookie)
            self.acks[cookie] = payload
            if not self.pending:
                self.event.set()

    def drop(self, cookie: str) -> None:
        """Watcher died: stop waiting on it (its ack never comes)."""
        self.pending.discard(cookie)
        if not self.pending:
            self.event.set()


class _Waiter(WaiterBase):
    """Sub-write ack gatherer."""

    def __init__(self, pending, members=None):
        super().__init__(pending, members)
        self.results: dict[int, int] = {}

    def complete(self, shard: int, result: int) -> None:
        if self._finish(shard):
            self.results[shard] = result

    def fail_key(self, key: int) -> None:
        # a reset IS a connection failure: fold like the connect path
        self.complete(key, -ENOTCONN)


class _ReadWaiter(WaiterBase):
    """MOSDECSubOpReadReply chunk gatherer."""

    def __init__(self, pending, members=None):
        super().__init__(pending, members)
        self.data: dict[int, bytes] = {}
        self.attrs: dict[int, dict] = {}
        self.errors: dict[int, int] = {}

    def complete(
        self, shard: int, data: bytes | None, attrs: dict | None, err: int
    ) -> None:
        if not self._finish(shard):
            return
        if err:
            self.errors[shard] = err
        else:
            self.data[shard] = data if data is not None else b""
            self.attrs[shard] = attrs or {}

    def fail_key(self, key: int) -> None:
        self.complete(key, None, None, -EIO)


class OSD(Dispatcher):
    """One object-storage daemon.

    ``device`` is where its codecs live: None is the card (raises
    ``DeviceUnavailableError`` without CUDA), ``"cpu"`` is for tests."""

    def __init__(
        self,
        osd_id: int,
        mon_addr: str,
        store: ObjectStore | None = None,
        heartbeat_interval: float | None = None,
        heartbeat_grace: float | None = None,
        subop_timeout: float | None = None,
        scrub_interval: float | None = None,
        config: "Config | None" = None,
        device=None,
    ):
        from ..common import Config, PerfCountersCollection

        self.config = config or Config()
        cfg = self.config
        self.device = resolve(device)
        from ..common.log import install as _install_memlog

        _install_memlog()  # recent-events ring (reference:src/log)
        self.osd_id = osd_id
        self.name = f"osd.{osd_id}"
        self.mon_addr = mon_addr
        self.messenger = AsyncMessenger(self.name, self)
        self.messenger.apply_config(cfg)
        from ..auth import daemon_auth_context

        self.messenger.auth = daemon_auth_context(cfg, self.name)
        self.store = store or MemStore()
        self.subop_timeout = (
            cfg.osd_subop_timeout if subop_timeout is None else subop_timeout
        )
        self.osdmap: OSDMap | None = None
        self.addr = ""
        self.heartbeat_interval = (
            cfg.osd_heartbeat_interval
            if heartbeat_interval is None else heartbeat_interval
        )
        self.heartbeat_grace = (
            cfg.osd_heartbeat_grace
            if heartbeat_grace is None else heartbeat_grace
        )
        # observability (reference:src/common/perf_counters.cc + the
        # l_osd_* registrations in src/osd/OSD.cc)
        self.perf = PerfCountersCollection()
        self.perf.attach(self.messenger.perf)  # msgr wire counters
        # the zero-copy audit family (utils/buffers.py): every payload
        # memcpy the data path still performs, per hop — process-global
        # (copies happen in shared client/striper/codec code), attached
        # so it rides perf dump -> mgr prometheus like any subsystem
        from ..utils.buffers import data_path_perf

        self.perf.attach(data_path_perf())
        # the small-op cost ledger + per-hop latency family
        # (common/stack_ledger.py): header encode/decode
        # seconds + frame allocs fed at the messenger boundary, and
        # the stack.lat_<hop> histograms this OSD feeds for sampled
        # ops — process-global like data_path, attached so the family
        # rides perf dump -> mgr prometheus
        from ..common.stack_ledger import stack_perf

        self.perf.attach(stack_perf())
        posd = self.perf.create("osd")
        posd.add_counter("op", "client ops")
        posd.add_counter("op_r", "client reads")
        posd.add_counter("op_w", "client mutations")
        posd.add_counter("op_in_bytes", "client write payload bytes")
        posd.add_counter("op_out_bytes", "client read payload bytes")
        posd.add_counter("op_err", "client ops answered with an error")
        posd.add_counter("subop_w", "sub-writes applied on this shard")
        posd.add_time_avg("op_latency", "client op wall time")
        # 2D log2 (payload bytes x latency) grid — the reference's
        # l_osd_op_*_lat_*_hist perf histograms, served raw via
        # dump_histograms and flattened to prometheus _bucket series
        posd.add_histogram("op_latency_histogram",
                           "client op payload size x wall time")
        # slow-request visibility (reference OpTracker
        # check_ops_in_flight -> the SLOW_OPS health warning): gauges
        # refreshed at each mgr report from the live tracker state
        posd.add_gauge("slow_ops",
                       "in-flight ops older than osd_op_complaint_time")
        posd.add_gauge("slow_ops_oldest_sec",
                       "age of the oldest slow op (seconds)")
        # the shared EC family (osd/ec_perf.py): ONE registration used
        # by this OSD and the accelerator daemon — the engine room
        # (dispatcher/supervisor/trace) mutates the same keys in both
        # processes, so the families must be defined once
        from .ec_perf import create_accel_client_perf, create_ec_perf

        pec = create_ec_perf(self.perf)
        # the OSD-side half of the accel family: this daemon's view of
        # its remote accelerator lane
        pacc = create_accel_client_perf(self.perf)
        # QoS op scheduler (reference: osd_op_queue selecting the
        # mClock/WPQ op queues; see osd/scheduler.py): per-class
        # counters are registered with LITERAL keys so the
        # check_counters gate sees them; the scheduler mutates the
        # same families via f-strings keyed on its class names
        from ..common.perf_counters import latency_axis
        from .scheduler import CLASSES as QOS_CLASSES
        from .scheduler import OpScheduler, QosSpec

        pqos = self.perf.create("qos")
        pqos.add_time_avg("grant_latency", "qos grant wait, all classes")
        pqos.add_counter("admitted_client", "client grants")
        pqos.add_counter("admitted_recovery", "recovery grants")
        pqos.add_counter("admitted_scrub", "scrub grants")
        pqos.add_counter("admitted_snaptrim", "snaptrim grants")
        pqos.add_counter("admitted_ec_background", "ec_background grants")
        pqos.add_counter("deferred_client", "client admissions shed")
        pqos.add_counter("deferred_recovery", "recovery admissions shed")
        pqos.add_counter("deferred_scrub", "scrub admissions shed "
                                           "(past osd_op_queue_cut_off)")
        pqos.add_counter("deferred_snaptrim", "snaptrim admissions shed")
        pqos.add_counter("deferred_ec_background",
                         "ec_background admissions shed")
        pqos.add_counter("preempted_client",
                         "client waiters bypassed by another class")
        pqos.add_counter("preempted_recovery",
                         "recovery waiters bypassed by another class")
        pqos.add_counter("preempted_scrub",
                         "scrub waiters bypassed by another class")
        pqos.add_counter("preempted_snaptrim",
                         "snaptrim waiters bypassed by another class")
        pqos.add_counter("preempted_ec_background",
                         "ec_background waiters bypassed by another class")
        pqos.add_counter("paced_client", "client pacing waits")
        pqos.add_counter("paced_recovery", "recovery pacing waits")
        pqos.add_counter("paced_scrub", "scrub pacing waits")
        pqos.add_counter("paced_snaptrim", "snaptrim pacing waits")
        pqos.add_counter("paced_ec_background",
                         "ec_background stripes paced at the EC "
                         "dispatcher boundary")
        pqos.add_gauge("share_client",
                       "client attained rate / reservation (-1 = no "
                       "reservation configured)")
        pqos.add_gauge("share_recovery",
                       "recovery attained rate / reservation")
        pqos.add_gauge("share_scrub", "scrub attained rate / reservation")
        pqos.add_gauge("share_snaptrim",
                       "snaptrim attained rate / reservation")
        pqos.add_gauge("share_ec_background",
                       "ec_background attained rate / reservation")
        pqos.add_histogram("wait_client_histogram",
                           "client grant/queue wait",
                           axes=latency_axis(lat_min=1e-5))
        pqos.add_histogram("wait_recovery_histogram",
                           "recovery grant wait",
                           axes=latency_axis(lat_min=1e-5))
        pqos.add_histogram("wait_scrub_histogram", "scrub grant wait",
                           axes=latency_axis(lat_min=1e-5))
        pqos.add_histogram("wait_snaptrim_histogram",
                           "snaptrim grant wait",
                           axes=latency_axis(lat_min=1e-5))
        pqos.add_histogram("wait_ec_background_histogram",
                           "ec_background grant/pace wait",
                           axes=latency_axis(lat_min=1e-5))
        self.scheduler = OpScheduler(
            {
                k: QosSpec(
                    reservation=cfg.get(f"osd_mclock_scheduler_{k}_res"),
                    weight=cfg.get(f"osd_mclock_scheduler_{k}_wgt"),
                    limit=cfg.get(f"osd_mclock_scheduler_{k}_lim"),
                )
                for k in QOS_CLASSES
            },
            policy=cfg.osd_op_queue,
            slots=cfg.osd_op_queue_slots,
            cut_off=cfg.osd_op_queue_cut_off,
            perf=pqos,
        )
        # the mesh EC data path (osd_ec_mesh): batches split over the
        # lanes of a device mesh, gathered reconstruct; None = the
        # single-device path.  With the dispatcher on (default) the mesh
        # is a DISPATCHER LANE — coalescing, QoS pacing, launch
        # deadlines, and failover all apply to mesh traffic; only the
        # dispatcher-off config keeps the direct per-op route
        self.ec_mesh = None
        if cfg.osd_ec_mesh:
            from ..parallel.engine import get_mesh_engine

            self.ec_mesh = get_mesh_engine(cfg.osd_ec_mesh_devices,
                                           device=self.device)
        # cross-op EC microbatch dispatcher (default on), plus the
        # engine health supervisor (osd/ec_failover): fatal launch
        # failures — on the single-device AND mesh lanes — replay on
        # the host fallback and trip the breaker; while tripped, the
        # QoS scheduler treats capacity as degraded and ec_background
        # pacing squeezes to reservation
        self.ec_dispatch = None
        self.ec_supervisor = None
        self.accel_client = None
        if getattr(cfg, "osd_ec_dispatch", True):
            from ..accel.router import AccelRouter
            from .ec_dispatch import ECDispatcher
            from .ec_failover import EngineSupervisor

            # constructed even with failover configured OFF (enabled
            # gates the state machine, not the object): `config set
            # osd_ec_engine_failover true` on a RUNNING osd must arm
            # the breaker, not silently no-op while config show says on
            self.ec_supervisor = EngineSupervisor(
                enabled=cfg.osd_ec_engine_failover,
                perf=pec,
                probe_interval=cfg.osd_ec_probe_interval,
                on_degraded=lambda d: setattr(
                    self.scheduler, "capacity_degraded", d
                ),
            )
            # the remote dispatcher lane: coalesced
            # batches ship to the accelerator FLEET over the
            # messenger — the AccelRouter holds one client per
            # mon-published AccelMap entry (fed from every map push in
            # _handle_map) and keeps osd_ec_accel_addr as the
            # single-entry static-fleet compat shim.  Constructed even
            # with osd_ec_accel_mode=off (the default) — `config set
            # osd_ec_accel_addr/mode` on a RUNNING osd must arm the
            # lane live, exactly like the breaker above
            self.accel_client = AccelRouter(
                self.messenger,
                addr=cfg.osd_ec_accel_addr,
                mode=cfg.osd_ec_accel_mode,
                deadline=cfg.osd_ec_accel_deadline,
                retry_interval=cfg.osd_ec_accel_retry_interval,
                stale_interval=cfg.osd_ec_accel_stale_interval,
                perf=pacc,
                perf_collection=self.perf,
            )
            self.ec_dispatch = ECDispatcher(
                perf=pec,
                window=cfg.osd_ec_dispatch_window,
                max_stripes=cfg.osd_ec_dispatch_max_stripes,
                bucket=cfg.osd_ec_dispatch_bucket,
                scheduler=self.scheduler,
                supervisor=self.ec_supervisor,
                launch_deadline=cfg.osd_ec_launch_deadline,
                mesh_engine=self.ec_mesh,
                launch_history=cfg.osd_ec_launch_history,
                remote=self.accel_client,
            )
            self.ec_dispatch.inject_engine_failure = \
                cfg.ec_inject_engine_failure
            self.ec_dispatch.inject_launch_hang = \
                cfg.ec_inject_launch_hang
        prec = self.perf.create("recovery")
        prec.add_counter("pushes", "objects/shards pushed")
        prec.add_counter("reservation_waits",
                         "recovery passes that queued for a reservation")
        # churn/peering observability: the storm matrix pins
        # its invariants on these — kicks vs passes proves back-to-back
        # epoch bumps COALESCE instead of stacking concurrent passes
        prec.add_counter("kicks", "recovery wakeups requested (map epochs)")
        prec.add_counter("passes", "recovery passes actually run")
        prec.add_counter("coalesced_kicks",
                         "kicks absorbed into an already-pending pass")
        prec.add_counter("interrupted_passes",
                         "passes that saw a newer map land mid-pass")
        prec.add_counter("scans_served",
                         "MOSDPGScan requests answered (GetInfo/GetLog)")
        prec.add_counter("bytes_pushed",
                         "recovery/backfill payload bytes pushed")
        prec.add_counter("divergent_rollbacks",
                         "divergent log entries rolled back from stashes")
        prec.add_counter("reservations_revoked",
                         "held reservations preempted by a higher-"
                         "priority PG (revoke received)")
        # map-churn accounting, fed off _handle_map/_note_intervals —
        # the live-cluster side of the ChurnPlanner's predictions
        # (osd/churn.py): pgs_remapped here is what the plan's
        # remapped set must match
        pchurn = self.perf.create("churn")
        pchurn.add_counter("maps_applied", "osdmap epochs applied")
        pchurn.add_counter(
            "pgs_remapped",
            "locally-hosted PGs whose acting set changed on a map advance",
        )
        pchurn.add_counter("intervals_recorded",
                           "past-interval records appended")
        pchurn.add_counter(
            "map_gap_refetches",
            "full-map refetches after an incremental epoch gap",
        )
        # admission control (reference:src/osd/OSD.h local_reserver /
        # remote_reserver; config_opts.h:621 osd_max_backfills): two
        # independent slot pools so primaries reserving toward each
        # other cannot deadlock
        from .reservations import AsyncReserver

        _backfills = cfg.get("osd_max_backfills")
        self.local_reserver = AsyncReserver(_backfills)
        self.remote_reserver = AsyncReserver(_backfills)
        pscrub = self.perf.create("scrub")
        pscrub.add_counter("scrubs", "PG deep scrubs completed")
        pscrub.add_counter("errors", "inconsistencies found")
        pscrub.add_counter("repaired", "inconsistencies repaired")
        pscrub.add_gauge(
            "unrepaired",
            "CURRENT unrepaired inconsistencies (latest pass per pg)",
        )
        # per-tenant op ledger: space-saving top-K over
        # (client, pool, class) — the sketch's own health counters are
        # a perf family so eviction pressure is visible in prometheus
        from .client_ledger import ClientLedger

        pcli = self.perf.create("client")
        pcli.add_counter("accounted_ops",
                         "client ops accounted into the tenant ledger")
        pcli.add_counter("ledger_evictions",
                         "top-K evictions (tail mass folded into the "
                         "'other' bucket; high churn = raise "
                         "osd_client_ledger_topk)")
        pcli.add_gauge("ledger_entries",
                       "live (client, pool, class) keys tracked — "
                       "bounded by 2x osd_client_ledger_topk")
        self.client_ledger = ClientLedger(
            topk=cfg.osd_client_ledger_topk,
            window=cfg.osd_client_ledger_window,
            perf=pcli,
        )
        # the SLO latency-storm injector: cached so the op
        # hot path reads an attribute, not the config dict; _every
        # scopes the delay to 1-in-N ops so the tail-
        # sampling acceptance run can make ~1% of ops slow
        self._inject_op_delay = float(cfg.osd_inject_op_delay)
        self._inject_op_delay_every = int(cfg.osd_inject_op_delay_every)
        self._inject_op_delay_n = 0
        # tail-sampled tracing: every client op provisionally
        # traces (the frame header already carries trace id + stamp);
        # the keep policy fires at op COMPLETION, when wall time,
        # result and the launch record are all known — kept waterfalls
        # queue here and ride the next MPGStats report to the mgr store
        ptr = self.perf.create("trace")
        ptr.add_counter("kept", "client ops whose trace the keep "
                                "policy retained (any reason)")
        ptr.add_counter("kept_slow",
                        "traces kept for wall time past "
                        "osd_trace_keep_slow_threshold")
        ptr.add_counter("kept_error",
                        "traces kept for a failed/EAGAIN-folded op")
        ptr.add_counter("kept_replay",
                        "traces kept for a failover/fallback replay "
                        "or accel re-route in the launch record")
        ptr.add_counter("kept_baseline",
                        "traces kept by the 1-in-N baseline draw")
        ptr.add_counter("dropped",
                        "traced client ops the keep policy discarded "
                        "(the healthy median — no spans built)")
        ptr.add_counter("shipped",
                        "kept waterfalls assembled and sent to the "
                        "mgr trace store via MPGStats")
        self._trace_keep = bool(cfg.osd_trace_keep)
        self._trace_keep_thr = float(cfg.osd_trace_keep_slow_threshold)
        self._pending_traces: deque[dict] = deque(maxlen=256)
        # op tracking (reference:src/common/TrackedOp.h OpTracker):
        # typed state transitions, bounded history, slow-op detection
        from ..common.op_tracker import OpTracker

        self.op_tracker = OpTracker(
            history_size=cfg.osd_op_history_size
        )
        if self.ec_dispatch is not None:
            # SLOW_OPS -> launch correlation (ROADMAP 5a): an op dump
            # names the device launch that carried it, straight from
            # the dispatcher's flight recorder
            self.op_tracker.launch_lookup = self.ec_dispatch.flight.lookup
        self._slow_reported = 0  # slow ops already clog'd (edge trigger)
        # op waterfall sampling: 1-in-N client ops get full
        # hop spans (recorded + reply-piggybacked + stack.lat_* fed)
        self._trace_sample_every = int(cfg.osd_op_trace_sample_every)
        self._trace_sampled_n = 0
        from ..common.tracing import set_ring_capacity

        set_ring_capacity(cfg.trace_ring_capacity)
        self._mon_conn: Connection | None = None
        self._admin = None
        # live knobs: without observers, admin-socket `config set` would
        # change `config show` but not daemon behavior;
        # tracked so stop() unregisters them — a shared Config must not
        # keep firing actions on (or pinning) dead daemons
        self._observers = [
            ("osd_subop_timeout",
             lambda _n, v: setattr(self, "subop_timeout", v)),
            ("osd_heartbeat_grace",
             lambda _n, v: setattr(self, "heartbeat_grace", v)),
            ("osd_scrub_interval", self._on_scrub_interval),
            # raising osd_max_backfills must immediately grant queued
            # reservations (the reference's config-observer on the
            # AsyncReservers)
            ("osd_max_backfills", lambda _n, v: (
                self.local_reserver.set_max(v),
                self.remote_reserver.set_max(v),
            )),
            # dispatcher knobs stay live for `config set` tuning
            ("osd_ec_dispatch_window", lambda _n, v: (
                self.ec_dispatch is not None
                and setattr(self.ec_dispatch, "window", float(v))
            )),
            ("osd_ec_dispatch_max_stripes", lambda _n, v: (
                self.ec_dispatch is not None
                and setattr(self.ec_dispatch, "max_stripes", int(v))
            )),
            ("osd_ec_dispatch_bucket", lambda _n, v: (
                self.ec_dispatch is not None
                and setattr(self.ec_dispatch, "bucket", bool(v))
            )),
            # fault-domain knobs: deadline/backoff tuning and the
            # injection hooks must flip on a RUNNING osd (the fault
            # matrix arms and lifts them live)
            ("osd_ec_launch_deadline", self._on_ec_launch_deadline),
            ("osd_ec_probe_interval", lambda _n, v: (
                self.ec_supervisor is not None
                and setattr(self.ec_supervisor, "probe_interval",
                            float(v))
            )),
            ("osd_ec_engine_failover", lambda _n, v: (
                self.ec_supervisor is not None
                and self.ec_supervisor.set_enabled(bool(v))
            )),
            ("ec_inject_engine_failure", lambda _n, v: (
                self.ec_dispatch is not None
                and setattr(self.ec_dispatch, "inject_engine_failure",
                            int(v))
            )),
            ("ec_inject_launch_hang", lambda _n, v: (
                self.ec_dispatch is not None
                and setattr(self.ec_dispatch, "inject_launch_hang",
                            float(v))
            )),
            # remote accelerator lane knobs: routing must
            # re-target / re-mode on a RUNNING osd — the fault matrix
            # and MiniCluster wiring both flip them live
            ("osd_ec_accel_addr", lambda _n, v: (
                self.accel_client is not None
                and self.accel_client.set_addr(str(v))
            )),
            ("osd_ec_accel_mode", lambda _n, v: (
                self.accel_client is not None
                and self.accel_client.set_mode(str(v))
            )),
            ("osd_ec_accel_deadline", lambda _n, v: (
                self.accel_client is not None
                and setattr(self.accel_client, "deadline", float(v))
            )),
            ("osd_ec_accel_retry_interval", lambda _n, v: (
                self.accel_client is not None
                and setattr(self.accel_client, "retry_interval",
                            float(v))
            )),
            ("osd_ec_accel_stale_interval", lambda _n, v: (
                self.accel_client is not None
                and setattr(self.accel_client, "stale_interval",
                            float(v))
            )),
            # QoS scheduler knobs stay live: `config set osd_op_queue
            # fifo` must switch a RUNNING osd's policy (queued waiters
            # re-order, nothing is dropped)
            ("osd_op_queue", lambda _n, v: self.scheduler.set_policy(v)),
            ("osd_op_queue_slots",
             lambda _n, v: self.scheduler.set_slots(v)),
            ("osd_op_queue_cut_off", lambda _n, v: setattr(
                self.scheduler, "cut_off", max(1, int(v)))),
            # op waterfall knobs: sampling rate and ring
            # capacity flip on a RUNNING osd (the live tests and a
            # debug session both crank sampling to 1 temporarily)
            ("osd_op_trace_sample_every", lambda _n, v: setattr(
                self, "_trace_sample_every", int(v))),
            ("trace_ring_capacity", self._on_trace_ring_capacity),
            # reply coalescing (binary wire protocol PR): the ack-batch
            # bound must tune on a RUNNING osd — it is the knob the
            # small-op latency tests sweep live
            ("ms_reply_coalesce_max", lambda _n, v: setattr(
                self.messenger, "reply_coalesce_max", int(v))),
            # tenant ledger + SLO storm injector: the
            # cardinality bound must shrink live, and the burn-rate
            # tests flip the delay on a RUNNING osd
            ("osd_client_ledger_topk",
             lambda _n, v: self.client_ledger.set_topk(int(v))),
            ("osd_client_ledger_window", lambda _n, v: setattr(
                self.client_ledger, "window", max(0.1, float(v)))),
            ("osd_inject_op_delay", lambda _n, v: setattr(
                self, "_inject_op_delay", float(v))),
            ("osd_inject_op_delay_every", lambda _n, v: setattr(
                self, "_inject_op_delay_every", int(v))),
            # tail-sampling keep policy: the bench overhead
            # capture disarms it on a RUNNING osd, and the slow
            # threshold must track a live complaint-time change (0 =
            # derived complaint/4, resolved at evaluation)
            ("osd_trace_keep", lambda _n, v: setattr(
                self, "_trace_keep", bool(v))),
            ("osd_trace_keep_slow_threshold", lambda _n, v: setattr(
                self, "_trace_keep_thr", float(v))),
        ]
        for _qk in QOS_CLASSES:
            for _qf, _qa in (("res", "reservation"), ("wgt", "weight"),
                             ("lim", "limit")):
                self._observers.append((
                    f"osd_mclock_scheduler_{_qk}_{_qf}",
                    lambda _n, v, k=_qk, a=_qa: self.scheduler.set_spec(
                        k, **{a: v}
                    ),
                ))
        for opt, cb in self._observers:
            cfg.observe(opt, cb)
        self._codecs: dict[int, tuple[Any, StripeInfo]] = {}
        self._tid = 0
        self._write_waiters: dict[int, _Waiter] = {}
        self._read_waiters: dict[int, _ReadWaiter] = {}
        self._pg_versions: dict[str, Eversion] = {}
        self._pg_committed: dict[str, Eversion] = {}  # roll-forward watermark
        # highest all-present-committed version per PG (the watermark
        # candidate before the min-in-flight cap in _mark_committed)
        self._pg_commit_high: dict[str, Eversion] = {}
        # versions with sub-write fan-outs still in flight per PG
        self._pg_inflight: dict[str, set[Eversion]] = {}
        self._trimmed_snaps: dict[int, set[int]] = {}  # pool -> handled rms
        self._trimming: set[int] = set()  # pools with a trim pass running
        # watch/notify (reference:src/osd/Watch.{h,cc}): in-memory watcher
        # table; clients re-register after resets (the linger model)
        self._watchers: dict[tuple[int, str], dict[str, Connection]] = {}
        self._notify_waiters: dict[int, "_NotifyWaiter"] = {}
        # (watch key, client notify id) -> completed/in-flight fan-out:
        # retried notifies join rather than re-fire (see _do_notify)
        self._notify_dedupe: dict[tuple, asyncio.Future] = {}
        self._pg_locks: dict[str, asyncio.Lock] = {}
        # epoch when each local PG's current acting interval began
        # (peering past-intervals bookkeeping, see _note_intervals)
        self._interval_start: dict[str, int] = {}
        # (pgid, head oid) -> lock: serializes family META decisions and
        # commits (see obj_lock); the in-flight EXTENT table underneath
        # lets disjoint-extent writes to one object pipeline their
        # read/encode phases (reference:src/osd/ExtentCache.h:1)
        self._obj_locks: dict[tuple[str, str], asyncio.Lock] = {}
        self._extent_locks = ec_transaction.ExtentLocks()
        # (pgid, family) -> projected StripeHashes across pipelined
        # commits (the reference's unstable hash_infos); the generation
        # counter bumps whenever a failed fan-out invalidates the
        # projection, so an already-prepared concurrent op can tell its
        # snapshot is stale
        self._ec_hash_proj: dict[tuple[str, str], "StripeHashes"] = {}
        self._ec_hash_gen: dict[tuple[str, str], int] = {}
        # watchdog (reference:common/HeartbeatMap): the op engine is the
        # "worker"; a wedged op marks the daemon unhealthy (heartbeats
        # stop flowing -> peers report us), a blown suicide timeout
        # force-stops the daemon, the asyncio analog of ceph_abort
        from ..common.heartbeat_map import HeartbeatMap
        from ..common.lockdep import lockdep_enable

        # process wrappers (tools/daemon.py) set True: their suicide
        # must os._exit after the stop attempt, because a wedged
        # non-daemon executor thread blocks normal interpreter exit.
        # In-process clusters (MiniCluster) keep the default — an
        # os._exit there would kill the whole test process.
        self.suicide_hard_exit = False
        self.hb_map = HeartbeatMap(self.name, on_suicide=self._hb_suicide)
        self._op_handle = self.hb_map.add_worker(
            "osd_op_worker",
            cfg.osd_op_thread_timeout,
            cfg.osd_op_thread_suicide_timeout,
        )
        # EC device launches get their own handle (osd/ec_failover):
        # grace = the launch deadline (health warn on a wedged device
        # call), suicide_grace = the op-worker daemon policy — the
        # asyncio-side wait_for fails the waiters over fast, this clock
        # covers the thread that never came back.  Deadline 0 disables
        # the failover deadline, NOT the watchdog: the handle falls
        # back to the generic op-worker grace so a wedged launch still
        # marks the daemon unhealthy and still hits suicide policy.
        self._ec_launch_handle = None
        if self.ec_dispatch is not None:
            self._ec_launch_handle = self.hb_map.add_worker(
                "ec_device_launch",
                self._ec_watchdog_grace(cfg.osd_ec_launch_deadline),
                cfg.osd_op_thread_suicide_timeout,
            )
            self.ec_dispatch.set_watchdog_handle(self._ec_launch_handle)
        if cfg.lockdep:
            lockdep_enable(True)
        self._tasks: set[asyncio.Task] = set()
        self._hb_task: asyncio.Task | None = None
        self._wd_task: asyncio.Task | None = None
        self._mgr_task: asyncio.Task | None = None
        self._mgr_conn: Connection | None = None
        self._mgr_addr_used = ""  # where _mgr_conn points (failover check)
        self._pg_stats_cache: dict[str, tuple[tuple, dict]] = {}
        self._hb_last: dict[int, float] = {}
        self._map_event = asyncio.Event()
        self._booted_again = float("-inf")
        self._stopping = False
        from .recovery import RecoveryManager
        from .scrub import ScrubManager

        self.recovery = RecoveryManager(self)
        from .tiering import TieringService

        self.tiering = TieringService(self)
        self.scrub = ScrubManager(
            self,
            interval=(
                cfg.osd_scrub_interval
                if scrub_interval is None else scrub_interval
            ),
        )

    def _refresh_op_handle(self) -> None:
        """Pin the watchdog deadlines to the OLDEST in-flight op — one
        shared handle must not let fresh traffic mask a wedged op (the
        reference sidesteps this with per-thread handles; grace 0 =
        watchdog disabled, handled by HeartbeatHandle.pin)."""
        self._op_handle.pin(self.op_tracker.oldest_start())

    def _ec_watchdog_grace(self, deadline: float) -> float:
        """The ec_device_launch handle's grace: the launch deadline, or
        (deadline 0 = unbounded launches) the generic op-worker grace —
        '0 disables the deadline, not the watchdog'."""
        return (float(deadline) if deadline > 0
                else self.config.osd_op_thread_timeout)

    def _on_trace_ring_capacity(self, _name: str, value: int) -> None:
        """trace_ring_capacity is live (process-global: one set of
        rings per process, so the last setter wins — the same sharing
        the data_path family documents)."""
        from ..common.tracing import set_ring_capacity

        set_ring_capacity(int(value))

    def _on_ec_launch_deadline(self, _name: str, value: float) -> None:
        """osd_ec_launch_deadline is live: it bounds future launches
        (dispatcher) and re-graces the watchdog handle."""
        if self.ec_dispatch is not None:
            self.ec_dispatch.launch_deadline = float(value)
        if self._ec_launch_handle is not None:
            self._ec_launch_handle.grace = self._ec_watchdog_grace(value)

    def _hb_suicide(self, worker: str) -> None:
        """A worker blew its suicide timeout: take the daemon down hard
        (the reference aborts the process; here the cluster-visible
        effect — the daemon dies and peers fail it — is what matters)."""
        if self._stopping:
            return  # is_healthy() re-polls; one abort is enough
        self._stopping = True
        logger.error("%s: %s suicide timeout — aborting daemon",
                     self.name, worker)
        from ..common.log import dump_recent

        for line in dump_recent(50):  # the crash-time recent-events dump
            logger.error("recent: %s", line)
        # NOT tracked in self._tasks: stop() cancels those, and the
        # shutdown task cancelling itself would leave the messenger up
        task = asyncio.ensure_future(self.stop(umount=False))
        if self.suicide_hard_exit:
            # process daemons (tools/daemon.py) must not trust the
            # interpreter to exit after stop(): a truly-wedged device
            # call sits in a NON-daemon executor thread, and
            # concurrent.futures' atexit hook would join it forever —
            # the hang this suicide exists to end.  os._exit skips the
            # join (reference abort() parity; 134 = 128+SIGABRT); the
            # timer backstop covers stop() itself wedging.
            task.add_done_callback(lambda _t: os._exit(134))
            asyncio.get_running_loop().call_later(10.0, os._exit, 134)

    def _on_scrub_interval(self, _name: str, value: float) -> None:
        self.scrub.interval = value
        if value > 0:
            self.scrub.start()  # no-op if already running

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        try:
            self.store.mount()
        except NeedsMkfs:
            # only a never-formatted store: any OTHER mount failure on a
            # durable store must NOT be answered by formatting it
            self.store.mkfs()
            self.store.mount()
        self.addr = await self.messenger.bind(host, port)
        await self._connect_mon()
        async with asyncio.timeout(10):
            await self._map_event.wait()
        if self.heartbeat_interval > 0:
            self._hb_task = asyncio.ensure_future(self._heartbeat_loop())
        if self.config.osd_op_thread_timeout > 0:
            # the watchdog must not depend on the (optional) peer
            # heartbeat loop, or the suicide timeout is inert in every
            # cluster that disables pings
            self._wd_task = asyncio.ensure_future(self._watchdog_loop())
        # unconditional: this loop doubles as the slow-op tick, which
        # must run even when mgr reporting is disabled
        self._mgr_task = asyncio.ensure_future(self._mgr_report_loop())
        self.recovery.start()
        self.recovery.kick()  # reconcile whatever the map says we lead
        self.scrub.start()
        self.tiering.start()
        await self._start_admin_socket()
        return self.addr

    @property
    def _mon_addrs(self) -> list[str]:
        """mon_addr may be one address or a monmap list (multi-mon)."""
        if isinstance(self.mon_addr, str):
            return [self.mon_addr]
        return list(self.mon_addr)

    async def _connect_mon(self) -> Connection:
        """Subscribe + announce to the first reachable mon (any mon
        serves maps and forwards reports to the leader); the connection
        is re-established against another mon if this one dies."""
        last: Exception | None = None
        for _attempt in range(3):
            for i, addr in enumerate(self._mon_addrs):
                try:
                    conn = await self.messenger.connect(addr, f"mon.{i}")
                except (ConnectionError, OSError) as e:
                    last = e
                    continue
                conn.send(messages.MMonGetMap(
                    have=self.osdmap.epoch if self.osdmap else 0
                ))
                conn.send(messages.MOSDBoot(osd_id=self.osd_id, addr=self.addr))
                self._mon_conn = conn
                return conn
            await asyncio.sleep(0.2)
        raise ConnectionError(f"no mon reachable: {last}")

    def clog(self, level: str, msg: str) -> None:
        """Best-effort cluster-log send (reference:common/LogClient —
        ECBackend.cc:956 clog_error and the scrub repair flow report
        corruption this way): fire-and-forget to the mon; a daemon that
        cannot reach its mon must never block or crash on
        observability."""
        conn = self._mon_conn
        if conn is None:
            return
        try:
            conn.send(messages.MLog(entries=[{
                "stamp": time.time(), "name": self.name,
                "level": level, "msg": msg,
            }]))
        except Exception:
            pass

    def _on_mon_reset(self) -> None:
        """Our mon died: fail over to another one (reference MonClient
        hunting)."""
        if self._stopping:
            return

        async def rehunt():
            try:
                await self._connect_mon()
                logger.info("%s: re-homed to a live mon", self.name)
            except (ConnectionError, OSError):
                await asyncio.sleep(0.5)
                if not self._stopping:
                    t = asyncio.ensure_future(rehunt())
                    self._tasks.add(t)
                    t.add_done_callback(self._tasks.discard)

        t = asyncio.ensure_future(rehunt())
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _start_admin_socket(self) -> None:
        """`ceph daemon osd.N <cmd>` surface (reference admin_socket.cc);
        enabled when the ``admin_socket`` option is set ('{name}' expands
        to this daemon's name)."""
        path = self.config.admin_socket
        if not path:
            return
        from ..common import AdminSocket, register_common

        self._admin = AdminSocket(path.replace("{name}", self.name))
        a = self._admin
        register_common(a, perf=self.perf, config=self.config,
                        device=self.device)
        self.op_tracker.register_admin(a)
        a.register(
            "dump_watchdog",
            lambda req: self.hb_map.dump(),
            "HeartbeatMap worker deadlines",
        )

        async def _arch(_req: dict) -> dict:
            # the host flags probe runs g++ once (a second or so): keep
            # it off the event loop or a diagnostics command stalls
            # heartbeats and in-flight ops
            return await asyncio.get_running_loop().run_in_executor(
                None, self._arch_dump
            )

        a.register("arch", _arch, "accelerator/host capability probe")
        if self.ec_dispatch is not None:
            a.register(
                "dump_ec_dispatch",
                lambda req: self.ec_dispatch.dump(),
                "EC microbatch dispatcher: open batches, flush reasons, "
                "pad waste, observed bucket table",
            )
            a.register(
                "dump_launch_history",
                lambda req: self.ec_dispatch.flight.dump(),
                "device-launch flight recorder: the last N launches "
                "(lane, batch key, QoS class, queue-wait vs device "
                "wall, slowest member op's trace id)",
            )
        if self.ec_supervisor is not None:
            a.register(
                "dump_engine_health",
                lambda req: self.ec_dispatch.engine_health(),
                "EC engine health state machine: breaker state, probe "
                "backoff, failure history, failover totals",
            )
        a.register(
            "dump_op_pq_state",
            lambda req: self.scheduler.dump(),
            "QoS op scheduler: policy, per-class specs, queues, "
            "dmClock tags, admission totals",
        )
        a.register(
            "dump_client_ledger",
            lambda req: self.client_ledger.dump(),
            "per-tenant op ledger: top-K (client, pool, class) rows "
            "with IOPS/bytes/p99/share over the sliding window, the "
            "evicted-other bucket, and sketch health",
        )
        a.register(
            "dump_reservations",
            lambda req: {
                "local": self.local_reserver.dump(),
                "remote": self.remote_reserver.dump(),
            },
            "recovery reservation slots: granted (with priorities) and "
            "queued, local and remote reservers",
        )
        a.register(
            "status",
            lambda req: {
                "name": self.name,
                "addr": self.addr,
                "epoch": self._epoch(),
                "pgs_led": sum(
                    1 for _ in self._led_pgs()
                ) if self.osdmap else 0,
            },
            "daemon identity and map epoch",
        )
        await a.start()

    def _arch_dump(self) -> dict:
        """The reference's ``arch`` probe fields for this daemon's
        device (the card, or the host for a CPU daemon)."""
        import platform

        import torch

        from ..utils.arch import host_march_flags

        cuda = self.device.type == "cuda"
        return {
            "platform": "gpu" if cuda else "cpu",
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if cuda else "cpu"),
            "num_devices": torch.cuda.device_count() if cuda else 1,
            "has_mxu": False,
            "host_machine": platform.machine(),
            "preferred_gf_kernel": "gf_matmul" if cuda else "plain",
            "host_march_flags": list(host_march_flags()),
        }

    def _led_pgs(self):
        for pool in self.osdmap.pools.values():
            for pg in self.osdmap.pgs_of_pool(pool.id):
                _u, _up, _a, primary = self.osdmap.pg_to_up_acting_osds(pg)
                if primary == self.osd_id:
                    yield pg

    async def stop(self, umount: bool = True) -> None:
        """``umount=False`` models a hard crash: the store is abandoned
        without a clean shutdown, so a durable backend must recover from
        its journal alone on the next mount."""
        self._stopping = True
        for opt, cb in self._observers:
            self.config.unobserve(opt, cb)
        self.scheduler.stop()  # queued grants pass; the wake timer dies
        self.recovery.stop()
        self.scrub.stop()
        self.tiering.stop()
        if self._hb_task:
            self._hb_task.cancel()
        if self._wd_task:
            self._wd_task.cancel()
        if self._mgr_task:
            self._mgr_task.cancel()
        me = asyncio.current_task()
        for t in list(self._tasks):
            if t is not me:  # a tracked task calling stop() must finish it
                t.cancel()
        if self.ec_dispatch is not None:
            # Task.cancel() above only MARKS the op tasks — yield once
            # so the cancellations actually land on their awaited
            # futures, then the flush below drops them instead of
            # launching a full device batch for doomed ops
            await asyncio.sleep(0)
            await self.ec_dispatch.stop()
        if self._admin is not None:
            await self._admin.stop()
            self._admin = None
        await self.messenger.shutdown()
        if umount:
            self.store.umount()

    # -- dispatch ------------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, messages.MOSDMapMsg):
            self._handle_map(msg, conn)
        elif isinstance(msg, messages.MOSDOp):
            # run as a task: the op blocks on shard round-trips and must not
            # stall the connection reader (sharded op queue analog)
            t = asyncio.ensure_future(self._handle_client_op(conn, msg))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)
        elif isinstance(msg, messages.MOSDECSubOpWrite):
            self._handle_sub_write(conn, msg)
        elif isinstance(msg, messages.MOSDECSubOpWriteReply):
            # the reply rides the client op's trace id: progress the
            # tracked op even though this is a different dispatch
            self.op_tracker.mark_by_trace(msg.trace, "sub_op_applied")
            w = self._write_waiters.get(msg.tid)
            if w:
                w.complete(msg.shard, msg.result)
        elif isinstance(msg, messages.MOSDECSubOpRead):
            self._handle_sub_read(conn, msg)
        elif isinstance(msg, messages.MOSDECSubOpReadReply):
            w = self._read_waiters.get(msg.tid)
            if w:
                err = msg.errors[0] if msg.errors else 0
                data = msg.blobs[0] if msg.blobs else b""
                w.complete(msg.shard, data, msg.attrs, err)  # attrs: flat {key: str}
        elif isinstance(msg, messages.MOSDOpReply):
            # replies to the OSD's own internal ops (tier traffic to the
            # base pool — the OSD acting as its own Objecter)
            self.tiering.on_reply(msg)
        elif isinstance(msg, messages.MWatchNotifyAck):
            nw = self._notify_waiters.get(msg.notify_id)
            if nw:
                nw.ack(msg.cookie, msg.blobs[0] if msg.blobs else b"")
        elif isinstance(msg, (messages.MAccelReply, messages.MAccelBeacon)):
            # shared-accelerator traffic: replies resolve the
            # remote lane's in-flight batches, beacons update the
            # routing health (TRIPPED/saturated -> local lanes, no
            # timeout chain)
            if self.accel_client is not None:
                self.accel_client.handle(msg, conn)
        elif isinstance(msg, messages.MOSDRepOp):
            self._handle_rep_op(conn, msg)
        elif isinstance(msg, messages.MOSDRepOpReply):
            self.op_tracker.mark_by_trace(msg.trace, "sub_op_applied")
            w = self._write_waiters.get(msg.tid)
            if w:
                w.complete(msg.from_osd, msg.result)
        elif isinstance(msg, messages.MPGLs):
            self._handle_pgls(conn, msg)
        elif isinstance(msg, messages.MOSDScrub):
            t = asyncio.ensure_future(self._handle_scrub(conn, msg))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)
        elif isinstance(msg, messages.MOSDPGScan):
            self.recovery.handle_scan(conn, msg)
        elif isinstance(msg, messages.MOSDPGScanReply):
            self.recovery.handle_scan_reply(msg)
        elif isinstance(msg, messages.MRecoveryReserve):
            self.recovery.handle_reserve(conn, msg)
        elif isinstance(msg, messages.MPing):
            conn.send(messages.MPingReply(stamp=msg.stamp, epoch=self._epoch()))
        elif isinstance(msg, messages.MPingReply):
            self._hb_last[self._peer_osd_id(conn)] = time.monotonic()

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._mon_conn:
            self._mon_conn = None
            self._on_mon_reset()
            return
        if conn is self._mgr_conn:
            self._mgr_conn = None
        if self.accel_client is not None:
            # the accelerator link died: fail the remote lane's
            # in-flight batches NOW (they replay on the local fallback
            # without waiting out the RPC deadline) and mark the remote
            # unreachable so new batches route local immediately
            self.accel_client.on_reset(conn)
        # a dead client's watches die with its connection (reference:
        # Watch.cc handle_watch_timeout; lingers re-register on reconnect)
        for key, table in list(self._watchers.items()):
            for cookie, wconn in list(table.items()):
                if wconn is conn:
                    del table[cookie]
                    for nw in self._notify_waiters.values():
                        nw.drop(cookie)
            if not table:
                del self._watchers[key]
        # fail every in-flight sub-op this peer owed us so primary ops and
        # recovery scans re-plan promptly instead of waiting out timeouts
        peer = self._peer_osd_id(conn)
        if peer < 0:
            return
        for w in list(self._write_waiters.values()):
            w.fail_member(peer)
        for w in list(self._read_waiters.values()):
            w.fail_member(peer)
        self.recovery.fail_member(peer)
        # remote reservations a dead primary held OR had queued here must
        # free their slots, or one crashed peer starves every later
        # recovery (reference: the reservation cancel on pg interval
        # change)
        self.remote_reserver.cancel_where(
            lambda k: isinstance(k, tuple) and k and k[0] == peer
        )

    def _peer_osd_id(self, conn: Connection) -> int:
        name = conn.peer_name
        if name.startswith("osd."):
            try:
                return int(name.split(".", 1)[1])
            except ValueError:
                pass
        return -1

    def _epoch(self) -> int:
        return self.osdmap.epoch if self.osdmap else 0

    def _handle_map(self, msg: messages.MOSDMapMsg,
                    conn: Connection | None = None) -> None:
        if self.osdmap is not None and msg.epoch <= self.osdmap.epoch:
            return
        from .osdmap import advance_map

        m = advance_map(self.osdmap, msg.epoch, msg.osdmap, msg.incrementals)
        if m is None:
            # delta chain does not bridge to our epoch: fetch a full map
            # (reference:src/osd/OSD.cc handle_osd_map request_full path)
            if conn is not None:
                # count only refetches actually SENT — a conn-less
                # delivery observing a gap resolves via the next push
                self.perf.get("churn").inc("map_gap_refetches")
                conn.send(messages.MMonGetMap(have=None))
            return
        old = self.osdmap
        self.osdmap = m
        self.perf.get("churn").inc("maps_applied")
        self._codecs.clear()  # pools/profiles may have changed
        if self.accel_client is not None:
            # the accelerator fleet rides the map: a mon
            # markdown reaches this router on the same push that
            # carries any other map change — one push, no side channel
            self.accel_client.apply_map(m.accelmap)
        try:
            self._note_intervals(old, m)
        except Exception:
            logger.exception("%s: interval recording failed", self.name)
        self._map_event.set()
        if (old is not None and old.is_up(self.osd_id)
                and not m.is_up(self.osd_id) and not self._stopping):
            self._boot_again(m.epoch)
        self.recovery.kick()  # acting sets may have changed
        self._kick_snap_trim()

    def _boot_again(self, epoch: int) -> None:
        """A map marks this running OSD down (a peer missed our replies
        while our loop stalled, or a late report): announce ourselves
        again, as Ceph's OSD does when "wrongly marked me down"
        (reference:src/osd/OSD.cc), at most once per heartbeat grace."""
        now = time.monotonic()
        if now - self._booted_again < self.heartbeat_grace:
            return
        self._booted_again = now
        logger.warning("%s: map e%d wrongly marks me down; booting again",
                       self.name, epoch)
        if self._mon_conn is not None:
            self._mon_conn.send(messages.MOSDBoot(osd_id=self.osd_id, addr=self.addr))

    def _note_intervals(self, old, new) -> None:
        """Close acting-set intervals for locally-hosted PGs on map
        advance (reference:src/osd/osd_types.cc
        PastIntervals::check_new_interval): when a PG's acting set or
        primary changed, append the closed interval to each local shard's
        pgmeta omap.  Peering's prior set is the union of these records
        across reachable members — how a new primary learns which
        ex-members may hold writes from a stale interval."""
        if old is None:
            return
        from .peering import PAST_INTERVALS_KEY, PastIntervals

        try:
            cids = self.store.list_collections()
        except Exception:
            return
        by_pg: dict[str, list[tuple[CollectionId, int]]] = {}
        for cid in cids:
            base, _, s = cid.pg.partition("s")
            try:
                shard = int(s) if s else -1
            except ValueError:
                continue
            by_pg.setdefault(base, []).append((cid, shard))
        for pgid_s, locs in by_pg.items():
            try:
                pg = PGid.parse(pgid_s)
                _u, _t, old_acting, old_primary = old.pg_to_up_acting_osds(pg)
                _u2, _t2, new_acting, new_primary = new.pg_to_up_acting_osds(pg)
            except Exception:
                continue  # pool vanished / unparsable: nothing to record
            if old_acting == new_acting and old_primary == new_primary:
                continue
            self.perf.get("churn").inc("pgs_remapped")
            start = self._interval_start.get(pgid_s, old.epoch)
            self._interval_start[pgid_s] = new.epoch
            for cid, shard in locs:
                try:
                    raw = self.store.omap_get(cid, meta_oid(shard)).get(
                        PAST_INTERVALS_KEY
                    )
                except KeyError:
                    raw = None
                past = PastIntervals.from_json(raw)
                past.note_change(start, old.epoch, old_acting, old_primary)
                txn = Transaction().omap_setkeys(
                    cid, meta_oid(shard),
                    {PAST_INTERVALS_KEY: past.to_json()},
                )
                self.store.apply(txn)
                self.perf.get("churn").inc("intervals_recorded")

    def _kick_snap_trim(self) -> None:
        """Schedule clone trimming for pools whose removed_snaps grew
        (the SnapTrimmer trigger, reference:src/osd/PrimaryLogPG.cc
        kick_snap_trim on map advance).  A pool is recorded as handled
        only after a COMPLETE trim pass, so degraded/failed passes are
        retried on the next map advance."""
        for pool in self.osdmap.pools.values():
            removed = set(pool.removed_snaps)
            if not removed or removed == self._trimmed_snaps.get(pool.id):
                continue
            if pool.id in self._trimming:
                continue  # one pass per pool at a time
            self._trimming.add(pool.id)
            t = asyncio.ensure_future(self._snap_trim_pool(pool))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    # -- codec / placement helpers --------------------------------------------

    def _pool_codec(self, pool: Pool) -> tuple[Any, StripeInfo]:
        cached = self._codecs.get(pool.id)
        if cached is not None:
            return cached
        profile = self.osdmap.get_erasure_code_profile(pool.erasure_code_profile)
        plugin = profile.get("plugin", "jerasure")
        codec = registry.instance().factory(plugin, profile,
                                            device=self.device)
        chunk = codec.get_chunk_size(pool.stripe_width)
        sinfo = StripeInfo(
            stripe_width=chunk * codec.get_data_chunk_count(), chunk_size=chunk
        )
        self._codecs[pool.id] = (codec, sinfo)
        return codec, sinfo

    def _new_tid(self) -> int:
        self._tid += 1
        return self._tid

    # -- client op engine (reference:PrimaryLogPG::do_osd_ops) ----------------

    _WRITE_OPS = frozenset(
        ("writefull", "write", "append", "zero", "truncate", "delete")
    )
    # replicated ops that must plan+commit under the PG lock
    _REP_LOCKED_OPS = _WRITE_OPS | frozenset(
        ("rollback", "call", "setxattr", "rmxattr",
         "omap_setkeys", "omap_rmkeys", "omap_clear")
    )
    # mutations a quota-full pool still REJECTS: everything that can
    # grow data, incl. setxattr (creates missing objects) and omap
    # writes — but NOT the space-freeing ops (delete/rmxattr/omap rm/
    # clear), which are the way out of full.  "call" is handled by the
    # method's own WR flag at the gate.
    _QUOTA_GATED_OPS = (_REP_LOCKED_OPS
                        - frozenset(("delete", "rmxattr", "omap_rmkeys",
                                     "omap_clear", "call")))

    def _op_sampled(self, msg: messages.MOSDOp, internal: bool) -> bool:
        """1-in-``osd_op_trace_sample_every`` client ops get full
        waterfall spans; with the tail keep policy armed this draw is
        the BASELINE keep reason — the healthy-
        median sample the anomaly-kept traces are compared against.
        Internal peer-daemon ops never sample: their originator's op
        owns the trace."""
        n = self._trace_sample_every
        if internal or n <= 0 or msg.trace is None:
            return False
        self._trace_sampled_n += 1
        return self._trace_sampled_n % n == 0

    def _trace_keep_reason(self, msg: messages.MOSDOp, result: int,
                           dt: float, sampled: bool) -> str | None:
        """The tail-sampling keep decision, evaluated at op
        COMPLETION when wall time, result and the launch record are
        all known — the Dapper->Canopy decide-late pattern.  Returns
        the keep reason (``slow``/``error``/``replay``/``baseline``)
        or None (drop).  Reasons are checked most-severe first so the
        perf breakdown attributes each kept trace to what actually
        condemned it.  With ``osd_trace_keep`` off this never runs:
        the caller falls back to pure head sampling."""
        thr = self._trace_keep_thr
        if thr <= 0:
            thr = float(self.config.osd_op_complaint_time) / 4.0
        if thr > 0 and dt >= thr:
            return "slow"
        if result < 0:
            # every error fold counts, the -EAGAIN retry class
            # included: an op the client must replay is exactly the
            # op whose waterfall the operator will want
            return "error"
        if self.ec_dispatch is not None:
            # anomaly evidence from the launch that carried this trace
            # (ops/device_trace.py FlightRecorder): an engine fault, a
            # failover-served batch, or an accelerator that answered
            # from ITS fallback — correct bytes, but a re-routed path
            # worth a waterfall.  O(flight ring) per op; the ring is
            # empty on pure-replicated paths.
            try:
                rec = self.ec_dispatch.flight.lookup(msg.trace)
            except Exception:  # pragma: no cover - observability only
                rec = None
            if rec is not None and (
                rec.get("error") or rec.get("origin")
                or rec.get("served") == "fallback"
                or rec.get("remote_served") == "fallback"
            ):
                return "replay"
        return "baseline" if sampled else None

    def _waterfall_spans(self, conn: Connection, msg: messages.MOSDOp,
                         op) -> list[dict]:
        """Build one sampled op's hop spans (this OSD's view of the
        waterfall), record them into the local ``stack`` provider
        ring, feed the ``stack.lat_<hop>`` histograms, and return the
        JSON-able list the reply piggybacks (``t0`` in THIS daemon's
        monotonic clock; the client re-aligns).

        Hops, all in this process's timeline:

        - ``client_serialize``: the client's submit->frame-queued span
          — its DURATION is exact (both stamps are the client's own
          clock: ``msg.stamps["submit"]`` and the frame header's send
          stamp).
        - ``wire``: send stamp (aligned) -> receive stamp.  Skipped
          when the peer's clock was never estimated (first frames can
          beat the probe round trip).

        Placement is **causally anchored**: the wire hop ends exactly
        at our receive stamp and client_serialize ends exactly where
        wire starts, so every span this daemon emits sits on ONE rigid
        local timeline and the merged waterfall is monotonic by
        construction — clock alignment determines the wire DURATION
        (and carries its uncertainty), never the ordering.  Without
        the clamp, an offset error of rtt/2 (the estimator's honest
        bound) can exceed a loopback hop gap and fake a reordering.
        - ``dispatch``: receive stamp -> op-tracker creation.
        - ``qos_wait`` / ``execute``: straight off the typed OpTracker
          transitions.
        - children of execute, from the flight record of the launch
          that carried this trace: ``coalesce_wait`` (batch queue
          wait), ``accel_queue_wait`` (remote lane only) and
          ``device_wall``.  Their DURATIONS are measured; their
          placement is back-to-back ending at execute end (the launch
          record does not keep absolute stamps) — documented
          approximation, excluded from path_sum by the parent link.
        """
        from ..common import stack_ledger
        from ..common.tracing import record_span, span_id_for

        trace = msg.trace
        now = time.monotonic()
        ev: dict[str, float] = {}
        for state, ts in op.events:
            ev.setdefault(state, ts)
        peer = conn.peer_name
        # per-CONNECTION estimate: peer names are not unique across
        # processes, so alignment never reads a name-keyed global
        align = conn.clock_align
        sent = msg.sent
        submit = (msg.stamps or {}).get("submit")
        recv = msg.recv_ts
        spans: list[dict] = []
        wire_start = recv  # where client spans anchor (causal clamp)
        if sent is not None and recv is not None:
            loc = align(float(sent))
            if loc is not None:
                aligned_t0, unc = loc
                dur = max(0.0, recv - aligned_t0)
                wire_start = recv - dur
                spans.append({"hop": "wire", "t0": wire_start,
                              "dur": dur, "entity": self.name,
                              "uncertainty": unc})
        if sent is not None and submit is not None:
            dur = max(0.0, float(sent) - float(submit))
            anchor = wire_start if wire_start is not None else now
            loc = align(float(submit))
            unc = loc[1] if loc is not None else None
            spans.append({"hop": "client_serialize",
                          "t0": anchor - dur, "dur": dur,
                          "entity": peer,
                          **({"uncertainty": unc}
                             if unc is not None else {})})
        tq, td = ev.get("queued_for_qos"), ev.get("dequeued")
        if recv is not None:
            # dispatch runs to the qos mark (not just op creation):
            # the tracker bookkeeping between the two is dispatch-side
            # work, and leaving it uncovered opens a gap the hop-sum
            # honesty check would charge to nobody
            d_end = tq if tq is not None else op.initiated_at
            spans.append({"hop": "dispatch", "t0": recv,
                          "dur": max(0.0, d_end - recv),
                          "entity": self.name})
        if tq is not None and td is not None:
            spans.append({"hop": "qos_wait", "t0": tq,
                          "dur": max(0.0, td - tq),
                          "entity": self.name})
        if td is not None:
            spans.append({"hop": "execute", "t0": td,
                          "dur": max(0.0, now - td),
                          "entity": self.name})
            rec = None
            if self.ec_dispatch is not None:
                try:
                    rec = self.ec_dispatch.flight.lookup(trace)
                except Exception:  # pragma: no cover - observability only
                    rec = None
            if rec:
                parent = span_id_for(trace, self.name, "execute")
                cursor = now
                # laid out backwards from execute end: the device wall
                # is last, the accel-side wait before it, the local
                # coalesce wait first.  Clamped at the execute span's
                # own start: the flight record carries BATCH-level
                # durations (the oldest member's queue wait, the
                # shared launch wall), and a child rendered before its
                # parent — before this op even reached the OSD — would
                # read as time travel, not as the documented
                # approximation
                for hop, key in (("device_wall", "device_wall_s"),
                                 ("accel_queue_wait",
                                  "remote_queue_wait_s"),
                                 ("coalesce_wait", "queue_wait_s")):
                    dur = rec.get(key)
                    if not dur:
                        continue
                    cursor = max(td, cursor - float(dur))
                    spans.append({"hop": hop, "t0": cursor,
                                  "dur": float(dur),
                                  "entity": self.name,
                                  "parent": parent})
        for s in spans:
            # the tenant id rides every span event so op_waterfall can
            # answer "whose op" without a tracker lookup
            record_span(s["hop"], s["t0"], s["dur"], trace=trace,
                        entity=s["entity"], parent=s.get("parent"),
                        uncertainty=s.get("uncertainty"),
                        **({"client": msg.client}
                           if msg.client is not None else {}))
            stack_ledger.feed_hop(s["hop"], s["dur"])
        # lat_total = client submit -> reply queued: the OSD-visible
        # extent, fed HERE because this daemon's family is the one the
        # mgr exports continuously (the reply wire/delivery tail rides
        # lat_reply_* from the client) — the registration text says so
        base = None
        if submit is not None:
            loc = align(float(submit))
            base = loc[0] if loc is not None else None
        if base is None:
            base = recv if recv is not None else op.initiated_at
        stack_ledger.feed_hop("total", max(0.0, now - base))
        stack_ledger.stack_perf().inc("sampled_ops")
        return [
            {k: (round(v, 9) if isinstance(v, float) else v)
             for k, v in s.items()}
            for s in spans
        ]

    async def _handle_client_op(self, conn: Connection, msg: messages.MOSDOp) -> None:
        posd = self.perf.get("osd")
        posd.inc("op")
        names = [op.get("op") for op in msg.ops]
        if any(n in self._WRITE_OPS for n in names):
            posd.inc("op_w")
            posd.inc("op_in_bytes", sum(len(b) for b in msg.blobs))
        if any(n == "read" for n in names):
            posd.inc("op_r")
        # the tracked op carries the client's trace id so sub-op replies
        # (arriving on other dispatch contexts) can mark its progress;
        # the tenant id rides the desc into dump_ops_in_flight and the
        # contextvar so EC dispatch/flight records attribute to it with
        # no signature threading
        from ..common.tracing import current_client

        current_client.set(msg.client)
        op = self.op_tracker.create(
            trace=msg.trace, tid=msg.tid, oid=msg.oid, pool=msg.pool,
            ops=names, client=msg.client,
        )
        self._refresh_op_handle()
        # QoS admission (reference: enqueue_op -> the osd_op_queue ->
        # dequeue_op): ops from PEER DAEMONS bypass — they run on
        # behalf of an op that already holds a grant on its primary
        # (tier promotion/flush internal ops), and re-admitting them
        # could deadlock the slot pool against their originator
        internal = conn.peer_name.startswith("osd.")
        sampled = self._op_sampled(msg, internal)
        replied = False
        granted = False
        try:
            if not internal:
                op.mark("queued_for_qos")
                if msg.from_batch:
                    # arrived inside a multi-op request frame: tally
                    # BEFORE admit so dump_op_pq_state shows the
                    # batched share even while members sit queued
                    self.scheduler.note_batch_member("client")
                await self.scheduler.admit("client")
                granted = True
            op.mark("dequeued")
            _trace.point("osd_dequeue_op", osd=self.osd_id, tid=msg.tid,
                         oid=msg.oid, ops=names)
            t0 = time.perf_counter()
            if self._inject_op_delay > 0 and not internal:
                # SLO storm injector: burns the latency budget without
                # touching execution — inside the measured window so
                # op_latency and the ledger p99 both see it; raises
                # SLO_BURN live, clears when the knob resets.
                # _every thins it to 1-in-N ops so the tail-sampling
                # acceptance run can pin a ~1% slow tail
                self._inject_op_delay_n += 1
                if (self._inject_op_delay_every <= 1
                        or self._inject_op_delay_n
                        % self._inject_op_delay_every == 0):
                    await asyncio.sleep(self._inject_op_delay)
            try:
                result, out, blobs = await self._execute_op(msg, conn)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.exception("%s: op tid=%s failed", self.name, msg.tid)
                result, out, blobs = -EIO, [{"error": str(e)}], []
            dt = time.perf_counter() - t0
            posd.observe("op_latency", dt)
            # in+out payload x latency: reads land on their returned
            # bytes, writes on their submitted bytes, so a size-skewed
            # latency regression shows in the right bucket row
            posd.hist(
                "op_latency_histogram",
                sum(len(b) for b in msg.blobs)
                + sum(len(b) for b in blobs),
                dt,
            )
            _trace.point("osd_op_reply", osd=self.osd_id, tid=msg.tid,
                         result=result)
            if result < 0:
                posd.inc("op_err")
            else:
                posd.inc(
                    "op_out_bytes", sum(len(b) for b in blobs)
                )
            if msg.client is not None and not internal:
                # tenant attribution: O(K) however many
                # clients exist — unattributed peers never reach here
                self.client_ledger.account(
                    msg.client, msg.pool, "client",
                    bytes_in=sum(len(b) for b in msg.blobs),
                    bytes_out=sum(len(b) for b in blobs),
                    lat=dt, err=result < 0,
                )
            op.mark("replied")
            spans_payload = None
            keep = None
            if not internal and msg.trace is not None:
                if self._trace_keep:
                    keep = self._trace_keep_reason(msg, result, dt, sampled)
                elif sampled:
                    # keep policy disarmed: pure head sampling, exactly
                    # the behaviour before the keep policy (and the tracing-off
                    # arm of the bench overhead capture)
                    keep = "baseline"
            if keep is not None:
                # best-effort by contract: a waterfall bug must never
                # fail an op that executed fine
                try:
                    spans_payload = self._waterfall_spans(conn, msg, op)
                except Exception:  # pragma: no cover - observability only
                    logger.exception(
                        "%s: waterfall span build failed for tid=%s",
                        self.name, msg.tid,
                    )
                else:
                    ptr = self.perf.get("trace")
                    ptr.inc("kept")
                    ptr.inc("kept_" + keep)
                    launch = None
                    if self.ec_dispatch is not None:
                        # launch-record linkage: the flight ring entry
                        # that served this op, so `trace show` can name
                        # the lane/engine behind a replay-kept trace
                        try:
                            rec = self.ec_dispatch.flight.lookup(msg.trace)
                        except Exception:  # pragma: no cover
                            rec = None
                        if rec is not None:
                            launch = {
                                k: rec.get(k)
                                for k in ("seq", "served", "origin",
                                          "error", "remote_served")
                                if rec.get(k) is not None
                            }
                    self._pending_traces.append({
                        "trace": msg.trace,
                        "client": msg.client,
                        "pool": msg.pool,
                        "klass": "client",
                        "reason": keep,
                        "wall_s": round(dt, 6),
                        "result": result,
                        "launch": launch,
                        "t": time.time(),
                    })
            elif not internal and msg.trace is not None:
                self.perf.get("trace").inc("dropped")
            conn.send(
                messages.MOSDOpReply(
                    tid=msg.tid, result=result, epoch=self._epoch(), out=out,
                    blobs=blobs, spans=spans_payload,
                )
            )
            replied = True
        finally:
            if granted:
                # the slot must free no matter how this op dies, or a
                # few failed ops wedge the whole admission pool
                self.scheduler.complete("client")
            # the tracker entry MUST retire no matter how this op dies
            # (a leaked in-flight op pins oldest_start -> the watchdog
            # deadline never clears and SLOW_OPS stays raised forever);
            # only ops whose reply actually left count as completed in
            # dump_historic_ops — cancelled or reply-encode-failed ops
            # must not masquerade as served
            self.op_tracker.finish(op, completed=replied)
            self._refresh_op_handle()

    async def _pool_at_epoch(self, pool_id: int, epoch: int):
        """The pool once this OSD's map reaches ``epoch``, or None when
        the map does not get there within ``MAP_WAIT_S`` (or lacks the
        pool when it does)."""
        try:
            async with asyncio.timeout(MAP_WAIT_S):
                while self.osdmap.epoch < epoch:
                    # _handle_map sets the event on every map it takes
                    self._map_event.clear()
                    await self._map_event.wait()
        except TimeoutError:
            pass
        return self.osdmap.pools.get(pool_id)

    def _quota_rejects(self, msg: messages.MOSDOp) -> bool:
        """True iff this op batch contains a data-GROWING mutation
        (gating only _WRITE_OPS would let setxattr/omap writes bypass
        the quota, and falsely reject a delete+read batch).  cls calls
        gate on the method's WR flag."""
        for op in msg.ops:
            n = op.get("op")
            if n in self._QUOTA_GATED_OPS:
                return True
            if n == "call":
                from .. import cls as cls_mod

                try:
                    kls = cls_mod.get_class(
                        op.get("cls", ""),
                        class_dir=self.config.get("osd_class_dir")
                        or None,
                    )
                except cls_mod.ClsLoadError:
                    return True  # broken class: fail closed at the gate
                method = (kls.methods.get(op.get("method", ""))
                          if kls else None)
                if method is not None and method.is_write:
                    return True
        return False

    async def _execute_op(
        self, msg: messages.MOSDOp, conn: Connection | None = None
    ) -> tuple[int, list, list[bytes]]:
        if self.osdmap is None:
            return -EAGAIN, [{"error": "no map"}], []
        pool = self.osdmap.pools.get(msg.pool)
        if pool is None and (msg.epoch or 0) > self.osdmap.epoch:
            # the client holds a newer map than ours (a pool created
            # since): wait for it, as Ceph's OSD queues an op until
            # its map reaches the op's epoch, rather than answer
            # -ENOENT for a pool that exists
            pool = await self._pool_at_epoch(msg.pool, msg.epoch)
        if pool is None:
            return -ENOENT, [{"error": f"no pool {msg.pool}"}], []
        # the modded pg (raw seed folded onto pg_num) names collections and
        # the version stream — reference:OSDMap raw_pg_to_pg; using the raw
        # pg would give every object its own phantom PG
        pg, acting, primary = self.osdmap.object_to_acting(msg.oid, msg.pool)
        if primary != self.osd_id:
            # client raced a map change; it must re-target
            return -EAGAIN, [{"error": "not primary", "primary": primary}], []
        names = [op.get("op") for op in msg.ops]
        from .osdmap import FLAG_FULL_QUOTA

        if "pause" in self.osdmap.cluster_flags:
            # `ceph osd set pause` stops client IO cluster-wide
            # (reference blocks the op until unpause; here the client's
            # bounded EAGAIN retry surfaces the pause instead of
            # waiting forever — divergence documented)
            return -EAGAIN, [{"error": "cluster IO paused "
                                       "(osd unset pause to resume)"}], []
        # quota gate: the pool itself, and — when this pool is a cache
        # TIER — its base pool too: everything admitted to the cache
        # eventually flushes to the base, so a quota-full base must
        # stop new client writes AT the cache (clients redirected to
        # the cache pool would otherwise bypass the base's quota)
        quota_full = bool(pool.flags & FLAG_FULL_QUOTA)
        if not quota_full and pool.tier_of >= 0:
            base = self.osdmap.pools.get(pool.tier_of)
            quota_full = base is not None and bool(
                base.flags & FLAG_FULL_QUOTA
            )
        if quota_full and self._quota_rejects(msg):
            # quota-full pools reject data-growing mutations but allow
            # deletions/space-freeing — the only way out of full
            # (reference:PrimaryLogPG -EDQUOT on FLAG_FULL_QUOTA).
            # The tier agent's flush backlog keeps retrying on its
            # periodic tick until the operator raises the quota.
            return -EDQUOT, [{"error": f"pool '{pool.name}' is full "
                                       "(quota)"}], []
        if any(n in ("watch", "unwatch", "notify") for n in names):
            # backend-independent: watch state lives on the primary, not
            # in the object store (reference:src/osd/Watch.cc)
            return await self._watch_execute(pg, pool, acting, msg, conn)
        if pool.type == POOL_TYPE_ERASURE:
            return await self._ec_execute(pg, pool, acting, msg)
        tiered = pool.tier_of >= 0 and pool.cache_mode == "writeback"
        if tiered:
            # cache-pool op (reference:PrimaryLogPG maybe_handle_cache):
            # record the hit, promote on miss, inject the dirty marker —
            # BEFORE the pg lock (promote takes it itself)
            await self.tiering.prepare(pg, pool, acting, msg)
        names = [op.get("op") for op in msg.ops]  # prepare may inject
        if any(n in self._REP_LOCKED_OPS for n in names):
            # every replicated mutation plans against current state
            # (snap clone decisions, cls read-modify-write, projected
            # sizes) — planning and commit must be atomic vs concurrent
            # ops on the PG (the reference holds the PG lock across
            # execute_ctx); the commit path skips re-locking
            async with self.pg_lock(pg):
                result = await self._rep_execute(pg, pool, acting, msg,
                                                 locked=True)
        else:
            result = await self._rep_execute(pg, pool, acting, msg)
        if tiered:
            await self.tiering.finish(pg, pool, acting, msg, result[0])
        return result

    def _handle_pgls(self, conn: Connection, msg) -> None:
        """List this PG's objects from the primary's own shard (every
        acting shard holds a chunk of every object, so the local scan is
        complete — the reference's PGLS, reference:src/osd/
        PrimaryLogPG.cc do_pg_op)."""
        try:
            pg = PGid.parse(msg.pgid)
            if self.osdmap is None:
                raise RuntimeError("no map")
            pool = self.osdmap.pools.get(pg.pool)
            if pool is None:
                raise RuntimeError(f"no pool {pg.pool}")
            _up, _upp, acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
            if primary != self.osd_id:
                conn.send(messages.MPGLsReply(
                    tid=msg.tid, result=-EAGAIN, names=[],
                ))
                return
            if pool.type == POOL_TYPE_ERASURE:
                shard = next(
                    (s for s, o in enumerate(acting) if o == self.osd_id), 0
                )
            else:
                shard = -1
            objects, _log, _info, _ivs = self.recovery._local_scan(
                str(pg), shard
            )
            conn.send(messages.MPGLsReply(
                tid=msg.tid, result=0,
                # clones/snapdirs are internal names, not listable heads
                names=sorted(
                    n for n in objects if not snaps_mod.is_clone_name(n)
                ),
            ))
        except Exception as e:
            logger.exception("%s: pgls of %s failed", self.name, msg.pgid)
            conn.send(messages.MPGLsReply(
                tid=msg.tid, result=-EIO, names=[str(e)],
            ))

    async def _handle_scrub(self, conn: Connection, msg) -> None:
        """Operator-commanded deep scrub of one PG (the `ceph pg scrub`
        analog; engine in scrub.py, reference:src/osd/ECBackend.cc:2313).
        A failed scrub, a device fault in its repair decode included,
        is answered with the error."""
        try:
            pg = PGid.parse(msg.pgid)
            if self.osdmap is None:
                raise RuntimeError("no map")
            pool = self.osdmap.pools.get(pg.pool)
            if pool is None:
                raise RuntimeError(f"no pool {pg.pool}")
            _up, _upp, acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
            if primary != self.osd_id:
                conn.send(messages.MOSDScrubReply(
                    tid=msg.tid, result=-EAGAIN,
                    report={"error": "not primary", "primary": primary},
                ))
                return
            report = await self.scrub.scrub_pg(
                pg, pool, acting, repair=bool(msg.repair)
            )
            conn.send(messages.MOSDScrubReply(
                tid=msg.tid, result=0, report=report,
            ))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.exception("%s: scrub of %s failed", self.name, msg.pgid)
            conn.send(messages.MOSDScrubReply(
                tid=msg.tid, result=-EIO, report={"error": str(e)},
            ))

    # ======================= EC backend =====================================

    def _shard_cid(self, pg: PGid, shard: int) -> CollectionId:
        return CollectionId(f"{pg}s{shard}")

    @staticmethod
    def _lock_idle(lock) -> bool:
        """True when nobody holds OR waits on the lock: release() wakes
        waiters via call_soon, so locked() alone has a False window while
        a woken waiter is still pending — evicting then would hand the
        same key two live Lock instances."""
        inner = getattr(lock, "_lock", lock)  # LockdepLock wraps
        return not lock.locked() and not getattr(inner, "_waiters", None)

    def _get_lock(self, table: dict, key, name: str,
                  max_entries: int | None = None) -> asyncio.Lock:
        """Shared lazy-create for the lock tables; LockdepLock is a plain
        asyncio.Lock unless lockdep is enabled (the reference's
        `lockdep = true` config)."""
        lock = table.get(key)
        if lock is None:
            from ..common.lockdep import LockdepLock

            if max_entries is not None and len(table) > max_entries:
                # bound the table: only fully idle locks may be evicted
                for k in [k for k, v in table.items() if self._lock_idle(v)]:
                    del table[k]
            lock = table[key] = LockdepLock(name)
        return lock

    def pg_lock(self, pg: PGid) -> asyncio.Lock:
        """Per-PG mutation lock: serializes REPLICATED-pool client
        mutations and recovery pushes on the primary (the role of the
        reference's PG lock, reference:src/osd/PG.h lock()).  The EC
        pipeline uses the finer obj_lock instead."""
        key = str(pg)
        return self._get_lock(self._pg_locks, key, f"{self.name}:pg:{key}")

    def obj_lock(self, pg: PGid, oid: str) -> asyncio.Lock:
        """Per-object-family mutation lock for the EC pipeline — the
        collapsed ExtentCache (reference:src/osd/ExtentCache.h:1 + the
        three wait-lists reference:src/osd/ECBackend.h:549-551): RMWs to
        the SAME object serialize (any same-object extents conflict in
        the collapsed model), while RMWs to different objects in one PG
        pipeline freely — their read and commit phases interleave.

        The key is the object's HEAD name: clones and the snapdir share
        their head's lock because SnapSet state spans the family (a
        clone trim and a head write must not interleave).  EC recovery
        and scrub take the same lock per repaired object, preserving
        the client-vs-repair exclusion the per-PG lock used to give."""
        key = (str(pg), snaps_mod.clone_parent(oid))
        return self._get_lock(
            self._obj_locks, key,
            f"{self.name}:obj:{key[0]}:{key[1]}", max_entries=4096,
        )

    def ec_exclusive(self, pg: PGid, oid: str):
        """Family lock + whole-object extent exclusivity: waits out any
        in-flight pipelined extent writes (fast-path _ec_mutate) before
        entering, then excludes them until exit.  Every non-pipelined
        family mutation — delete, setxattr, rollback, repair, scrub —
        must use this instead of bare obj_lock, or it could interleave
        with a fast op's unlocked read/encode phase."""
        import contextlib

        @contextlib.asynccontextmanager
        async def _cm():
            key = (str(pg), snaps_mod.clone_parent(oid))
            ext = self._extent_locks
            rec = ext.enqueue(key, ec_transaction.ExtentLocks.FULL)
            try:
                if not rec.active:
                    # FIFO: our queued FULL record blocks every later
                    # acquisition, so in-flight fast writes drain and we
                    # run next — no starvation
                    await rec.event.wait()
                async with self.obj_lock(pg, oid):
                    yield
            finally:
                ext.release(key, rec.token)
                self._ec_hash_proj.pop(key, None)

        return _cm()

    def _next_version(self, pg: PGid) -> Eversion:
        prev = self._pg_versions.get(str(pg), Eversion())
        v = Eversion(self._epoch(), prev.version + 1)
        self._pg_versions[str(pg)] = v
        return v

    async def _ec_execute(
        self, pg: PGid, pool: Pool, acting: list[int], msg: messages.MOSDOp
    ) -> tuple[int, list, list[bytes]]:
        out: list = []
        blobs: list[bytes] = []
        snapc = snaps_mod.SnapContext.from_dict(msg.snapc)
        # reads at a snap resolve oid -> serving clone once per message
        read_oid = msg.oid
        if msg.snapid is not None:
            r, read_oid = await self._ec_resolve_snap(
                pg, pool, acting, msg.oid, int(msg.snapid)
            )
            if r < 0:
                return r, [{"rval": r}], blobs
        for op in msg.ops:
            name = op["op"]
            if name in ("writefull", "write", "append", "zero", "truncate"):
                data = (
                    msg.blobs[op["data"]] if op.get("data") is not None else b""
                )
                r = await self._ec_mutate(
                    pg, pool, acting, msg.oid, name, op, data, snapc
                )
                out.append({"rval": r})
                if r < 0:
                    return r, out, blobs
            elif name == "delete":
                r = await self._ec_delete(pg, pool, acting, msg.oid, snapc)
                out.append({"rval": r})
                if r < 0:
                    return r, out, blobs
            elif name == "rollback":
                r = await self._ec_rollback(
                    pg, pool, acting, msg.oid, int(op["snapid"]), snapc
                )
                out.append({"rval": r})
                if r < 0:
                    return r, out, blobs
            elif name == "list_snaps":
                r, ssd = await self._ec_list_snaps(pg, pool, acting, msg.oid)
                out.append({"rval": r, **({"snapset": ssd} if r == 0 else {})})
                if r < 0:
                    return r, out, blobs
            elif name == "read":
                off = int(op.get("offset", 0))
                ln = int(op.get("length", 0)) or -1
                r, data = await self._ec_read(pg, pool, acting, read_oid, off, ln)
                if r < 0:
                    out.append({"rval": r})
                    return r, out, blobs
                out.append({"rval": 0, "data": len(blobs)})
                blobs.append(data)
            elif name == "stat":
                r, size = await self._ec_stat(pg, pool, acting, read_oid)
                out.append({"rval": r, "size": size})
                if r < 0:
                    return r, out, blobs
            elif name in ("setxattr", "rmxattr"):
                value = (
                    msg.blobs[op["data"]] if op.get("data") is not None else b""
                )
                r = await self._ec_setxattr(
                    pg, pool, acting, msg.oid, op["key"],
                    value if name == "setxattr" else None, snapc=snapc,
                )
                out.append({"rval": r})
                if r < 0:
                    return r, out, blobs
            elif name in ("getxattr", "getxattrs"):
                r, attrs = await self._ec_getxattrs(pg, pool, acting, read_oid)
                if r < 0:
                    out.append({"rval": r})
                    return r, out, blobs
                if name == "getxattr":
                    val = attrs.get(op["key"])
                    if val is None:
                        out.append({"rval": -ENOENT})
                    else:
                        out.append({"rval": 0, "data": len(blobs)})
                        blobs.append(val)
                else:
                    out.append({
                        "rval": 0,
                        "attrs": {k: len(blobs) + i for i, k in
                                  enumerate(sorted(attrs))},
                    })
                    blobs.extend(attrs[k] for k in sorted(attrs))
            elif name.startswith("omap_"):
                # EC pools do not support omap (reference:PrimaryLogPG.cc
                # do_osd_ops rejects omap writes on EC with -EOPNOTSUPP)
                out.append({"rval": -EOPNOTSUPP, "error": "no omap on EC pools"})
                return -EOPNOTSUPP, out, blobs
            elif name == "call":
                # object classes need omap/overwrite primitives EC shards
                # don't have (matches rados-classes-on-EC being
                # unsupported at the reference version)
                out.append({"rval": -EOPNOTSUPP,
                            "error": "no object classes on EC pools"})
                return -EOPNOTSUPP, out, blobs
            else:
                out.append({"rval": -EINVAL, "error": f"bad op {name!r}"})
                return -EINVAL, out, blobs
        return 0, out, blobs

    USER_XATTR_PREFIX = "u_"  # system keys ("_", hinfo) live unprefixed

    async def _ec_setxattr(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        key: str, value: bytes | None, raw_key: bool = False,
        snapc: "snaps_mod.SnapContext | None" = None,
        create_missing: bool = True,
    ) -> int:
        """Set (or remove, value=None) a user xattr on every present
        shard — a versioned mutation through the normal sub-write path
        (reference stores object attrs on all EC shards).  ``raw_key``
        skips the user prefix (system attrs, e.g. the SnapSet).  Like
        every mutation, clones on first-write-after-snap.
        ``create_missing=False`` answers -ENOENT instead of creating —
        background maintainers (the snap trimmer) must never RESURRECT
        an object a racing client delete just removed."""
        async with self.ec_exclusive(pg, oid):
            codec, _si = self._pool_codec(pool)
            k, km = codec.get_data_chunk_count(), codec.get_chunk_count()
            present = [
                (s, o) for s, o in enumerate(acting[:km])
                if o != CRUSH_ITEM_NONE
            ]
            if len(present) < max(pool.min_size, k):
                return -EAGAIN
            oi, hashes, vers, errs, ss = await self._ec_meta(
                pg, oid, dict(present)
            )
            if any(e != -ENOENT for e in errs.values()):
                return -EAGAIN
            create = oi is None
            if create and (value is None or not create_missing):
                return -ENOENT  # rmxattr / no-create on a missing object
            if not create:
                newest = tuple(Eversion.from_list(oi["version"]).to_list())
                present = [
                    (s, o) for s, o in present if vers.get(s) == newest
                ]
                if len(present) < max(pool.min_size, k):
                    return -EAGAIN
            # clone-on-first-write-after-snap applies to metadata too;
            # a recreate-after-delete adopts the snapdir's SnapSet like
            # the data-write path does
            remove_snapdir = False
            if snapc is not None and create:
                ss, remove_snapdir = await self._ec_adopt_snapdir(
                    pg, oid, dict(present), ss
                )
                if ss is None:
                    return -EAGAIN
            clone_src = snaps_mod.plan_clone(
                ss, snapc, not create, 0 if create else int(oi["size"]), oid
            )
            version = self._next_version(pg)
            prior = (
                Eversion() if create else Eversion.from_list(oi["version"])
            )
            oi_b = json.dumps(
                {
                    "size": 0 if create else int(oi["size"]),
                    "version": version.to_list(),
                }
            ).encode()
            sname = stash_name(oid, version)
            entry = PGLogEntry("modify", oid, version, prior, stash=sname)
            skey = key if raw_key else self.USER_XATTR_PREFIX + key
            hinfo_b = None
            if create:
                # setxattr creates missing objects (reference semantics);
                # a fresh empty crc table keeps scrub quiet
                _codec, sinfo = self._pool_codec(pool)
                hinfo_b = json.dumps(
                    StripeHashes(km, sinfo.chunk_size).to_dict()
                ).encode()

            def build_txn(shard: int) -> Transaction:
                cid = self._shard_cid(pg, shard)
                soid = ObjectId(oid, shard)
                txn = (
                    Transaction()
                    .create_collection(cid)
                    .try_stash(cid, soid, ObjectId(sname, shard))
                )
                if clone_src is not None:
                    txn.try_stash(cid, soid, ObjectId(clone_src, shard))
                if remove_snapdir:
                    txn.remove(
                        cid, ObjectId(snaps_mod.snapdir_name(oid), shard)
                    )
                if value is None:
                    txn.rmattr(cid, soid, skey)
                else:
                    txn.setattr(cid, soid, skey, value)
                txn.setattr(cid, soid, OI_KEY, oi_b)
                if not ss.empty() and skey != snaps_mod.SS_KEY:
                    txn.setattr(cid, soid, snaps_mod.SS_KEY, ss.to_json())
                if hinfo_b is not None:
                    txn.setattr(cid, soid, StripeHashes.XATTR_KEY, hinfo_b)
                return txn

            return await self._ec_fan_out(
                pg, present, build_txn, [entry], version
            )

    async def _ec_getxattrs(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str
    ) -> tuple[int, dict[str, bytes]]:
        """User xattrs from the newest-version shard."""
        codec, _si = self._pool_codec(pool)
        km = codec.get_chunk_count()
        available = {
            s: o for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE
        }
        _d, attrs, errs = await self._read_shards(
            pg, oid, available, want_data=False
        )
        best: dict | None = None
        newest = (0, 0)
        for s, a in attrs.items():
            raw = a.get(OI_KEY)
            if raw is None:
                continue
            v = tuple(json.loads(raw).get("version", [0, 0]))
            if v >= newest:
                newest = v
                best = a
        if best is None:
            if any(e != -ENOENT for e in errs.values()):
                return -EIO, {}
            return -ENOENT, {}
        plen = len(self.USER_XATTR_PREFIX)
        return 0, {
            k[plen:]: v.encode("latin-1") for k, v in best.items()
            if k.startswith(self.USER_XATTR_PREFIX)
        }

    # -- EC mutation pipeline (RMW) -------------------------------------------

    async def _ec_mutate(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        opname: str, op: dict, data: bytes,
        snapc: "snaps_mod.SnapContext | None" = None,
        attr_ops: dict[str, bytes | None] | None = None,
    ) -> int:
        """One EC object mutation, extent-pipelined.

        Same-object RMWs whose stripe extents are DISJOINT now overlap
        their expensive phases — the old-stripe shard reads and the
        encode — exactly like the reference's in-flight extent cache
        lets concurrent writes through the waiting_reads stage
        (reference:src/osd/ExtentCache.h:1, ECBackend.h:549-551).
        Overlapping extents (and every size-changing / snap-mutating /
        attr-carrying op) chain: the later op waits for the in-flight
        conflicts and re-plans against the post-commit state.

        The COMMIT phase stays serialized per object family: versions
        are assigned and sub-writes sent under the family lock, so
        per-connection FIFO delivery makes shard apply order equal
        version order (OI/hinfo last-write = newest), and the sub-op
        re-send rounds stay safe (no later version can interleave with
        a retry).  A per-family projected StripeHashes carries the crc
        table across pipelined commits so each hinfo includes every
        previously committed stripe.
        """
        key = (str(pg), snaps_mod.clone_parent(oid))
        ext = self._extent_locks
        rec = None
        try:
            while True:
                async with self.obj_lock(pg, oid):
                    prep = await self._ec_mutate_prepare(
                        pg, pool, acting, oid, opname, op, data, snapc,
                        attr_ops,
                    )
                    if isinstance(prep, int):
                        return prep
                    ranges = (
                        prep["ranges"] if prep["fast"]
                        else ec_transaction.ExtentLocks.FULL
                    )
                    if rec is not None and rec.active and (
                        rec.ranges == ranges
                        or rec.ranges == ec_transaction.ExtentLocks.FULL
                    ):
                        pass  # reservation still covers the fresh plan
                    else:
                        if rec is not None:
                            # the plan changed while we waited (another
                            # op resized/rewrote): trade the stale
                            # reservation for one matching the new plan
                            ext.release(key, rec.token)
                        rec = ext.enqueue(key, ranges)
                    if rec.active:
                        if not prep["fast"]:
                            # exclusive op: run inline under the family
                            # lock (the pre-r4 serialized model)
                            try:
                                return await self._ec_mutate_execute(
                                    pg, pool, acting, oid, prep,
                                    locked=True,
                                )
                            finally:
                                ext.release(key, rec.token)
                                rec = None
                                self._ec_hash_proj.pop(key, None)
                        break  # fast path continues outside the lock
                # FIFO wait: our queued record blocks later-arriving
                # conflicts, so a stream of fast writes cannot starve us
                await rec.event.wait()
                # woken with extents (tentatively) held: re-plan against
                # the post-conflict object state and re-validate
            try:
                return await self._ec_mutate_execute(
                    pg, pool, acting, oid, prep, locked=False
                )
            finally:
                ext.release(key, rec.token)
                rec = None
                if not ext.busy(key):
                    self._ec_hash_proj.pop(key, None)
        finally:
            if rec is not None:  # cancelled/raised while queued
                ext.release(key, rec.token)

    async def _ec_mutate_prepare(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        opname: str, op: dict, data: bytes,
        snapc: "snaps_mod.SnapContext | None" = None,
        attr_ops: dict[str, bytes | None] | None = None,
    ) -> "int | dict":
        """Phase 1 (under the family lock): read shard meta, plan the
        stripe-aligned RMW (ECTransaction::get_write_plan analog), and
        classify fast (interior write, extent-lockable) vs exclusive."""
        codec, sinfo = self._pool_codec(pool)
        k, km = codec.get_data_chunk_count(), codec.get_chunk_count()
        present = [
            (s, o) for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE
        ]
        if len(present) < max(pool.min_size, k):
            return -EAGAIN  # degraded below min_size: cannot accept writes
        available = dict(present)
        oi, hashes, vers, meta_errs, ss = await self._ec_meta(pg, oid, available)
        if any(e != -ENOENT for e in meta_errs.values()):
            # a shard's state is UNKNOWN (not merely absent): planning a
            # partial write against a possibly-stale oi could silently
            # truncate or fork the object — back off and let the client
            # retry once the map/peers settle
            return -EAGAIN
        old_size = int(oi["size"]) if oi else 0
        prior = Eversion.from_list(oi["version"]) if oi else Eversion()
        # snapshots (reference:PrimaryLogPG.cc make_writeable): first
        # write after a snap clones the pre-write object; a recreate
        # after delete-with-clones adopts the SnapSet parked on snapdir
        remove_snapdir = False
        if snapc is not None and oi is None:
            ss, remove_snapdir = await self._ec_adopt_snapdir(
                pg, oid, available, ss
            )
            if ss is None:
                return -EAGAIN
        clone_src = snaps_mod.plan_clone(
            ss, snapc, oi is not None, old_size, oid
        )
        if oi is not None and opname != "writefull":
            # partial ops must only stamp shards that are up to date: a
            # stale/rejoined shard stamped with the new version+crc table
            # would pass version checks while holding old bytes in its
            # untouched stripes, becoming invisible to recovery (the
            # reference routes writes around 'missing' shards and lets
            # recovery push them forward, reference:src/osd/ECBackend.cc
            # recovery path). Stale shards keep their old version here, so
            # version-based repair still finds them.
            newest = tuple(prior.to_list())
            present = [(s, o) for s, o in present if vers.get(s) == newest]
            if len(present) < max(pool.min_size, k):
                return -EAGAIN

        if opname == "writefull":
            offset = 0
            plan = ec_transaction.plan_write_full(sinfo, old_size, len(data))
        elif opname == "write":
            offset = int(op.get("offset", 0))
            plan = ec_transaction.plan_write(sinfo, old_size, offset, len(data))
        elif opname == "append":
            offset = old_size
            plan = ec_transaction.plan_append(sinfo, old_size, len(data))
        elif opname == "zero":
            offset = int(op.get("offset", 0))
            length = int(op.get("length", 0))
            data = b"\x00" * length
            plan = ec_transaction.plan_write(sinfo, old_size, offset, length)
        elif opname == "truncate":
            size = int(op.get("size", op.get("offset", 0)))
            plan = ec_transaction.plan_truncate(sinfo, old_size, size)
            offset = plan.will_write[0]
            data = b""
        else:
            return -EINVAL

        # fast-path eligibility: an interior overwrite that changes no
        # object-level state beyond its own stripes may pipeline behind
        # the extent table; everything else is exclusive
        fast = (
            opname in ("write", "zero")
            and oi is not None
            and clone_src is None
            and not remove_snapdir
            and plan.shard_truncate is None
            and plan.new_size == old_size
            and not attr_ops
            and hashes is not None
            and hashes.chunk_size == sinfo.chunk_size
            and plan.will_write[1] > 0
        )
        return {
            "fast": fast,
            "ranges": tuple(plan.to_read) + (plan.will_write,),
            "hash_gen": self._ec_hash_gen.get(
                (str(pg), snaps_mod.clone_parent(oid)), 0
            ),
            "codec": codec, "sinfo": sinfo, "km": km,
            "present": present, "oi": oi, "hashes": hashes, "ss": ss,
            "old_size": old_size, "prior": prior,
            "remove_snapdir": remove_snapdir, "clone_src": clone_src,
            "plan": plan, "offset": offset, "data": data,
            "opname": opname, "attr_ops": attr_ops,
        }

    # -- EC math routing: the dispatcher, the mesh and the inline path -------
    @contextlib.contextmanager
    def _ec_timed(self, op: str, nbytes: int, mesh: bool,
                  account: bool = True):
        """Shared kernel-boundary instrumentation for the encode/decode
        routers: one trace span + wall-time avg + per-engine GB/s gauge
        — one definition so the two paths cannot drift.
        ``account=False`` on the dispatcher route: the op-level wall
        time there includes queue wait plus the whole shared batch, so
        feeding it to the device-wall-time avg/histogram/gauge would
        inflate every one of them by the coalescing window (and N-fold
        for the batch) — the dispatcher records those from its own
        per-launch time instead; only the trace span (genuinely per-op)
        remains here."""
        pec = self.perf.get("ec")
        t0 = time.perf_counter()
        with _trace_ec.span(f"ec_{op}", nbytes=nbytes,
                            engine="mesh" if mesh else "host"):
            yield
        if not account:
            return
        ec_util.account_ec_call(pec, op, nbytes,
                                time.perf_counter() - t0, mesh=mesh)

    async def _ec_encode_bufs(self, sinfo, codec, buf, *,
                              klass: str = "client",
                              ) -> dict[int, np.ndarray]:
        """Encode router: with ``osd_ec_dispatch`` on, everything goes
        through the cross-op microbatch dispatcher (coalesced launches
        in a worker thread, so heartbeat/messenger/op-tracker tasks are
        never frozen behind a device call) — with ``osd_ec_mesh`` also
        on, matrix codecs take its MESH LANE.  Dispatcher off keeps the
        direct routes (mesh per-op, else inline ``ec_util``).  Bytes are
        identical on every route (pinned by
        tests/test_torch_ec_dispatch.py and
        tests/test_torch_mesh_datapath.py)."""
        dispatched = self.ec_dispatch is not None
        mesh = (
            self.ec_dispatch.mesh_route(sinfo, codec) if dispatched
            else self.ec_mesh is not None and self.ec_mesh.supports(codec)
        )
        with self._ec_timed("encode", len(buf), mesh,
                            account=not dispatched):
            if dispatched:
                return await self.ec_dispatch.encode(
                    sinfo, codec, buf, klass=klass
                )
            if mesh:
                self.perf.get("ec").inc("mesh_encode_calls")
                return self.ec_mesh.encode(sinfo, codec, buf)
            return ec_util.encode(sinfo, codec, buf)

    async def _ec_decode_concat(self, sinfo, codec, chunks, *,
                                klass: str = "client",
                                locality: "list[str] | None" = None,
                                ) -> bytes:
        """Reconstruct router: missing rows rebuilt by the mesh's
        gathered reconstruct when the engine applies; decodes ride the
        microbatch dispatcher like encodes.  ``locality`` carries the
        surviving shards' OSD locality labels (crush host names) so the
        accel router can prefer the accelerator co-located with the
        survivor bytes."""
        k = codec.get_data_chunk_count()
        missing = any(r not in chunks for r in range(k))
        dispatched = self.ec_dispatch is not None
        mesh = (
            self.ec_dispatch.mesh_route(sinfo, codec, missing=missing)
            if dispatched
            else (self.ec_mesh is not None
                  and self.ec_mesh.supports(codec)
                  and missing)
        )
        nbytes = sum(int(c.size) for c in chunks.values())
        with self._ec_timed("decode", nbytes, mesh,
                            account=not dispatched):
            if dispatched:
                return await self.ec_dispatch.decode_concat(
                    sinfo, codec, chunks, klass=klass,
                    locality=locality,
                )
            if mesh:
                self.perf.get("ec").inc("mesh_decode_calls")
                return self.ec_mesh.decode_concat(sinfo, codec, chunks)
            return ec_util.decode_concat(sinfo, codec, chunks)

    async def _ec_mutate_execute(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        prep: dict, locked: bool,
    ) -> int:
        """Phases 2+3: read+decode the partially-covered old stripes,
        re-encode the will_write extent in ONE batched device call, then
        commit (stash+write fan-out, all-present ack, trim watermark).
        ``locked=True`` means the caller holds the family lock for the
        whole call (exclusive ops); fast-path ops run the reads/encode
        unlocked and re-take the lock only for the commit.

        Rollback safety: every shard transaction stashes the pre-write
        object (``try_stash``, stash-if-absent) so an interrupted
        fan-out leaves the old version restorable; recovery rolls back
        any version that fewer than k shards committed (the pg-log
        rollback design, reference:doc/dev/osd_internals/erasure_coding/
        ecbackend.rst)."""
        codec, sinfo = prep["codec"], prep["sinfo"]
        km, plan = prep["km"], prep["plan"]
        present, hashes, ss = prep["present"], prep["hashes"], prep["ss"]
        offset, data, opname = prep["offset"], prep["data"], prep["opname"]
        clone_src = prep["clone_src"]
        remove_snapdir = prep["remove_snapdir"]
        attr_ops = prep["attr_ops"]

        # fetch + decode the partially-covered old stripes (≤ 2 extents)
        old_exts: dict[int, bytes] = {}
        for eoff, elen in plan.to_read:
            r, old = await self._ec_read(pg, pool, acting, oid, eoff, elen)
            if r < 0 and r != -ENOENT:
                return r
            old_exts[eoff] = old

        # re-encode the will_write extent: one batched device call
        shard_bufs = None
        c_off = 0
        if plan.will_write[1] > 0:
            buf = ec_transaction.merge_extents(plan, sinfo, old_exts, offset, data)
            shard_bufs = await self._ec_encode_bufs(sinfo, codec, buf)
            c_off = sinfo.aligned_logical_offset_to_chunk_offset(plan.will_write[0])
            pec = self.perf.get("ec")
            pec.inc("encode_calls")
            pec.inc("encode_bytes", len(buf))

        if locked:
            return await self._ec_commit(
                pg, oid, prep, shard_bufs, c_off, hashes
            )
        key = (str(pg), snaps_mod.clone_parent(oid))
        async with self.obj_lock(pg, oid):
            # pipelined commit: start from the PROJECTED crc table so
            # this hinfo includes every stripe committed while our reads
            # were in flight (the reference keeps the same projection as
            # its unstable hash_infos)
            proj = self._ec_hash_proj.get(key)
            if proj is None and (
                self._ec_hash_gen.get(key, 0) != prep["hash_gen"]
            ):
                # a concurrent commit FAILED since our prepare: shard
                # crc state is unknown and our prepare-time snapshot is
                # stale — make the client retry so prepare re-reads the
                # authoritative table
                return -EAGAIN
            return await self._ec_commit(
                pg, oid, prep, shard_bufs, c_off,
                proj if proj is not None else hashes,
            )

    async def _ec_commit(
        self, pg: PGid, oid: str, prep: dict, shard_bufs, c_off: int,
        hashes,
    ) -> int:
        """Version assignment + hinfo + per-shard txn fan-out.  Runs
        under the family lock (held by caller or taken in execute), so
        versions are assigned in send order per shard connection."""
        sinfo, km, plan = prep["sinfo"], prep["km"], prep["plan"]
        present, ss = prep["present"], prep["ss"]
        opname, prior = prep["opname"], prep["prior"]
        clone_src = prep["clone_src"]
        remove_snapdir = prep["remove_snapdir"]
        attr_ops = prep["attr_ops"]
        key = (str(pg), snaps_mod.clone_parent(oid))

        # per-stripe crc table + object info (overwrite-safe HashInfo);
        # work on a COPY so a failed fan-out cannot poison the projection
        if opname == "writefull" or hashes is None or (
            hashes.chunk_size != sinfo.chunk_size
        ):
            hashes = StripeHashes(km, sinfo.chunk_size)
        else:
            hashes = StripeHashes.from_dict(hashes.to_dict())
        if shard_bufs is not None:
            hashes.set_range(plan.will_write[0] // sinfo.stripe_width, shard_bufs)
        hashes.truncate_stripes(
            sinfo.logical_to_next_stripe_offset(plan.new_size) // sinfo.stripe_width
        )
        hinfo_b = json.dumps(hashes.to_dict()).encode()

        version = self._next_version(pg)
        oi_b = json.dumps(
            {"size": plan.new_size, "version": version.to_list()}
        ).encode()
        sname = stash_name(oid, version)
        entry = PGLogEntry("modify", oid, version, prior, stash=sname)

        def build_txn(shard: int) -> Transaction:
            cid = self._shard_cid(pg, shard)
            soid = ObjectId(oid, shard)
            txn = (
                Transaction()
                .create_collection(cid)
                .try_stash(cid, soid, ObjectId(sname, shard))
            )
            if clone_src is not None:
                # preserve the pre-write shard for snap reads (the copy
                # carries the old OI + crc table, so the clone is
                # readable/scrubable like any object); try_stash = clone
                # iff present, so a stale shard missing the head object
                # doesn't fail the whole sub-write
                txn.try_stash(cid, soid, ObjectId(clone_src, shard))
            if remove_snapdir:
                txn.remove(cid, ObjectId(snaps_mod.snapdir_name(oid), shard))
            if plan.shard_truncate is not None:
                txn.truncate(cid, soid, plan.shard_truncate)
            if shard_bufs is not None:
                txn.write(cid, soid, c_off, shard_bufs[shard].tobytes())
            txn.setattr(cid, soid, StripeHashes.XATTR_KEY, hinfo_b)
            txn.setattr(cid, soid, OI_KEY, oi_b)
            if not ss.empty():
                txn.setattr(cid, soid, snaps_mod.SS_KEY, ss.to_json())
            for ak, av in (attr_ops or {}).items():
                pak = self.USER_XATTR_PREFIX + ak
                if av is None:
                    txn.rmattr(cid, soid, pak)
                else:
                    txn.setattr(cid, soid, pak, av)
            return txn

        r = await self._ec_fan_out(pg, present, build_txn, [entry], version)
        if r == 0:
            self._ec_hash_proj[key] = hashes
        else:
            # unknown shard state: force the next op to re-read the
            # authoritative crc table instead of trusting the
            # projection, and bump the generation so an in-flight
            # concurrent op notices its prepare-time snapshot is stale
            self._ec_hash_proj.pop(key, None)
            self._ec_hash_gen[key] = self._ec_hash_gen.get(key, 0) + 1
        return r

    async def _gather_subops(self, waiter: "_Waiter", send_round,
                             keys: list) -> None:
        """Fan out sub-ops and gather acks, RE-SENDING keys lost to
        transient failures (severed sockets, dropped replies) up to
        osd_subop_retries extra rounds.  Safe because sub-op
        transactions are idempotent (absolute-offset writes + keyed log
        entries) and the caller holds the lock that serializes
        same-object mutations — the role of the reference messenger's
        reconnect/replay semantics
        (reference:src/msg/async/AsyncConnection.cc replay on reconnect,
        exercised by the msgr-failures thrash matrix).  ESTALE results
        (a demoted primary) are definitive and never retried."""
        attempts = 1 + max(
            0, int(getattr(self.config, "osd_subop_retries", 2))
        )
        targets = list(keys)
        for attempt in range(attempts):
            await send_round(targets)
            try:
                async with asyncio.timeout(self.subop_timeout):
                    await waiter.event.wait()
            except TimeoutError:
                pass
            retry = sorted(
                set(waiter.pending)
                | {k for k, r in waiter.results.items()
                   if r in (-EIO, -ENOTCONN)}
            )
            if not retry or attempt == attempts - 1:
                return
            logger.info(
                "%s: re-sending %d sub-op(s) after transient loss: %s",
                self.name, len(retry), retry,
            )
            for k in retry:
                waiter.results.pop(k, None)
                waiter.pending.add(k)
            waiter.event.clear()
            targets = retry

    async def _ec_fan_out(
        self, pg: PGid, present: list[tuple[int, int]], build_txn,
        entries: list[PGLogEntry], version: Eversion,
    ) -> int:
        """The EC sub-write commit protocol shared by every versioned EC
        mutation (writes, deletes, xattr updates): per-shard txn fan-out,
        all-present ack gathering, ESTALE->EAGAIN folding, roll-forward
        watermark advance on success (reference:src/osd/ECBackend.cc:1389
        submit_transaction -> :1946 try_finish_rmw)."""
        tid = self._new_tid()
        by_shard = dict(present)
        waiter = _Waiter({s for s, _ in present}, by_shard)
        self._write_waiters[tid] = waiter
        # register as in-flight BEFORE any sub-write leaves: with
        # pipelined per-object commits, the roll-forward watermark must
        # never pass a version whose fan-out could still fail and need
        # its rollback stashes (see _mark_committed)
        inflight = self._pg_inflight.setdefault(str(pg), set())
        inflight.add(version)

        async def send_round(shards):
            for shard in shards:
                await self._send_sub_write(
                    tid, pg, shard, by_shard[shard], build_txn(shard),
                    entries,
                )

        try:
            await self._gather_subops(
                waiter, send_round, [s for s, _ in present]
            )
        finally:
            del self._write_waiters[tid]
            inflight.discard(version)
        if waiter.pending:
            logger.warning("%s: ec commit tid=%d timed out on %s",
                           self.name, tid, waiter.pending)
            return -EIO
        if any(r != 0 for r in waiter.results.values()):
            if any(r == -ESTALE for r in waiter.results.values()):
                return -EAGAIN  # demoted primary; client re-targets
            if any(r == -ENOTCONN for r in waiter.results.values()):
                # a member died faster than the map: the client waits
                # out the markdown and retries degraded — never EIO
                return -EAGAIN
            return -EIO
        self._mark_committed(pg, version, present)
        return 0

    # -- snap trimming --------------------------------------------------------

    async def _snap_trim_pool(self, pool: Pool) -> None:
        """Delete clones whose snaps were all removed and scrub the
        removed ids out of every SnapSet (the SnapTrimmer,
        reference:src/osd/PrimaryLogPG.cc TrimmingObjects/snap_trimmer)."""
        from .scheduler import QosDeferred

        removed = set(pool.removed_snaps)
        complete = True
        try:
            for pg in self.osdmap.pgs_of_pool(pool.id):
                _u, _up, acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
                if primary != self.osd_id:
                    continue
                # QoS grant per PG trim pass (the reference's snap-trim
                # entries in the op queue): a shed pass is retried on
                # the next map kick, never queued unbounded
                try:
                    async with self.scheduler.grant("snaptrim"):
                        if pool.type == POOL_TYPE_ERASURE:
                            ok = await self._snap_trim_pg_ec(
                                pg, pool, acting, removed
                            )
                        else:
                            ok = await self._snap_trim_pg_rep(
                                pg, pool, acting, removed
                            )
                except QosDeferred:
                    ok = False
                complete = complete and ok
        except asyncio.CancelledError:
            raise
        except Exception:
            complete = False
            logger.exception("%s: snap trim of pool %s failed",
                             self.name, pool.name)
        finally:
            self._trimming.discard(pool.id)
        if complete:
            self._trimmed_snaps[pool.id] = removed
            # snaps removed while this pass ran were not in its capture:
            # re-kick so they aren't stranded until an unrelated map event
            cur = self.osdmap.pools.get(pool.id) if self.osdmap else None
            if cur is not None and set(cur.removed_snaps) != removed:
                self._kick_snap_trim()

    def _trim_scan_heads(self, cid: CollectionId) -> list[str]:
        """Head/snapdir names with snapshot state in a local collection."""
        heads: set[str] = set()
        try:
            names = self.store.list_objects(cid)
        except KeyError:
            return []
        for o in names:
            n = o.name
            if n == "_pgmeta_" or is_stash_name(n):
                continue
            if snaps_mod.is_clone_name(n):
                heads.add(snaps_mod.clone_parent(n))
        return sorted(heads)

    async def _snap_trim_pg_rep(
        self, pg: PGid, pool: Pool, acting: list[int], removed: set[int]
    ) -> bool:
        ok = True
        cid = CollectionId(str(pg))
        for head in self._trim_scan_heads(cid):
            async with self.pg_lock(pg):  # plan+commit atomically per head
                head_exists, ss, from_sdir = self._rep_snapset(cid, head)
                dead = ss.trim(removed)
                if not dead:
                    continue
                txn = Transaction().create_collection(cid)
                for d in dead:
                    txn.remove(cid, ObjectId(snaps_mod.clone_name(head, d)))
                carrier = (
                    snaps_mod.snapdir_name(head) if from_sdir else head
                )
                log_op = "modify"
                if not ss.clones and from_sdir:
                    txn.remove(cid, ObjectId(carrier))  # nothing left
                    log_op = "delete"
                else:
                    # the seq must survive even with zero clones, so reads
                    # at trimmed snaps resolve MISSING rather than head
                    txn.setattr(
                        cid, ObjectId(carrier), snaps_mod.SS_KEY,
                        ss.to_json()
                    )
                try:
                    size = self.store.stat(cid, ObjectId(carrier))
                except KeyError:
                    size = 0
                r = await self._rep_commit_locked(
                    pg, acting, txn, carrier, log_op, size
                )
            ok = ok and r == 0
        return ok

    async def _snap_trim_pg_ec(
        self, pg: PGid, pool: Pool, acting: list[int], removed: set[int]
    ) -> bool:
        ok = True
        shard = next(
            (s for s, o in enumerate(acting) if o == self.osd_id), 0
        )
        cid = self._shard_cid(pg, shard)
        for head in self._trim_scan_heads(cid):
            r, head_exists, ss = await self._ec_snapset(
                pg, pool, acting, head
            )
            if r < 0:
                ok = False  # degraded/raced: retried on the next map kick
                continue
            dead = ss.trim(removed)
            if not dead:
                continue
            for d in dead:
                r = await self._ec_delete(
                    pg, pool, acting, snaps_mod.clone_name(head, d)
                )
                ok = ok and r in (0, -ENOENT)
            carrier = head if head_exists else snaps_mod.snapdir_name(head)
            if ss.clones or head_exists:
                # NEVER create: head_exists is a pre-lock snapshot, and a
                # racing client delete must not be undone by the trimmer
                # recreating the head as an empty object (thrash finding)
                r = await self._ec_setxattr(
                    pg, pool, acting, carrier, snaps_mod.SS_KEY,
                    ss.to_json() if not ss.empty() else None,
                    raw_key=True, create_missing=False,
                )
            else:
                r = await self._ec_delete(pg, pool, acting, carrier)
            ok = ok and r in (0, -ENOENT)
        return ok

    # -- EC snapshots ---------------------------------------------------------

    async def _ec_adopt_snapdir(
        self, pg: PGid, oid: str, available: dict[int, int],
        ss: "snaps_mod.SnapSet",
    ) -> tuple["snaps_mod.SnapSet | None", bool]:
        """Recreate-after-delete: pick up the SnapSet parked on the
        snapdir.  Returns (snapset or None on -EAGAIN, remove_snapdir)."""
        sd_oi, _h, _v, sd_errs, sd_ss = await self._ec_meta(
            pg, snaps_mod.snapdir_name(oid), dict(available)
        )
        if any(e != -ENOENT for e in sd_errs.values()):
            return None, False
        if sd_oi is not None:
            return sd_ss, True
        return ss, False

    async def _ec_snapset(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str
    ) -> tuple[int, bool, "snaps_mod.SnapSet"]:
        """(errno, head_exists, snapset) — falls back to the snapdir when
        the head is deleted (reference:PrimaryLogPG.cc find_object_context)."""
        codec, _si = self._pool_codec(pool)
        km = codec.get_chunk_count()
        available = {
            s: o for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE
        }
        if not available:
            return -EAGAIN, False, snaps_mod.SnapSet()
        oi, _h, _v, errs, ss = await self._ec_meta(pg, oid, available)
        if any(e != -ENOENT for e in errs.values()):
            return -EAGAIN, False, ss
        if oi is not None:
            return 0, True, ss
        sd_oi, _h2, _v2, sd_errs, sd_ss = await self._ec_meta(
            pg, snaps_mod.snapdir_name(oid), available
        )
        if any(e != -ENOENT for e in sd_errs.values()):
            return -EAGAIN, False, ss
        if sd_oi is None:
            return -ENOENT, False, snaps_mod.SnapSet()
        return 0, False, sd_ss

    async def _ec_resolve_snap(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str, snapid: int
    ) -> tuple[int, str]:
        """Map (oid, snapid) -> the object actually serving that snap."""
        r, head_exists, ss = await self._ec_snapset(pg, pool, acting, oid)
        if r < 0:
            return r, oid
        res = ss.resolve(snapid)
        if res == snaps_mod.SnapSet.HEAD:
            return (0, oid) if head_exists else (-ENOENT, oid)
        if res == snaps_mod.SnapSet.MISSING:
            return -ENOENT, oid
        return 0, snaps_mod.clone_name(oid, res)

    async def _ec_list_snaps(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str
    ) -> tuple[int, dict]:
        r, head_exists, ss = await self._ec_snapset(pg, pool, acting, oid)
        if r < 0:
            return r, {}
        return 0, {
            "seq": ss.seq,
            "head_exists": head_exists,
            "clones": [
                {"cloneid": c.cloneid, "snaps": c.snaps, "size": c.size}
                for c in ss.clones
            ],
        }

    async def _ec_rollback(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        snapid: int, snapc: "snaps_mod.SnapContext | None",
    ) -> int:
        """Restore the head to its state at ``snapid``
        (reference:PrimaryLogPG.cc _rollback_to): resolves the serving
        clone and rewrites the head from it (itself snap-aware, so a
        snap taken since the last write still gets its clone); rollback
        to a snap where the object did not exist deletes the head."""
        r, src = await self._ec_resolve_snap(pg, pool, acting, oid, snapid)
        if r == -ENOENT:
            rr, head_exists, _ss = await self._ec_snapset(
                pg, pool, acting, oid
            )
            if rr == -EAGAIN:
                return rr
            if rr == 0 and head_exists:
                return await self._ec_delete(pg, pool, acting, oid, snapc)
            return -ENOENT
        if r < 0:
            return r
        if src == oid:
            return 0  # head already serves that snap
        r, data = await self._ec_read(pg, pool, acting, src)
        if r < 0:
            return r
        # restore the clone's user xattrs and drop head-only ones, like
        # the replicated rollback (reference _rollback_to copies attrs)
        rc, clone_attrs = await self._ec_getxattrs(pg, pool, acting, src)
        if rc < 0:
            return rc
        rh, head_attrs = await self._ec_getxattrs(pg, pool, acting, oid)
        if rh not in (0, -ENOENT):
            return rh
        attr_ops: dict[str, bytes | None] = {
            k: None for k in head_attrs if k not in clone_attrs
        }
        attr_ops.update(clone_attrs)
        return await self._ec_mutate(
            pg, pool, acting, oid, "writefull", {}, data, snapc, attr_ops
        )

    async def _ec_delete(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        snapc: "snaps_mod.SnapContext | None" = None,
    ) -> int:
        async with self.ec_exclusive(pg, oid):
            return await self._ec_delete_locked(pg, pool, acting, oid, snapc)

    async def _ec_delete_locked(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        snapc: "snaps_mod.SnapContext | None" = None,
    ) -> int:
        codec, _ = self._pool_codec(pool)
        km = codec.get_chunk_count()
        present = [
            (s, o) for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE
        ]
        if not present:
            return -EAGAIN
        # a delete preserves the pre-delete object when the snap context
        # demands it, and ALWAYS parks a surviving SnapSet on the snapdir
        # — even snapc-less deletes (a self-managed-snap client's pool
        # context is empty) must not orphan existing clones
        # (reference:PrimaryLogPG.cc make_writeable delete branch +
        # get_snapdir)
        oi, _h, _v, errs, ss = await self._ec_meta(pg, oid, dict(present))
        if any(e != -ENOENT for e in errs.values()):
            return -EAGAIN
        clone_src = snaps_mod.plan_clone(
            ss, snapc, oi is not None,
            0 if oi is None else int(oi["size"]), oid,
        )
        write_snapdir = bool(ss.clones)
        version = self._next_version(pg)
        sname = stash_name(oid, version)
        entry = PGLogEntry("delete", oid, version, Eversion(), stash=sname)
        sdir = snaps_mod.snapdir_name(oid)
        sd_oi = json.dumps(
            {"size": 0, "version": version.to_list()}
        ).encode()
        # an empty crc table keeps scrub quiet on the zero-length snapdir
        _codec2, sinfo = self._pool_codec(pool)
        sd_hinfo = json.dumps(
            StripeHashes(km, sinfo.chunk_size).to_dict()
        ).encode()

        def build_txn(shard: int) -> Transaction:
            cid = self._shard_cid(pg, shard)
            soid = ObjectId(oid, shard)
            txn = (
                Transaction()
                .create_collection(cid)
                .try_stash(cid, soid, ObjectId(sname, shard))
            )
            if clone_src is not None:
                txn.try_stash(cid, soid, ObjectId(clone_src, shard))
            txn.remove(cid, soid)
            sdoid = ObjectId(sdir, shard)
            if write_snapdir:
                txn.touch(cid, sdoid)
                txn.setattr(cid, sdoid, OI_KEY, sd_oi)
                txn.setattr(cid, sdoid, StripeHashes.XATTR_KEY, sd_hinfo)
                txn.setattr(cid, sdoid, snaps_mod.SS_KEY, ss.to_json())
            else:
                txn.remove(cid, sdoid)  # no clones left: no snapdir
            return txn

        return await self._ec_fan_out(pg, present, build_txn, [entry], version)

    # -- commit watermark / stash trim ----------------------------------------

    def _mark_committed(
        self, pg: PGid, version: Eversion, present: list[tuple[int, int]]
    ) -> None:
        """All present shards committed ``version``: advance the PG's
        roll-forward watermark and eagerly tell shards to drop rollback
        stashes ≤ it (the reference's roll_forward_to,
        reference:src/osd/ECBackend.cc:1389 submit_transaction). The next
        sub-op piggybacks the watermark anyway, so a lost trim only
        delays space reclaim.

        With pipelined per-object commits the watermark is capped just
        BELOW the oldest still-in-flight version: op B (v6) completing
        while op A (v5) is still fanning out must not trim A's rollback
        stashes — if A then fails partially, shards that applied v5
        would have overwritten their old chunks with the stash gone,
        leaving no restorable version (the reference's roll_forward_to
        has the same min-in-flight bound via its ordered waiting_commit
        list)."""
        key = str(pg)
        high = self._pg_commit_high.get(key, Eversion())
        if high < version:
            self._pg_commit_high[key] = high = version
        inflight = self._pg_inflight.get(key)
        if inflight:
            m = min(inflight)
            # largest safe trim point strictly below every in-flight
            # entry (the exact predecessor need not exist; trimming is
            # comparison-based)
            cap = Eversion(m.epoch, m.version - 1)
            wm = min(high, cap)
        else:
            wm = high
        if self._pg_committed.get(key, Eversion()) < wm:
            self._pg_committed[key] = wm
        for shard, osd in present:
            t = asyncio.ensure_future(self._send_trim(pg, shard, osd))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    async def _send_trim(self, pg: PGid, shard: int, osd: int) -> None:
        try:
            await self._send_sub_write(0, pg, shard, osd, Transaction(), [])
        except asyncio.CancelledError:
            raise
        except Exception:
            pass  # best-effort; the watermark rides the next sub-op too

    async def _send_sub_write(
        self,
        tid: int,
        pg: PGid,
        shard: int,
        osd: int,
        txn: Transaction,
        entries: list[PGLogEntry],
    ) -> None:
        trim_to = self._pg_committed.get(str(pg), Eversion())
        if tid:  # not the best-effort trim nudge (tid=0)
            from ..common.tracing import current_trace

            self.op_tracker.mark_by_trace(
                current_trace.get(), "sub_op_sent"
            )
            _trace.point("osd_sub_op_sent", osd=self.osd_id,
                         shard=shard, to_osd=osd)
        if osd == self.osd_id:
            # self-delivery (reference:ECBackend.cc:878 handle_sub_write)
            r = self._apply_sub_write(txn, str(pg), shard, entries, trim_to)
            w = self._write_waiters.get(tid)
            if w:
                w.complete(shard, r)
            return
        addr = self.osdmap.get_addr(osd)
        ops, blobs = messages.encode_txn(txn)
        try:
            conn = await self.messenger.connect(addr, f"osd.{osd}")
        except (ConnectionError, OSError):
            # peer died before the map said so: fail this shard as a
            # CONNECTION loss (the gather folds it to -EAGAIN, the
            # client retries on the post-markdown map), not the op
            w = self._write_waiters.get(tid)
            if w:
                w.complete(shard, -ENOTCONN)
            return
        conn.send(
            messages.MOSDECSubOpWrite(
                pgid=str(pg), tid=tid, from_osd=self.osd_id, shard=shard,
                txn=ops, log=[e.to_dict() for e in entries],
                at_version=entries[-1].version.to_list() if entries else None,
                trim_to=trim_to.to_list(), epoch=self._epoch(), blobs=blobs,
            )
        )

    def _apply_sub_write(
        self,
        txn: Transaction,
        pgid: str,
        shard: int,
        entries: list[PGLogEntry],
        trim_to: Eversion | None = None,
    ) -> int:
        """Append the log entries to the shard's pgmeta in the SAME
        transaction as the data, then commit — the crash-consistency
        contract (reference:ECBackend.cc:908-938 log_operation +
        queue_transactions). ``trim_to`` additionally drops rollback
        stashes for fully-committed entries."""
        cid = CollectionId(f"{pgid}s{shard}" if shard >= 0 else pgid)
        for entry in entries:
            add_log_entry_to_txn(txn, cid, shard, entry)
        if trim_to is not None and trim_to > Eversion():
            trim_stashes_to_txn(self.store, cid, shard, trim_to, txn)
        if txn.empty():
            return 0
        try:
            self.store.apply(txn)
            self.perf.get("osd").inc("subop_w")
            _trace.point("osd_sub_op_applied", osd=self.osd_id,
                         pgid=pgid, shard=shard)
            return 0
        except Exception:
            logger.exception("%s: sub-write apply failed", self.name)
            return -EIO

    def _gate_subop(self, pgid: str, epoch: int | None, from_osd: int | None) -> int:
        """Reject sub-ops from a demoted primary: a sender on an older map
        epoch is only honored if it is STILL the acting primary for the PG
        in OUR map — otherwise a stale primary racing a map change could
        clobber data written by the new one (the reference gates sub-ops
        on same-interval checks via the op epoch)."""
        if epoch is None or from_osd is None or self.osdmap is None:
            return 0  # legacy/internal senders: no gate
        if epoch >= self._epoch():
            return 0  # sender at least as current as us
        try:
            pg = PGid.parse(pgid.split("s", 1)[0])
            _up, _upp, _acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
        except Exception:
            return -ESTALE
        return 0 if from_osd == primary else -ESTALE

    def _handle_sub_write(self, conn: Connection, msg: messages.MOSDECSubOpWrite) -> None:
        r = self._gate_subop(msg.pgid, msg.epoch, msg.from_osd)
        if r == 0:
            txn = messages.decode_txn(msg.txn, msg.blobs)
            entries = [PGLogEntry.from_dict(d) for d in msg.log]
            trim_to = (
                Eversion.from_list(msg.trim_to) if msg.trim_to else None
            )
            r = self._apply_sub_write(txn, msg.pgid, msg.shard, entries, trim_to)
        conn.send(
            messages.MOSDECSubOpWriteReply(
                pgid=msg.pgid, tid=msg.tid, shard=msg.shard, result=r
            )
        )

    # -- EC read path ---------------------------------------------------------

    async def _ec_meta(
        self, pg: PGid, oid: str, available: dict[int, int]
    ) -> tuple[
        dict | None, StripeHashes | None, dict[int, tuple], dict[int, int],
        "snaps_mod.SnapSet",
    ]:
        """Newest object info + crc table from the shards' xattrs (one
        attrs-only round trip) — the planner's hash_infos input
        (reference:src/osd/ECTransaction.h:26-33 WritePlan.hash_infos).
        Returns (oi, hashes, per-shard versions, per-shard errnos,
        snapset-of-newest-shard); callers must distinguish
        absent-everywhere from unreachable via ``errs``."""
        _d, attrs, errs = await self._read_shards(
            pg, oid, dict(available), want_data=False
        )
        oi: dict | None = None
        hashes: StripeHashes | None = None
        vers: dict[int, tuple] = {}
        newest = (0, 0)
        ss_raw: bytes | None = None
        for s, a in attrs.items():
            raw = a.get(OI_KEY)
            if raw is None:
                vers[s] = (0, 0)
                continue
            o = json.loads(raw)
            v = tuple(o.get("version", [0, 0]))
            vers[s] = v
            if v >= newest:
                newest = v
                oi = o
                ss_raw = a.get(snaps_mod.SS_KEY)
                hraw = a.get(StripeHashes.XATTR_KEY)
                hashes = None
                if hraw is not None:
                    try:
                        hashes = StripeHashes.from_dict(json.loads(hraw))
                    except Exception:
                        hashes = None
        return oi, hashes, vers, errs, snaps_mod.SnapSet.from_json(ss_raw)

    async def _ec_read(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str,
        off: int = 0, length: int = -1, *, klass: str = "client",
    ) -> tuple[int, bytes]:
        """Ranged EC read: fetch only the chunk extents covering the
        requested stripes from a minimal decodable shard set, verify
        per-stripe crcs and version agreement, decode (one batched device
        call), slice (reference:src/osd/ECBackend.cc:2187
        objects_read_and_reconstruct, :1438 get_min_avail_to_read_shards,
        :941/:994-1008 handle_sub_read + crc check, :2239 retry reads)."""
        codec, sinfo = self._pool_codec(pool)
        k, km = codec.get_data_chunk_count(), codec.get_chunk_count()
        want = list(range(k))
        available = {
            s: o for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE
        }
        if length >= 0:
            s0 = sinfo.logical_to_prev_stripe_offset(off)
            s1 = sinfo.logical_to_next_stripe_offset(off + length)
            c_off = sinfo.aligned_logical_offset_to_chunk_offset(s0)
            c_len = sinfo.aligned_logical_offset_to_chunk_offset(s1) - c_off
        else:
            s0, c_off, c_len = 0, 0, -1
        first_stripe = s0 // sinfo.stripe_width
        failed: set[int] = set()
        for _attempt in range(km):  # each retry excludes newly-failed shards
            usable = [s for s in available if s not in failed]
            try:
                to_read = codec.minimum_to_decode(want, usable)
            except Exception:
                return -EIO, b""
            shard_data, shard_attrs, errs = await self._read_shards(
                pg, oid, {s: available[s] for s in to_read},
                offset=c_off, length=c_len,
            )
            failed |= set(errs)
            # crc verification (reference:ECBackend.cc:994-1008) + version
            # agreement: a rejoined shard that missed a degraded overwrite
            # passes its own (stale) crc, so shards must also agree on the
            # object version before their chunks may be mixed
            chunks: dict[int, np.ndarray] = {}
            ois: dict[int, dict] = {}
            for s, data in shard_data.items():
                attrs = shard_attrs.get(s, {})
                arr = np.frombuffer(data, dtype=np.uint8)
                hraw = attrs.get(StripeHashes.XATTR_KEY)
                if hraw is not None and arr.size:
                    ok = False
                    try:
                        sh = StripeHashes.from_dict(json.loads(hraw))
                        ok = (
                            arr.size % sinfo.chunk_size == 0
                            and sh.verify(s, first_stripe, arr)
                        )
                    except Exception:
                        ok = False
                    if not ok:
                        logger.warning(
                            "%s: shard %d of %s failed crc", self.name, s, oid
                        )
                        failed.add(s)
                        continue
                oi_raw = attrs.get(OI_KEY)
                if oi_raw is not None:
                    ois[s] = json.loads(oi_raw)
                chunks[s] = arr
            newest = max(
                (tuple(oi.get("version", [0, 0])) for oi in ois.values()),
                default=(0, 0),
            )
            size: int | None = None
            for s in list(chunks):
                oi = ois.get(s)
                ver = tuple(oi.get("version", [0, 0])) if oi else (0, 0)
                if ver < newest:
                    logger.warning(
                        "%s: shard %d of %s is stale (%s < %s)",
                        self.name, s, oid, ver, newest,
                    )
                    failed.add(s)
                    del chunks[s]
                elif oi is not None:
                    size = int(oi["size"])
            if errs and all(e == -ENOENT for e in errs.values()) and not chunks:
                return -ENOENT, b""  # object absent on every shard asked
            if set(to_read) <= set(chunks):
                if size is None:
                    size = 0
                end = size if length < 0 else min(off + length, size)
                if off >= end:
                    return 0, b""
                pec = self.perf.get("ec")
                pec.inc("decode_calls")
                pec.inc("decode_bytes", sum(c.size for c in chunks.values()))
                # the surviving shards' locality labels (the OSDs the
                # chunks were actually read from -> their crush hosts):
                # the accel router prefers the accelerator matching
                # the majority label, so reconstruct reads stop
                # shipping survivor bytes across the fabric
                locality = [
                    lbl for lbl in (
                        self.osdmap.locality_of(available[s])
                        for s in chunks if s in available
                    ) if lbl
                ]
                logical = await self._ec_decode_concat(
                    sinfo, codec, chunks, klass=klass,
                    locality=locality or None,
                )
                if off == s0 and end - s0 == len(logical):
                    return 0, logical  # aligned read: no trim slice
                # trim as a VIEW of the reassembly buffer, not a copy
                return 0, memoryview(logical)[off - s0 : end - s0]
            # else: a shard failed mid-read — loop retries with survivors
        return -EIO, b""

    async def _ec_stat(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str
    ) -> tuple[int, int]:
        """Object logical size from the newest object-info xattr."""
        codec, _ = self._pool_codec(pool)
        km = codec.get_chunk_count()
        available = {
            s: o for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE
        }
        oi, _hashes, _vers, errs, _ss = await self._ec_meta(pg, oid, available)
        if oi is None:
            if any(e != -ENOENT for e in errs.values()):
                return -EIO, 0  # unreachable shards: absence is unproven
            return -ENOENT, 0
        return 0, int(oi["size"])

    async def _read_shards(
        self,
        pg: PGid,
        oid: str,
        targets: dict[int, int],
        want_data: bool = True,
        store_shard: int | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> tuple[dict[int, bytes], dict[int, dict], dict[int, int]]:
        """Fetch shard extents (+xattrs) from `targets` {key: osd}.

        ``offset``/``length`` are in the chunk domain (length -1 = to the
        end of the shard). Keys are shard ids for EC; for replicated
        fan-out pass ``store_shard=-1`` so every member reads the
        whole-PG collection while replies still route by key.
        """
        tid = self._new_tid()
        waiter = _ReadWaiter(set(targets), dict(targets))
        self._read_waiters[tid] = waiter
        try:
            for key, osd in targets.items():
                shard = key if store_shard is None else store_shard
                if osd == self.osd_id:
                    data, attrs, err = self._local_shard_read(
                        pg, shard, oid, want_data, offset, length
                    )
                    waiter.complete(key, data, attrs, err)
                    continue
                addr = self.osdmap.get_addr(osd)
                try:
                    conn = await self.messenger.connect(addr, f"osd.{osd}")
                except (ConnectionError, OSError):
                    waiter.complete(key, None, None, -EIO)
                    continue
                conn.send(
                    messages.MOSDECSubOpRead(
                        pgid=str(pg), tid=tid, shard=key,
                        reads=[{"oid": [oid, shard], "offset": offset,
                                "length": length, "want_data": want_data}],
                        attrs=True,
                    )
                )
            try:
                async with asyncio.timeout(self.subop_timeout):
                    await waiter.event.wait()
            except TimeoutError:
                for shard in list(waiter.pending):
                    waiter.complete(shard, None, None, -EIO)
            return waiter.data, waiter.attrs, waiter.errors
        finally:
            del self._read_waiters[tid]

    def _local_shard_read(
        self, pg: PGid, shard: int, oid: str, want_data: bool = True,
        offset: int = 0, length: int = -1,
    ) -> tuple[bytes, dict, int]:
        # shard -1 = replicated whole-object read from the PG collection
        cid = self._shard_cid(pg, shard) if shard >= 0 else CollectionId(str(pg))
        soid = ObjectId(oid, shard)
        try:
            data = (
                self.store.read(cid, soid, offset, length) if want_data else b""
            )
            attrs = {
                k: v.decode("latin-1")
                for k, v in self.store.getattrs(cid, soid).items()
            }
            return data, attrs, 0
        except KeyError:
            return b"", {}, -ENOENT
        except Exception:
            logger.exception("%s: shard read failed", self.name)
            return b"", {}, -EIO

    def _handle_sub_read(self, conn: Connection, msg: messages.MOSDECSubOpRead) -> None:
        rd = msg.reads[0]
        oid, shard = rd["oid"]
        pg = PGid.parse(msg.pgid)
        data, attrs, err = self._local_shard_read(
            pg, shard, oid, rd.get("want_data", True),
            rd.get("offset", 0), rd.get("length", -1),
        )
        conn.send(
            messages.MOSDECSubOpReadReply(
                pgid=msg.pgid, tid=msg.tid, shard=msg.shard,
                reads=[{"data": 0}], attrs=attrs,
                errors=[err] if err else [], blobs=[data],
            )
        )

    # ======================= replicated backend ==============================

    # -- object classes (reference:src/osd/ClassHandler.cc + src/cls/) -------

    CLS_XATTR_PREFIX = "c_"  # cls attrs: their own namespace, like "u_"

    def _do_cls_call(
        self, cid: CollectionId, oid: ObjectId, op: dict,
        blobs: list[bytes], txn: Transaction,
    ) -> tuple[int, dict, dict]:
        """Run one cls method; its writes join ``txn`` so they commit
        (and replicate) atomically with the surrounding client op
        (reference:PrimaryLogPG.cc do_osd_ops CEPH_OSD_OP_CALL).
        Returns (rval, method output or error dict, {mutated, new_size})."""
        from .. import cls as cls_mod

        info = {"mutated": False, "new_size": None}
        try:
            kls = cls_mod.get_class(
                op.get("cls", ""),
                class_dir=self.config.get("osd_class_dir") or None,
            )
        except cls_mod.ClsLoadError as e:
            logger.error("cls load failed: %s", e)
            return -EIO, {"error": str(e)}, info
        method = kls.methods.get(op.get("method", "")) if kls else None
        if method is None:
            return -EOPNOTSUPP, {
                "error": f"no method {op.get('cls')}.{op.get('method')}"
            }, info
        input = dict(op.get("input") or {})
        if op.get("data") is not None:
            input["data"] = blobs[op["data"]]

        def _read() -> bytes | None:
            try:
                return bytes(self.store.read(cid, oid))
            except KeyError:
                return None

        def _getx(key: str) -> bytes | None:
            try:
                return self.store.getattr(
                    cid, oid, self.CLS_XATTR_PREFIX + key
                )
            except KeyError:
                return None

        def _mark() -> None:
            info["mutated"] = True

        def _setx(key: str, value: bytes) -> None:
            _mark()
            txn.touch(cid, oid)
            txn.setattr(cid, oid, self.CLS_XATTR_PREFIX + key, value)

        def _omap_get() -> dict[str, bytes]:
            try:
                return dict(self.store.omap_get(cid, oid))
            except KeyError:
                return {}

        def _omap_get_keys(keys: list[str]) -> dict[str, bytes]:
            try:
                return self.store.omap_get_keys(cid, oid, keys)
            except KeyError:
                return {}

        def _omap_get_range(
            start_after: str, prefix: str, max_entries: int
        ) -> tuple[dict[str, bytes], bool]:
            try:
                return self.store.omap_get_range(
                    cid, oid, start_after=start_after, prefix=prefix,
                    max_entries=max_entries,
                )
            except KeyError:
                return {}, False

        def _omap_set(kv: dict[str, bytes]) -> None:
            _mark()
            txn.touch(cid, oid)
            txn.omap_setkeys(cid, oid, kv)

        def _omap_rm(keys: list[str]) -> None:
            _mark()
            txn.omap_rmkeys(cid, oid, keys)

        def _write_full(data: bytes) -> None:
            _mark()
            info["new_size"] = len(data)
            txn.remove(cid, oid).write(cid, oid, 0, data)

        ctx = cls_mod.MethodContext(
            read=_read, getxattr=_getx, setxattr=_setx,
            omap_get=_omap_get, omap_get_keys=_omap_get_keys,
            omap_get_range=_omap_get_range,
            omap_set=_omap_set, omap_rm=_omap_rm,
            write_full=_write_full, writable=method.is_write,
        )
        try:
            ret = method.fn(ctx, input) or {}
        except cls_mod.ClsError as e:
            return -e.code, {"error": str(e)}, info
        except Exception as e:
            logger.exception("cls %s.%s failed", kls.name, method.name)
            return -EIO, {"error": f"cls crashed: {e}"}, info
        return 0, ret, info

    # -- watch / notify (reference:src/osd/Watch.{h,cc}) ----------------------

    async def _watch_execute(
        self, pg: PGid, pool: Pool, acting: list[int],
        msg: messages.MOSDOp, conn: Connection | None,
    ) -> tuple[int, list, list[bytes]]:
        out: list = []
        blobs: list[bytes] = []
        key = (pool.id, msg.oid)
        for op in msg.ops:
            name = op["op"]
            if name == "watch":
                r = await self._obj_exists(pg, pool, acting, msg.oid)
                if r < 0:
                    out.append({"rval": r})
                    return r, out, blobs
                if conn is None:
                    out.append({"rval": -EINVAL})
                    return -EINVAL, out, blobs
                cookie = str(op.get("cookie", ""))
                self._watchers.setdefault(key, {})[cookie] = conn
                out.append({"rval": 0})
            elif name == "unwatch":
                cookie = str(op.get("cookie", ""))
                table = self._watchers.get(key, {})
                table.pop(cookie, None)
                if not table:
                    self._watchers.pop(key, None)
                out.append({"rval": 0})
            elif name == "notify":
                payload = (
                    msg.blobs[op["data"]] if op.get("data") is not None else b""
                )
                timeout = float(op.get("timeout", 5.0))
                acks, missed = await self._do_notify(
                    key, msg.oid, payload, timeout,
                    nid=op.get("nid"),
                )
                out.append({
                    "rval": 0,
                    "acks": {c: len(blobs) + i for i, c in
                             enumerate(sorted(acks))},
                    "missed": sorted(missed),
                })
                blobs.extend(acks[c] for c in sorted(acks))
            else:
                out.append({"rval": -EINVAL,
                            "error": "watch ops cannot mix with I/O ops"})
                return -EINVAL, out, blobs
        return 0, out, blobs

    async def _obj_exists(
        self, pg: PGid, pool: Pool, acting: list[int], oid: str
    ) -> int:
        """Watch requires the object to exist (reference do_osd_ops
        CEPH_OSD_OP_WATCH on missing object -> -ENOENT)."""
        if pool.type == POOL_TYPE_ERASURE:
            r, _size = await self._ec_stat(pg, pool, acting, oid)
            return r
        cid = CollectionId(str(pg))
        return 0 if self.store.exists(cid, ObjectId(oid)) else -ENOENT

    async def _do_notify(
        self, key: tuple[int, str], oid: str, payload: bytes, timeout: float,
        nid: str | None = None,
    ) -> tuple[dict[str, bytes], list[str]]:
        """Fan a notify out to every watcher, gather acks (or time out),
        reference:src/osd/Watch.cc Notify::init/maybe_complete_notify.

        ``nid`` is the client-chosen notify id: operate()'s retry loop
        (map change / not-primary / EAGAIN) may deliver the same logical
        notify twice, and watch callbacks are not required to be
        idempotent — a duplicate nid joins the in-flight (or
        completed) fan-out instead of re-firing every watcher."""
        if nid is not None:
            prior = self._notify_dedupe.get((key, nid))
            if prior is not None:
                return await asyncio.shield(prior)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._notify_dedupe[(key, nid)] = fut
            if len(self._notify_dedupe) > 512:  # bounded memory: evict
                # oldest COMPLETED entries only — evicting an in-flight
                # fan-out would re-enable the double-fire this prevents
                done = [
                    kk for kk, f in self._notify_dedupe.items() if f.done()
                ]
                for kk in done[: len(self._notify_dedupe) - 512]:
                    self._notify_dedupe.pop(kk, None)
            try:
                result = await self._do_notify(key, oid, payload, timeout)
            except BaseException as e:
                fut.set_exception(e)
                fut.exception()  # retrieved: no un-awaited warning
                self._notify_dedupe.pop((key, nid), None)
                raise
            fut.set_result(result)
            return result
        watchers = dict(self._watchers.get(key, {}))
        notify_id = self._new_tid()
        waiter = _NotifyWaiter(set(watchers))
        self._notify_waiters[notify_id] = waiter
        try:
            for cookie, conn in watchers.items():
                try:
                    conn.send(messages.MWatchNotify(
                        notify_id=notify_id, cookie=cookie, oid=oid,
                        notifier=self.name, blobs=[payload],
                    ))
                except (ConnectionError, OSError):
                    waiter.drop(cookie)
            try:
                async with asyncio.timeout(timeout):
                    await waiter.event.wait()
            except TimeoutError:
                pass
            missed = sorted(waiter.pending)
            return dict(waiter.acks), missed
        finally:
            del self._notify_waiters[notify_id]

    def _rep_snapset(
        self, cid: CollectionId, oid_str: str
    ) -> tuple[bool, "snaps_mod.SnapSet", bool]:
        """(head_exists, snapset, snapset-came-from-snapdir) from the
        primary's local store (every replica holds whole objects)."""
        oid = ObjectId(oid_str)
        if self.store.exists(cid, oid):
            try:
                raw = self.store.getattr(cid, oid, snaps_mod.SS_KEY)
            except KeyError:
                raw = None
            return True, snaps_mod.SnapSet.from_json(raw), False
        sd = ObjectId(snaps_mod.snapdir_name(oid_str))
        if self.store.exists(cid, sd):
            try:
                raw = self.store.getattr(cid, sd, snaps_mod.SS_KEY)
            except KeyError:
                raw = None
            return False, snaps_mod.SnapSet.from_json(raw), True
        return False, snaps_mod.SnapSet(), False

    def _rep_resolve_snap(
        self, cid: CollectionId, oid_str: str, snapid: int
    ) -> tuple[int, str]:
        head_exists, ss, _sd = self._rep_snapset(cid, oid_str)
        res = ss.resolve(snapid)
        if res == snaps_mod.SnapSet.HEAD:
            return (0, oid_str) if head_exists else (-ENOENT, oid_str)
        if res == snaps_mod.SnapSet.MISSING:
            return -ENOENT, oid_str
        return 0, snaps_mod.clone_name(oid_str, res)

    async def _rep_execute(
        self, pg: PGid, pool: Pool, acting: list[int], msg: messages.MOSDOp,
        locked: bool = False,
    ) -> tuple[int, list, list[bytes]]:
        cid = CollectionId(str(pg))
        oid = ObjectId(msg.oid)
        out: list = []
        blobs: list[bytes] = []
        txn = Transaction().create_collection(cid)
        mutates = False
        # an earlier op in THIS batch creates the object: later ops'
        # existence checks must see the projected state, not pre-state
        # (rados compound-op semantics: ops execute sequentially)
        batch_created = False
        log_op = "modify"
        try:
            projected_size = self.store.stat(cid, oid)
        except KeyError:
            projected_size = 0
        # snapshots: writes clone-on-first-write-after-snap, reads at a
        # snap resolve to the serving clone (reference:PrimaryLogPG.cc
        # make_writeable / find_object_context)
        snapc = snaps_mod.SnapContext.from_dict(msg.snapc)
        read_oid = oid
        if msg.snapid is not None:
            r, resolved = self._rep_resolve_snap(cid, msg.oid, int(msg.snapid))
            if r < 0:
                return r, [{"rval": r}], blobs
            read_oid = ObjectId(resolved)
        ss: "snaps_mod.SnapSet | None" = None

        def prep_write() -> "snaps_mod.SnapSet":
            """Once per message, before the first mutating op lands in
            the txn: clone the pre-write object if a snap demands it."""
            nonlocal ss
            if ss is not None:
                return ss
            head_exists, ss, from_sdir = self._rep_snapset(cid, msg.oid)
            clone_src = snaps_mod.plan_clone(
                ss, snapc, head_exists, projected_size, msg.oid
            )
            if clone_src is not None:
                txn.try_stash(cid, oid, ObjectId(clone_src))
            if snapc is not None and from_sdir:
                txn.remove(cid, ObjectId(snaps_mod.snapdir_name(msg.oid)))
            return ss

        def delete_head() -> None:
            """Remove the head, parking the SnapSet on the snapdir while
            clones survive it (shared by delete and rollback-to-absent,
            reference:PrimaryLogPG.cc make_writeable delete branch)."""
            nonlocal projected_size, mutates, log_op
            txn.remove(cid, oid)
            sd = ObjectId(snaps_mod.snapdir_name(msg.oid))
            if ss is not None and ss.clones:
                txn.touch(cid, sd)
                txn.setattr(cid, sd, snaps_mod.SS_KEY, ss.to_json())
            else:
                txn.remove(cid, sd)
            projected_size = 0
            mutates = True
            log_op = "delete"

        for op in msg.ops:
            name = op["op"]
            if name in self._REP_LOCKED_OPS:
                # EVERY mutation goes through make_writeable (including
                # cls calls and xattr/omap changes), or a snap silently
                # absorbs post-snap state
                prep_write()
            if name == "writefull":
                data = msg.blobs[op["data"]]
                txn.remove(cid, oid).write(cid, oid, 0, data)
                projected_size = len(data)
                mutates = True
                batch_created = True
                log_op = "modify"
                out.append({"rval": 0})
            elif name == "write":
                data = msg.blobs[op["data"]]
                off = op.get("offset", 0)
                txn.write(cid, oid, off, data)
                projected_size = max(projected_size, off + len(data))
                mutates = True
                batch_created = True
                log_op = "modify"
                out.append({"rval": 0})
            elif name == "append":
                data = msg.blobs[op["data"]]
                txn.write(cid, oid, projected_size, data)
                projected_size += len(data)
                mutates = True
                batch_created = True
                log_op = "modify"
                out.append({"rval": 0})
            elif name == "truncate":
                size = int(op.get("size", op.get("offset", 0)))
                txn.truncate(cid, oid, size)
                projected_size = size
                mutates = True
                log_op = "modify"
                out.append({"rval": 0})
            elif name == "zero":
                off = int(op.get("offset", 0))
                ln = int(op.get("length", 0))
                txn.zero(cid, oid, off, ln)
                projected_size = max(projected_size, off + ln)
                mutates = True
                log_op = "modify"
                out.append({"rval": 0})
            elif name == "delete":
                delete_head()
                out.append({"rval": 0})
            elif name == "rollback":
                r, src = self._rep_resolve_snap(
                    cid, msg.oid, int(op["snapid"])
                )
                if r == -ENOENT and self.store.exists(cid, oid):
                    # object absent at that snap: rollback deletes head
                    delete_head()
                    out.append({"rval": 0})
                    continue
                if r < 0:
                    out.append({"rval": r})
                    return r, out, blobs
                if src != msg.oid:
                    data = self.store.read(cid, ObjectId(src))
                    attrs = self.store.getattrs(cid, ObjectId(src))
                    txn.remove(cid, oid).write(cid, oid, 0, bytes(data))
                    for k, v in attrs.items():
                        if k not in (OI_KEY, snaps_mod.SS_KEY):
                            txn.setattr(cid, oid, k, v)
                    projected_size = len(data)
                    mutates = True
                    log_op = "modify"
                out.append({"rval": 0})
            elif name == "call":
                r, ret, info = self._do_cls_call(cid, oid, op, msg.blobs, txn)
                out.append({"rval": r, **({"ret": ret} if r == 0 else ret)})
                if r < 0:
                    return r, out, blobs
                if info["mutated"]:
                    mutates = True
                    if info["new_size"] is not None:
                        projected_size = info["new_size"]
            elif name == "list_snaps":
                head_exists, lss, _sd = self._rep_snapset(cid, msg.oid)
                if not head_exists and lss.empty():
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                out.append({
                    "rval": 0,
                    "snapset": {
                        "seq": lss.seq,
                        "head_exists": head_exists,
                        "clones": [
                            {"cloneid": c.cloneid, "snaps": c.snaps,
                             "size": c.size}
                            for c in lss.clones
                        ],
                    },
                })
            elif name == "read":
                try:
                    ln = op.get("length", -1) or -1
                    data = self.store.read(
                        cid, read_oid, op.get("offset", 0), ln
                    )
                except KeyError:
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                out.append({"rval": 0, "data": len(blobs)})
                blobs.append(data)
            elif name == "stat":
                try:
                    size = self.store.stat(cid, read_oid)
                except KeyError:
                    out.append({"rval": -ENOENT, "size": 0})
                    return -ENOENT, out, blobs
                out.append({"rval": 0, "size": size})
            elif name == "setxattr":
                txn.setattr(
                    cid, oid, self.USER_XATTR_PREFIX + op["key"],
                    msg.blobs[op["data"]],
                )
                mutates = True
                out.append({"rval": 0})
            elif name == "tier.dirty":
                # internal cache-tier marker (tiering.py):
                # rides the mutating batch so dirty-tracking commits in
                # the SAME transaction as the write it marks
                from .tiering import DIRTY_KEY

                txn.setattr(cid, oid, DIRTY_KEY, b"1")
                mutates = True
                out.append({"rval": 0})
            elif name == "tier.whiteout":
                # record "base delete pending" in the pg meta omap, in
                # the SAME transaction as the cache delete: until the
                # base delete is confirmed, promote must treat the
                # object as deleted (an acked delete must not
                # silently un-delete via re-promotion).  Analog of
                # the reference's whiteout object flag
                # (reference:src/osd/PrimaryLogPG.cc CEPH_OSD_OP_DELETE
                # whiteout path).
                from .pg_log import meta_oid
                from .tiering import whiteout_key

                txn.omap_setkeys(
                    cid, meta_oid(-1), {whiteout_key(msg.oid): b"1"}
                )
                mutates = True
                out.append({"rval": 0})
            elif name == "tier.clear_whiteout":
                from .pg_log import meta_oid
                from .tiering import whiteout_key

                txn.omap_rmkeys(cid, meta_oid(-1), [whiteout_key(msg.oid)])
                mutates = True
                out.append({"rval": 0})
            elif name == "rmxattr":
                if not self.store.exists(cid, oid):
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                txn.rmattr(cid, oid, self.USER_XATTR_PREFIX + op["key"])
                mutates = True
                out.append({"rval": 0})
            elif name == "getxattr":
                try:
                    val = self.store.getattr(
                        cid, read_oid, self.USER_XATTR_PREFIX + op["key"]
                    )
                except KeyError:
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                out.append({"rval": 0, "data": len(blobs)})
                blobs.append(val)
            elif name == "getxattrs":
                try:
                    attrs = self.store.getattrs(cid, read_oid)
                except KeyError:
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                plen = len(self.USER_XATTR_PREFIX)
                user = {
                    k[plen:]: v for k, v in sorted(attrs.items())
                    if k.startswith(self.USER_XATTR_PREFIX)
                }
                out.append({
                    "rval": 0,
                    "attrs": {k: len(blobs) + i for i, k in enumerate(user)},
                })
                blobs.extend(user.values())
            elif name == "omap_setkeys":
                kv = {
                    k: msg.blobs[bi] for k, bi in op.get("keys", {}).items()
                }
                txn.omap_setkeys(cid, oid, kv)
                mutates = True
                out.append({"rval": 0})
            elif name == "omap_clear":
                if not (self.store.exists(cid, oid) or batch_created):
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                txn.omap_clear(cid, oid)
                mutates = True
                out.append({"rval": 0})
            elif name == "omap_rmkeys":
                if not (self.store.exists(cid, oid) or batch_created):
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                txn.omap_rmkeys(cid, oid, list(op.get("keys", [])))
                mutates = True
                out.append({"rval": 0})
            elif name == "omap_get":
                try:
                    omap = self.store.omap_get(cid, read_oid)
                except KeyError:
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                keys = sorted(omap)
                out.append({
                    "rval": 0,
                    "keys": {k: len(blobs) + i for i, k in enumerate(keys)},
                })
                blobs.extend(omap[k] for k in keys)
            elif name == "omap_get_keys":
                try:
                    got = self.store.omap_get_keys(
                        cid, read_oid, list(op.get("keys", []))
                    )
                except KeyError:
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                keys = sorted(got)
                out.append({
                    "rval": 0,
                    "keys": {k: len(blobs) + i for i, k in enumerate(keys)},
                })
                blobs.extend(got[k] for k in keys)
            elif name == "omap_get_range":
                try:
                    page, truncated = self.store.omap_get_range(
                        cid, read_oid,
                        start_after=str(op.get("start_after", "")),
                        prefix=str(op.get("prefix", "")),
                        max_entries=int(op.get("max_entries", 1000)),
                    )
                except KeyError:
                    out.append({"rval": -ENOENT})
                    return -ENOENT, out, blobs
                keys = sorted(page)
                out.append({
                    "rval": 0,
                    "keys": {k: len(blobs) + i for i, k in enumerate(keys)},
                    "truncated": truncated,
                })
                blobs.extend(page[k] for k in keys)
            else:
                out.append({"rval": -EINVAL})
                return -EINVAL, out, blobs
        if mutates:
            if ss is not None and not ss.empty() and log_op != "delete":
                txn.setattr(cid, oid, snaps_mod.SS_KEY, ss.to_json())
            if locked:
                r = await self._rep_commit_locked(
                    pg, acting, txn, msg.oid, log_op, projected_size
                )
            else:
                r = await self._rep_commit(
                    pg, acting, txn, msg.oid, log_op, projected_size
                )
            if r < 0:
                return r, out, blobs
        return 0, out, blobs

    async def _rep_commit(
        self, pg: PGid, acting: list[int], txn: Transaction, oid: str,
        log_op: str = "modify", projected_size: int = 0,
    ) -> int:
        async with self.pg_lock(pg):
            return await self._rep_commit_locked(
                pg, acting, txn, oid, log_op, projected_size
            )

    async def _rep_commit_locked(
        self, pg: PGid, acting: list[int], txn: Transaction, oid: str,
        log_op: str, projected_size: int,
    ) -> int:
        version = self._next_version(pg)
        entry = PGLogEntry(log_op, oid, version, Eversion())
        if log_op != "delete":
            # keep the OI version current on every mutation so recovery's
            # freshness checks can trust it (analog of object_info_t)
            cid = CollectionId(str(pg))
            txn.setattr(
                cid, ObjectId(oid), OI_KEY,
                json.dumps(
                    {"size": projected_size, "version": version.to_list()}
                ).encode(),
            )
        replicas = [o for o in acting if o != CRUSH_ITEM_NONE]
        tid = self._new_tid()
        waiter = _Waiter(set(replicas), {o: o for o in replicas})
        self._write_waiters[tid] = waiter
        ops, blobs = messages.encode_txn(txn)

        async def send_round(osds):
            from ..common.tracing import current_trace

            for osd in osds:
                if osd == self.osd_id:
                    waiter.complete(
                        osd, self._apply_sub_write(txn, str(pg), -1, [entry])
                    )
                    continue
                try:
                    conn = await self.messenger.connect(
                        self.osdmap.get_addr(osd), f"osd.{osd}"
                    )
                except (ConnectionError, OSError):
                    waiter.complete(osd, -ENOTCONN)
                    continue
                self.op_tracker.mark_by_trace(
                    current_trace.get(), "sub_op_sent"
                )
                _trace.point("osd_sub_op_sent", osd=self.osd_id,
                             to_osd=osd, pgid=str(pg))
                conn.send(
                    messages.MOSDRepOp(
                        pgid=str(pg), tid=tid, from_osd=self.osd_id,
                        txn=ops, log=[entry.to_dict()],
                        at_version=entry.version.to_list(),
                        epoch=self._epoch(), blobs=blobs,
                    )
                )

        try:
            await self._gather_subops(waiter, send_round, replicas)
        finally:
            del self._write_waiters[tid]
        if waiter.pending:
            return -EIO
        if any(r != 0 for r in waiter.results.values()):
            if any(r == -ENOTCONN for r in waiter.results.values()):
                return -EAGAIN  # dead replica pre-markdown: retry on
                # the next map, the write lands degraded
            return -EIO
        return 0

    async def _meta_rep_commit(
        self, pg: PGid, acting: list[int], txn: Transaction
    ) -> int:
        """Replicate a PG-metadata-only transaction (no pg_log entry, no
        object version): used for bookkeeping that must survive primary
        failover but describes no object mutation — e.g. clearing a
        cache-tier whiteout once the base delete is confirmed.  Caller
        holds no object-level ordering requirement."""
        replicas = [o for o in acting if o != CRUSH_ITEM_NONE]
        tid = self._new_tid()
        waiter = _Waiter(set(replicas), {o: o for o in replicas})
        self._write_waiters[tid] = waiter
        ops, blobs = messages.encode_txn(txn)

        async def send_round(osds):
            for osd in osds:
                if osd == self.osd_id:
                    waiter.complete(
                        osd, self._apply_sub_write(txn, str(pg), -1, [])
                    )
                    continue
                try:
                    conn = await self.messenger.connect(
                        self.osdmap.get_addr(osd), f"osd.{osd}"
                    )
                except (ConnectionError, OSError):
                    waiter.complete(osd, -EIO)
                    continue
                conn.send(
                    messages.MOSDRepOp(
                        pgid=str(pg), tid=tid, from_osd=self.osd_id,
                        txn=ops, log=[], at_version=[0, 0],
                        epoch=self._epoch(), blobs=blobs,
                    )
                )

        try:
            await self._gather_subops(waiter, send_round, replicas)
        finally:
            del self._write_waiters[tid]
        if waiter.pending or any(
            r != 0 for r in waiter.results.values()
        ):
            return -EIO
        return 0

    def _handle_rep_op(self, conn: Connection, msg: messages.MOSDRepOp) -> None:
        r = self._gate_subop(msg.pgid, msg.epoch, msg.from_osd)
        if r == 0:
            txn = messages.decode_txn(msg.txn, msg.blobs)
            entries = [PGLogEntry.from_dict(d) for d in msg.log]
            r = self._apply_sub_write(txn, msg.pgid, -1, entries)
        conn.send(
            messages.MOSDRepOpReply(
                pgid=msg.pgid, tid=msg.tid, from_osd=self.osd_id, result=r
            )
        )

    # ======================= heartbeats ======================================

    async def _watchdog_loop(self) -> None:
        """Poll the HeartbeatMap independently of peer pings (the
        reference polls from its always-on heartbeat(); here pings are
        optional, the watchdog is not)."""
        period = max(0.05, self.config.osd_op_thread_timeout / 3)
        try:
            while not self._stopping:
                await asyncio.sleep(period)
                self.hb_map.is_healthy()
        except asyncio.CancelledError:
            pass

    async def _mgr_report_loop(self) -> None:
        """Periodic MPGStats to the active mgr (reference:src/osd/OSD.cc
        mgrc report path, src/messages/MPGStats.h) — and the OSD's tick
        for slow-op detection (check_ops_in_flight runs off the tick in
        the reference): the slow_ops gauges and the '%d slow requests'
        clog warning must refresh even when no mgr is configured,
        reachable, or reporting is disabled — the clog only needs the
        mon connection."""
        try:
            while not self._stopping:
                interval = self.config.osd_mgr_report_interval
                await asyncio.sleep(interval if interval > 0 else 1.0)
                self._refresh_slow_ops()
                if (interval <= 0 or self.osdmap is None
                        or not self.osdmap.mgr_addr):
                    continue
                addr = self.osdmap.mgr_addr
                try:
                    conn = self._mgr_conn
                    if (conn is None or conn._closed
                            or self._mgr_addr_used != addr):
                        # failover re-target: an open conn to a DEMOTED
                        # mgr must not keep swallowing our reports (and
                        # must not leak — close it)
                        if conn is not None and not conn._closed:
                            await conn.close()
                        conn = await self.messenger.connect(
                            addr, self.osdmap.mgr_name
                        )
                        self._mgr_conn = conn
                        self._mgr_addr_used = addr
                    pgs, used = await self._collect_pg_stats()
                    # ledger gauge + rows ride the same report: the
                    # mgr's ceph_client_* series and the SLO module
                    # see tenants at report cadence
                    self.perf.get("client").set(
                        "ledger_entries",
                        self.client_ledger.entry_count(),
                    )
                    conn.send(messages.MPGStats(
                        osd=self.osd_id, epoch=self._epoch(), pgs=pgs,
                        perf=self.perf.dump(),
                        store={"bytes_used": used},
                        ledger=self.client_ledger.series(),
                        traces=self._drain_kept_traces(),
                    ))
                except (ConnectionError, OSError):
                    self._mgr_conn = None  # mgr bouncing; retry next tick
        except asyncio.CancelledError:
            pass

    def _drain_kept_traces(self) -> list[dict]:
        """Assemble the keep-policy survivors into shippable waterfalls
        for the mgr trace store.  Assembly runs HERE, at
        report cadence rather than in the op path, for two reasons: it
        amortizes the ring scan over the report interval, and it gives
        the client's reply-side spans (reply_wire/reply_dispatch/total,
        recorded when the reply lands) time to reach the shared ring in
        single-process clusters — draining at op completion would ship
        waterfalls that structurally miss their last hops."""
        if not self._pending_traces:
            return []
        from ..common.tracing import op_waterfall

        out: list[dict] = []
        ptr = self.perf.get("trace")
        while self._pending_traces:
            meta = self._pending_traces.popleft()
            try:
                wf = op_waterfall(meta["trace"])
            except Exception:  # pragma: no cover - observability only
                logger.exception("%s: trace assembly failed for %s",
                                 self.name, meta["trace"])
                continue
            # ring-eviction race: the spans aged out before this tick
            # — ship the metadata anyway (reason/wall/client survive;
            # the store renders an empty waterfall honestly)
            wf.update(meta)
            out.append(wf)
            ptr.inc("shipped")
        return out

    def _refresh_slow_ops(self) -> None:
        """Recompute the slow-request gauges from the live tracker (the
        reference's OpTracker::check_ops_in_flight, run off the tick):
        the mgr reads them from our perf report and raises SLOW_OPS.
        New slow ops are clog'd once (edge-triggered) like the
        reference's '%d slow requests' cluster-log warnings."""
        self.scheduler.refresh_gauges()  # qos share-attainment gauges
        if self.ec_supervisor is not None:
            # engine_state must survive an admin `perf reset` — a
            # zeroed gauge would clear ACCEL_DEGRADED while TRIPPED
            self.ec_supervisor.refresh_gauge()
        if self.accel_client is not None:
            # same rule for remote_unreachable: a perf reset must not
            # silently clear ACCEL_UNREACHABLE while the remote is down
            self.accel_client.refresh_gauges()
        self._pull_device_trace_totals()
        slow = self.op_tracker.slow_ops(self.config.osd_op_complaint_time)
        posd = self.perf.get("osd")
        posd.set("slow_ops", len(slow))
        oldest_op = max(slow, key=lambda o: o.age(), default=None)
        oldest = oldest_op.age() if oldest_op is not None else 0.0
        posd.set("slow_ops_oldest_sec", round(oldest, 3))
        if len(slow) > self._slow_reported:
            # name WHERE the oldest op's time went (its typed-state
            # durations — the waterfall's coarse shape for unsampled
            # ops), so the warning points at a hop, not just an age
            dom = oldest_op.dominant_state() if oldest_op else None
            # ... and WHOSE ops they are: when one tenant owns the
            # majority of the slow set, say so — "the cluster is slow"
            # becomes "client X is slow"
            owners: dict = {}
            for o in slow:
                c = o.desc.get("client")
                if c is not None:
                    owners[c] = owners.get(c, 0) + 1
            culprit = ""
            if owners:
                top = max(owners, key=lambda c: owners[c])
                if owners[top] * 2 > len(slow):
                    culprit = (f"; dominant client {top} owns "
                               f"{owners[top]}/{len(slow)}")
            self.clog(
                "warn",
                f"{len(slow)} slow requests, oldest blocked for "
                f"{oldest:.1f}s in state {dom or 'unknown'} "
                f"(complaint time "
                f"{self.config.osd_op_complaint_time:g}s)"
                f"{culprit}",
            )
        self._slow_reported = len(slow)

    def _pull_device_trace_totals(self) -> None:
        """Fold the process-global device tracer's per-bucket totals
        (ops/device_trace: seconds of traced fused-op / DMA / ICI-
        collective device events across closed `kernel trace` windows)
        into this daemon's ``ec.device_time_*`` counters, and mirror
        the last window's occupancy into the ``device_occupancy``
        gauge — the mgr prometheus module then exports the breakdown
        like every other family.  consume_totals hands each window's
        seconds out exactly once process-wide, so with N in-process
        daemons a sum over their series equals the true traced time
        (each daemon independently delta-pulling totals() would
        report N copies)."""
        try:
            from ..ops.device_trace import tracer

            tot = tracer().consume_totals()
        except Exception:  # tracer unavailable: observability only
            return
        pec = self.perf.get("ec")
        for bucket, key in (("fused_op", "device_time_fused_op"),
                            ("dma", "device_time_dma"),
                            ("collective", "device_time_collective")):
            if tot[bucket] > 0:
                pec.inc(key, tot[bucket])
        pec.set("device_occupancy", tot["last_occupancy"])

    async def _collect_pg_stats(self) -> tuple[dict, int]:
        """Per-led-PG object/byte counts from the local store (the
        primary's report is the authoritative one in the mgr's PGMap).
        Yields to the loop between objects — a big store scan must not
        stall in-flight ops or the watchdog."""
        scanned = 0
        pgs: dict[str, dict] = {}
        used = 0
        if self.osdmap is None:
            return pgs, used
        for pool in self.osdmap.pools.values():
            for pg in self.osdmap.pgs_of_pool(pool.id):
                _u, _up, acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
                if primary != self.osd_id:
                    self._pg_stats_cache.pop(str(pg), None)
                    continue
                # an unchanged PG (same epoch + same last-issued version)
                # reuses its last scan — rescanning every object every
                # second is pure waste on a quiet store
                cache_key = (
                    self._epoch(),
                    self._pg_versions.get(str(pg), Eversion()).key(),
                )
                hit = self._pg_stats_cache.get(str(pg))
                if hit is not None and hit[0] == cache_key:
                    pgs[str(pg)] = hit[1]
                    used += hit[1]["bytes"]
                    continue
                if pool.type == POOL_TYPE_ERASURE:
                    shard = next(
                        (s for s, o in enumerate(acting)
                         if o == self.osd_id), 0
                    )
                    cid = self._shard_cid(pg, shard)
                else:
                    cid = CollectionId(str(pg))
                objects = 0
                pg_bytes = 0
                try:
                    names = self.store.list_objects(cid)
                except KeyError:
                    names = []
                for o in names:
                    scanned += 1
                    if scanned % 256 == 0:
                        await asyncio.sleep(0)
                    n = o.name
                    if (n == "_pgmeta_" or is_stash_name(n)
                            or snaps_mod.is_clone_name(n)):
                        continue
                    objects += 1
                    try:
                        raw = self.store.getattr(cid, o, OI_KEY)
                        pg_bytes += int(json.loads(raw).get("size", 0))
                    except (KeyError, ValueError):
                        try:
                            pg_bytes += self.store.stat(cid, o)
                        except KeyError:
                            pass
                stat = {
                    "objects": objects, "bytes": pg_bytes,
                    "primary": self.osd_id,
                }
                pgs[str(pg)] = stat
                self._pg_stats_cache[str(pg)] = (cache_key, stat)
                used += pg_bytes
        return pgs, used

    async def _heartbeat_loop(self) -> None:
        """reference:src/osd/OSD.cc:4104-4245 heartbeat + failure_queue."""
        prev = time.monotonic()
        try:
            while not self._stopping:
                await asyncio.sleep(self.heartbeat_interval)
                woke = time.monotonic()
                # this loop ran late (the event loop was stalled): the
                # peers' replies may still sit unread, so this round
                # pings but judges nobody
                late = woke - prev > 2 * self.heartbeat_interval
                prev = woke
                if not self.hb_map.is_healthy():
                    # a wedged worker: stop pinging so peers report us
                    # (reference:OSD.cc heartbeat() cct->get_heartbeat_map()
                    # ->is_healthy() gate)
                    continue
                if self.osdmap is None:
                    continue
                now = time.monotonic()
                for osd in range(self.osdmap.max_osd):
                    if osd == self.osd_id:
                        continue
                    if not self.osdmap.is_up(osd):
                        # its last reply belongs to an incarnation that
                        # is gone: a rebooted peer gets a full grace,
                        # not a failure report on its first map
                        self._hb_last.pop(osd, None)
                        continue
                    addr = self.osdmap.get_addr(osd)
                    if not addr:
                        continue
                    last = self._hb_last.setdefault(osd, now)
                    if now - last > self.heartbeat_grace and not late:
                        logger.info(
                            "%s: peer osd.%d silent for %.1fs -> reporting",
                            self.name, osd, now - last,
                        )
                        mon = self._mon_conn
                        if mon is None:
                            mon = await self._connect_mon()
                        mon.send(
                            messages.MOSDFailure(
                                target_osd=osd, reporter=self.osd_id,
                                epoch=self._epoch(),
                            )
                        )
                        self._hb_last[osd] = now  # back off further reports
                        continue
                    try:
                        conn = await self.messenger.connect(addr, f"osd.{osd}")
                        conn.send(
                            messages.MPing(stamp=now, epoch=self._epoch())
                        )
                    except OSError:
                        self._hb_last.setdefault(osd, now - 2 * self.heartbeat_grace)
        except asyncio.CancelledError:
            pass
