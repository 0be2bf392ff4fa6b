"""The shared EC accelerator daemon.

Counterpart of ``ceph_tpu/accel/daemon.py``.  Here the daemon owns the
card: ``AccelDaemon(name, device=None)`` runs its dispatcher's launches
on CUDA (and raises ``DeviceUnavailableError`` without it);
``device="cpu"`` is for tests.  Every codec it builds comes from this
package's registry on that device, so an ISA / Reed-Solomon batch runs
``gf_matmul`` and a bit-matrix batch runs ``bitmatrix_xor`` on the card.
Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: the ``admin_socket`` option (the admin socket, ROADMAP Queue A
item 10) and the ``osd_ec_mesh`` option (the mesh lane, item 8).

One standalone process keeps persistent device state (codecs, their
matrices, built kernels) resident and amortizes device cost across the
whole storage plane.  Without this daemon every OSD owns its own device
lane, so device count scales with daemon count; the
:class:`AccelDaemon` inverts that — ONE process owns the device and
serves batched encode/decode to many OSDs over the messenger, so device
count scales with *traffic*.

The engine room is exactly the OSD's (one code path, two processes):

- an :class:`~ceph_tpu_torch.osd.ec_dispatch.ECDispatcher` coalesces
  requests into padded launches — but here the requests arrive from
  *different OSD daemons*, so batches coalesce **across clients** (the
  shared-occupancy win; the flight recorder records which OSDs shared
  each launch, and a stripe stays traceable
  client -> OSD -> accelerator -> device via the trace id the
  messenger restores on dispatch);
- its own dmClock :class:`~ceph_tpu_torch.osd.scheduler.OpScheduler`
  instance paces background classes (requests carry the QoS class in
  the RPC), so client-vs-background isolation holds end to end;
- the full fault domain: the shared failure classifier, the launch
  deadline with the HeartbeatMap watchdog pin, bit-identical
  host-fallback replay, the breaker + canary re-promotion — a shared
  device serving dozens of OSDs must fail over, not fail everyone.  A
  CUDA error in a worker thread is a fatal engine error: the batch
  replays on the host engine here, and if that fails too the reply is
  EIO and the client OSD replays the batch locally.

Health flows two ways: every reply and a periodic
:class:`~ceph_tpu_torch.msg.messages.MAccelBeacon` piggyback the breaker
state + queue depth (OSDs route around a TRIPPED or saturated
accelerator without a timeout chain), and — when a monitor is
configured (``mon_addr``) — the daemon subscribes to maps, registers
into the mon-published AccelMap (``MAccelBoot`` with its
``accel_locality`` label and capacity, refreshed every beacon tick;
OSD routers learn it from the next map push) and reports its perf
counters to the map's mgr (``MDaemonStats``).  An unreachable mon is
logged and retried; it never moves the codecs off the card.

Threads and buffers: the dispatcher launches kernels from its worker
threads while the event loop serves the sockets.  A request's member
payloads are read-only views of the messenger's receive block, which is
recycled once no view exports it.  The batching lane gathers them into
its own host buffer before any copy to the card, and a single-op
launch's view is copied by the codec (``models.base``) before
``torch.from_numpy``, so no upload reads a block after its recycling.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any

import numpy as np

from ..device import resolve
from ..msg import AsyncMessenger, Connection, Dispatcher, messages
from ..msg.message import Message
from ..msg.messenger import send_daemon_stats
from ..osd import ec_util
from ..utils.buffers import as_u8

logger = logging.getLogger("ceph_tpu_torch.accel")

EINVAL = 22
EIO = 5

# a client entity counts toward the ``accel.clients`` gauge for this
# long after its last request
_CLIENT_FRESH_S = 30.0

_NOT_PORTED = {
    "admin_socket": "the admin socket waits for ROADMAP Queue A item 10",
    "osd_ec_mesh": "the mesh lane waits for ROADMAP Queue A item 8 "
                   "(multi-device EC)",
}


class AccelDaemon(Dispatcher):
    """One shared accelerator process (see module doc).

    ``device`` is where its codecs live: None is the card (raises
    ``DeviceUnavailableError`` without CUDA), ``"cpu"`` is for tests.
    ``mon_addr`` (one address or a list) is optional: without it the
    daemon serves requests and beacons but skips map subscription,
    AccelMap registration and mgr reporting (the standalone topology).
    """

    def __init__(self, name: str = "accel.0",
                 mon_addr: "str | list[str] | None" = None,
                 config=None, device=None):
        from ..common import Config, PerfCountersCollection
        from ..common.log import install as _install_memlog

        self.config = config or Config()
        cfg = self.config
        for what, refused in (("admin_socket", cfg.admin_socket),
                              ("osd_ec_mesh", cfg.osd_ec_mesh)):
            if refused:
                raise NotImplementedError(
                    f"{what} is not supported: {_NOT_PORTED[what]}")
        self.device = resolve(device)
        _install_memlog()
        self.name = name
        self.mon_addr = mon_addr
        self.osdmap = None
        self.messenger = AsyncMessenger(name, self)
        self.messenger.apply_config(cfg)
        from ..auth import daemon_auth_context

        self.messenger.auth = daemon_auth_context(cfg, name)
        self.addr = ""
        # -- observability: the SAME ec family the OSD registers (one
        # definition, osd/ec_perf.py — the engine room mutates the
        # same keys in both processes) plus the accel-service half
        from ..osd.ec_perf import create_accel_service_perf, create_ec_perf
        from ..utils.buffers import data_path_perf

        self.perf = PerfCountersCollection()
        self.perf.attach(self.messenger.perf)
        self.perf.attach(data_path_perf())
        # the small-op cost ledger: this daemon's RPC
        # frames pay header encode/decode too — same process-global
        # family the OSD attaches, riding perf dump -> mgr
        from ..common.stack_ledger import stack_perf

        self.perf.attach(stack_perf())
        pec = create_ec_perf(self.perf)
        self._pacc = create_accel_service_perf(self.perf)
        # -- QoS: this daemon's OWN dmClock instance (requests carry
        # the class in the RPC, so client-vs-background pacing holds
        # end to end across the wire); perf=None — the per-class wait
        # histograms live on the OSDs, where admission happens
        from ..osd.scheduler import CLASSES as QOS_CLASSES
        from ..osd.scheduler import OpScheduler, QosSpec

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
        )
        # -- the engine room: breaker and dispatcher — the OSD's
        # discipline, verbatim
        from ..osd.ec_dispatch import ECDispatcher
        from ..osd.ec_failover import EngineSupervisor

        self.supervisor = EngineSupervisor(
            enabled=cfg.osd_ec_engine_failover,
            perf=pec,
            probe_interval=cfg.osd_ec_probe_interval,
            on_degraded=lambda d: setattr(
                self.scheduler, "capacity_degraded", d
            ),
        )
        self.dispatch = ECDispatcher(
            perf=pec,
            window=cfg.osd_ec_dispatch_window,
            max_stripes=cfg.osd_ec_dispatch_max_stripes,
            bucket=cfg.osd_ec_dispatch_bucket,
            scheduler=self.scheduler,
            supervisor=self.supervisor,
            launch_deadline=cfg.osd_ec_launch_deadline,
            launch_history=cfg.osd_ec_launch_history,
        )
        self.dispatch.inject_engine_failure = cfg.ec_inject_engine_failure
        self.dispatch.inject_launch_hang = cfg.ec_inject_launch_hang
        # -- watchdog: a wedged device call must mark THIS daemon
        # unhealthy and eventually kill it (tools/daemon.py sets
        # suicide_hard_exit), exactly like the OSD's launch handle
        from ..common.heartbeat_map import HeartbeatMap

        self.suicide_hard_exit = False
        self.hb_map = HeartbeatMap(self.name, on_suicide=self._hb_suicide)
        self._launch_handle = self.hb_map.add_worker(
            "ec_device_launch",
            (cfg.osd_ec_launch_deadline
             if cfg.osd_ec_launch_deadline > 0
             else cfg.osd_op_thread_timeout),
            cfg.osd_op_thread_suicide_timeout,
        )
        self.dispatch.set_watchdog_handle(self._launch_handle)
        # (profile-tuple, stripe_width, chunk_size) -> (codec, sinfo):
        # the accelerator's analog of the OSD's per-pool codec cache —
        # a persistent process keeps codecs (and their device state)
        # resident across every client's traffic
        self._codecs: dict[tuple, tuple[Any, ec_util.StripeInfo]] = {}
        self._clients: dict[str, dict] = {}  # peer -> {"ops","bytes","t"}
        self._inflight = 0
        self._cross_client_reported = 0  # -> accel.cross_client_batches
        self._tasks: set[asyncio.Task] = set()
        self._beacon_task: asyncio.Task | None = None
        self._report_task: asyncio.Task | None = None
        self._stopping = False
        self._mon_conn: Connection | None = None
        # live knobs (tracked so stop() unregisters; a shared Config
        # must not keep firing actions on dead daemons)
        self._observers = [
            ("osd_ec_dispatch_window", lambda _n, v: setattr(
                self.dispatch, "window", float(v))),
            ("osd_ec_dispatch_max_stripes", lambda _n, v: setattr(
                self.dispatch, "max_stripes", int(v))),
            ("osd_ec_dispatch_bucket", lambda _n, v: setattr(
                self.dispatch, "bucket", bool(v))),
            ("osd_ec_launch_deadline", self._on_launch_deadline),
            ("osd_ec_probe_interval", lambda _n, v: setattr(
                self.supervisor, "probe_interval", float(v))),
            ("osd_ec_engine_failover", lambda _n, v:
                self.supervisor.set_enabled(bool(v))),
            ("ec_inject_engine_failure", lambda _n, v: setattr(
                self.dispatch, "inject_engine_failure", int(v))),
            ("ec_inject_launch_hang", lambda _n, v: setattr(
                self.dispatch, "inject_launch_hang", float(v))),
            # the binary wire protocol: the accel serves MANY client
            # OSDs over one messenger — the ack-batch bound must tune
            # live here exactly like on the OSD (its encode replies
            # carry blobs and stay vectored; beacons and piggybacked
            # health acks are the coalescible traffic)
            ("ms_reply_coalesce_max", lambda _n, v: setattr(
                self.messenger, "reply_coalesce_max", int(v))),
        ]
        for opt, cb in self._observers:
            cfg.observe(opt, cb)

    def _on_launch_deadline(self, _name: str, value: float) -> None:
        self.dispatch.launch_deadline = float(value)
        self._launch_handle.grace = (
            float(value) if value > 0
            else self.config.osd_op_thread_timeout
        )

    def _hb_suicide(self, worker: str) -> None:
        if self._stopping:
            return
        self._stopping = True
        logger.error("%s: %s suicide timeout — aborting daemon",
                     self.name, worker)
        task = asyncio.ensure_future(self.stop())
        if self.suicide_hard_exit:
            task.add_done_callback(lambda _t: os._exit(134))
            asyncio.get_running_loop().call_later(10.0, os._exit, 134)

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self.addr = await self.messenger.bind(host, port)
        self._beacon_task = asyncio.ensure_future(self._beacon_loop())
        if self.mon_addr:
            # best-effort: the accelerator serves fine without a mon
            # (standalone topology); with one, it learns the map (mgr
            # address), REGISTERS into the mon-published AccelMap (OSD
            # routers learn this daemon from the next map push) and
            # reports its counters
            try:
                await self._connect_mon()
                self._register_mon()
            # swallow-ok: the report loop keeps retrying the mon
            except (ConnectionError, OSError) as e:
                logger.warning("%s: no mon reachable at start (%r); "
                               "registration deferred", self.name, e)
        self._report_task = asyncio.ensure_future(self._report_loop())
        logger.info("%s: serving EC batches at %s", self.name, self.addr)
        return self.addr

    @property
    def _mon_addrs(self) -> list[str]:
        if isinstance(self.mon_addr, str):
            return [self.mon_addr]
        return list(self.mon_addr or [])

    async def _connect_mon(self) -> Connection:
        """Connect to the first reachable mon and subscribe to its maps
        (``MMonGetMap``)."""
        last: Exception | None = None
        for addr in self._mon_addrs:
            try:
                conn = await self.messenger.connect(addr, "mon")
                conn.send(messages.MMonGetMap(have=0))
                self._mon_conn = conn
                return conn
            # swallow-ok: tries the next mon; raises when all fail
            except (ConnectionError, OSError) as e:
                last = e
        raise ConnectionError(f"no mon reachable: {last}")

    def _register_mon(self) -> None:
        """One AccelMap registration beacon to the mon (best-effort —
        a dead mon conn is the report loop's problem): name, serving
        address, locality label, stripe capacity."""
        conn = self._mon_conn
        if conn is None or not self.addr or self._stopping:
            return
        conn.send(messages.MAccelBoot(
            name=self.name, addr=self.addr,
            locality=self.config.accel_locality,
            capacity=max(1, int(self.config.osd_op_queue_slots)),
            down=False,
        ))

    async def stop(self, crash: bool = False) -> None:
        """``crash=True`` models SIGKILL: connections die NOW, mid-
        batch — in-flight replies are never sent, and every client OSD
        must recover by replaying locally (zero failed client ops)."""
        if not crash and not self._stopping and self._mon_conn is not None:
            # graceful deregistration: the mon marks us down on this
            # word instead of waiting out the beacon grace (a crash
            # stop deliberately skips it — the connection reset and
            # the grace ARE the crash signal)
            try:
                self._mon_conn.send(messages.MAccelBoot(
                    name=self.name, addr=self.addr, locality="",
                    capacity=0, down=True,
                ))
            # swallow-ok: best-effort deregistration on a dying conn —
            # the mon's reset path covers it
            except Exception:
                pass
        self._stopping = True
        for opt, cb in self._observers:
            self.config.unobserve(opt, cb)
        self.scheduler.stop()
        for t in (self._beacon_task, self._report_task):
            if t is not None:
                t.cancel()
        for t in list(self._tasks):
            t.cancel()
        if crash:
            await self.messenger.shutdown()
        # let the serve-task cancellations land before the dispatcher
        # flushes, so doomed waiters drop instead of launching
        await asyncio.sleep(0)
        await self.dispatch.stop()
        if not crash:
            await self.messenger.shutdown()

    # -- dispatch ------------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, (messages.MAccelEncode, messages.MAccelDecode)):
            # run as a task: serving blocks on the device (and on
            # coalescing windows), and the connection reader must keep
            # pulling CONCURRENT requests — that concurrency IS the
            # cross-client coalescing win
            t = asyncio.ensure_future(self._serve(conn, msg))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)
        elif isinstance(msg, messages.MOSDMapMsg):
            from ..osd.osdmap import advance_map

            if self.osdmap is None or msg.epoch > self.osdmap.epoch:
                m = advance_map(
                    self.osdmap, msg.epoch, msg.osdmap, msg.incrementals
                )
                if m is None:
                    conn.send(messages.MMonGetMap(have=None))
                    return
                self.osdmap = m

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._mon_conn:
            self._mon_conn = None

    # -- the service ---------------------------------------------------------

    def _codec_for(self, profile: dict, stripe_width: int,
                   chunk_size: int):
        """Rebuild (and cache) the codec named by the wire profile.
        The geometry is TRUSTED from the wire and validated by the
        shared encode/decode prologue (ec_util), exactly as a local
        batch would be — the accelerator and the OSD must accept the
        same batches."""
        from ..models import registry

        prof = {str(k): str(v) for k, v in (profile or {}).items()}
        key = (tuple(sorted(prof.items())), int(stripe_width),
               int(chunk_size))
        cached = self._codecs.get(key)
        if cached is not None:
            return cached
        plugin = prof.get("plugin", "jerasure")
        codec = registry.instance().factory(plugin, prof,
                                            device=self.device)
        sinfo = ec_util.StripeInfo(
            stripe_width=int(stripe_width), chunk_size=int(chunk_size)
        )
        self._codecs[key] = (codec, sinfo)
        return codec, sinfo

    def _note_client(self, peer: str, nbytes: int) -> None:
        c = self._clients.setdefault(peer, {"ops": 0, "bytes": 0})
        c["ops"] += 1
        c["bytes"] += nbytes
        c["t"] = time.monotonic()

    def client_table(self) -> dict:
        now = time.monotonic()
        return {
            peer: {"ops": c["ops"], "bytes": c["bytes"],
                   "age_s": round(now - c["t"], 3)}
            for peer, c in sorted(self._clients.items())
        }

    def queue_depth(self) -> int:
        """Requests currently in service (queued + launching): the
        saturation signal the beacon carries."""
        return self._inflight

    def _health_fields(self) -> dict:
        return {
            "engine_state": self.supervisor.state,
            "queue_depth": self.queue_depth(),
            "capacity": max(1, int(self.config.osd_op_queue_slots)),
        }

    async def _serve(self, conn: Connection, msg: Message) -> None:
        t0 = time.perf_counter()
        decode = isinstance(msg, messages.MAccelDecode)
        pacc = self._pacc
        pacc.inc("rpc_decode" if decode else "rpc_encode")
        klass = msg.klass or "client"
        reply_extra: dict = {}
        self._inflight += 1
        pacc.set("queue_depth", self._inflight)
        try:
            codec, sinfo = self._codec_for(
                msg.profile, msg.stripe_width, msg.chunk_size
            )
            if decode:
                result_blobs, nbytes_in = await self._serve_decode(
                    conn, msg, codec, sinfo, klass
                )
                reply_extra["shards"] = None
            else:
                result_blobs, nbytes_in, shards = await self._serve_encode(
                    conn, msg, codec, sinfo, klass
                )
                reply_extra["shards"] = shards
            self._note_client(conn.peer_name, nbytes_in)
            pacc.inc("rpc_bytes_in", nbytes_in)
            out_bytes = sum(
                v.nbytes if isinstance(v, np.ndarray) else len(v)
                for v in result_blobs
            )
            pacc.inc("rpc_bytes_out", out_bytes)
            # served-engine + device-wall attribution: the launch that
            # carried this request is findable by its trace id in the
            # flight recorder (the record ended before the dispatcher
            # resolved our waiter), so the client OSD's own flight
            # record can show the TRUE device time — not the RTT —
            # and which engine here produced the bytes
            from ..common.tracing import current_trace

            launch = self.dispatch.flight.lookup(
                current_trace.get()) or {}
            reply = messages.MAccelReply(
                tid=msg.tid, result=0, blobs=result_blobs,
                served=launch.get("served"),
                device_wall_s=launch.get("device_wall_s"),
                # the accel-side coalesce wait: the client OSD's
                # flight record and op waterfall split the remote RTT
                # into wait-here vs device wall
                queue_wait_s=launch.get("queue_wait_s"),
                **reply_extra, **self._health_fields(),
            )
        except Exception as e:
            # fork by the SHARED classifier (models/matrix_codec): a
            # data-class error (malformed batch, >m erasures — the
            # validation prologue and codec IOErrors) answers EINVAL
            # and the client OSD surfaces it to its waiters untouched;
            # anything else (device AND host fallback both failed here,
            # or shutdown raced the batch) answers EIO and the client
            # replays the batch on its LOCAL fallback engine — either
            # way no error is swallowed and no client op fails
            from ..models.matrix_codec import classify_engine_error

            kind = classify_engine_error(e)
            if kind != "data":
                logger.warning("%s: batch tid=%s failed: %r",
                               self.name, msg.tid, e)
            pacc.inc("rpc_errors")
            reply = messages.MAccelReply(
                tid=msg.tid,
                result=(-EINVAL if kind == "data" else -EIO),
                error=repr(e)[:300],
                **self._health_fields(),
            )
        finally:
            self._inflight -= 1
            pacc.set("queue_depth", self._inflight)
        conn.send(reply)
        pacc.observe("service_time", time.perf_counter() - t0)

    async def _serve_encode(self, conn, msg, codec, sinfo, klass):
        """Each MEMBER op of the client's coalesced batch submits
        individually into the dispatcher (the payloads already arrived
        as separate borrowed frame views — re-gathering them here
        would pay a full extra copy before the dispatcher's own
        ec_gather, and would make N member ops count as ONE dispatcher
        op, undercounting coalesce/occupancy/flight attribution).  The
        members land in the same tick, so they coalesce into one
        launch — together with other clients' members."""
        bufs = [as_u8(bl) for bl in msg.blobs]
        total = sum(b.size for b in bufs)
        tenants = msg.tenants or []
        outs = await asyncio.gather(*[
            # per-member tenant attribution: the flight
            # recorder shows the SAME u64 ids the OSD ledger keys on;
            # unattributed members fall back to the sending OSD's name
            self.dispatch.encode(sinfo, codec, b, klass=klass,
                                 client=(tenants[i]
                                         if i < len(tenants)
                                         and tenants[i]
                                         else conn.peer_name))
            for i, b in enumerate(bufs)
        ])
        self._sync_cross_client()
        shards = sorted(outs[0]) if outs else []
        # member-major reply blobs: the per-member shard buffers ARE
        # the dispatcher's result slices — sent as views, no join
        return [o[s] for o in outs for s in shards], total, shards

    async def _serve_decode(self, conn, msg, codec, sinfo, klass):
        present = [int(s) for s in msg.present]
        nsh = len(present)
        n_ops = len(msg.stripes or [1])
        blobs = msg.blobs
        if len(blobs) != nsh * n_ops:
            raise ValueError(
                f"decode batch carries {len(blobs)} blobs for "
                f"{n_ops} ops x {nsh} shards"
            )
        payloads = [
            {present[j]: as_u8(blobs[i * nsh + j]) for j in range(nsh)}
            for i in range(n_ops)
        ]
        total = sum(
            v.size for p in payloads for v in p.values()
        )
        tenants = msg.tenants or []
        outs = await asyncio.gather(*[
            # see _serve_encode: per-member tenant attribution
            self.dispatch.decode_concat(sinfo, codec, p, klass=klass,
                                        client=(tenants[i]
                                                if i < len(tenants)
                                                and tenants[i]
                                                else conn.peer_name))
            for i, p in enumerate(payloads)
        ])
        self._sync_cross_client()
        return list(outs), total

    def _sync_cross_client(self) -> None:
        """Mirror the dispatcher's cross-client-batch total into the
        ``accel.cross_client_batches`` counter (the dispatcher's perf
        handle is the ``ec`` family; the service-side key lives in
        ``accel``)."""
        total = self.dispatch._totals.get("cross_client_batches", 0)
        delta = total - self._cross_client_reported
        if delta > 0:
            self._cross_client_reported = total
            self._pacc.inc("cross_client_batches", delta)

    # -- beacon, watchdog + mgr reporting ------------------------------------

    async def _beacon_loop(self) -> None:
        """Engine-state/queue-depth beacon to every connected peer: a
        TRIPPED breaker or a saturating queue re-routes OSD traffic to
        their local lanes on the NEXT request — no timeout chain — and
        a healthy beacon routes it back (``accel_beacon_interval``;
        <= 0 disables the beacons).  The mon gets the AccelMap
        registration beacon on every tick either way.  Runs until
        :meth:`stop` cancels it."""
        while not self._stopping:
            interval = self.config.accel_beacon_interval
            await asyncio.sleep(interval if interval > 0 else 1.0)
            if self._stopping:
                continue
            # the mon gets the REGISTRATION beacon (MAccelBoot)
            # regardless of the client-beacon knob: interval <= 0
            # disables only the OSD-facing health beacons — a live
            # daemon must keep proving liveness to the mon, or the
            # beacon-grace check would mark a healthy accelerator
            # down.  True silence (this loop wedged or dead) is exactly
            # what mon_accel_beacon_grace catches
            self._register_mon()
            if interval <= 0:
                continue
            fields = self._health_fields()
            sent = False
            for conn in list(self.messenger._all):
                if conn is self._mon_conn:
                    continue  # the mon is not an EC client
                conn.send(messages.MAccelBeacon(name=self.name, **fields))
                sent = True
            if sent:
                self._pacc.inc("beacons")
            now = time.monotonic()
            self._pacc.set("clients", sum(
                1 for c in self._clients.values()
                if now - c["t"] <= _CLIENT_FRESH_S
            ))

    async def _report_loop(self) -> None:
        """The report tick (``accel_mgr_report_interval``): perf-counter
        reports to the map's mgr (``MDaemonStats``; nothing while the
        map names no mgr) and a reconnect to the mon when its link
        died; also POLLS the HeartbeatMap (it is passive — suicide only
        fires from is_healthy()), so a wedged device launch past
        suicide_grace actually stops the daemon like the watchdog
        contract promises, and re-asserts the engine_state gauge so a
        perf reset cannot hide a TRIPPED breaker.  Runs until
        :meth:`stop` cancels it."""
        while not self._stopping:
            interval = self.config.accel_mgr_report_interval
            await asyncio.sleep(interval if interval > 0 else 1.0)
            self.hb_map.is_healthy()
            self.supervisor.refresh_gauge()
            if interval <= 0 or not self.mon_addr:
                continue
            if self._mon_conn is None:
                try:
                    await self._connect_mon()
                # swallow-ok: mon bouncing — retry next tick
                except (ConnectionError, OSError):
                    logger.warning("%s: no mon reachable; retrying",
                                   self.name)
                    continue
            await send_daemon_stats(
                self.messenger, self.osdmap, self.name, self.perf.dump(),
            )
