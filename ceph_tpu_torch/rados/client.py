"""RadosClient / IoCtx: the client object API.

Re-expression of the reference client stack: ``RadosClient`` bootstraps
mon connection + map subscription (reference:src/librados/RadosClient.cc
connect), ``IoCtx`` scopes ops to a pool (reference:src/librados/
IoCtxImpl.cc), and ``operate`` plays the Objecter: compute the target
from the current OSDMap (object -> pg -> acting primary,
reference:src/osdc/Objecter.cc _calc_target), send the MOSDOp, and
re-target + resend when the map changes, the primary rejects us, or the
connection resets (reference:src/osdc/Objecter.cc op_submit :2192,
resend on handle_osd_map).

Counterpart of ``ceph_tpu/rados/client.py``, whole.  Its frames are the
reference's, so this client drives a cluster of either package, and the
reference's client drives a cluster of this one.  The client has no
card: it encodes nothing and places objects by the scalar CRUSH walk
(``osd/osdmap.py``).  ``scrub_pool`` is kept, but this package's OSD
answers ``MOSDScrub`` with an error until its scrub is ported (ROADMAP
Queue A item 6b).
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import logging
import time
from typing import Any

from ..common.perf_counters import PerfCounters
from ..common.tracing import current_trace, new_trace_id
from ..msg import AsyncMessenger, Connection, Dispatcher, messages
from ..msg.message import Message
from ..osd.osdmap import OSDMap
from ..utils.buffers import note_copy

logger = logging.getLogger("ceph_tpu_torch.rados")

_client_counter = itertools.count(1)


def client_session_id(name: str) -> int:
    """Stable 63-bit tenant id for an entity name — the u64
    every MOSDOp carries and every ledger/flight record keys on.  A
    content hash, not a counter: the same named client maps to the same
    id across reconnects and processes, so attribution survives
    restarts.  Masked to 63 bits to stay positive in every marshal."""
    digest = hashlib.blake2b(name.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x7FFF_FFFF_FFFF_FFFF

ENOENT = 2
EAGAIN = 11
EACCES = 13


def resolve_mon_arg(spec: str) -> "str | list[str]":
    """A ``-m`` value: one address, a comma list, or a monmap FILE (the
    bootstrap artifact monmaptool writes / vstart --write-monmap emits).
    A broken monmap file exits with a CLI-friendly error, not a
    traceback — this only runs on operator-supplied ``-m`` values."""
    import os as _os
    import sys as _sys

    if _os.path.isfile(spec):
        from ..tools.monmaptool import load_monmap, monmap_addrs

        try:
            return monmap_addrs(load_monmap(spec))
        except Exception as e:
            print(f"error: bad monmap file {spec!r}: {e}",
                  file=_sys.stderr)
            raise SystemExit(2) from e
    return spec.split(",") if "," in spec else spec


class RadosError(OSError):
    def __init__(self, code: int, msg: str = ""):
        super().__init__(abs(code), msg or f"rados error {code}")
        self.code = code


class _OpAggregator:
    """Objecter-parity op aggregation (the request-direction half of
    ROADMAP item 1a).

    Ops submitted within one event-loop tick to the SAME target OSD
    stage here and flush as one burst into that connection's send
    queue.  The burst is what makes them ADJACENT when the writer
    loop's multi-op batcher (messenger ms_op_batch_max) drains the
    queue — adjacency is the entire batching precondition, and without
    staging each ``conn.send`` wakes the writer loop which happily
    ships one-op frames.  The producers that make bursts common are
    the striper's extent fan-out and the object cacher's writeback
    flush (both ``asyncio.gather`` over ``operate``); a lone op pays
    one ``call_soon`` hop (same tick, no sleep), not a delay — the
    reference Objecter's session submit queue has the same
    flush-on-next-tick shape.

    Trace stamping happens in ``submit`` (the caller's context is
    still active there); the flush callback runs in whichever context
    scheduled it first, which must never decide another op's trace id.
    """

    def __init__(self, client: "RadosClient"):
        self._client = client
        self._staged: dict[Connection, list[Message]] = {}
        self._flush_scheduled = False

    def submit(self, conn: Connection, msg: Message) -> None:
        if msg.trace is None:
            msg.trace = (current_trace.get()
                         or new_trace_id(self._client.name))
        q = self._staged.get(conn)
        if q is None:
            self._staged[conn] = q = []
        q.append(msg)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        staged, self._staged = self._staged, {}
        perf = self._client.perf
        for conn, msgs in staged.items():
            for m in msgs:
                conn.send(m)
            # frames-on-the-wire is the messenger's number
            # (msgr.batched_ops/batch_frames); this one is the
            # CLIENT-side burst width the aggregator achieved per
            # target — the knob the op_batch_max packer feeds on
            perf.observe("ops_per_frame", len(msgs))


class RadosClient(Dispatcher):
    """Cluster handle: mon session + map + op submission."""

    def __init__(self, mon_addr: "str | list[str]", name: str | None = None,
                 op_timeout: float = 10.0, max_retries: int = 8,
                 auth_entity: str | None = None,
                 auth_secret: str | None = None):
        self.name = name or f"client.{next(_client_counter)}"
        # the per-tenant attribution id every op of ours carries
        self.client_id = client_session_id(self.name)
        # cephx: entity + secret prove key possession to the mon, which
        # returns the ticket every later handshake presents
        self.auth_entity = auth_entity
        self.auth_secret = auth_secret
        self.mon_addr = mon_addr
        self.messenger = AsyncMessenger(self.name, self)
        self.osdmap: OSDMap | None = None
        self.op_timeout = op_timeout
        self.max_retries = max_retries
        self._tid = itertools.count(1)
        self._op_futs: dict[int, asyncio.Future] = {}
        self._fut_conns: dict[int, Connection] = {}
        self._map_waiters: list[asyncio.Future] = []
        self._log_watchers: list[asyncio.Queue] = []  # ceph -w feeds
        self._logsub_fut: asyncio.Future | None = None  # sub ack/nack
        self._logsub_lock: asyncio.Lock | None = None  # serializes subs
        self._logsub_conn: Connection | None = None  # where we're subbed
        self._cmd_addr: str | None = None  # current mon target for commands
        self._sub_conn: Connection | None = None  # map subscription feed
        self._shutdown = False
        self._tasks: set[asyncio.Task] = set()
        # client-side observability (Objecter parity): how wide the op
        # aggregator's per-target bursts actually are
        self.perf = PerfCounters("client").add_avg(
            "ops_per_frame",
            "ops staged per target OSD per aggregator flush (burst "
            "width the wire-level op batcher packs from)")
        self._op_agg = _OpAggregator(self)
        # watches: cookie -> {pool, oid, callback, conn} (linger state)
        self._watches: dict[str, dict] = {}
        self._watch_cookie = itertools.count(1)

    @property
    def _mon_addrs(self) -> list[str]:
        """mon_addr may be one address or a monmap list (multi-mon)."""
        if isinstance(self.mon_addr, str):
            return [self.mon_addr]
        return list(self.mon_addr)

    async def _mon_conn(self, addr: str | None = None) -> Connection:
        """Connect to the given mon (or hunt for any live one)."""
        last: Exception | None = None
        addrs = [addr] if addr else self._mon_addrs
        for a in addrs:
            try:
                conn = await self.messenger.connect(a, f"mon@{a}")
                self._cmd_addr = a
                return conn
            except (ConnectionError, OSError) as e:
                last = e
        raise ConnectionError(f"no mon reachable: {last}")

    # -- lifecycle
    async def connect(self) -> "RadosClient":
        await self._subscribe()
        async with asyncio.timeout(10):
            while self.osdmap is None:
                await self._wait_for_map_change(-1, 10.0)
        return self

    async def _authenticate(self, mon: Connection) -> None:
        """CephX bootstrap (reference:MonClient::authenticate): prove key
        possession over a mon nonce, pocket the ticket — every later
        handshake (OSDs, other mons) presents it."""
        from ..auth import AuthContext, challenge_response, unseal_skey

        if self.auth_secret is None or (
            self.messenger.auth is not None
            and self.messenger.auth.ticket_fresh()
        ):
            return
        r1 = await self._auth_roundtrip(mon, {"op": "get_nonce"})
        if r1.result < 0:
            raise RadosError(r1.result, "auth: no nonce")
        if not r1.nonce:
            return  # the mon runs with auth off: nothing to prove
        r2 = await self._auth_roundtrip(mon, {
            "op": "authenticate",
            "entity": self.auth_entity or self.name,
            "proof": challenge_response(self.auth_secret, r1.nonce),
        })
        if r2.result < 0 or not r2.ticket or not r2.skey:
            raise RadosError(r2.result or -EACCES, "authentication failed")
        ctx = AuthContext(self.auth_entity or self.name)
        ctx.adopt_ticket(
            r2.ticket, unseal_skey(self.auth_secret, r2.ticket, r2.skey)
        )
        self.messenger.auth = ctx

    async def _auth_roundtrip(self, conn: Connection, fields: dict):
        tid = next(self._tid)
        fut = asyncio.get_running_loop().create_future()
        self._op_futs[tid] = fut
        self._fut_conns[tid] = conn
        try:
            conn.send(messages.MAuth(tid=tid, **fields))
            async with asyncio.timeout(self.op_timeout):
                return await fut
        finally:
            self._op_futs.pop(tid, None)
            self._fut_conns.pop(tid, None)

    async def _subscribe(self) -> None:
        mon = await self._mon_conn()
        await self._authenticate(mon)
        self._sub_conn = mon
        mon.send(messages.MMonGetMap(
            have=self.osdmap.epoch if self.osdmap else 0
        ))

    def _resubscribe_later(self) -> None:
        """Our subscription mon died: re-home the map feed to a live one
        (reference MonClient hunting).  Tasks are strongly referenced —
        the loop only weak-refs pending tasks and an unreferenced rehunt
        could be garbage-collected mid-flight."""
        if self._shutdown:
            return

        async def rehunt():
            while not self._shutdown:
                try:
                    await self._subscribe()
                    return
                except (ConnectionError, OSError):
                    await asyncio.sleep(0.3)

        t = asyncio.ensure_future(rehunt())
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def shutdown(self) -> None:
        self._shutdown = True
        await self.messenger.shutdown()

    # -- dispatch
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
                for fut in self._map_waiters:
                    if not fut.done():
                        fut.set_result(None)
                self._map_waiters.clear()
        elif isinstance(
            msg,
            (
                messages.MOSDOpReply,
                messages.MMonCommandReply,
                messages.MOSDScrubReply,
                messages.MPGLsReply,
                messages.MClientReply,
                messages.MAuthReply,
            ),
        ):
            fut = self._op_futs.pop(msg.tid, None)
            self._fut_conns.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, messages.MWatchNotify):
            await self._handle_watch_notify(conn, msg)
        elif isinstance(msg, messages.MLog):
            for q in self._log_watchers:
                for e in list(msg.entries or []):
                    if q.full():  # slow consumer: drop its oldest
                        try:
                            q.get_nowait()
                        except asyncio.QueueEmpty:
                            pass
                    q.put_nowait(e)
        elif isinstance(msg, messages.MLogSub):
            fut = self._logsub_fut
            if fut is not None and not fut.done():
                fut.set_result(bool(msg.sub))

    async def _handle_watch_notify(
        self, conn: Connection, msg: messages.MWatchNotify
    ) -> None:
        """A notify fired on an object we watch: run the callback, then
        ack so the notifier's gather completes (reference:
        src/osdc/Objecter.cc handle_watch_notify + librados WatchCtx).

        Delivery runs as a task: ms_dispatch is awaited inline by the
        connection reader, so an async callback doing I/O on this same
        connection would deadlock against its own reply."""

        async def deliver() -> None:
            w = self._watches.get(msg.cookie)
            payload = msg.blobs[0] if msg.blobs else b""
            if w is not None:
                try:
                    res = w["callback"](msg.notifier, payload)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    logger.exception("%s: watch callback failed", self.name)
            conn.send(
                messages.MWatchNotifyAck(
                    notify_id=msg.notify_id, cookie=msg.cookie
                )
            )

        t = asyncio.ensure_future(deliver())
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._sub_conn:
            self._sub_conn = None
            self._resubscribe_later()
        # fail in-flight ops on this conn fast so operate() can re-target
        for tid, c in list(self._fut_conns.items()):
            if c is conn:
                fut = self._op_futs.pop(tid, None)
                del self._fut_conns[tid]
                if fut is not None and not fut.done():
                    fut.set_exception(ConnectionResetError(f"{conn} reset"))
        # linger semantics: re-register watches whose OSD connection died
        # (reference:Objecter.cc _linger_ops resend on reset)
        stale = [c for c, w in self._watches.items() if w.get("conn") is conn]
        if stale and not self._shutdown:
            t = asyncio.ensure_future(self._rewatch(stale))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    async def _rewatch(self, cookies: list[str]) -> None:
        await asyncio.sleep(0.2)  # let the map catch up with the failure
        for cookie in cookies:
            w = self._watches.get(cookie)
            if w is None:
                continue
            try:
                reply = await self.operate(
                    w["pool"], w["oid"],
                    [{"op": "watch", "cookie": cookie}], [],
                )
                if reply.result == 0:
                    w["conn"] = await self._primary_conn(w["pool"], w["oid"])
            except (RadosError, ConnectionError, OSError):
                logger.warning(
                    "%s: re-watch of %s/%s failed", self.name,
                    w["pool"], w["oid"],
                )

    async def _wait_for_map_change(self, have_epoch: int, timeout: float) -> None:
        if self.osdmap is not None and self.osdmap.epoch > have_epoch:
            return
        fut = asyncio.get_running_loop().create_future()
        self._map_waiters.append(fut)
        try:
            async with asyncio.timeout(timeout):
                await fut
        except TimeoutError:
            pass

    # -- mon commands
    async def command_on(
        self, conn: Connection, cmd: dict
    ) -> messages.MMonCommandReply:
        """One MMonCommand round trip on an already-chosen connection
        (shared by mon commands and the ceph CLI's direct-to-mgr path)."""
        tid = next(self._tid)
        fut = asyncio.get_running_loop().create_future()
        self._op_futs[tid] = fut
        self._fut_conns[tid] = conn
        try:
            conn.send(messages.MMonCommand(tid=tid, cmd=cmd))
            async with asyncio.timeout(self.op_timeout):
                return await fut
        finally:
            self._op_futs.pop(tid, None)
            self._fut_conns.pop(tid, None)

    async def watch_cluster_log(
        self, maxsize: int = 1000
    ) -> "asyncio.Queue[dict]":
        """Subscribe to live cluster-log entries (`ceph -w`,
        reference:LogMonitor log subscriptions): returns a BOUNDED
        queue the dispatcher feeds (a slow consumer loses its oldest
        entries, never memory).  A command round trip first pins
        _cmd_addr at the leader; the mon ACKs the sub, and an election
        racing the pin is retried.  Pass the queue back to
        :meth:`unwatch_cluster_log` when done.  If the leader later
        changes, the feed goes quiet until re-subscribed (the reference
        CLI re-buffers across mon failover the same way)."""
        if self._logsub_lock is None:
            self._logsub_lock = asyncio.Lock()
        async with self._logsub_lock:  # one ack slot -> one sub at a time
            for _attempt in range(self.max_retries):
                await self.command({"prefix": "log last", "num": 0})
                conn = await self._mon_conn(self._cmd_addr)
                fut: asyncio.Future = (
                    asyncio.get_running_loop().create_future()
                )
                self._logsub_fut = fut
                try:
                    conn.send(messages.MLogSub(sub=True))
                    async with asyncio.timeout(self.op_timeout):
                        ok = await fut
                except (TimeoutError, ConnectionError, OSError):
                    ok = False
                finally:
                    self._logsub_fut = None
                if ok:
                    q: asyncio.Queue = asyncio.Queue(maxsize)
                    self._log_watchers.append(q)
                    self._logsub_conn = conn
                    return q
                await asyncio.sleep(0.2)  # mid-election: re-pin + retry
        raise RadosError(-EAGAIN, "could not subscribe to cluster log")

    def unwatch_cluster_log(self, q: "asyncio.Queue[dict]") -> None:
        try:
            self._log_watchers.remove(q)
        except ValueError:
            pass
        if not self._log_watchers and self._logsub_conn is not None:
            # tell the mon to stop streaming — otherwise it serializes
            # every entry to this connection forever
            try:
                self._logsub_conn.send(messages.MLogSub(sub=False))
            except Exception:
                pass
            self._logsub_conn = None

    async def command(self, cmd: dict) -> tuple[int, str, Any]:
        """Mon command; follows leader redirects and fails over to other
        mons (reference MonClient hunting + command forwarding)."""
        target = self._cmd_addr
        last: tuple[int, str, Any] | None = None
        for _attempt in range(self.max_retries):
            try:
                conn = await self._mon_conn(target)
                reply = await self.command_on(conn, cmd)
            except PermissionError as e:
                raise RadosError(-EACCES, str(e)) from e
            except (ConnectionError, OSError, TimeoutError):
                target = None  # hunt any live mon next round
                await asyncio.sleep(0.2)
                continue
            if (
                reply.code == -EAGAIN
                and reply.status == "not leader"
            ):
                hint = (reply.out or {}).get("addr")
                target = hint  # None -> hunt; the mon may still be voting
                last = (reply.code, reply.status, reply.out)
                await asyncio.sleep(0.2 if hint is None else 0)
                continue
            return reply.code, reply.status, reply.out
        if last is not None:
            return last
        raise RadosError(-EAGAIN, "mon command exhausted retries")

    # -- pools
    async def create_pool(self, name: str, pool_type: str = "replicated",
                          **kw) -> int:
        code, status, out = await self.command(
            {"prefix": "osd pool create", "pool": name,
             "pool_type": pool_type, **kw}
        )
        if code < 0:
            raise RadosError(code, status)
        await self.wait_for_pool(name)
        return out["pool_id"]

    async def wait_for_pool(self, name: str, timeout: float = 10.0) -> None:
        async with asyncio.timeout(timeout):
            while self.osdmap is None or self.osdmap.lookup_pool(name) is None:
                have = self.osdmap.epoch if self.osdmap else -1
                await self._wait_for_map_change(have, timeout)

    def io_ctx(self, pool_name: str) -> "IoCtx":
        pool = self.osdmap.lookup_pool(pool_name) if self.osdmap else None
        if pool is None:
            raise RadosError(-ENOENT, f"no pool {pool_name!r}")
        return IoCtx(self, pool_name)

    # -- op submission (Objecter)
    async def _primary_conn(self, pool_name: str, oid: str) -> Connection:
        """The (cached) connection to the object's current primary —
        the conn a watch rides on."""
        pool = self.osdmap.lookup_pool(pool_name)
        if pool is None:
            raise RadosError(-ENOENT, f"no pool {pool_name!r}")
        pg = self.osdmap.object_locator_to_pg(oid, pool.id)
        _up, _upp, _acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
        addr = self.osdmap.get_addr(primary) if primary >= 0 else None
        if not addr:
            raise RadosError(-EAGAIN, "no primary for watch")
        return await self.messenger.connect(addr, f"osd.{primary}")

    async def operate(
        self, pool_name: str, oid: str, ops: list[dict], blobs: list[bytes],
        snapc: dict | None = None, snapid: int | None = None,
        op_timeout: float | None = None,
    ) -> messages.MOSDOpReply:
        if op_timeout is None:
            op_timeout = self.op_timeout
        last_err: Exception | None = None
        if (
            self.auth_secret is not None
            and self.messenger.auth is not None
            and not self.messenger.auth.ticket_fresh()
        ):
            # a near-expiry ticket would fail the NEXT OSD handshake:
            # refresh through the mon before dialing (cephx renewal)
            try:
                await self._authenticate(await self._mon_conn())
            except (ConnectionError, OSError):
                pass  # mon hunting happens below anyway
        for attempt in range(self.max_retries):
            # waterfall submit stamp: taken at ATTEMPT
            # start, so the client_serialize hop covers the real
            # client-side cost of this submission — pool lookup, pg
            # mapping, (cached) connect — not just the frame encode
            t_submit = time.monotonic()
            epoch = self.osdmap.epoch
            pool = self.osdmap.lookup_pool(pool_name)
            if pool is None:
                raise RadosError(-ENOENT, f"no pool {pool_name!r}")
            if pool.read_tier >= 0 and pool.read_tier in self.osdmap.pools:
                # cache-tier overlay (reference:osdc/Objecter.cc
                # _calc_target read_tier/write_tier): ops target the
                # CACHE pool; its OSDs promote/flush against the base.
                # This framework sets read_tier == write_tier, so one
                # redirect covers both directions.
                pool = self.osdmap.pools[pool.read_tier]
            pg = self.osdmap.object_locator_to_pg(oid, pool.id)
            _up, _upp, _acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
            addr = self.osdmap.get_addr(primary) if primary >= 0 else None
            if primary < 0 or not addr:
                await self._wait_for_map_change(epoch, self.op_timeout)
                continue
            tid = next(self._tid)
            fut = asyncio.get_running_loop().create_future()
            self._op_futs[tid] = fut
            try:
                conn = await self.messenger.connect(addr, f"osd.{primary}")
                self._fut_conns[tid] = conn
                m = messages.MOSDOp(
                    tid=tid, epoch=epoch, pool=pool.id, oid=oid,
                    ops=ops, blobs=blobs, snapc=snapc, snapid=snapid,
                    # the submit stamp plus the frame header's send
                    # stamp give the OSD the client_serialize hop
                    # with no span shipping — both are OUR clock, so
                    # the duration is exact wherever it is read
                    stamps={"submit": round(t_submit, 9)},
                    client=self.client_id,
                )
                # via the aggregator, not conn.send: concurrent ops to
                # this OSD in the same tick ship as ONE multi-op frame
                self._op_agg.submit(conn, m)
                async with asyncio.timeout(op_timeout):
                    reply = await fut
            except PermissionError as e:
                # deterministic auth rejection from the OSD handshake:
                # retrying is pointless and hides WHY
                self._op_futs.pop(tid, None)
                self._fut_conns.pop(tid, None)
                raise RadosError(-EACCES, str(e)) from e
            except (ConnectionError, OSError, TimeoutError) as e:
                self._op_futs.pop(tid, None)
                self._fut_conns.pop(tid, None)
                last_err = e
                logger.info(
                    "%s: op %s/%s to osd.%d failed (%s); re-targeting",
                    self.name, pool_name, oid, primary, type(e).__name__,
                )
                await self._wait_for_map_change(epoch, 2.0)
                continue
            if reply.result == -EAGAIN:
                # wrong primary (map race) — wait for a newer map and retry
                await self._wait_for_map_change(epoch, self.op_timeout)
                continue
            if getattr(reply, "spans", None):
                # a SAMPLED op: the OSD piggybacked its hop spans —
                # align + record them here, so the full cross-daemon
                # waterfall is readable in this process
                try:
                    self._note_waterfall(conn, m, reply)
                except Exception:  # pragma: no cover - observability only
                    logger.exception(
                        "%s: waterfall record failed", self.name
                    )
            return reply
        raise RadosError(-EAGAIN, f"op to {pool_name}/{oid} exhausted retries"
                         ) from last_err

    def _note_waterfall(self, conn: Connection, msg, reply) -> None:
        """Record a sampled op's piggybacked hop spans (the OSD's
        monotonic clock) into THIS process's ``stack`` provider ring,
        aligned through the messenger clock table, plus the
        client-side hops — common/tracing.op_waterfall then merges
        everything into one timeline (stable span ids dedupe against
        the OSD's own copies when both daemons share a process).

        The network hops are **offset-free in sum**: total network
        time = (our send stamp -> our reply receive) minus the OSD's
        busy extent — every term a same-clock difference, so the hop
        sum honesty check does not inherit clock-offset error.  The
        clock alignment only SPLITS that total between ``wire`` and
        ``reply_wire`` (midpoint split when no estimate exists —
        exactly the RTT/2 assumption, with the uncertainty saying so).
        Placement is causally chained (serialize -> wire -> the OSD
        extent re-anchored as one rigid block at sent+wire ->
        reply_wire ends at our receive), so the merged ordering cannot
        be faked by alignment error.  OSD spans that cannot be aligned
        are skipped: mis-placing them would fake an ordering the
        uncertainty field exists to prevent."""
        from ..common import stack_ledger
        from ..common.tracing import has_spans, record_span

        trace = reply.trace
        if not trace:
            return
        # per-CONNECTION estimate (peer names are not unique across
        # processes — clocksync module docstring)
        align = conn.clock_align
        peer = conn.peer_name
        # SAME-PROCESS fast path: the OSD already recorded every span
        # it measured into this process's ring with TRUE timestamps —
        # re-recording aligned reconstructions next to them would mix
        # two rigid timelines in one waterfall (per-span dedupe could
        # then pick copies from different frames, a reordering no real
        # clock produced).  We only add the reply-side hops, and the
        # piggybacked stamps are same-clock, so no alignment at all.
        local = has_spans(trace)
        # 1. parse the OSD's spans; the client-pair hops (wire /
        # client_serialize) are recomputed below from our own stamps
        parsed: list[tuple[str, float, float, dict]] = []
        osd_extent: list[tuple[float, float]] = []
        for s in reply.spans:
            try:
                t0, dur = float(s["t0"]), float(s["dur"])
                hop = str(s["hop"])
            except (KeyError, TypeError, ValueError):
                continue
            if hop in ("client_serialize", "wire"):
                continue
            if local:
                if s.get("entity") == peer and not s.get("parent"):
                    osd_extent.append((t0, dur))  # same clock: raw
                continue
            loc = align(t0)
            if loc is None:
                continue
            t0_local, align_unc = loc
            if s.get("entity") == peer and not s.get("parent"):
                osd_extent.append((t0_local, dur))
            parsed.append((hop, t0_local, dur, {
                "entity": str(s.get("entity") or peer),
                "parent": s.get("parent"),
                "uncertainty": (float(s.get("uncertainty") or 0.0)
                                + align_unc),
            }))
        sent_cl = msg.sent
        recv_cl = reply.recv_ts
        if sent_cl is None or recv_cl is None:
            return
        submit = (getattr(msg, "stamps", None) or {}).get("submit")
        if not osd_extent:
            # nothing usable (cross-process with no clock estimate
            # yet): without the OSD busy extent the "network total"
            # would be the whole round trip, execute included —
            # recording a wire split from that (or feeding the
            # histograms with it) would be exported fiction.  Keep
            # only what our own clock proves.
            if not local and submit is not None:
                dur = max(0.0, float(sent_cl) - float(submit))
                record_span("client_serialize", float(submit), dur,
                            trace=trace, entity=self.name)
            dur = max(0.0, time.monotonic() - recv_cl)
            record_span("reply_dispatch", recv_cl, dur, trace=trace,
                        entity=self.name)
            stack_ledger.feed_hop("reply_dispatch", dur)
            return
        # 2. offset-free network total: (our turnaround) - (the
        # OSD's busy extent)
        ext_t0 = min(t0 for t0, _d in osd_extent)
        ext_end = max(t0 + d for t0, d in osd_extent)
        osd_busy = ext_end - ext_t0
        net_total = max(0.0, (recv_cl - float(sent_cl)) - osd_busy)
        if local:
            # same process, same clock: EVERY client-pair hop is
            # exactly measurable, no offset estimate involved — the
            # reply path is the gap between the OSD extent's end and
            # our receive stamp, and the wire hop is the gap between
            # our send stamp and the extent's start (ext_t0 IS the
            # OSD's receive stamp, already in our clock).  These exact
            # copies carry no uncertainty, so they win the span dedupe
            # over the OSD's alignment-based versions — under load the
            # OSD's estimate error would otherwise eat a visible slice
            # of the hop sum.
            rw = max(0.0, recv_cl - ext_end)
            record_span("reply_wire", recv_cl - rw, rw, trace=trace,
                        entity=self.name)
            stack_ledger.feed_hop("reply_wire", rw)
            w = max(0.0, ext_t0 - float(sent_cl))
            record_span("wire", float(sent_cl), w, trace=trace,
                        entity=peer)
            if submit is not None:
                record_span("client_serialize", float(submit),
                            max(0.0, float(sent_cl) - float(submit)),
                            trace=trace, entity=self.name)
        else:
            # 3. cross-process: split the total by alignment, then
            # RE-ANCHOR the whole rigid OSD frame at sent + wire so
            # the chain is contiguous BY CONSTRUCTION — serialize ->
            # wire -> [OSD extent, shifted as one block] -> reply_wire
            # ends at our receive.  Alignment error moves only the
            # split (reported as uncertainty); raw aligned positions
            # could land the OSD frame outside our [send, recv] window
            # whenever the offset error exceeds the one-way delay,
            # faking a reordering (the loopback flake this replaces).
            rw = None
            split_unc = net_total / 2.0
            # NB (binary wire protocol): a reply that rode a coalesced
            # batch frame carries the BATCH's shared send stamp — the
            # moment the writer loop shipped the run.  Flush-on-idle
            # keeps that within one writer wakeup of the per-reply
            # stamp, so reply_wire stays an honest wire measure; any
            # residual batch wait shows up here, where it is in fact
            # spent.
            if reply.sent is not None:
                loc = align(float(reply.sent))
                if loc is not None:
                    rw = min(max(0.0, recv_cl - loc[0]), net_total)
                    split_unc = min(loc[1], net_total / 2.0)
            if rw is None:
                rw = net_total / 2.0  # no estimate: RTT/2 midpoint
            wire = net_total - rw
            shift = (float(sent_cl) + wire) - ext_t0
            for hop, t0_local, dur, extra in parsed:
                record_span(hop, t0_local + shift, dur, trace=trace,
                            entity=extra["entity"],
                            parent=extra["parent"],
                            uncertainty=extra["uncertainty"])
            record_span("wire", float(sent_cl), wire, trace=trace,
                        entity=peer, uncertainty=split_unc)
            if submit is not None:
                dur = max(0.0, float(sent_cl) - float(submit))
                record_span("client_serialize", float(submit), dur,
                            trace=trace, entity=self.name)
            record_span("reply_wire", recv_cl - rw, rw, trace=trace,
                        entity=self.name, uncertainty=split_unc)
            stack_ledger.feed_hop("reply_wire", rw)
        # 4. reply delivery: frame read -> this op's task resumed
        # (future resolution + loop scheduling — real small-op latency
        # a busy client loop pays; our own clock, no alignment)
        dur = max(0.0, time.monotonic() - recv_cl)
        record_span("reply_dispatch", recv_cl, dur, trace=trace,
                    entity=self.name)
        stack_ledger.feed_hop("reply_dispatch", dur)

    async def _pg_roundtrip(
        self, pg, build_msg, timeout: float, resend_on_timeout: bool = True
    ):
        """One request to a PG's primary with map-change retargeting;
        ``build_msg(tid)`` makes the message (the pg-addressed command
        pattern shared by scrub and pgls)."""
        for _attempt in range(self.max_retries):
            epoch = self.osdmap.epoch
            _up, _upp, _acting, primary = self.osdmap.pg_to_up_acting_osds(pg)
            addr = self.osdmap.get_addr(primary) if primary >= 0 else None
            if primary < 0 or not addr:
                await self._wait_for_map_change(epoch, self.op_timeout)
                continue
            tid = next(self._tid)
            fut = asyncio.get_running_loop().create_future()
            self._op_futs[tid] = fut
            try:
                conn = await self.messenger.connect(addr, f"osd.{primary}")
                self._fut_conns[tid] = conn
                conn.send(build_msg(tid))
                async with asyncio.timeout(timeout):
                    reply = await fut
            except TimeoutError:
                self._op_futs.pop(tid, None)
                self._fut_conns.pop(tid, None)
                if not resend_on_timeout:
                    raise RadosError(
                        -EIO, f"pg {pg} request timed out after "
                        f"{timeout:.0f}s (still running server-side)"
                    )
                await self._wait_for_map_change(epoch, 2.0)
                continue
            except PermissionError as e:
                self._op_futs.pop(tid, None)
                self._fut_conns.pop(tid, None)
                raise RadosError(-EACCES, str(e)) from e
            except (ConnectionError, OSError):
                self._op_futs.pop(tid, None)
                self._fut_conns.pop(tid, None)
                await self._wait_for_map_change(epoch, 2.0)
                continue
            if reply.result == -EAGAIN:
                await self._wait_for_map_change(epoch, self.op_timeout)
                continue
            return reply
        raise RadosError(-EAGAIN, f"pg {pg} request exhausted retries")

    # -- scrub (the `ceph pg deep-scrub` / `rados scrub` surface)
    async def scrub_pool(
        self, pool_name: str, repair: bool = True
    ) -> list[dict]:
        """Deep-scrub every PG of a pool at its primary; returns the
        per-PG scrub reports (engine: the OSD's scrub manager, analog of
        reference:src/osd/ECBackend.cc:2313 be_deep_scrub)."""
        pool = self.osdmap.lookup_pool(pool_name) if self.osdmap else None
        if pool is None:
            raise RadosError(-ENOENT, f"no pool {pool_name!r}")
        # a PG deep scrub reads every shard of every object: it needs a far
        # larger deadline than one object op (and a timed-out scrub keeps
        # running server-side — re-sending would queue duplicate scrubs)
        scrub_timeout = max(self.op_timeout * 6, 60.0)
        reports = []
        for pg in self.osdmap.pgs_of_pool(pool.id):
            reply = await self._pg_roundtrip(
                pg,
                lambda tid, pg=pg: messages.MOSDScrub(
                    tid=tid, pgid=str(pg), repair=repair,
                ),
                scrub_timeout,
                resend_on_timeout=False,
            )
            if reply.result < 0:
                raise RadosError(reply.result, str(reply.report))
            reports.append(reply.report)
        return reports

    async def list_objects(self, pool_name: str) -> list[str]:
        """Every object name in a pool via per-PG pgls at the primaries
        (`rados ls`, reference:src/osd/PrimaryLogPG.cc do_pg_op PGLS)."""
        pool = self.osdmap.lookup_pool(pool_name) if self.osdmap else None
        if pool is None:
            raise RadosError(-ENOENT, f"no pool {pool_name!r}")
        names: set[str] = set()
        for pg in self.osdmap.pgs_of_pool(pool.id):
            reply = await self._pg_roundtrip(
                pg,
                lambda tid, pg=pg: messages.MPGLs(tid=tid, pgid=str(pg)),
                self.op_timeout,
            )
            if reply.result < 0:
                raise RadosError(reply.result, f"pgls {pg}")
            names.update(reply.names)
        return sorted(names)


class IoCtx:
    """Pool-scoped object operations (reference:src/librados/IoCtxImpl.cc).

    Snapshots (reference:IoCtxImpl snapc/snap_seq handling): writes carry
    a SnapContext — the pool's own for named pool snaps, or the one set
    with :meth:`set_snapc` for self-managed snaps; reads honor
    :meth:`set_read` (a snap id) and resolve to the serving clone.
    """

    def __init__(self, client: RadosClient, pool_name: str):
        self.client = client
        self.pool_name = pool_name
        self.read_snap: int | None = None   # set_read: reads-at-snap
        self._selfmanaged_snapc: dict | None = None

    # -- snap context plumbing ----------------------------------------------
    def set_read(self, snapid: int | None) -> None:
        """Route reads to the object state at ``snapid`` (None = head)."""
        self.read_snap = snapid

    def set_snapc(self, seq: int, snaps: list[int]) -> None:
        """Self-managed snap context for subsequent writes (newest
        first, like librados selfmanaged_snap_set_write_ctx)."""
        self._selfmanaged_snapc = {
            "seq": int(seq), "snaps": [int(s) for s in snaps]
        }

    def write_snapc(self) -> dict | None:
        """The SnapContext writes carry: explicit self-managed one, else
        the pool's named snaps from the current map."""
        if self._selfmanaged_snapc is not None:
            return self._selfmanaged_snapc
        pool = self.client.osdmap.lookup_pool(self.pool_name)
        if pool is None or not pool.snaps:
            return None
        return {
            "seq": pool.snap_seq,
            "snaps": sorted(pool.snaps, reverse=True),
        }

    async def _op_w(self, oid: str, ops: list[dict], blobs: list[bytes]):
        return await self.client.operate(
            self.pool_name, oid, ops, blobs, snapc=self.write_snapc()
        )

    async def _op_r(self, oid: str, ops: list[dict], blobs: list[bytes]):
        return await self.client.operate(
            self.pool_name, oid, ops, blobs, snapid=self.read_snap
        )

    # -- snapshot operations -------------------------------------------------
    async def create_snap(self, name: str) -> int:
        """Named pool snapshot (rados mksnap); returns its snap id and
        waits for the map so subsequent writes clone against it."""
        code, status, out = await self.client.command(
            {"prefix": "osd pool mksnap", "pool": self.pool_name,
             "snap": name}
        )
        if code < 0:
            raise RadosError(code, status)
        snapid = out["snapid"]
        await self._wait_snap_seq(snapid)
        return snapid

    async def remove_snap(self, name: str) -> None:
        code, status, out = await self.client.command(
            {"prefix": "osd pool rmsnap", "pool": self.pool_name,
             "snap": name}
        )
        if code < 0:
            raise RadosError(code, status)

    async def list_pool_snaps(self) -> list[dict]:
        code, status, out = await self.client.command(
            {"prefix": "osd pool lssnap", "pool": self.pool_name}
        )
        if code < 0:
            raise RadosError(code, status)
        return out["snaps"]

    async def lookup_snap(self, name: str) -> int:
        for s in await self.list_pool_snaps():
            if s["name"] == name:
                return s["snapid"]
        raise RadosError(-ENOENT, f"no snap {name!r}")

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id the application manages itself (librbd's
        mode; reference librados selfmanaged_snap_create)."""
        code, status, out = await self.client.command(
            {"prefix": "osd pool selfmanaged-snap create",
             "pool": self.pool_name}
        )
        if code < 0:
            raise RadosError(code, status)
        return out["snapid"]

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        code, status, _ = await self.client.command(
            {"prefix": "osd pool selfmanaged-snap rm",
             "pool": self.pool_name, "snapid": snapid}
        )
        if code < 0:
            raise RadosError(code, status)

    async def _wait_snap_seq(self, snapid: int, timeout: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            pool = self.client.osdmap.lookup_pool(self.pool_name)
            if pool is not None and pool.snap_seq >= snapid:
                return
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise RadosError(-EAGAIN, "snap not visible in map")
            await self.client._wait_for_map_change(
                self.client.osdmap.epoch, remaining
            )

    async def rollback(self, oid: str, snap: "str | int") -> None:
        """Restore ``oid`` to its state at the snap (rados rollback)."""
        snapid = (
            await self.lookup_snap(snap) if isinstance(snap, str) else snap
        )
        reply = await self._op_w(
            oid, [{"op": "rollback", "snapid": snapid}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"rollback {oid}@{snapid}")

    async def list_snaps(self, oid: str) -> dict:
        """The object's SnapSet: seq, clones with their snaps/sizes."""
        reply = await self.client.operate(
            self.pool_name, oid, [{"op": "list_snaps"}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"list_snaps {oid}")
        return reply.out[0]["snapset"]

    # -- object I/O ----------------------------------------------------------
    # Write payloads travel as borrowed views (zero-copy contract,
    # msg/message.py): the caller's buffer is sliced into the frame
    # segments directly and must stay unmutated until the op completes
    # (resends reuse the same views).
    async def write_full(self, oid: str, data: bytes) -> None:
        reply = await self._op_w(
            oid, [{"op": "writefull", "data": 0}], [data]
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"write_full {oid}")

    async def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        reply = await self._op_w(
            oid, [{"op": "write", "offset": offset, "data": 0}], [data]
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"write {oid}")

    async def append(self, oid: str, data: bytes) -> None:
        reply = await self._op_w(
            oid, [{"op": "append", "data": 0}], [data]
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"append {oid}")

    async def truncate(self, oid: str, size: int) -> None:
        reply = await self._op_w(oid, [{"op": "truncate", "size": size}], [])
        if reply.result < 0:
            raise RadosError(reply.result, f"truncate {oid}")

    async def zero(self, oid: str, offset: int, length: int) -> None:
        reply = await self._op_w(
            oid, [{"op": "zero", "offset": offset, "length": length}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"zero {oid}")

    async def read(self, oid: str, offset: int = 0, length: int = 0,
                   *, copy: bool = True) -> bytes:
        """Read an extent.  ``copy=False`` returns the reply frame's
        ``memoryview`` directly (zero-copy — the view pins the frame
        buffer; the striper's gather path uses this); the default
        materializes independent bytes for API compatibility, and that
        copy is accounted (``data_path.copied_bytes_client_read``)."""
        reply = await self._op_r(
            oid, [{"op": "read", "offset": offset, "length": length}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"read {oid}")
        blob = reply.blobs[reply.out[0]["data"]]
        if not copy:
            return blob
        note_copy("client_read", len(blob))
        return bytes(blob)  # copy-ok: independent-bytes API default

    async def remove(self, oid: str) -> None:
        reply = await self._op_w(oid, [{"op": "delete"}], [])
        if reply.result < 0:
            raise RadosError(reply.result, f"remove {oid}")

    async def stat(self, oid: str) -> int:
        """Returns object size."""
        reply = await self._op_r(oid, [{"op": "stat"}], [])
        if reply.result < 0:
            raise RadosError(reply.result, f"stat {oid}")
        return reply.out[0]["size"]

    # -- xattrs (reference librados rados_setxattr/getxattr/rmxattr)
    async def setxattr(self, oid: str, key: str, value: bytes) -> None:
        reply = await self._op_w(
            oid, [{"op": "setxattr", "key": key, "data": 0}], [bytes(value)]
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"setxattr {oid} {key}")

    async def getxattr(self, oid: str, key: str) -> bytes:
        reply = await self._op_r(oid, [{"op": "getxattr", "key": key}], [])
        out = reply.out[0]
        if reply.result < 0 or out.get("rval", 0) < 0:
            raise RadosError(
                min(reply.result, out.get("rval", 0)), f"getxattr {oid} {key}"
            )
        return bytes(reply.blobs[out["data"]])

    async def rmxattr(self, oid: str, key: str) -> None:
        reply = await self._op_w(oid, [{"op": "rmxattr", "key": key}], [])
        if reply.result < 0:
            raise RadosError(reply.result, f"rmxattr {oid} {key}")

    async def getxattrs(self, oid: str) -> dict[str, bytes]:
        reply = await self._op_r(oid, [{"op": "getxattrs"}], [])
        if reply.result < 0:
            raise RadosError(reply.result, f"getxattrs {oid}")
        out = reply.out[0]
        return {
            k: bytes(reply.blobs[bi]) for k, bi in out.get("attrs", {}).items()
        }

    # -- watch / notify (reference librados rados_watch/notify) --------------
    async def watch(self, oid: str, callback) -> str:
        """Watch ``oid``: ``callback(notifier, payload)`` runs on every
        notify (may be async).  Returns the watch cookie.  The watch
        re-registers itself if the OSD connection resets (linger)."""
        cookie = f"{self.client.name}.w{next(self.client._watch_cookie)}"
        # register the callback BEFORE the op commits: the OSD may fan a
        # notify at us the instant the watch lands, and an acked notify
        # whose callback never ran is a silent loss
        self.client._watches[cookie] = {
            "pool": self.pool_name, "oid": oid, "callback": callback,
            "conn": None,
        }
        try:
            reply = await self.client.operate(
                self.pool_name, oid, [{"op": "watch", "cookie": cookie}], []
            )
            if reply.result < 0:
                raise RadosError(reply.result, f"watch {oid}")
            self.client._watches[cookie]["conn"] = (
                await self.client._primary_conn(self.pool_name, oid)
            )
        except BaseException:
            self.client._watches.pop(cookie, None)
            raise
        return cookie

    async def unwatch(self, cookie: str) -> None:
        w = self.client._watches.pop(cookie, None)
        if w is None:
            return
        reply = await self.client.operate(
            self.pool_name, w["oid"], [{"op": "unwatch", "cookie": cookie}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"unwatch {w['oid']}")

    async def notify(
        self, oid: str, payload: bytes = b"", timeout: float = 5.0
    ) -> dict:
        """Notify every watcher; returns {"acks": {cookie: reply_bytes},
        "missed": [cookie]} after all acks or the timeout."""
        # the op must outlive the OSD-side ack gather, or operate()'s
        # retry would fan duplicate notifies at every watcher
        # client-chosen notify id: if operate()'s retry loop resends the
        # op, the OSD dedupes on it instead of double-firing callbacks
        nid = f"{self.client.name}.n{next(self.client._tid)}"
        reply = await self.client.operate(
            self.pool_name, oid,
            [{"op": "notify", "data": 0, "timeout": timeout, "nid": nid}],
            [bytes(payload)],
            op_timeout=timeout + 5.0,
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"notify {oid}")
        out = reply.out[0]
        return {
            "acks": {
                c: bytes(reply.blobs[bi]) for c, bi in out["acks"].items()
            },
            "missed": out["missed"],
        }

    # -- object classes (reference librados rados_exec) ----------------------
    async def exec(
        self, oid: str, cls: str, method: str,
        input: dict | None = None, data: bytes | None = None,
    ) -> dict:
        """Invoke an in-OSD object-class method atomically on ``oid``."""
        op = {"op": "call", "cls": cls, "method": method,
              "input": input or {}}
        blobs: list[bytes] = []
        if data is not None:
            op["data"] = 0
            blobs.append(bytes(data))
        reply = await self._op_w(oid, [op], blobs)
        out = reply.out[0]
        if reply.result < 0 or out.get("rval", 0) < 0:
            raise RadosError(
                min(reply.result, out.get("rval", 0)),
                out.get("error", f"exec {cls}.{method} on {oid}"),
            )
        return out.get("ret", {})

    # -- omap (replicated pools only; EC pools answer -EOPNOTSUPP like
    #    the reference, reference:src/osd/PrimaryLogPG.cc do_osd_ops)
    async def omap_set(self, oid: str, kv: dict[str, bytes]) -> None:
        keys = {}
        blobs = []
        for k, v in kv.items():
            keys[k] = len(blobs)
            blobs.append(bytes(v))
        reply = await self._op_w(
            oid, [{"op": "omap_setkeys", "keys": keys}], blobs
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"omap_set {oid}")

    async def omap_get(self, oid: str) -> dict[str, bytes]:
        reply = await self._op_r(oid, [{"op": "omap_get"}], [])
        if reply.result < 0:
            raise RadosError(reply.result, f"omap_get {oid}")
        out = reply.out[0]
        return {
            k: bytes(reply.blobs[bi]) for k, bi in out.get("keys", {}).items()
        }

    async def omap_get_keys(
        self, oid: str, keys: list[str]
    ) -> dict[str, bytes]:
        """Keyed omap lookup: only the named keys travel the wire
        (reference:librados omap_get_vals_by_keys)."""
        reply = await self._op_r(
            oid, [{"op": "omap_get_keys", "keys": list(keys)}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"omap_get_keys {oid}")
        out = reply.out[0]
        return {
            k: bytes(reply.blobs[bi]) for k, bi in out.get("keys", {}).items()
        }

    async def omap_get_range(
        self, oid: str, *, start_after: str = "", prefix: str = "",
        max_entries: int = 1000,
    ) -> tuple[dict[str, bytes], bool]:
        """One sorted page of omap entries strictly after
        ``start_after`` under ``prefix``: (page, truncated) — the
        reference's omap_get_vals(start_after, filter_prefix,
        max_return)."""
        reply = await self._op_r(
            oid, [{"op": "omap_get_range", "start_after": start_after,
                   "prefix": prefix, "max_entries": int(max_entries)}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"omap_get_range {oid}")
        out = reply.out[0]
        page = {
            k: bytes(reply.blobs[bi]) for k, bi in out.get("keys", {}).items()
        }
        return page, bool(out.get("truncated"))

    async def omap_rmkeys(self, oid: str, keys: list[str]) -> None:
        reply = await self._op_w(
            oid, [{"op": "omap_rmkeys", "keys": list(keys)}], []
        )
        if reply.result < 0:
            raise RadosError(reply.result, f"omap_rmkeys {oid}")
