"""Log-based recovery: peering + shard backfill.

Re-expression of the reference recovery flow (reference:src/osd/PG.h:1654
RecoveryMachine Peering/GetInfo/GetLog/GetMissing/Active/Recovering and
reference:src/osd/ECBackend.cc:520 continue_recovery_op) for the
mini-cluster:

1. On every map epoch change, the primary of each PG runs the peering
   phases (``osd/peering.py``):
   - GetInfo/GetLog: every acting shard reports its object set, pg log,
     PGShardInfo (last_epoch_started + log-derived last_update), and
     recorded past intervals in one MOSDPGScan round trip.
   - prior set: past-interval members not in the acting set are scanned
     as strays (reference PG::build_prior) — they may hold writes a
     stale-interval primary landed during a partition.
   - authoritative selection: find_best_info — max last_epoch_started
     FIRST (interval order), then max last_update, then longest log.
   - GetMissing: entries past the authoritative head on stale-interval
     members are DIVERGENT — rolled back from their per-entry stashes
     (reference:src/osd/PGLog.cc _merge_divergent_entries), never
     merged.  Same-interval in-flight tails are arbitrated by the
     decodability check below (roll forward iff >= k shards hold the
     version; stash-rollback otherwise).
   - activation: a clean pass persists the new last_epoch_started on
     every reachable member, fencing older intervals out of future
     find_best_info rounds.
2. Authoritative-interval logs and object sets then merge into the
   per-object state — newest version wins within the interval, a delete
   entry at the newest version wins over older modifies.
3. Divergence repair:
   - a shard missing an object (or holding a stale version) gets the
     object's chunk rebuilt — the primary reads+decodes the object from
     the healthy shards (the §3.3 reconstruct path,
     reference:src/osd/ECBackend.cc:376 handle_recovery_read_complete ->
     ECUtil::decode), re-encodes (one batched device call), and pushes
     the shard's chunk as a normal sub-write transaction
     (reference: RecoveryOp WRITING state / MOSDPGPush);
   - a shard holding an object the authoritative log says is deleted
     gets a remove transaction (reference: divergent-entry rollback,
     reference:doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27).

Replicated PGs recover the same way with whole-object pushes
(reference:src/osd/ReplicatedBackend.cc pull/push).

Counterpart of ``ceph_tpu/osd/recovery.py``, whole.  Its reads and
re-encodes go through the hosting OSD (``osd._ec_read`` and
``osd._ec_encode_bufs``), so on the card a backfill's decode and its
re-encode run ``gf_matmul`` (or ``bitmatrix_xor`` for a bit-matrix
pool) through the OSD's dispatcher, under the ``recovery`` QoS class.
"""

from __future__ import annotations

import asyncio
import json
import logging

from ..common.tracing import current_trace, new_trace_id, record_span
from ..msg import messages
from ..store import CollectionId, ObjectId, Transaction
from .ec_util import StripeHashes
from . import ec_util, peering
from .osdmap import CRUSH_ITEM_NONE, PGid, Pool, POOL_TYPE_ERASURE
from .pg_log import (
    Eversion,
    PGLogEntry,
    is_stash_name,
    meta_oid,
    read_log,
    stash_name,
)

logger = logging.getLogger("ceph_tpu_torch.osd.recovery")

OI_KEY = "_"
ENOENT = 2


class RecoveryManager:
    """Drives recovery for the PGs this OSD currently leads."""

    def __init__(self, osd):
        self.osd = osd
        self._scan_waiters: dict[int, "_ScanWaiter"] = {}
        self._task: asyncio.Task | None = None
        self._wakeup = asyncio.Event()
        self._retry_needed = False
        # remote-reservation round trips in flight (tid -> (future, osd))
        self._reserve_waiters: dict[int, tuple[asyncio.Future, int]] = {}
        # grant tasks running on behalf of remote primaries
        self._grant_tasks: set[asyncio.Task] = set()
        # osd_recovery_max_active instrumentation: concurrent object
        # pushes this primary has in flight, with high-water mark
        self.active_pushes = 0
        self.max_active_pushes = 0
        # peering re-entrancy: one pass runs at a time; map
        # epochs arriving faster than passes complete COALESCE into the
        # one pending wakeup (counted), never stack concurrent passes.
        # _pass_map is the epoch SNAPSHOT the running pass computes
        # against — acting sets, stray reachability and the activation
        # les all come from one map, so a mid-pass push can never mix
        # two epochs' views (the newer epoch re-kicks a whole pass)
        self._pass_running = False
        self._pass_map = None
        # PGs whose remote reservation was revoked mid-pass: the push
        # loop stops STARTING new pushes for them (in-flight ones
        # finish — single bounded sub-writes) so preemption actually
        # frees the target's osd_max_backfills slot
        self._revoked: set[str] = set()

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for t in list(self._grant_tasks):
            t.cancel()
        self._grant_tasks.clear()

    @property
    def recoveries_done(self) -> int:
        """Pushes completed — reads through the perf counter so the
        manager and `perf dump` can never disagree."""
        return self.osd.perf.get("recovery").get("pushes")

    def kick(self) -> None:
        """Called on every new map epoch.  Kicks while a pass is
        running (or one is already pending) coalesce — the set event
        absorbs them into exactly one follow-up pass on the NEWEST
        map, the re-entrancy contract the storm matrix pins."""
        prec = self.osd.perf.get("recovery")
        prec.inc("kicks")
        if self._pass_running or self._wakeup.is_set():
            prec.inc("coalesced_kicks")
        self._wakeup.set()

    def fail_member(self, osd_id: int) -> None:
        """A peer's connection reset: release scans it owed us."""
        for w in list(self._scan_waiters.values()):
            w.fail_member(osd_id)
        for tid, (fut, member) in list(self._reserve_waiters.items()):
            if member == osd_id and not fut.done():
                fut.set_exception(ConnectionError(f"osd.{osd_id} reset"))
        self._retry_needed = True

    # -- scan plumbing --------------------------------------------------------

    def handle_scan(self, conn, msg: messages.MOSDPGScan) -> None:
        """Shard side: report objects + log + info + past intervals for
        one PG shard (GetInfo + GetLog in one round trip)."""
        self.osd.perf.get("recovery").inc("scans_served")
        objects, log, info, intervals = self._local_scan(
            msg.pgid, msg.store_shard
        )
        conn.send(
            messages.MOSDPGScanReply(
                pgid=msg.pgid, tid=msg.tid, shard=msg.shard,
                objects=objects, log=log, info=info, intervals=intervals,
            )
        )

    def handle_scan_reply(self, msg: messages.MOSDPGScanReply) -> None:
        w = self._scan_waiters.get(msg.tid)
        if w:
            w.complete(
                msg.shard, msg.objects, msg.log, msg.info, msg.intervals
            )

    # -- reservation protocol (admission control) ------------------------------

    def handle_reserve(self, conn, msg: messages.MRecoveryReserve) -> None:
        """Both sides of the remote-reservation exchange
        (reference:src/messages/MRecoveryReserve.h): as push TARGET we
        queue the request on our remote reserver and send the grant when
        a slot frees; as PRIMARY we resolve the waiting future."""
        if msg.op == "request":
            key = (msg.from_osd, msg.pgid)

            def _on_preempt(key=key, conn=conn, pgid=msg.pgid):
                # a strictly-higher-priority PG evicted this grant
                # (reference AsyncReserver preempt_by_prio + the
                # MBackfillReserve REVOKE flow): tell the primary its
                # slot is gone so it stops pushing and re-reserves
                try:
                    conn.send(messages.MRecoveryReserve(
                        pgid=pgid, tid=0, from_osd=self.osd.osd_id,
                        op="revoke", prio=0,
                    ))
                # swallow-ok: primary already gone; its reset frees everything
                except (ConnectionError, OSError):
                    pass

            # the grant is REVOCABLE (on_preempt): under backfill-vs-
            # recovery contention a more-degraded PG's request preempts
            # a less-degraded one's held slot instead of queueing
            # behind it (the storm matrix exercises this at scale)
            fut = self.osd.remote_reserver.request(
                key, msg.prio or 0, on_preempt=_on_preempt
            )
            if not fut.done():
                # contention is visible on the OSD whose slots are full
                self.osd.perf.get("recovery").inc("reservation_waits")

            async def _grant():
                try:
                    await fut
                # swallow-ok: daemon stopping: the grant task dies with its reserver
                except asyncio.CancelledError:
                    return
                try:
                    conn.send(
                        messages.MRecoveryReserve(
                            pgid=msg.pgid, tid=msg.tid,
                            from_osd=self.osd.osd_id, op="grant", prio=0,
                        )
                    )
                # swallow-ok: primary vanished pre-grant; the slot is cancelled back
                except (ConnectionError, OSError):
                    # primary vanished before the grant: free the slot
                    self.osd.remote_reserver.cancel(key)

            t = asyncio.ensure_future(_grant())
            self._grant_tasks.add(t)
            t.add_done_callback(self._grant_tasks.discard)
        elif msg.op == "grant":
            entry = self._reserve_waiters.get(msg.tid)
            if entry and not entry[0].done():
                entry[0].set_result(True)
        elif msg.op == "release":
            self.osd.remote_reserver.cancel((msg.from_osd, msg.pgid))
        elif msg.op == "revoke":
            # primary side of a preemption: a push target took our slot
            # away for a higher-priority PG.  The in-flight pushes to it
            # finish (they are single bounded sub-writes), the pass is
            # flagged for retry and re-reserves at its own priority
            self.osd.perf.get("recovery").inc("reservations_revoked")
            logger.info(
                "%s: recovery reservation for pg %s revoked by osd.%d",
                self.osd.name, msg.pgid, msg.from_osd,
            )
            self._revoked.add(msg.pgid)
            self._retry_needed = True
            self._wakeup.set()

    async def _acquire_reservations(
        self, pg: PGid, members: set[int], prio: int = 0
    ) -> list[int] | None:
        """Local slot first, then one remote slot per distinct push
        target (reference PG states WaitLocalRecoveryReserved ->
        WaitRemoteRecoveryReserved).  Returns the remote members to
        release later, or None when the budget ran out — the caller
        defers the pass, releasing everything, so a queued cluster
        cannot deadlock on criss-cross reservations.  ``prio`` is the
        PG's recovery priority (more degraded = higher, the reference's
        get_recovery_priority shape): it orders reserver queues and may
        PREEMPT a held lower-priority revocable grant on a full
        target."""
        osd = self.osd
        perf = osd.perf.get("recovery")
        timeout = osd.config.get("osd_recovery_reserve_timeout")
        lkey = ("local", str(pg))
        lfut = osd.local_reserver.request(lkey, prio)
        if not lfut.done():
            perf.inc("reservation_waits")
        try:
            async with asyncio.timeout(timeout):
                await lfut
        # swallow-ok: reservation timeout = deferred pass (slot cancelled, caller retries)
        except TimeoutError:
            osd.local_reserver.cancel(lkey)
            return None
        except asyncio.CancelledError:
            osd.local_reserver.cancel(lkey)
            raise
        held: list[int] = []
        try:
            for member in sorted(m for m in members if m != osd.osd_id):
                ok = await self._reserve_remote(pg, member, timeout, prio)
                if not ok:
                    self._release_reservations(pg, held)
                    return None
                held.append(member)
            # self-pushes take our own remote slot directly (local fast
            # path)
            if osd.osd_id in members:
                sfut = osd.remote_reserver.request(
                    (osd.osd_id, str(pg)), prio
                )
                if not sfut.done():
                    perf.inc("reservation_waits")
                try:
                    async with asyncio.timeout(timeout):
                        await sfut
                # swallow-ok: self-slot timeout = deferred pass (slots released, caller retries)
                except TimeoutError:
                    osd.remote_reserver.cancel((osd.osd_id, str(pg)))
                    self._release_reservations(pg, held)
                    return None
                held.append(osd.osd_id)
        except asyncio.CancelledError:
            # daemon stop/restart mid-acquisition: the local slot and
            # every slot gathered so far must not outlive the task
            self._release_reservations(pg, held)
            raise
        return held

    async def _reserve_remote(
        self, pg: PGid, member: int, timeout: float, prio: int = 0
    ) -> bool:
        osd = self.osd
        m = self._map()
        addr = m.get_addr(member) if m else None
        if not addr:
            return False
        tid = osd._new_tid()
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._reserve_waiters[tid] = (fut, member)
        try:
            conn = await osd.messenger.connect(addr, f"osd.{member}")
            conn.send(
                messages.MRecoveryReserve(
                    pgid=str(pg), tid=tid, from_osd=osd.osd_id,
                    op="request", prio=prio,
                )
            )
            async with asyncio.timeout(timeout):
                await fut
            return True
        # swallow-ok: reserve failed/timed out: slot withdrawn, pass defers
        except (TimeoutError, ConnectionError, OSError):
            self._withdraw_remote(pg, addr, member)
            return False
        except asyncio.CancelledError:
            # task cancelled mid-wait (stop/repeering): the target may
            # grant later with nobody listening — withdraw or its slot
            # leaks for good
            self._withdraw_remote(pg, addr, member)
            raise
        finally:
            self._reserve_waiters.pop(tid, None)

    def _withdraw_remote(self, pg: PGid, addr, member: int) -> None:
        """Fire-and-forget release keeping the target's queue clean when
        a request is abandoned (timeout, error, cancellation)."""
        osd = self.osd

        async def _send():
            try:
                conn = await osd.messenger.connect(addr, f"osd.{member}")
                conn.send(
                    messages.MRecoveryReserve(
                        pgid=str(pg), tid=0, from_osd=osd.osd_id,
                        op="release", prio=0,
                    )
                )
            # swallow-ok: peer death frees the slot via ms_handle_reset
            except (ConnectionError, OSError):
                pass  # peer death frees the slot via ms_handle_reset

        t = asyncio.ensure_future(_send())
        self._grant_tasks.add(t)
        t.add_done_callback(self._grant_tasks.discard)

    def _release_reservations(self, pg: PGid, remote_members: list[int]) -> None:
        osd = self.osd
        osd.local_reserver.cancel(("local", str(pg)))
        for member in remote_members:
            if member == osd.osd_id:
                osd.remote_reserver.cancel((osd.osd_id, str(pg)))
                continue
            m = self._map()
            addr = m.get_addr(member) if m else None
            if not addr:
                continue

            async def _send_release(addr=addr, member=member):
                try:
                    conn = await osd.messenger.connect(addr, f"osd.{member}")
                    conn.send(
                        messages.MRecoveryReserve(
                            pgid=str(pg), tid=0, from_osd=osd.osd_id,
                            op="release", prio=0,
                        )
                    )
                # swallow-ok: peer death already freed the slot (ms_handle_reset)
                except (ConnectionError, OSError):
                    pass  # peer death already freed the slot (ms_handle_reset)

            t = asyncio.ensure_future(_send_release())
            self._grant_tasks.add(t)
            t.add_done_callback(self._grant_tasks.discard)

    def _local_scan(
        self, pgid: str, shard: int
    ) -> tuple[dict, list, dict, list]:
        store = self.osd.store
        cid = CollectionId(f"{pgid}s{shard}" if shard >= 0 else pgid)
        objects: dict[str, dict] = {}
        try:
            oids = store.list_objects(cid)
        # swallow-ok: collection absent = empty shard scan (nothing stored yet)
        except KeyError:
            return {}, [], peering.PGShardInfo().to_dict(), []
        log_entries = read_log(store, cid, shard)
        # last applied version per object comes from the shard's own log —
        # replicated partial writes never rewrite the OI xattr, and EC
        # recovery pushes carry the authoritative version in their entry
        last_ver: dict[str, list[int]] = {}
        for e in log_entries:
            last_ver[e.oid] = e.version.to_list()
        for oid in oids:
            if oid.name == "_pgmeta_" or is_stash_name(oid.name):
                continue
            try:
                oi = json.loads(store.getattr(cid, oid, OI_KEY))
            # swallow-ok: no object-info xattr yet: version comes from the log
            except KeyError:
                oi = {}
            version = max(
                tuple(oi.get("version", [0, 0])),
                tuple(last_ver.get(oid.name, (0, 0))),
            )
            objects[oid.name] = {
                "version": list(version),
                "size": oi.get("size", 0),
            }
        log = [e.to_dict() for e in log_entries]
        # GetInfo payload: stored les + log-derived last_update, plus
        # this member's recorded past intervals (for the prior set)
        stored_info, intervals_raw = None, None
        try:
            omap = store.omap_get(cid, meta_oid(shard))
            raw = omap.get(peering.INFO_KEY)
            stored_info = json.loads(raw) if raw else None
            intervals_raw = omap.get(peering.PAST_INTERVALS_KEY)
        # swallow-ok: no pgmeta omap yet: fresh shard, default info
        except KeyError:
            pass
        info = peering.derive_info(stored_info, log_entries).to_dict()
        intervals = [
            iv.to_list()
            for iv in peering.PastIntervals.from_json(intervals_raw).intervals
        ]
        return objects, log, info, intervals

    # -- the recovery loop ----------------------------------------------------

    async def _loop(self) -> None:
        try:
            while True:
                await self._wakeup.wait()
                self._wakeup.clear()
                self._retry_needed = False
                self._pass_running = True
                self.osd.perf.get("recovery").inc("passes")
                try:
                    await self._recover_all()
                except asyncio.CancelledError:
                    raise
                # swallow-ok: pass flagged for retry below (and logged)
                except Exception:
                    logger.exception("%s: recovery pass failed", self.osd.name)
                    self._retry_needed = True
                finally:
                    self._pass_running = False
                if self._retry_needed and not self._wakeup.is_set():
                    # partial pass (peer raced away): back off and retry
                    await asyncio.sleep(0.5)
                    self._wakeup.set()
        # swallow-ok: daemon stop: the recovery loop ends
        except asyncio.CancelledError:
            pass

    async def _recover_all(self) -> None:
        osd = self.osd
        if osd.osdmap is None:
            return
        # one epoch snapshot for the WHOLE pass: a map push landing
        # mid-pass must not mix two epochs' acting sets inside one PG's
        # peering (the re-entrancy invariant) — the push's kick() is
        # already pending, so the newer map gets its own full pass
        m = self._pass_map = osd.osdmap
        try:
            flags = m.cluster_flags
            if "norecover" in flags or "nobackfill" in flags:
                # `ceph osd set norecover|nobackfill` parks the pass; the
                # unset's map epoch re-kicks it (recovery and backfill are
                # one unified push path here, so either flag parks it)
                self._retry_needed = False
                return
            for pool in list(m.pools.values()):
                for pg in m.pgs_of_pool(pool.id):
                    _up, _upp, acting, primary = m.pg_to_up_acting_osds(pg)
                    if primary != osd.osd_id:
                        continue
                    try:
                        await self._recover_pg(pg, pool, acting)
                    except asyncio.CancelledError:
                        raise
                    # swallow-ok: pg pass flagged for retry (and logged)
                    except Exception:
                        logger.exception(
                            "%s: recovery of pg %s failed", osd.name, pg
                        )
                        self._retry_needed = True
            if osd.osdmap is not m:
                # a newer epoch landed mid-pass; its kick is pending,
                # so the whole pass re-runs against the new map
                osd.perf.get("recovery").inc("interrupted_passes")
        finally:
            self._pass_map = None

    def _map(self):
        """The running pass's epoch snapshot (the live map outside a
        pass) — every map read on the peering/push path goes through
        here so one pass sees one epoch."""
        return self._pass_map if self._pass_map is not None \
            else self.osd.osdmap

    async def _recover_pg(self, pg: PGid, pool: Pool, acting: list[int]) -> None:
        osd = self.osd
        # every recovery pass of a PG is one traced operation: the id
        # rides the frame header of each MOSDPGScan
        # round trip and each push sub-write the pass sends, the EC
        # dispatcher's _Op.trace picks it up (so dump_launch_history
        # finds a slow recovery decode by this id), and the peering/push
        # spans below land in the op waterfall ring
        trace = new_trace_id(f"osd.{osd.osd_id}-rec-{pg}")
        tok = current_trace.set(trace)
        try:
            await self._recover_pg_traced(pg, pool, acting, trace)
        finally:
            current_trace.reset(tok)

    async def _recover_pg_traced(
        self, pg: PGid, pool: Pool, acting: list[int], trace: str
    ) -> None:
        osd = self.osd
        erasure = pool.type == POOL_TYPE_ERASURE
        if erasure:
            shards = {
                s: o for s, o in enumerate(acting) if o != CRUSH_ITEM_NONE
            }
        else:
            # replicated: every member plays the same role; key by osd id
            shards = {o: o for o in acting if o != CRUSH_ITEM_NONE}
        if not shards:
            return

        # -- GetInfo + GetLog: one scan round trip per acting member
        t0 = asyncio.get_event_loop().time()
        scans = await self._scan_shards(pg, shards, erasure)
        record_span(
            "peering_scan", t0, asyncio.get_event_loop().time() - t0,
            trace=trace, entity=f"osd.{osd.osd_id}", pg=str(pg),
            members=len(shards),
        )
        if scans is None:
            return
        infos = {
            k: peering.derive_info(
                r[2], [PGLogEntry.from_dict(e) for e in r[1]]
            )
            for k, r in scans.items()
        }
        auth_key = peering.find_best_info(infos)
        auth_info = (
            infos[auth_key] if auth_key is not None else peering.PGShardInfo()
        )

        # -- prior set (reference PG::build_prior): members of past
        # intervals since the authoritative les may hold writes from a
        # stale-interval primary; scan the reachable ones as strays
        past = peering.PastIntervals()
        for r in scans.values():
            if r[3]:
                past = past.merged_with(
                    peering.PastIntervals(
                        [peering.Interval.from_list(v) for v in r[3]]
                    )
                )
        strays = self._stray_targets(
            pg, erasure, shards, past, auth_info.last_epoch_started
        )
        stray_scans: dict[int, tuple] = {}
        if strays:
            got = await self._scan_shards(
                pg, {k: m for k, (m, _s) in strays.items()}, erasure,
                store_shards={k: s for k, (_m, s) in strays.items()},
            )
            stray_scans = got or {}
            # find_best_info must see stray infos too:
            # a past-interval member that peered a NEWER interval than
            # the whole acting set holds the authoritative history — the
            # acting set's view must not outvote it
            stray_infos = {
                k: peering.derive_info(
                    r[2], [PGLogEntry.from_dict(e) for e in r[1]]
                )
                for k, r in stray_scans.items()
            }
            best_all = peering.find_best_info({**infos, **stray_infos})
            if best_all is not None and best_all in stray_infos and (
                stray_infos[best_all].last_epoch_started
                > auth_info.last_epoch_started
            ):
                # the newest peered interval lives OUTSIDE the acting
                # set: anything we rolled back or repaired now would
                # destroy acked writes.  Defer — the surviving holders
                # are up (we just scanned them), so the map/backfill
                # will converge acting toward them (reference: the
                # pg_temp/backfill path; PG waits rather than judges)
                logger.warning(
                    "%s: %s authoritative history is on stray osd.%d "
                    "(les %d > acting %d): deferring recovery pass",
                    osd.name, pg, strays[best_all][0],
                    stray_infos[best_all].last_epoch_started,
                    auth_info.last_epoch_started,
                )
                self._retry_needed = True
                return

        # -- GetMissing: a STALE-interval member's entries are valid
        # only up to what the authoritative history knows about that
        # object; anything past that is divergent — rolled back from
        # stashes, never merged (reference:src/osd/PGLog.cc
        # _merge_divergent_entries; ecbackend.rst rollback design).
        # The boundary is PER OBJECT (the auth log's newest version of
        # that oid), not the global head: a stale write at a lower
        # global version must not slip under the cap.
        # Same-interval tails stay: the decodability check in
        # _repair_object arbitrates in-flight writes (roll-forward when
        # >= k shards hold the version, stash-rollback otherwise).
        max_les = auth_info.last_epoch_started
        auth_vers = (
            self._object_versions(scans[auth_key])
            if auth_key is not None else {}
        )
        # an EMPTY authoritative history cannot declare anything
        # divergent: with no reachable member of the data's interval the
        # safe state is "wait", never "destroy" (the down/incomplete
        # rule, reference PG::choose_acting)
        can_judge = bool(auth_vers) or auth_info.last_update > Eversion()
        for key, r in {**scans, **stray_scans}.items():
            if key == auth_key or not can_judge:
                continue
            stored_les = peering.PGShardInfo.from_dict(r[2]).last_epoch_started
            if stored_les >= max_les:
                # same-interval member (acting or stray): an in-flight
                # tail, arbitrated by the decodability machinery — never
                # unconditionally rolled back
                continue
            div = peering.divergent_entries_per_object(
                auth_vers, [PGLogEntry.from_dict(e) for e in r[1]],
            )
            if not div:
                continue
            if erasure:
                unacked = await self._unacked_entries(pg, shards, acting, past, div)
                for e in div:
                    if e not in unacked and e.version > auth_vers.get(e.oid, Eversion()):
                        # possibly acked: state, which the repair pass
                        # rolls forward, never a rollback
                        auth_vers[e.oid] = e.version
                div = unacked
                if not div:
                    continue
            member, store_shard = (
                strays[key] if key in stray_scans
                else (shards[key], key if erasure else -1)
            )
            await self._rollback_divergent(
                pg, erasure, member, store_shard, div
            )

        authoritative = self._merge(scans, infos, auth_info, auth_vers)

        # -- admission control: peering above ran unthrottled (the
        # reference never throttles GetInfo/GetLog), but data movement
        # needs a local + per-target remote reservation slot
        # (osd_max_backfills) and runs at most osd_recovery_max_active
        # object pushes concurrently (reference:src/common/
        # config_opts.h:621,:801; PG.h WaitLocalRecoveryReserved)
        work: list[tuple[str, dict]] = []
        for oid, state in authoritative.items():
            if state["op"] == "delete":
                if any(oid in scans.get(k, ({}, []))[0] for k in shards):
                    work.append((oid, state))
            elif self._scan_stale(scans, shards, oid, state):
                work.append((oid, state))
        if work:
            # recovery priority: more outstanding repair work = more
            # degraded = higher priority (the coarse shape of the
            # reference's get_recovery_priority) — under a full
            # reserver a badly-degraded PG preempts a nearly-clean
            # one's revocable grant instead of queueing behind it
            prio = min(250, len(work))
            self._revoked.discard(str(pg))  # fresh reservation round
            held = await self._acquire_reservations(
                pg, set(shards.values()), prio
            )
            if held is None:
                self._retry_needed = True
                return
            try:
                max_active = max(
                    1, int(osd.config.get("osd_recovery_max_active"))
                )
                sem = asyncio.Semaphore(max_active)

                async def _one(oid: str, state: dict) -> None:
                    if str(pg) in self._revoked:
                        # the target took our slot away mid-pass: stop
                        # STARTING pushes; the retry pass re-reserves
                        self._retry_needed = True
                        return
                    async with sem:
                        # QoS grant per object push (the reference's
                        # PGRecovery items in the op queue): recovery
                        # asks the scheduler instead of free-running,
                        # so a storm backs off behind client traffic.
                        # No shed path: recovery's scheduler backlog is
                        # already bounded (the semaphore above caps
                        # waiters at osd_recovery_max_active, behind
                        # the osd_max_backfills reservations), so it
                        # queues instead of deferring
                        async with osd.scheduler.grant("recovery"):
                            self.active_pushes += 1
                            self.max_active_pushes = max(
                                self.max_active_pushes,
                                self.active_pushes,
                            )
                            try:
                                if state["op"] == "delete":
                                    await self._propagate_delete(
                                        pg, pool, erasure, shards,
                                        scans, oid, state,
                                    )
                                else:
                                    await self._repair_object(
                                        pg, pool, erasure, shards,
                                        scans, oid, state, acting, past,
                                    )
                            finally:
                                self.active_pushes -= 1

                results = await asyncio.gather(
                    *(_one(o, s) for o, s in work), return_exceptions=True
                )
                for r in results:
                    if isinstance(r, BaseException):
                        logger.error(
                            "%s: recovery push in %s failed: %r",
                            osd.name, pg, r,
                        )
                        self._retry_needed = True
            finally:
                self._release_reservations(pg, held)

        # -- activation: a clean pass peers this interval — bump every
        # reachable member's last_epoch_started so later-arriving writes
        # from older intervals can never win find_best_info
        # (reference PG::activate last_epoch_started update).
        # Gate: only an interval that REACHED the PG's history may
        # activate — bumping les from members that hold neither data,
        # log, nor a prior les would fence out (and later destroy) the
        # real data when its holders return (the reference's
        # down/incomplete peering states)
        history_reached = any(
            i.last_epoch_started > 0 or i.log_len > 0 or scans[k][0]
            for k, i in infos.items()
        )
        if not self._retry_needed and history_reached:
            await self._activate(pg, erasure, shards, infos)

    @staticmethod
    def _scan_stale(
        scans: dict[int, tuple], shards: dict[int, int], oid: str,
        state: dict,
    ) -> bool:
        """True when any acting member's scan disagrees with the
        authoritative version — the cheap trigger for a repair."""
        return any(
            tuple(
                scans.get(key, ({}, []))[0].get(oid, {}).get(
                    "version", [-1, -1]
                )
            ) != tuple(state["version"])
            for key in shards
        )

    @staticmethod
    def _object_versions(scan: tuple) -> dict[str, Eversion]:
        """The authoritative member's newest known version per object
        (its listing + its log) — the per-object divergence boundary."""
        vers: dict[str, Eversion] = {}
        objects, log = scan[0], scan[1]
        for oid, info in objects.items():
            v = Eversion.from_list(info["version"])
            if v > vers.get(oid, Eversion()):
                vers[oid] = v
        for e in log:
            v = Eversion.from_list(e["version"])
            if v > vers.get(e["oid"], Eversion()):
                vers[e["oid"]] = v
        return vers

    def _stray_targets(
        self, pg: PGid, erasure: bool, shards: dict[int, int],
        past: peering.PastIntervals, since_les: int,
    ) -> dict[int, tuple[int, int]]:
        """{waiter_key: (osd_id, store_shard)} for reachable past-interval
        members not in the current acting set.  For EC intervals the
        member's index in the recorded acting list IS its shard key, so
        its stale chunks/log live in that shard collection."""
        osd = self.osd
        acting_members = set(shards.values())
        out: dict[int, tuple[int, int]] = {}
        claimed: set[tuple[int, int]] = set()
        for iv in sorted(
            past.intervals, key=lambda iv: iv.last, reverse=True
        ):
            if iv.last < since_les:
                continue
            for idx, member in enumerate(iv.acting):
                if not (0 <= member != CRUSH_ITEM_NONE) \
                        or member in acting_members:
                    continue
                m = self._map()
                if not m or not m.is_up(member) or not m.get_addr(member):
                    continue  # down: unreachable (see _repair_object defer)
                s = idx if erasure else -1
                if (member, s) in claimed:
                    continue
                claimed.add((member, s))
                out[1000 + len(out)] = (member, s)
        return out

    async def _scan_shards(
        self, pg: PGid, shards: dict[int, int], erasure: bool,
        store_shards: dict[int, int] | None = None,
    ) -> dict[int, tuple[dict, list, dict | None, list | None]] | None:
        """{key: (objects, log, info, intervals)} from every member,
        local fast path.  ``store_shards`` overrides the shard
        collection scanned per key (stray members keep their chunks in
        the shard collection of the interval they served)."""
        osd = self.osd
        tid = osd._new_tid()
        waiter = _ScanWaiter(set(shards), dict(shards))
        self._scan_waiters[tid] = waiter
        try:
            for key, member in shards.items():
                if store_shards is not None:
                    shard_field = store_shards[key]
                else:
                    shard_field = key if erasure else -1
                if member == osd.osd_id:
                    objects, log, info, ivs = self._local_scan(
                        str(pg), shard_field
                    )
                    waiter.complete(key, objects, log, info, ivs)
                    continue
                addr = self._map().get_addr(member)
                if not addr:
                    waiter.complete(key, {}, [])
                    continue
                try:
                    conn = await osd.messenger.connect(addr, f"osd.{member}")
                # swallow-ok: scan-era read raced a delete: next pass re-evaluates
                except (ConnectionError, OSError):
                    # stale map: member already dead.  Mark the PASS
                    # failed — an unreachable member completed as an
                    # empty scan would feed les=0 into find_best_info
                    # and let a stale member win authority for this
                    # pass; abort like a timeout does
                    # and let the newer epoch re-kick.
                    waiter.complete(key, {}, [])
                    waiter.failed.add(key)
                    self._retry_needed = True
                    continue
                conn.send(
                    messages.MOSDPGScan(
                        pgid=str(pg), tid=tid, shard=key,
                        store_shard=shard_field, from_osd=osd.osd_id,
                    )
                )
            try:
                async with asyncio.timeout(10.0):
                    await waiter.event.wait()
            # swallow-ok: scan timeout flags the pass for retry (logged)
            except TimeoutError:
                logger.warning("%s: scan of %s timed out", osd.name, pg)
                self._retry_needed = True
                return None
            if waiter.failed:
                logger.info(
                    "%s: scan of %s lost members %s; pass aborted",
                    osd.name, pg, sorted(waiter.failed),
                )
                self._retry_needed = True
                return None
            return waiter.results
        finally:
            del self._scan_waiters[tid]

    @staticmethod
    def _merge(
        scans: dict[int, tuple],
        infos: dict[int, "peering.PGShardInfo"] | None = None,
        auth_info: "peering.PGShardInfo | None" = None,
        auth_vers: dict[str, Eversion] | None = None,
    ) -> dict[str, dict]:
        """Authoritative per-object state (the merge_log outcome,
        reference:src/osd/PGLog.cc).

        Members of the AUTHORITATIVE interval (les == max les) merge in
        full: newest version wins, delete-at-newest wins — within one
        interval the primary serialized all writes, so version order is
        write order.  A STALE-interval member contributes, per object,
        only up to the version the authoritative history knows for that
        object (a global-head cap would let stale writes at lower
        version tuples through); everything past that is the
        divergent set the caller rolled back, never state.
        """
        state: dict[str, dict] = {}
        max_les = auth_info.last_epoch_started if auth_info else 0

        def consider(oid: str, op: str, version: list[int],
                     capped: bool) -> None:
            if capped:
                known = (auth_vers or {}).get(oid)
                if known is None or Eversion.from_list(version) > known:
                    return  # stale member past the auth history for oid
            cur = state.get(oid)
            if (
                cur is None
                or tuple(version) > tuple(cur["version"])
                # at equal version a delete log entry beats the listing of
                # a not-yet-removed object (no resurrection on ties)
                or (tuple(version) == tuple(cur["version"]) and op == "delete")
            ):
                state[oid] = {"op": op, "version": list(version)}

        for shard, r in scans.items():
            objects, log = r[0], r[1]
            les = (
                infos[shard].last_epoch_started
                if infos and shard in infos else max_les
            )
            capped = les < max_les
            for oid, info in objects.items():
                consider(oid, "modify", info["version"], capped)
            for e in log:
                consider(e["oid"], e["op"], e["version"], capped)
        return state

    async def _unacked_entries(
        self, pg: PGid, shards: dict[int, int], acting: list[int],
        past: "peering.PastIntervals", entries: list[PGLogEntry],
    ) -> list[PGLogEntry]:
        """The divergent EC entries that are provably never acked
        (``_proven_unacked`` on fresh reads).  A primary serves writes
        in a new interval before a clean recovery pass stamps its
        last_epoch_started, so a member can trail the authoritative les
        while holding a write that interval ACKED on every present
        member; the authoritative member, down in that interval, never
        saw it.  Rolling such an entry back loses acked data; left in
        place, the repair pass rolls it forward to the members that
        lack it (the caller merges them into the authoritative
        versions)."""
        out = []
        for e in entries:
            if not any(iv.first <= e.version.epoch <= iv.last for iv in past.intervals):
                # no member recorded the entry's interval (a returning
                # member may scan before the others note it): who was
                # present then is unknown, so nothing is proven
                continue
            async with self.osd.ec_exclusive(pg, e.oid):
                vers, _errs = await self._fresh_versions(pg, True, shards, e.oid)
            if self._proven_unacked(pg, tuple(e.version.to_list()), vers, acting, past):
                out.append(e)
        return out

    async def _rollback_divergent(
        self, pg: PGid, erasure: bool, member: int, store_shard: int,
        entries: list[PGLogEntry],
    ) -> None:
        """Undo divergent entries on one member, newest-first: restore
        each entry's stash (or remove the object the entry created) and
        retract the log record (reference:src/osd/PGLog.cc
        _merge_divergent_entries; stash mechanics per
        doc/dev/osd_internals/erasure_coding/ecbackend.rst)."""
        osd = self.osd
        cid = CollectionId(
            f"{pg}s{store_shard}" if erasure else str(pg)
        )
        for e in entries:  # newest-first from peering.divergent_entries
            soid = ObjectId(e.oid, store_shard if erasure else -1)
            txn = Transaction().create_collection(cid)
            if e.op == "modify" and e.prior_version == Eversion():
                txn.remove(cid, soid)  # entry created it: undo = remove
            elif e.op == "modify" and e.stash:
                txn.stash_restore(
                    cid, ObjectId(e.stash, store_shard if erasure else -1),
                    soid,
                )
            # no stash (trimmed, or a delete entry): content cannot be
            # restored locally — retract the log record and let the
            # repair pass push the authoritative version over it
            txn.omap_rmkeys(
                cid, meta_oid(store_shard), [e.version.key()]
            )
            logger.warning(
                "%s: rolling back divergent %s v%s on osd.%d shard %d",
                osd.name, e.oid, e.version, member, store_shard,
            )
            osd.clog(
                "warn",
                f"pg {pg} rolling back divergent {e.oid} v{e.version} "
                f"on osd.{member} shard {store_shard}",
            )
            if not await self._push_txn(pg, store_shard, member, txn, None):
                self._retry_needed = True
            else:
                osd.perf.get("recovery").inc("divergent_rollbacks")

    async def _activate(
        self, pg: PGid, erasure: bool, shards: dict[int, int],
        infos: dict[int, "peering.PGShardInfo"],
    ) -> None:
        """Peering completed for this interval: persist the new
        last_epoch_started on every reachable member (reference
        PG::activate).  From here on, any write a stale-interval primary
        managed to land loses find_best_info on les, whatever its
        version numbers say."""
        osd = self.osd
        # the SNAPSHOT epoch, not the live one: the les we persist must
        # name the interval this pass actually peered — a map landing
        # mid-pass would otherwise stamp an interval nobody scanned
        les = self._map().epoch if self._map() is not None else osd._epoch()
        for key, member in shards.items():
            if infos.get(key) and infos[key].last_epoch_started >= les:
                continue  # already at (or past) this interval
            store_shard = key if erasure else -1
            cid = CollectionId(f"{pg}s{store_shard}" if erasure else str(pg))
            txn = Transaction().create_collection(cid).omap_setkeys(
                cid, meta_oid(store_shard),
                {peering.INFO_KEY: json.dumps({"les": les}).encode()},
            )
            if not await self._push_txn(pg, store_shard, member, txn, None):
                self._retry_needed = True

    async def _fresh_versions(
        self, pg: PGid, erasure: bool, shards: dict[int, int], oid: str
    ) -> tuple[dict[int, tuple], dict[int, int]]:
        """Revalidation read (attrs only) of every member's copy of ``oid``.

        Returns ({key: version currently stored}, {key: errno}); call
        under the lock that excludes client mutations of ``oid`` — the
        per-object family lock (osd.obj_lock) for erasure pools, the pg
        lock for replicated ones — so the answer can't be invalidated by
        a client op on this object.  It says nothing about OTHER objects
        in the PG: EC client ops elsewhere proceed concurrently.
        """
        osd = self.osd
        _d, attrs, errs = await osd._read_shards(
            pg, oid, dict(shards), want_data=False,
            store_shard=None if erasure else -1,
        )
        vers: dict[int, tuple] = {}
        for k, a in attrs.items():
            if OI_KEY in a:
                vers[k] = tuple(json.loads(a[OI_KEY]).get("version", [0, 0]))
            else:
                vers[k] = (0, 0)
        return vers, errs

    async def _propagate_delete(
        self, pg: PGid, pool: Pool, erasure: bool,
        shards: dict[int, int], scans: dict[int, tuple[dict, list]],
        oid: str, state: dict,
    ) -> None:
        osd = self.osd
        # EC client ops serialize per object family incl. in-flight
        # extent writes (osd.ec_exclusive); replicated ones per PG —
        # take the matching exclusion so repair cannot race the client
        # path
        lock = osd.ec_exclusive(pg, oid) if erasure else osd.pg_lock(pg)
        async with lock:
            vers, errs = await self._fresh_versions(pg, erasure, shards, oid)
            if vers and max(vers.values()) > tuple(state["version"]):
                return  # re-created after the scan: nothing to delete
            entry = PGLogEntry(
                "delete", oid, Eversion.from_list(state["version"]), Eversion()
            )
            for key in vers:  # the members that still hold the object
                member = shards[key]
                shard_field = key if erasure else -1
                cid = CollectionId(f"{pg}s{key}" if erasure else str(pg))
                soid = ObjectId(oid, key if erasure else -1)
                txn = Transaction().create_collection(cid).remove(cid, soid)
                logger.info(
                    "%s: recovery removing resurrected %s from osd.%d",
                    osd.name, soid, member,
                )
                if await self._push_txn(pg, shard_field, member, txn, entry):
                    self.osd.perf.get("recovery").inc("pushes")

    async def _repair_object(
        self, pg: PGid, pool: Pool, erasure: bool,
        shards: dict[int, int], scans: dict[int, tuple[dict, list]],
        oid: str, state: dict, acting: list[int],
        past: "peering.PastIntervals | None" = None,
    ) -> None:
        # cheap pre-filter on scan-era data; the real decision re-reads
        # fresh state under the pg lock (a client op may have raced)
        if not self._scan_stale(scans, shards, oid, state):
            return
        osd = self.osd
        lock = osd.ec_exclusive(pg, oid) if erasure else osd.pg_lock(pg)
        async with lock:
            # up to a few rounds: an undecodable newest version is first
            # rolled back via the shards' stashes, then the survivors are
            # repaired to the (decodable) version that remains
            for _round in range(3):
                vers, errs = await self._fresh_versions(pg, erasure, shards, oid)
                if not vers:
                    return  # gone everywhere: the delete path owns this case
                want_version = max(vers.values())
                if erasure and want_version > (0, 0):
                    holders = [k for k, v in vers.items() if v == want_version]
                    codec, _si = osd._pool_codec(pool)
                    k_data = codec.get_data_chunk_count()
                    try:
                        codec.minimum_to_decode(list(range(k_data)), holders)
                        decodable = True
                    # swallow-ok: undecodable set detected below; the rollback path owns it
                    except Exception:
                        decodable = False
                    if not decodable and any(
                        e != -ENOENT for e in errs.values()
                    ):
                        # some member is unreachable — the version may be
                        # fully committed on shards we cannot see; rolling
                        # back now could undo an acked write. Defer.
                        self._retry_needed = True
                        return
                    if not decodable and not self._proven_unacked(
                        pg, want_version, vers, acting, past
                    ):
                        # the down/incomplete rule (reference
                        # PG::choose_acting; the rolling-churn
                        # case): every REACHABLE member of the
                        # version-epoch's acting set holds the version
                        # — it may be a fully-ACKED degraded-interval
                        # write whose other chunks sit on a member
                        # that is currently down.  Rolling back now
                        # would destroy acked data; wait for the
                        # holder (or an operator decision) instead.
                        logger.warning(
                            "%s: %s/%s v%s undecodable but possibly "
                            "acked (holders down): deferring",
                            osd.name, pg, oid, want_version,
                        )
                        self._retry_needed = True
                        return
                    if not decodable:
                        # fewer than a decodable set committed this version:
                        # previously-acked data lives at the PRIOR version —
                        # roll the holders back via their stashes
                        # (reference:doc/dev/osd_internals/erasure_coding/
                        # ecbackend.rst rollback)
                        logger.warning(
                            "%s: %s/%s v%s undecodable on %s -> rolling back",
                            osd.name, pg, oid, want_version, holders,
                        )
                        if not await self._rollback(
                            pg, oid, want_version, holders, shards
                        ):
                            self._retry_needed = True
                            return
                        continue  # re-evaluate with fresh versions
                stale: dict[int, int] = {}
                for key, member in shards.items():
                    if vers.get(key) == want_version:
                        continue
                    if key in errs and errs[key] != -ENOENT:
                        # member unreachable right now: retry pass later
                        self._retry_needed = True
                        continue
                    stale[key] = member
                if not stale:
                    return
                await self._push_repairs(
                    pg, pool, erasure, shards, oid, list(want_version), stale,
                    acting, vers,
                )
                return

    def _proven_unacked(
        self, pg: PGid, want_version: tuple, vers: dict[int, tuple],
        acting: list[int], past: "peering.PastIntervals | None",
    ) -> bool:
        """Whether an undecodable newest EC version is PROVABLY never
        acked — the license to roll it back.

        A write acks only after every present member of its interval's
        acting set commits, so finding one UP, successfully-read member
        of the version-epoch's acting set that does NOT hold the
        version proves the ack never happened (the torn-RMW shape).
        When every reachable member of that interval holds it, the
        missing chunks may sit on down members of a DEGRADED interval
        — i.e. the write may be acked — and the caller must defer, not
        destroy (the rolling-churn scenario: write acked 2-of-3 while
        A was down, then B dies before A backfills)."""
        epoch = int(want_version[0])
        acting_e: list[int] | None = None
        for iv in (past.intervals if past is not None else []):
            if iv.first <= epoch <= iv.last:
                acting_e = list(iv.acting)
                break
        if acting_e is None:
            # no record covers the epoch: it belongs to the current
            # interval
            acting_e = list(acting)
        m = self._map()
        for s, member in enumerate(acting_e):
            if member == CRUSH_ITEM_NONE or member < 0:
                continue  # a degraded hole was never asked to commit
            if m is None or not m.is_up(member):
                continue  # down: unknowable, no proof either way
            if s >= len(acting) or acting[s] != member:
                # the slot re-homed since that interval: vers[s] holds
                # the CURRENT member's answer, not this one's
                continue
            v = vers.get(s)
            if v is None:
                continue  # not readable this pass (stray/moved slot)
            if v != tuple(want_version):
                return True  # an up member of the interval lacks it
        return False

    async def _rollback(
        self, pg: PGid, oid: str, version: tuple, holders: list[int],
        shards: dict[int, int],
    ) -> bool:
        """Restore each holder's stash of ``version`` (or remove the object
        if the rolled-back write created it) and retract the log entry —
        the EC rollback step of the reference's divergent-log handling."""
        osd = self.osd
        ver = Eversion.from_list(list(version))
        sname = stash_name(oid, ver)
        ok = True
        for key in holders:
            member = shards[key]
            cid = CollectionId(f"{pg}s{key}")
            txn = (
                Transaction()
                .stash_restore(cid, ObjectId(sname, key), ObjectId(oid, key))
                .omap_rmkeys(cid, meta_oid(key), [ver.key()])
            )
            if not await self._push_txn(pg, key, member, txn, None):
                ok = False
        return ok

    async def _push_repairs(
        self, pg: PGid, pool: Pool, erasure: bool, shards: dict[int, int],
        oid: str, version: list[int], stale: dict[int, int],
        acting: list[int], vers: dict[int, tuple],
    ) -> None:
        osd = self.osd
        entry = PGLogEntry(
            "modify", oid, Eversion.from_list(version), Eversion()
        )
        if erasure:
            # reconstruct the logical object, re-encode, push stale chunks
            # (one batched device call rebuilds every missing shard)
            codec, sinfo = osd._pool_codec(pool)
            # the rebuild's device math runs under the RECOVERY dmClock
            # class end to end: it paces through the QoS
            # scheduler at the dispatcher — and when the remote accel
            # lane carries the batch, the class rides MAccelEncode/
            # MAccelDecode into the accelerator's own scheduler — so a
            # repair storm cannot starve client stripes of any device
            r, data = await osd._ec_read(
                pg, pool, acting, oid, klass="recovery"
            )
            if r < 0:
                logger.warning(
                    "%s: cannot recover %s/%s (read err %d)",
                    osd.name, pg, oid, r,
                )
                self._retry_needed = True
                return
            padded = (
                sinfo.pad_to_stripe(data) if data else b"\x00" * sinfo.stripe_width
            )
            # routes through the microbatch dispatcher (whose mesh lane
            # serves when osd_ec_mesh is on) / host path (async router)
            shard_bufs = await osd._ec_encode_bufs(
                sinfo, codec, padded, klass="recovery"
            )
            km = codec.get_chunk_count()
            hashes = StripeHashes(km, sinfo.chunk_size)
            hashes.set_range(0, shard_bufs)
            hinfo_b = json.dumps(hashes.to_dict()).encode()
            oi_b = json.dumps(
                {"size": len(data), "version": version}
            ).encode()
            for key, member in stale.items():
                cid = CollectionId(f"{pg}s{key}")
                soid = ObjectId(oid, key)
                chunk = shard_bufs[key].tobytes()
                txn = (
                    Transaction()
                    .create_collection(cid)
                    .remove(cid, soid)
                    .write(cid, soid, 0, chunk)
                    .setattr(cid, soid, StripeHashes.XATTR_KEY, hinfo_b)
                    .setattr(cid, soid, OI_KEY, oi_b)
                )
                logger.info(
                    "%s: recovering %s shard %d -> osd.%d (v%s)",
                    osd.name, soid, key, member, version,
                )
                if await self._push_txn(pg, key, member, txn, entry):
                    prec = self.osd.perf.get("recovery")
                    prec.inc("pushes")
                    prec.inc("bytes_pushed", len(chunk))
        else:
            # replicated: push the whole object from a healthy member
            cid = CollectionId(str(pg))
            soid = ObjectId(oid)
            healthy = [k for k, v in vers.items() if list(v) == version]
            data = attrs = None
            for k in healthy:
                if shards[k] == osd.osd_id:
                    try:
                        data = osd.store.read(cid, soid)
                        attrs = osd.store.getattrs(cid, soid)
                    # swallow-ok: local copy raced away: try the next healthy member
                    except KeyError:
                        continue
                    break
            if data is None:
                for k in healthy:  # remote pull
                    d, a, errs = await osd._read_shards(
                        pg, oid, {-1: shards[k]}
                    )
                    if -1 in d and -1 not in errs:
                        data = d[-1]
                        attrs = {
                            ak: av.encode("latin-1")
                            for ak, av in a.get(-1, {}).items()
                        }
                        break
            if data is None:
                logger.warning(
                    "%s: cannot recover %s/%s (no healthy replica)",
                    osd.name, pg, oid,
                )
                self._retry_needed = True
                return
            for key, member in stale.items():
                logger.info(
                    "%s: recovering %s -> osd.%d (v%s)",
                    osd.name, soid, member, version,
                )
                if await self.push_replica_object(
                    pg, member, oid, data, attrs or {}, entry
                ):
                    prec = self.osd.perf.get("recovery")
                    prec.inc("pushes")
                    prec.inc("bytes_pushed", len(data))

    async def push_replica_object(
        self, pg: PGid, member: int, oid: str, data: bytes,
        attrs: dict[str, bytes], entry: PGLogEntry | None,
    ) -> bool:
        """Push one whole replicated object (data + attrs) to a member —
        the txn shape shared by recovery backfill and scrub repair
        (reference:src/osd/ReplicatedBackend.cc push).  Objects larger
        than ``osd_recovery_max_chunk`` go in bounded segments
        (reference:src/common/config_opts.h:803, 8 MiB default): the log
        entry rides only the FINAL segment, so a crash mid-push leaves
        an unlogged partial object that the next pass simply re-pushes."""
        cid = CollectionId(str(pg))
        soid = ObjectId(oid)
        max_chunk = max(
            1, int(self.osd.config.get("osd_recovery_max_chunk"))
        )
        data = bytes(data)
        segments = [
            (off, data[off:off + max_chunk])
            for off in range(0, max(len(data), 1), max_chunk)
        ]
        for i, (off, seg) in enumerate(segments):
            final = i == len(segments) - 1
            txn = Transaction()
            if i == 0:
                txn.create_collection(cid).remove(cid, soid)
                if not seg:
                    txn.write(cid, soid, 0, b"")
            if seg:
                txn.write(cid, soid, off, seg)
            if final:
                for ak, av in attrs.items():
                    txn.setattr(cid, soid, ak, av)
            if not await self._push_txn(
                pg, -1, member, txn, entry if final else None
            ):
                return False
        return True

    async def _push_txn(
        self, pg: PGid, shard: int, member: int, txn: Transaction,
        entry: PGLogEntry | None,
    ) -> bool:
        """Recovery pushes ride the normal sub-write path (same durability
        contract: log entry + data in one transaction; ``entry=None`` for
        rollbacks, which retract log entries instead of adding one).
        Returns success; a failed push flags the pass for retry."""
        osd = self.osd
        tid = osd._new_tid()
        from .daemon import _Waiter

        waiter = _Waiter({shard}, {shard: member})
        osd._write_waiters[tid] = waiter
        t0 = asyncio.get_event_loop().time()
        try:
            await osd._send_sub_write(
                tid, pg, shard, member, txn, [entry] if entry else []
            )
            async with asyncio.timeout(10.0):
                await waiter.event.wait()
            # the push round trip as a waterfall hop (same ring the
            # sampled client ops feed): a recovery trace reads as
            # peering_scan -> N recovery_push spans in dump_op_waterfall
            trace = current_trace.get()
            if trace is not None:
                record_span(
                    "recovery_push", t0,
                    asyncio.get_event_loop().time() - t0, trace=trace,
                    entity=f"osd.{osd.osd_id}", member=member, shard=shard,
                )
        # swallow-ok: push timeout flags the pass for retry (logged)
        except TimeoutError:
            logger.warning(
                "%s: recovery push to osd.%d timed out", osd.name, member
            )
            self._retry_needed = True
            return False
        finally:
            del osd._write_waiters[tid]
        if any(r != 0 for r in waiter.results.values()):
            logger.warning(
                "%s: recovery push to osd.%d failed %s",
                osd.name, member, waiter.results,
            )
            self._retry_needed = True
            return False
        return True


class _ScanWaiter:
    def __init__(self, pending: set[int], members: dict[int, int] | None = None):
        self.pending = set(pending)
        self.members = dict(members or {})
        self.results: dict[int, tuple[dict, list, dict | None, list | None]] = {}
        self.failed: set[int] = set()  # members lost mid-scan: pass aborts
        self.event = asyncio.Event()
        if not self.pending:
            self.event.set()

    def complete(
        self, shard: int, objects: dict, log: list,
        info: dict | None = None, intervals: list | None = None,
    ) -> None:
        if shard in self.pending:
            self.pending.discard(shard)
            self.results[shard] = (objects, log, info, intervals)
            if not self.pending:
                self.event.set()

    def fail_member(self, osd_id: int) -> None:
        for key in list(self.pending):
            if self.members.get(key) == osd_id:
                self.failed.add(key)
                self.complete(key, {}, [])
