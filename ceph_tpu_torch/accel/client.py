"""OSD-side client for the shared EC accelerator daemon.

Counterpart of ``ceph_tpu/accel/client.py``, whole: routing modes, beacon
health, the sticky unreachable state, ``run_batch`` and the member
slicing.  It speaks the reference's wire, so a client of either package
can feed an accelerator daemon of either package.

The :class:`AccelClient` is the EC dispatcher's **remote lane**: a
coalesced ``[ΣS, k, C]`` batch that would have launched on this OSD's
own device ships instead to a standalone accelerator daemon
(``accel.daemon``) over the messenger — one message per batch,
payloads as borrowed frame views (the zero-copy contract), the QoS
class and stripe geometry in the fields, the trace id on the frame
header.  The accelerator re-coalesces across *client OSDs* (the shared-
occupancy win) and answers with the whole-batch result; this client
slices the members back out, exactly as the local launch path does.

Routing (``osd_ec_accel_mode``):

- ``off`` — the lane does not exist (default).
- ``prefer`` — route remote while the accelerator's last beacon/reply
  reads HEALTHY/SUSPECT and unsaturated; otherwise the batch takes the
  local lanes.  A TRIPPED beacon re-routes the NEXT batch — no timeout
  chain.
- ``require`` — always route remote (a host with no local device);
  faults still replay on the local *host fallback* engine, so no
  client op ever fails.

Fault model — the accelerator is one more engine in the dispatcher's
fault domain: a connection reset, a blown ``osd_ec_accel_deadline``, or an
EIO reply raises :class:`AccelUnavailable` / :class:`AccelServiceError`
and the dispatcher replays the in-flight batch on the LOCAL fallback
engine, bit-identically — the flight-recorder record says
``origin=remote`` so an operator can tell a network trip from a device
trip.  Data-shape errors come back as :class:`AccelDataError` and
surface to the caller untouched, the same fork the local classifier
applies.  Reachability faults start an exponential backoff
(``osd_ec_accel_retry_interval``, up to 16x); a beacon or successful
reply clears it immediately.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..msg import messages
from ..utils.buffers import as_u8

logger = logging.getLogger("ceph_tpu_torch.accel.client")

# breaker states mirrored from osd/ec_failover (the beacon carries the
# accelerator's EngineSupervisor.state)
_TRIPPED = 2

# default for ``stale_interval`` (the ``osd_ec_accel_stale_interval``
# Option): a beacon/reply health snapshot aged >= it is stale and no
# longer gates routing — traffic re-probes instead of pinning
# "TRIPPED"/saturated forever off one last message before a quiet
# period (the accelerator may long since have re-promoted while no
# connection carried the news).  The boundary is pinned by
# tests/test_torch_accel_service.py (age == T is stale, age == T - ε
# still gates).
_STATE_STALE_S = 10.0

_BACKOFF_MAX_FACTOR = 16


class AccelDataError(ValueError):
    """The accelerator rejected the batch as malformed (its validation
    prologue — the same one the local lanes share).  Surfaces to the
    waiters; never replayed, never marks the remote down."""


class AccelUnavailable(RuntimeError):
    """The accelerator is unreachable (connect refused, link reset
    mid-batch, RPC deadline blown).  The dispatcher replays the batch
    on the local fallback engine and new batches route local until the
    backoff expires or a beacon arrives."""


class AccelServiceError(RuntimeError):
    """The accelerator answered, but could not serve (its device AND
    host fallback both failed, or it is shutting down).  Replay locally
    — but the remote stays routable: it is reachable, and its own
    breaker/canary owns the recovery."""


class AccelClient:
    """One OSD's handle on its shared accelerator (see module doc).

    ``perf`` is the OSD's ``accel`` PerfCounters (osd/ec_perf.py client
    half; None for a standalone client — totals still ride dump()).
    """

    def __init__(self, messenger, *, addr: str = "", mode: str = "off",
                 deadline: float = 10.0, retry_interval: float = 1.0,
                 stale_interval: float = _STATE_STALE_S, perf=None,
                 aid: int | None = None, locality: str = ""):
        self.messenger = messenger
        self.addr = addr
        # fleet identity (AccelRouter): the mon-assigned accel id and
        # locality label of the map entry this client targets (None/""
        # for the osd_ec_accel_addr static shim)
        self.aid = aid
        self.locality = locality
        self.mode = mode
        self.deadline = float(deadline)
        self.retry_interval = float(retry_interval)
        self.stale_interval = float(stale_interval)
        self._perf = perf
        self._conn = None
        self._tid = 0
        self._waiters: dict[int, asyncio.Future] = {}
        # reachability: ``_down`` is STICKY — set on connect/deadline
        # faults, cleared only by an actual word from the remote (a
        # beacon or reply) — while ``_down_until`` merely paces the
        # retry probes.  The split matters: ACCEL_UNREACHABLE must
        # stay raised while the accelerator is actually dead, not
        # clear whenever a backoff window lapses
        self._down = False
        self._down_until = 0.0
        self._fail_streak = 0
        # the accelerator's piggybacked health (beacon + every reply)
        self.remote_state = 0
        self.remote_queue = 0
        self.remote_capacity = 0
        self._state_at = 0.0
        self.totals = {
            "batches": 0, "ops": 0, "bytes": 0, "failures": 0,
            "data_errors": 0, "routed_away": 0, "beacons": 0,
            "resets": 0,
        }

    # -- routing -------------------------------------------------------------

    def routes(self, codec) -> bool:
        """Should the dispatcher open this batch on the remote lane?
        Needs a wire profile on the codec (a hand-built codec has no
        profile the accelerator could rebuild it from).  ``require``
        always routes; ``prefer`` routes only while the remote reads
        healthy — TRIPPED/saturated beacons and the unreachable backoff
        send traffic to the local lanes instead, and that re-route is
        COUNTED (``accel.remote_routed_away``) so an operator can see a
        sick remote shedding load."""
        if self.mode == "off" or not self.addr:
            return False
        if not getattr(codec, "_profile", None):
            return False
        if self.mode == "require":
            return True
        if self.available():
            return True
        self.totals["routed_away"] += 1
        if self._perf is not None:
            try:
                self._perf.inc("remote_routed_away")
            except Exception:  # swallow-ok: observability is best-effort
                pass
        return False

    def available(self) -> bool:
        """Reachable (or due a retry probe) and — per the last fresh
        beacon/reply — not TRIPPED and not saturated.  A down remote
        whose backoff expired reads available so TRAFFIC re-probes it;
        :attr:`unreachable` stays True until the probe succeeds.  A
        snapshot aged exactly ``stale_interval`` is already stale (the
        boundary the fleet tests pin): it stops gating and traffic
        re-probes."""
        now = time.monotonic()
        if self._down and now < self._down_until:
            return False
        if self.state_fresh(now):
            if self.remote_state >= _TRIPPED:
                return False
            if (self.remote_capacity
                    and self.remote_queue > self.remote_capacity):
                return False
        return True

    def state_fresh(self, now: float | None = None) -> bool:
        """Whether the last piggybacked health snapshot still gates
        routing (age strictly under ``stale_interval``)."""
        if now is None:
            now = time.monotonic()
        return now - self._state_at < self.stale_interval

    def load(self) -> float:
        """Queue depth / capacity from the last fresh snapshot — the
        router's balancing signal (the beacon piggyback is a balancing
        input, not just an avoidance input).  A stale or
        never-heard snapshot reads 0.0: an idle-looking unknown is
        exactly what a re-probe should target."""
        if not self.state_fresh() or not self.remote_capacity:
            return 0.0
        return self.remote_queue / self.remote_capacity

    @property
    def unreachable(self) -> bool:
        """True from the first reachability fault until the remote is
        actually heard from again (sticky — feeds ACCEL_UNREACHABLE)."""
        return self._down

    # -- the batch RPC (called by ECDispatcher._launch) ----------------------

    async def run_batch(self, b, ops):
        """Ship one coalesced batch; returns ``(results, pad=0,
        seconds, info)`` — the first three shaped exactly like the
        local ``_run_sync`` so the dispatcher's completion path is
        lane-agnostic, plus an ``info`` dict with the reply's
        accelerator-side evidence: ``served`` (the engine that
        produced the bytes — device/mesh/native_direct/fallback; rides
        the flight record as ``remote_served``) and ``queue_wait_s``
        (the accel-side coalesce wait — the op waterfall's
        accel_queue_wait hop).  ``seconds`` is the accelerator's
        device wall time when the reply carries it (the RTT lives in
        ``accel.remote_rtt``).  Raises AccelDataError /
        AccelUnavailable / AccelServiceError (see module doc for the
        fork each one takes)."""
        t0 = time.perf_counter()
        try:
            # the deadline bounds the WHOLE round trip, connect
            # included: a blackholed host (SYN drop) must not stall
            # the batch through the messenger's full dial-retry chain
            # while the waiters' failover budget reads 2s
            if self.deadline > 0:
                conn = await asyncio.wait_for(self._get_conn(),
                                              self.deadline)
            else:
                conn = await self._get_conn()
        except (ConnectionError, OSError, TimeoutError,
                asyncio.TimeoutError) as e:
            self._mark_down()
            raise AccelUnavailable(
                f"accelerator {self.addr} unreachable: {e!r}"
            ) from e
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._waiters[tid] = fut
        sinfo = b.sinfo
        profile = dict(b.codec._profile)
        stripes = [op.stripes for op in ops]
        # per-member tenant ids: the accelerator's dmClock
        # and flight records attribute device time to the SAME u64 the
        # OSD ledger keys on (0 = unattributed)
        tenants = [op.client if isinstance(op.client, int) else 0
                   for op in ops]
        try:
            if b.kind == "enc":
                # one borrowed view per member op — no gather on this
                # side at all; the frame encoder writes them vectored
                conn.send(messages.MAccelEncode(
                    tid=tid, profile=profile,
                    stripe_width=sinfo.stripe_width,
                    chunk_size=sinfo.chunk_size,
                    stripes=stripes, klass=b.klass,
                    tenants=tenants,
                    blobs=[op.payload for op in ops],
                ))
            else:
                present = sorted(ops[0].payload)
                conn.send(messages.MAccelDecode(
                    tid=tid, profile=profile,
                    stripe_width=sinfo.stripe_width,
                    chunk_size=sinfo.chunk_size,
                    stripes=stripes, present=present, klass=b.klass,
                    tenants=tenants,
                    blobs=[op.payload[s] for op in ops
                           for s in present],
                ))
            if self.deadline > 0:
                # whatever the connect phase spent comes out of the
                # same budget (floor 1ms so a reply already in the
                # queue still lands)
                remaining = max(
                    0.001, self.deadline - (time.perf_counter() - t0)
                )
                reply = await asyncio.wait_for(fut, remaining)
            else:
                reply = await fut
        except asyncio.TimeoutError:
            self._mark_down()
            raise AccelUnavailable(
                f"accelerator batch exceeded the {self.deadline:g}s "
                f"deadline"
            ) from None
        finally:
            self._waiters.pop(tid, None)
        rtt = time.perf_counter() - t0
        if reply.result:
            if int(reply.result) == -22:
                self.totals["data_errors"] += 1
                if self._perf is not None:
                    self._perf.inc("remote_data_errors")
                raise AccelDataError(str(reply.error))
            raise AccelServiceError(
                f"accelerator could not serve the batch: {reply.error}"
            )
        results = self._slice_results(b, ops, reply)
        self._note_success(b, ops, rtt)
        seconds = (float(reply.device_wall_s)
                   if reply.device_wall_s else rtt)
        return results, 0, seconds, {
            "served": reply.served,
            "queue_wait_s": reply.queue_wait_s,
        }

    def _slice_results(self, b, ops, reply):
        """Member-major reply blobs -> per-member results.  Encode
        members map to ``len(shards)`` blobs each (the accelerator's
        per-member result slices, sent as views); decode members to
        one logical blob each.  Everything is handed out as views of
        the receive frame — the zero-copy contract: receive frames are
        immutable and live as long as any blob view does."""
        if b.kind == "enc":
            shards = [int(s) for s in reply.shards or []]
            nsh = len(shards)
            if nsh == 0 or len(reply.blobs) != len(ops) * nsh:
                raise AccelServiceError(
                    f"encode reply carries {len(reply.blobs)} blobs "
                    f"for {len(ops)} members x {nsh} shards"
                )
            return [
                {s: as_u8(reply.blobs[i * nsh + j])
                 for j, s in enumerate(shards)}
                for i in range(len(ops))
            ]
        if len(reply.blobs) != len(ops):
            raise AccelServiceError(
                f"decode reply carries {len(reply.blobs)} blobs for "
                f"{len(ops)} members"
            )
        return [
            bl if isinstance(bl, memoryview) else memoryview(bl)
            for bl in reply.blobs
        ]

    # -- inbound (OSD.ms_dispatch routes accel traffic here) -----------------

    def handle(self, msg, conn=None) -> bool:
        """Route one inbound accel message; returns False for foreign
        types (the OSD's dispatch chain continues).  ``conn`` — when
        the caller has it — scopes the health piggyback to the
        CURRENT endpoint: after a live retarget the OLD accelerator's
        connection may stay open and keep beaconing, and its healthy
        beacons must not mark the NEW (possibly dead) endpoint
        reachable."""
        if conn is not None and getattr(conn, "peer_addr", "") != self.addr:
            return isinstance(
                msg, (messages.MAccelReply, messages.MAccelBeacon)
            )  # a stale endpoint's traffic: consumed, never trusted
        if isinstance(msg, messages.MAccelReply):
            self._on_reply(msg)
            return True
        if isinstance(msg, messages.MAccelBeacon):
            self._on_beacon(msg)
            return True
        return False

    def _on_reply(self, msg) -> None:
        self._note_health(msg)
        fut = self._waiters.pop(msg.tid, None)
        if fut is not None and not fut.done():
            fut.set_result(msg)

    def _on_beacon(self, msg) -> None:
        self.totals["beacons"] += 1
        self._note_health(msg)

    def _note_health(self, msg) -> None:
        """Every reply and beacon piggybacks the accelerator's health:
        a word from the remote proves reachability (backoff clears) and
        updates the routing inputs."""
        self.remote_state = int(msg.engine_state or 0)
        self.remote_queue = int(msg.queue_depth or 0)
        self.remote_capacity = int(msg.capacity or 0)
        self._state_at = time.monotonic()
        self._mark_up()
        if self._perf is not None:
            try:
                self._perf.set("remote_state", self.remote_state)
                self._perf.set("remote_queue_depth", self.remote_queue)
            except Exception:  # swallow-ok: observability is best-effort
                pass

    def on_reset(self, conn) -> None:
        """The OSD saw a connection die; if it was ours, every
        in-flight batch fails over NOW (the dispatcher replays each on
        the local fallback) instead of waiting out the RPC deadline —
        accelerator death mid-batch is classified like device death."""
        if conn is not self._conn:
            return
        self._conn = None
        self.totals["resets"] += 1
        self._mark_down()
        waiters = list(self._waiters.values())
        self._waiters.clear()
        for fut in waiters:
            if not fut.done():
                fut.set_exception(AccelUnavailable(
                    f"accelerator {self.addr} connection reset "
                    f"mid-batch"
                ))

    # -- connection / reachability state -------------------------------------

    async def _get_conn(self):
        conn = self._conn
        if conn is not None and not conn._closed:
            return conn
        conn = await self.messenger.connect(self.addr, "accel")
        self._conn = conn
        return conn

    def _mark_down(self) -> None:
        self._down = True
        self._fail_streak += 1
        backoff = min(
            self.retry_interval * (2 ** (self._fail_streak - 1)),
            self.retry_interval * _BACKOFF_MAX_FACTOR,
        )
        self._down_until = time.monotonic() + backoff
        self.totals["failures"] += 1
        logger.warning(
            "accelerator %s marked unreachable (failure #%d, retry in "
            "%.2fs)", self.addr, self._fail_streak, backoff,
        )
        if self._perf is not None:
            try:
                self._perf.set("remote_unreachable", 1)
            except Exception:  # swallow-ok: observability is best-effort
                pass

    def note_failure(self, exc: BaseException) -> None:
        """The dispatcher is replaying a remote batch on the local
        fallback engine: count the failover (reachability bookkeeping
        already happened where the fault was seen)."""
        if self._perf is not None:
            try:
                self._perf.inc("remote_failovers")
            except Exception:  # swallow-ok: observability is best-effort
                pass

    def _mark_up(self) -> None:
        if self._down:
            logger.info("accelerator %s reachable again", self.addr)
        self._down = False
        self._fail_streak = 0
        self._down_until = 0.0
        if self._perf is not None:
            try:
                self._perf.set("remote_unreachable", 0)
            except Exception:  # swallow-ok: observability is best-effort
                pass

    def _note_success(self, b, ops, rtt: float) -> None:
        t = self.totals
        t["batches"] += 1
        t["ops"] += len(ops)
        nbytes = sum(op.stripes for op in ops) * (
            b.sinfo.stripe_width if b.kind == "enc"
            else b.sinfo.chunk_size * len(ops[0].payload)
        )
        t["bytes"] += nbytes
        if self._perf is not None:
            try:
                self._perf.inc("remote_batches")
                self._perf.inc("remote_ops", len(ops))
                self._perf.inc("remote_bytes", nbytes)
                self._perf.observe("remote_rtt", rtt)
            except Exception:  # swallow-ok: observability is best-effort
                pass

    # -- live config ---------------------------------------------------------

    def set_addr(self, addr: str) -> None:
        """``osd_ec_accel_addr`` observer: retargeting resets the
        connection and the health history — the new endpoint starts
        clean.  In-flight batches to the OLD endpoint fail over NOW
        (their replies would be rejected by the endpoint scope check
        anyway, and waiting them out to the deadline would mark the
        NEW endpoint down for a fault it never had); the old
        connection is closed rather than left beaconing forever."""
        if addr == self.addr:
            return
        old = self._conn
        self.addr = addr
        self._conn = None
        self._down = False
        self._fail_streak = 0
        self._down_until = 0.0
        self.remote_state = 0
        self.remote_queue = 0
        self._state_at = 0.0
        waiters = list(self._waiters.values())
        self._waiters.clear()
        for fut in waiters:
            if not fut.done():
                fut.set_exception(AccelUnavailable(
                    "accelerator retargeted mid-batch"
                ))
        if old is not None and not old._closed:
            try:
                asyncio.ensure_future(old.close())
            # swallow-ok: no running loop (sync-context config load) — the conn object is unused and unreferenced from here
            except RuntimeError:
                pass

    def set_mode(self, mode: str) -> None:
        """``osd_ec_accel_mode`` observer.  Turning the lane OFF
        clears the sticky unreachable state: with no traffic and no
        beacons possible, nothing else could ever clear it, and a
        disabled lane must not keep ACCEL_UNREACHABLE raised (the same
        rule EngineSupervisor.set_enabled applies to ACCEL_DEGRADED)."""
        self.mode = mode
        if mode == "off":
            self._down = False
            self._fail_streak = 0
            self._down_until = 0.0
            if self._perf is not None:
                try:
                    self._perf.set("remote_unreachable", 0)
                except Exception:  # swallow-ok: observability is best-effort
                    pass

    def refresh_gauges(self) -> None:
        """Re-assert the accel gauges off the OSD's report tick (an
        admin ``perf reset`` must not silently clear
        ACCEL_UNREACHABLE while the remote is down).  A lane that is
        off or unconfigured never reads unreachable — there is nothing
        configured to reach."""
        if self._perf is None:
            return
        try:
            self._perf.set(
                "remote_unreachable",
                1 if (self.mode != "off" and self.addr
                      and self.unreachable) else 0,
            )
            self._perf.set("remote_state", self.remote_state)
        except Exception:  # swallow-ok: observability is best-effort
            pass

    # -- admin ---------------------------------------------------------------

    def dump(self) -> dict:
        """The remote slice of ``dump_ec_dispatch``."""
        now = time.monotonic()
        return {
            "addr": self.addr,
            "load": round(self.load(), 4),
            "mode": self.mode,
            "deadline_s": self.deadline,
            "unreachable": self.unreachable,
            "retry_in_s": round(max(0.0, self._down_until - now), 3),
            "remote_state": self.remote_state,
            "remote_queue_depth": self.remote_queue,
            "remote_capacity": self.remote_capacity,
            "state_age_s": (
                round(now - self._state_at, 3) if self._state_at else None
            ),
            "inflight": len(self._waiters),
            "totals": dict(self.totals),
            **({"aid": self.aid} if self.aid is not None else {}),
            **({"locality": self.locality} if self.locality else {}),
        }
