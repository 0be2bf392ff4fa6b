"""AccelRouter: load- and locality-aware routing over an accelerator
fleet.

Counterpart of ``ceph_tpu/accel/router.py``, whole.  One
:class:`~ceph_tpu_torch.accel.client.AccelClient` serves one daemon at
one statically configured address.  The router turns that into a
*fleet*:

- **membership from the mon.** The router consumes the mon-published
  :class:`~ceph_tpu_torch.accel.accelmap.AccelMap` (it rides every OSDMap
  push): one ``AccelClient`` per up entry, created/retargeted/dropped
  as epochs advance — an accelerator the mon marked down (beacon loss,
  connection reset) stops being a target within one map push, and its
  in-flight batches fail over NOW.  ``osd_ec_accel_addr`` survives as a
  single-entry static-fleet compat shim: with no map entries it behaves
  exactly like a single client.
- **load as a balancing signal.** Every beacon/reply already
  piggybacks queue_depth/capacity; a single client uses it only to AVOID a
  saturated remote.  The router uses it to *balance*: batches go to
  the least-loaded available accelerator, with hysteresis (the current
  target is kept while its load is within ``_HYSTERESIS`` of the best)
  so steady traffic does not flap between near-equal targets.
- **inter-accel failover.** A batch that fails on one accelerator
  (unreachable, deadline, EIO) is retried on the NEXT accelerator
  before the dispatcher ever sees an error — the local host fallback
  is reached only when the WHOLE fleet is down, and the remote lane's
  replay guarantee (zero failed client ops) holds across the hop.  Sticky
  unreachable state lives per accel id; the fleet summary
  (``accel.fleet_up``/``fleet_down`` gauges) feeds the mgr's
  ``ACCEL_FLEET_DEGRADED`` check, while ``ACCEL_UNREACHABLE`` now
  means the whole fleet is gone.
- **shard-locality decode.** Decode batches carry their surviving
  shards' OSD locality labels (crush host names, see
  ``OSDMap.locality_of``); the router prefers the accelerator whose
  ``accel_locality`` matches the majority label, so reads stop
  shipping survivor bytes across the fabric.  Hits and misses are
  counted (``accel.locality_hits``/``locality_misses``) and dumped.

Observability: the aggregate ``accel.remote_*`` family keeps its single-client
meaning (summed across the fleet); each map entry additionally gets a
per-accel ``accel@<id>`` family (``osd/ec_perf.py``
``create_accel_target_perf``) that the mgr prometheus module exports as
``ceph_accel_*{accel="<id>"}`` labelled series, so fleet skew is
visible per target.  ``dump_ec_dispatch`` embeds :meth:`dump` — the
per-accel table with load, health, and totals.
"""

from __future__ import annotations

import logging

from .client import (
    AccelClient,
    AccelServiceError,
    AccelUnavailable,
    _STATE_STALE_S,
)

logger = logging.getLogger("ceph_tpu_torch.accel.router")

# keep the current target while its load is within this margin of the
# least-loaded candidate: near-equal loads must not flap the batch
# stream (and its warm connection) between accelerators every beacon
_HYSTERESIS = 0.2


class _TargetPerf:
    """Fans one AccelClient's perf mutations into the aggregate
    ``accel`` family (fleet sums — the single-client series keep their meaning)
    and the per-accel ``accel@<id>`` family (the labelled split).
    Gauges go to the per-accel family only: fleet-level gauges
    (``remote_unreachable``, ``remote_state``, ...) are owned by the
    router's :meth:`AccelRouter.refresh_gauges`, where "all targets
    down" is decidable — a per-client set would be last-writer-wins
    noise."""

    def __init__(self, aggregate, target=None):
        self._aggregate = aggregate
        self._target = target

    def inc(self, key: str, by: int = 1) -> None:
        if self._aggregate is not None:
            self._aggregate.inc(key, by)
        if self._target is not None:
            self._target.inc(key, by)

    def observe(self, key: str, value) -> None:
        if self._aggregate is not None:
            self._aggregate.observe(key, value)
        if self._target is not None:
            self._target.observe(key, value)

    def set(self, key: str, value) -> None:
        if self._target is not None:
            self._target.set(key, value)


class AccelRouter:
    """One OSD's handle on the accelerator FLEET (see module doc).

    Drop-in for a single ``AccelClient`` at every dispatcher/daemon
    call site: ``routes``/``run_batch``/``note_failure`` for the
    dispatcher's remote lane, ``handle``/``on_reset`` for inbound
    traffic, ``set_addr``/``set_mode``/``refresh_gauges``/``dump`` for
    config/report plumbing, plus :meth:`apply_map` fed from every
    OSDMap advance.
    """

    def __init__(self, messenger, *, addr: str = "", mode: str = "off",
                 deadline: float = 10.0, retry_interval: float = 1.0,
                 stale_interval: float = _STATE_STALE_S, perf=None,
                 perf_collection=None):
        self.messenger = messenger
        self.mode = mode
        self._deadline = float(deadline)
        self._retry_interval = float(retry_interval)
        self._stale_interval = float(stale_interval)
        self._perf = perf  # the aggregate ``accel`` family (client half)
        self._coll = perf_collection  # for per-accel ``accel@id`` splits
        self._target_perf: dict[int, object] = {}
        # map-published targets (aid -> client) + the static shim
        self._map_clients: dict[int, AccelClient] = {}
        self.map_epoch = 0
        # published-but-down entries: not routing targets, but they ARE
        # deployed fleet capacity — a map whose every member is down
        # must read unreachable at the mgr, not silently shrink to
        # "no fleet configured" (an end-to-end drive found it: kill the whole
        # fleet and ACCEL_UNREACHABLE never raised)
        self._map_down = 0
        self._shim: AccelClient | None = None
        self.addr = ""
        if addr:
            self.set_addr(addr)
        self._current: int | None = None  # sticky target (hysteresis)
        self.totals = {
            "routed_away": 0, "failover_next": 0, "rebalances": 0,
            "locality_hits": 0, "locality_misses": 0,
        }

    # -- fleet membership ----------------------------------------------------

    def _new_client(self, addr: str, *, aid: int | None = None,
                    locality: str = "") -> AccelClient:
        target = None
        if aid is not None and self._coll is not None:
            target = self._target_perf.get(aid)
            if target is None:
                from ..osd.ec_perf import create_accel_target_perf

                target = create_accel_target_perf(self._coll, aid)
                self._target_perf[aid] = target
        return AccelClient(
            self.messenger, addr=addr, mode=self.mode,
            deadline=self._deadline, retry_interval=self._retry_interval,
            stale_interval=self._stale_interval,
            perf=_TargetPerf(self._perf, target),
            aid=aid, locality=locality,
        )

    def apply_map(self, amap) -> None:
        """Adopt a newer AccelMap (called on every OSDMap advance).
        Up entries get a client (created or retargeted, keeping their
        sticky health across refresh beacons); entries the mon marked
        down or removed stop being targets NOW — their in-flight
        batches fail over to the next accelerator instead of waiting
        out the RPC deadline for a daemon the cluster already knows is
        dead."""
        if amap is None or amap.epoch <= self.map_epoch:
            return
        self.map_epoch = amap.epoch
        self._map_down = sum(1 for e in amap.accels.values() if not e.up)
        up = {e.aid: e for e in amap.up_entries()}
        for aid, e in up.items():
            cl = self._map_clients.get(aid)
            if cl is None:
                self._map_clients[aid] = self._new_client(
                    e.addr, aid=aid, locality=e.locality
                )
            else:
                if cl.addr != e.addr:
                    cl.set_addr(e.addr)
                cl.locality = e.locality
                cl.remote_capacity = cl.remote_capacity or e.capacity
        for aid in [a for a in self._map_clients if a not in up]:
            cl = self._map_clients.pop(aid)
            logger.info("accel.%d left the map (down/removed): "
                        "dropping target %s", aid, cl.addr)
            cl.set_addr("")  # fails in-flight waiters over immediately
            if self._current == aid:
                self._current = None

    def _candidates(self) -> list[AccelClient]:
        """Routable targets: the mon-published fleet when it has up
        entries, else the ``osd_ec_accel_addr`` static shim (the single-client
        compat topology)."""
        if self._map_clients:
            return list(self._map_clients.values())
        return [self._shim] if self._shim is not None else []

    def _all_clients(self) -> list[AccelClient]:
        out = list(self._map_clients.values())
        if self._shim is not None:
            out.append(self._shim)
        return out

    # -- routing (the dispatcher's remote-lane interface) --------------------

    def routes(self, codec) -> bool:
        """Should the dispatcher open this batch on the remote lane?
        ``require`` always routes; ``prefer`` routes while ANY fleet
        member reads available — only a whole-fleet outage sheds to the
        local lanes, and that shed is counted."""
        if self.mode == "off":
            return False
        if not getattr(codec, "_profile", None):
            return False
        cands = self._candidates()
        if not cands:
            return False
        if self.mode == "require":
            return True
        if any(cl.available() for cl in cands):
            return True
        self.totals["routed_away"] += 1
        if self._perf is not None:
            try:
                self._perf.inc("remote_routed_away")
            except Exception:  # swallow-ok: observability is best-effort
                pass
        return False

    @staticmethod
    def _majority_label(ops) -> str | None:
        """The most common surviving-shard locality label across the
        batch's member ops (ties break lexicographically, so the
        preference is deterministic); None when no op carried labels
        (encode batches, flat crush topologies)."""
        counts: dict[str, int] = {}
        for op in ops:
            for lbl in getattr(op, "locality", None) or []:
                if lbl:
                    counts[lbl] = counts.get(lbl, 0) + 1
        if not counts:
            return None
        top = max(counts.values())
        return sorted(k for k, v in counts.items() if v == top)[0]

    def _order(self, b, ops) -> tuple[list[AccelClient], str | None]:
        """Candidate targets in try-order: locality-preferred first
        (decode batches carrying labels), then least-loaded with
        hysteresis.  Prefer mode restricts to available targets; in
        require mode, when nothing is available the batch still TRIES
        the fleet (down targets are due re-probes) before the caller
        replays locally."""
        cands = self._candidates()
        pool = [cl for cl in cands if cl.available()]
        if not pool and self.mode == "require":
            pool = cands
        label = self._majority_label(ops) if b.kind == "dec" else None
        pool.sort(key=lambda cl: (
            0 if (label and cl.locality == label) else 1,
            cl.load(),
            cl.aid if cl.aid is not None else 1 << 30,
        ))
        if pool and len(pool) > 1 and not (
            label and pool[0].locality == label
        ):
            # hysteresis: keep the current target while it is close to
            # the best (locality preference outranks stickiness — a
            # locality hit is the fabric win the ordering exists for)
            cur = next((cl for cl in pool if cl.aid == self._current
                        and self._current is not None), None)
            if cur is not None and cur is not pool[0] and (
                cur.load() <= pool[0].load() + _HYSTERESIS
            ):
                pool.remove(cur)
                pool.insert(0, cur)
        return pool, label

    def record_failure_next(self, cl: AccelClient,
                            e: BaseException) -> None:
        """One fleet member failed a batch that the NEXT member will
        retry: the inter-accel hop is counted (aggregate + the faulted
        target's family) so an operator can see failover traffic
        without a single client op having failed."""
        self.totals["failover_next"] += 1
        logger.warning(
            "accel %s failed a batch (%r): failing over to the next "
            "accelerator", cl.addr, e,
        )
        if cl._perf is not None:
            try:
                cl._perf.inc("remote_failover_next")
            except Exception:  # swallow-ok: observability is best-effort
                pass

    def _note_locality(self, chosen: AccelClient, label: str) -> None:
        hit = chosen.locality == label
        key = "locality_hits" if hit else "locality_misses"
        self.totals[key] += 1
        if self._perf is not None:
            try:
                self._perf.inc(key)
            except Exception:  # swallow-ok: observability is best-effort
                pass

    async def run_batch(self, b, ops):
        """Ship one coalesced batch to the fleet: the single client's
        contract (same return shape, same exception fork), plus the
        inter-accel failover loop — every available target is tried
        before an error reaches the dispatcher, so the local fallback
        replay happens only when the WHOLE fleet failed the batch.
        Data-shape errors (AccelDataError) surface from the FIRST
        target untouched: every accelerator runs the same validation
        prologue, so retrying a malformed batch elsewhere would just
        burn fleet capacity reproving it."""
        order, label = self._order(b, ops)
        if not order:
            raise AccelUnavailable(
                "no accelerator available (fleet down or unregistered)"
            )
        if label is not None:
            self._note_locality(order[0], label)
        if order[0].aid != self._current:
            if self._current is not None:
                self.totals["rebalances"] += 1
            self._current = order[0].aid
        last: Exception | None = None
        for i, cl in enumerate(order):
            try:
                return await cl.run_batch(b, ops)
            except (AccelUnavailable, AccelServiceError) as e:
                # AccelDataError is a ValueError, not caught here: it
                # propagates to the dispatcher's data fork untouched
                last = e
                if i + 1 < len(order):
                    self.record_failure_next(cl, e)
        assert last is not None
        raise last

    def note_failure(self, exc: BaseException) -> None:
        """The dispatcher is replaying a remote batch on the LOCAL
        fallback: the whole fleet failed it (see run_batch)."""
        if self._perf is not None:
            try:
                self._perf.inc("remote_failovers")
            except Exception:  # swallow-ok: observability is best-effort
                pass

    # -- inbound + connection lifecycle --------------------------------------

    def handle(self, msg, conn=None) -> bool:
        """Route one inbound accel message to the client(s) targeting
        the sending endpoint (matched by ``conn.peer_addr`` — each
        client additionally scope-checks, so a stale endpoint's traffic
        is consumed but never trusted).  Without a connection (the
        single-target call shape) the message goes to the sole
        target; with several targets it is dropped — an unattributable
        beacon must not mark an arbitrary target healthy."""
        from ..msg import messages

        if not isinstance(msg, (messages.MAccelReply,
                                messages.MAccelBeacon)):
            return False
        clients = self._all_clients()
        if conn is not None:
            addr = getattr(conn, "peer_addr", "")
            for cl in clients:
                if cl.addr == addr:
                    cl.handle(msg, conn)
            return True
        if len(clients) == 1:
            clients[0].handle(msg)
        return True

    def on_reset(self, conn) -> None:
        for cl in self._all_clients():
            cl.on_reset(conn)

    # -- live config ---------------------------------------------------------

    def set_addr(self, addr: str) -> None:
        """``osd_ec_accel_addr`` observer — the static-fleet compat
        shim.  Retargeting keeps the single client's semantics (in-flight batches to
        the old endpoint fail over NOW, the new endpoint starts
        clean); clearing the addr drops the shim."""
        if addr == self.addr:
            return
        self.addr = addr
        if not addr:
            if self._shim is not None:
                self._shim.set_addr("")
                self._shim = None
            return
        if self._shim is None:
            self._shim = self._new_client(addr)
        else:
            self._shim.set_addr(addr)

    def set_mode(self, mode: str) -> None:
        """``osd_ec_accel_mode`` observer; off clears every target's
        sticky down state (the single client's rule, applied fleet-wide)."""
        self.mode = mode
        for cl in self._all_clients():
            cl.set_mode(mode)

    def _propagate(self, attr: str, value: float) -> None:
        for cl in self._all_clients():
            setattr(cl, attr, float(value))

    @property
    def deadline(self) -> float:
        return self._deadline

    @deadline.setter
    def deadline(self, v: float) -> None:
        self._deadline = float(v)
        self._propagate("deadline", v)

    @property
    def retry_interval(self) -> float:
        return self._retry_interval

    @retry_interval.setter
    def retry_interval(self, v: float) -> None:
        self._retry_interval = float(v)
        self._propagate("retry_interval", v)

    @property
    def stale_interval(self) -> float:
        return self._stale_interval

    @stale_interval.setter
    def stale_interval(self, v: float) -> None:
        self._stale_interval = float(v)
        self._propagate("stale_interval", v)

    # -- fleet health (aggregate view; single-client compat attributes) --------------

    @property
    def unreachable(self) -> bool:
        """True when the WHOLE configured fleet is down (feeds
        ACCEL_UNREACHABLE; a partial outage is ACCEL_FLEET_DEGRADED
        instead, via the fleet gauges).  Mon-marked-down map entries
        count as down capacity: a map whose every member died must
        read unreachable, not "no fleet"."""
        cands = self._candidates()
        if cands:
            return all(cl.unreachable for cl in cands)
        return self._map_down > 0

    @property
    def remote_state(self) -> int:
        """Worst breaker state across the fleet (single-client compat: with a
        single target this is exactly that target's state)."""
        return max(
            (cl.remote_state for cl in self._candidates()), default=0
        )

    @property
    def client_totals(self) -> dict:
        out = {"batches": 0, "ops": 0, "bytes": 0, "failures": 0,
               "data_errors": 0, "routed_away": 0, "beacons": 0,
               "resets": 0}
        for cl in self._all_clients():
            for k, v in cl.totals.items():
                out[k] = out.get(k, 0) + v
        return out

    def aggregate_totals(self) -> dict:
        t = dict(self.client_totals)
        for k, v in self.totals.items():
            t[k] = t.get(k, 0) + v
        return t

    def refresh_gauges(self) -> None:
        """Fleet-level gauges off the OSD report tick (perf-reset
        proof, the single client's rule): ``remote_unreachable`` = the whole
        fleet is down, ``fleet_up``/``fleet_down`` feed
        ACCEL_FLEET_DEGRADED, ``remote_state`` the worst breaker.
        Per-target gauges refresh through each client's own handle."""
        for cl in self._all_clients():
            cl.refresh_gauges()
        if self._perf is None:
            return
        off = self.mode == "off"
        cands = self._candidates() if not off else []
        map_down = self._map_down if not off else 0
        down = sum(1 for cl in cands if cl.unreachable) + map_down
        size = len(cands) + map_down
        up = size - down
        try:
            self._perf.set("fleet_size", size)
            self._perf.set("fleet_up", up)
            self._perf.set("fleet_down", down)
            self._perf.set(
                "remote_unreachable",
                1 if (size and up == 0) else 0,
            )
            self._perf.set("remote_state", self.remote_state)
            self._perf.set("remote_queue_depth", max(
                (cl.remote_queue for cl in cands), default=0
            ))
        except Exception:  # swallow-ok: observability is best-effort
            pass

    # -- admin ---------------------------------------------------------------

    def dump(self) -> dict:
        """The remote slice of ``dump_ec_dispatch``: router policy +
        the per-accel table (load, health, per-target totals)."""
        return {
            "mode": self.mode,
            "map_epoch": self.map_epoch,
            "static_addr": self.addr,
            "current": self._current,
            "deadline_s": self._deadline,
            "stale_interval_s": self._stale_interval,
            "unreachable": self.unreachable,
            "fleet": {
                str(cl.aid if cl.aid is not None else "static"):
                    cl.dump()
                for cl in self._all_clients()
            },
            "totals": self.aggregate_totals(),
        }
