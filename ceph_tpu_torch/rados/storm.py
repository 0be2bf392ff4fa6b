"""Storm fault matrix: scripted cluster churn under sustained client
load, with hard invariants.

The scenario driver runs a live cluster (MiniCluster in-process, or any
object with the same kill/restart/mon surface) through the churn
scenarios ROADMAP item 4 names — single OSD SIGKILL, rolling multi-OSD
kill/rejoin, backfill-vs-recovery reservation contention, a scrub storm
colliding with recovery, and accelerator death mid-recovery — while
:class:`ClientLoad` keeps real client traffic flowing, and checks the
invariants that make churn survivable:

- **zero failed client ops**: every op either acks or retargets+resends
  inside the client (rados/client.py); an exception surfacing to the
  load generator is a scenario failure;
- **zero lost acked writes**: every write the cluster ACKED reads back
  byte-identical after the storm (the model check);
- **every PG reaches clean**: a repair-free deep scrub of every pool
  reports no inconsistencies once recovery settles;
- **plans match reality**: the remapped-PG set the
  :class:`~ceph_tpu_torch.osd.churn.ChurnPlanner` computed ON DEVICE from
  the pre/post maps equals the set of PGs whose acting set actually
  changed in the mon-published map — the device plan predicts exactly
  the storm the live cluster then rides out.

Counterpart of ``ceph_tpu/rados/storm.py``.  The device plan runs on an
explicit device: ``StormDriver(..., device=)`` when given, else the
cluster's own (``MiniCluster.device``, ``ProcCluster.device``); on the
card it launches the ``crush_straw2`` kernel.  The map snapshots come
from the cluster's in-process mon when it has one, else from the
client's map subscription (a ``ProcCluster``'s mon lives in another
process).
"""

from __future__ import annotations

import asyncio
import random
import time

from ..osd.churn import ChurnPlanner
from ..osd.osdmap import OSDMap


class ClientLoad:
    """Sustained client writes with ack accounting.

    Every ACKED write lands in ``model`` (the byte oracle); every
    surfaced exception lands in ``failed`` (must stay empty).  Writers
    use per-writer object namespaces so the model is race-free, and
    each write's payload is unique (seq-stamped) so a lost ack is
    indistinguishable from nothing — a stale read at verify time IS
    the lost write."""

    def __init__(self, io, *, prefix: str = "storm", objects: int = 8,
                 size: int = 4096, pause: float = 0.01, seed: int = 7):
        self.io = io
        self.prefix = prefix
        self.objects = objects
        self.size = size
        self.pause = pause
        self.seed = seed
        self.model: dict[str, bytes] = {}
        self.failed: list[str] = []
        self.latencies: list[float] = []
        self._tasks: list[asyncio.Task] = []
        self._stop = False
        self._seq = 0

    async def _writer(self, wid: int) -> None:
        rng = random.Random(self.seed + wid)
        while not self._stop:
            self._seq += 1
            name = f"{self.prefix}-w{wid}-{rng.randrange(self.objects)}"
            # the FULL seq rides the payload: two acked writes of one
            # object can never carry identical bytes, so a lost write
            # can never hide behind a byte-identical predecessor
            stamp = self._seq.to_bytes(8, "little")
            fill = bytes([self._seq & 0xFF]) * max(0, self.size - 8)
            data = (stamp + fill)[: max(8, self.size)]
            t0 = time.perf_counter()
            try:
                await self.io.write_full(name, data)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # an error REACHING the load generator is the failed
                # client op the matrix forbids (the client's own
                # retarget/resend machinery is supposed to absorb
                # every storm)
                self.failed.append(f"{name}: {e!r}")
            else:
                self.latencies.append(time.perf_counter() - t0)
                self.model[name] = data
            await asyncio.sleep(self.pause)

    def start(self, writers: int = 2) -> None:
        self._stop = False
        for wid in range(writers):
            self._tasks.append(
                asyncio.ensure_future(self._writer(wid))
            )

    async def stop(self) -> None:
        """Graceful: writers finish their CURRENT op before exiting —
        cancelling a client coroutine mid-fan-out would inject a torn
        write the cluster never failed, corrupting the model check."""
        self._stop = True
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    async def verify(self) -> list[str]:
        """Read back every acked write; returns the lost/corrupt list
        (must be empty)."""
        lost: list[str] = []
        for name, want in sorted(self.model.items()):
            try:
                got = await self.io.read(name)
            except Exception as e:
                lost.append(f"{name}: read failed {e!r}")
                continue
            if bytes(got) != want:
                lost.append(f"{name}: bytes diverged")
        return lost

    def p99_ms(self) -> float:
        if not self.latencies:
            return 0.0
        ws = sorted(self.latencies)
        return round(ws[min(len(ws) - 1, int(len(ws) * 0.99))] * 1e3, 3)


class StormDriver:
    """Drive one live cluster through the churn fault matrix.

    ``cluster`` is a MiniCluster (kill_osd/restart_osd/wait_for_osd_*)
    or a ProcCluster (the invariants and the plan only);
    ``client`` a connected RadosClient; ``pools`` the pool names under
    load (scrubbed for the clean check); ``device`` where the churn
    plan runs (None: the cluster's device, else the card)."""

    def __init__(self, cluster, client, pools: list[str],
                 clean_timeout: float = 60.0, device=None):
        self.cluster = cluster
        self.client = client
        self.pools = list(pools)
        self.device = device if device is not None else getattr(
            cluster, "device", None)
        # wait_clean budget: raise it for slow environments (a real
        # multi-process cluster on a loaded host converges in wall
        # time, not event-loop time)
        self.clean_timeout = float(clean_timeout)

    # -- map bookkeeping -----------------------------------------------------

    def snapshot_map(self) -> OSDMap:
        """An isolated copy of the mon's CURRENT published map (the
        wire round trip, so later mon mutations cannot alias in): the
        in-process mon's, or for a cluster whose mon is another process
        the client's subscribed copy."""
        mon = getattr(self.cluster, "mon", None)
        live = mon.osdmap if mon is not None else self.client.osdmap
        return OSDMap.from_dict(live.to_dict())

    @staticmethod
    def actual_remapped(pre: OSDMap, post: OSDMap) -> set[str]:
        """The PGs whose acting set actually changed between two
        published maps, computed by the SCALAR live-cluster path —
        the ground truth a device plan is held against."""
        out: set[str] = set()
        for pid, pool in post.pools.items():
            if pid not in pre.pools:
                continue
            for pg in post.pgs_of_pool(pid):
                _u, _up, pre_act, pre_prim = pre.pg_to_up_acting_osds(pg)
                _u2, _up2, post_act, post_prim = post.pg_to_up_acting_osds(pg)
                if pre_act != post_act or pre_prim != post_prim:
                    out.add(str(pg))
        return out

    def plan_between(self, pre: OSDMap, post: OSDMap) -> dict:
        """Device-plan the churn between two live map snapshots and
        verify the prediction against the live acting diff.  Returns
        {"plan": summary, "predicted": set, "actual": set}."""
        plan = ChurnPlanner(pre, device=self.device).plan(post)
        return {
            "plan": plan.summary(),
            "predicted": plan.remapped_pgs(),
            "actual": self.actual_remapped(pre, post),
        }

    # -- settling / invariants -----------------------------------------------

    async def settle(self, timeout: float = 20.0) -> bool:
        """Best-effort wait until every live OSD's recovery loop is
        idle with nothing pending, for two consecutive polls.  Returns
        False on timeout instead of failing — full quiescence is a
        latency optimization before the authoritative clean check
        (:meth:`wait_clean`), not itself an invariant: a slow host can
        keep a retry loop breathing past any fixed deadline while the
        data is already perfectly recovered."""
        daemons = self._in_process_osds()
        if daemons is None:
            # a ProcCluster's OSDs live in other processes: there is
            # no recovery state to poll, wait_clean (scrub-driven, over
            # the wire) is the convergence check
            await asyncio.sleep(min(1.0, timeout))
            return False
        quiet = 0
        deadline = time.monotonic() + timeout
        while quiet < 2:
            if time.monotonic() > deadline:
                return False
            busy = any(
                o.recovery._pass_running or o.recovery._retry_needed
                or o.recovery._wakeup.is_set()
                for o in daemons
            )
            quiet = 0 if busy else quiet + 1
            await asyncio.sleep(0.2)
        return True

    def _in_process_osds(self) -> "list | None":
        """The cluster's in-process OSD objects, or None for a
        multi-process cluster (ProcCluster) whose daemons are only
        reachable over the wire."""
        osds = getattr(self.cluster, "osds", None)
        if not isinstance(osds, dict):
            return None
        return list(osds.values())

    async def wait_clean(self, timeout: float | None = None) -> list[dict]:
        """Repair-free deep scrub of every pool until every PG reports
        clean — the matrix's 'every PG reaches clean' invariant."""
        timeout = self.clean_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        last: list[dict] = []
        while True:
            last = []
            for pool in self.pools:
                last.extend(
                    await self.client.scrub_pool(pool, repair=False)
                )
            if last and all(r.get("clean") for r in last):
                return last
            if time.monotonic() > deadline:
                dirty = [r for r in last if not r.get("clean")]
                raise AssertionError(
                    f"PGs not clean after {timeout}s: "
                    f"{[(r['pg'], r['errors']) for r in dirty]}"
                )
            # a dirty report means outstanding repair work: re-kick
            # every primary (the operator's `ceph pg repeer` nudge) so
            # a pass that raced the rejoin re-runs promptly
            for osd in self._in_process_osds() or []:
                osd.recovery.kick()
            await asyncio.sleep(0.5)

    async def check_invariants(self, load: ClientLoad) -> dict:
        """The shared post-scenario gate: zero failed ops, zero lost
        acked writes, every PG clean.  Stops the load first (the model
        must be frozen), lets recovery settle, THEN verifies — acked
        bytes must survive recovery, and an op the cluster is still
        arbitrating (a kill-torn fan-out mid-rollback) is not a lost
        write until the arbitration is done."""
        await load.stop()
        assert not load.failed, f"failed client ops: {load.failed[:5]}"
        await self.settle()
        # every PG clean FIRST (the authoritative convergence check —
        # it re-kicks primaries until recovery has truly landed), then
        # the byte oracle: acked writes must have survived recovery
        reports = await self.wait_clean()
        lost = await load.verify()
        assert not lost, f"lost acked writes: {lost[:5]}"
        return {
            "ops_acked": len(load.latencies),
            "objects": len(load.model),
            "pgs_scrubbed": len(reports),
            "client_p99_ms": load.p99_ms(),
        }

    # -- scenarios -----------------------------------------------------------

    async def scenario_single_kill(
        self, load: ClientLoad, victim: int | None = None,
        settle_writes: float = 0.3,
    ) -> dict:
        """One OSD SIGKILLs under load, stays down long enough for
        degraded writes, rejoins; recovery backfills it."""
        await asyncio.sleep(settle_writes)
        pre = self.snapshot_map()
        if victim is None:
            victim = sorted(self.cluster.osds)[-1]
        await self.cluster.kill_osd(victim, crash=False)
        await self.cluster.wait_for_osd_down(victim)
        post = self.snapshot_map()
        await asyncio.sleep(settle_writes)  # degraded-window writes
        await self.cluster.restart_osd(victim)
        await self.cluster.wait_for_osd_up(victim)
        result = await self.check_invariants(load)
        result["churn"] = self.plan_between(pre, post)
        result["victim"] = victim
        return result

    async def scenario_rolling(
        self, load: ClientLoad, victims: list[int] | None = None,
        settle_writes: float = 0.25,
    ) -> dict:
        """Rolling churn: OSDs die and rejoin back to back — each
        rejoin lands while the previous victim's recovery may still be
        running, so map epochs outrun peering rounds (the coalescing
        the re-entrancy contract pins)."""
        if victims is None:
            victims = sorted(self.cluster.osds)[-2:]

        def _survivor_sum(key: str) -> int:
            # deltas over SURVIVORS only: a restarted victim is a
            # fresh OSD object whose counters restart at zero, so
            # including victims would make the delta lie (or go
            # negative)
            total = 0
            for oid, osd in self.cluster.osds.items():
                if oid in victims:
                    continue
                try:
                    total += osd.perf.get("recovery").get(key)
                except (KeyError, TypeError):
                    pass
            return total

        kicks0 = _survivor_sum("kicks")
        coalesced0 = _survivor_sum("coalesced_kicks")
        for victim in victims:
            await asyncio.sleep(settle_writes)
            await self.cluster.kill_osd(victim, crash=False)
            await self.cluster.wait_for_osd_down(victim)
            await asyncio.sleep(settle_writes)
            await self.cluster.restart_osd(victim)
            await self.cluster.wait_for_osd_up(victim)
        result = await self.check_invariants(load)
        result["victims"] = victims
        result["kicks"] = _survivor_sum("kicks") - kicks0
        result["coalesced_kicks"] = (
            _survivor_sum("coalesced_kicks") - coalesced0
        )
        return result

    async def scenario_backfill_contention(
        self, load: ClientLoad, victim: int | None = None,
        settle_writes: float = 0.4,
    ) -> dict:
        """Backfill-vs-recovery contention: osd_max_backfills=1 on
        every OSD, then one rejoining member owes recovery to MANY PGs
        at once — the AsyncReservers must queue (reservation_waits),
        and more-degraded PGs may preempt near-clean ones' revocable
        grants (reservations_revoked)."""
        for osd in self.cluster.osds.values():
            osd.config.set("osd_max_backfills", 1)
        if victim is None:
            victim = sorted(self.cluster.osds)[-1]
        await asyncio.sleep(settle_writes)
        await self.cluster.kill_osd(victim, crash=False)
        await self.cluster.wait_for_osd_down(victim)
        # a wide degraded window: many PGs accumulate work for the
        # rejoining member, so its remote reserver sees real contention
        await asyncio.sleep(settle_writes * 2)
        await self.cluster.restart_osd(victim)
        await self.cluster.wait_for_osd_up(victim)
        result = await self.check_invariants(load)
        result["victim"] = victim
        result["reservation_waits"] = self._sum_counter(
            "recovery", "reservation_waits"
        )
        result["preemptions"] = sum(
            o.remote_reserver.preemptions + o.local_reserver.preemptions
            for o in self.cluster.osds.values()
        )
        return result

    async def scenario_scrub_storm(
        self, load: ClientLoad, victim: int | None = None,
        settle_writes: float = 0.3,
    ) -> dict:
        """A full-pool deep-scrub wave collides with live recovery:
        scrub reads race recovery pushes on the same objects under the
        same QoS scheduler — nothing may tear."""
        if victim is None:
            victim = sorted(self.cluster.osds)[-1]
        await asyncio.sleep(settle_writes)
        await self.cluster.kill_osd(victim, crash=False)
        await self.cluster.wait_for_osd_down(victim)
        await asyncio.sleep(settle_writes)
        await self.cluster.restart_osd(victim)
        await self.cluster.wait_for_osd_up(victim)
        # recovery is (or just was) running: storm every pool with
        # operator deep-scrubs NOW, repair on
        scrubs = await asyncio.gather(*(
            self.client.scrub_pool(pool, repair=True)
            for pool in self.pools
        ))
        result = await self.check_invariants(load)
        result["victim"] = victim
        result["storm_scrubs"] = sum(len(r) for r in scrubs)
        return result

    async def scenario_accel_death(
        self, load: ClientLoad, victim: int | None = None,
        settle_writes: float = 0.3,
    ) -> dict:
        """Accelerator death MID-RECOVERY: EC recovery decode batches
        route through the shared accelerator fleet; killing the serving
        accelerator mid-storm must fail the batches over (next accel,
        else local fallback) with zero failed ops — the accelerator
        fleet's failover discipline applied to recovery traffic."""
        if victim is None:
            victim = sorted(self.cluster.osds)[-1]
        await asyncio.sleep(settle_writes)
        await self.cluster.kill_osd(victim, crash=False)
        await self.cluster.wait_for_osd_down(victim)
        await asyncio.sleep(settle_writes)

        async def _kill_accel_soon():
            # mid-recovery: let the rejoin land and the first decode
            # batches reach the accelerator, then SIGKILL it
            await asyncio.sleep(0.15)
            names = sorted(self.cluster.accels)
            if names:
                await self.cluster.kill_accel(names[0], crash=True)

        killer = asyncio.ensure_future(_kill_accel_soon())
        await self.cluster.restart_osd(victim)
        await self.cluster.wait_for_osd_up(victim)
        await killer
        result = await self.check_invariants(load)
        result["victim"] = victim
        result["remote_failovers"] = self._sum_counter(
            "accel", "remote_failover_next"
        )
        return result

    # -- helpers -------------------------------------------------------------

    def _sum_counter(self, family: str, key: str) -> int:
        total = 0
        for osd in self._in_process_osds() or []:
            try:
                total += osd.perf.get(family).get(key)
            except (KeyError, TypeError):
                pass
        return total
