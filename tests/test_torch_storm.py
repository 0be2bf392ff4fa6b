"""The port's storm driver held to the reference's fault matrix, on the
CPU.

Every case of ``tests/test_churn_storm.py`` runs here on the port's
``MiniCluster(device="cpu")`` with the port's ``ClientLoad`` and
``StormDriver``, and checks what the reference's case checks: zero
failed client ops, zero lost acked writes, every PG clean, and the
counters each scenario moves.  In the matrix, the device plan of the
churn (``ChurnPlanner`` on the CPU, through ``StormDriver``'s device)
must equal the live cluster's remap (``predicted == actual``, non-empty)
in every scenario; the reference checks it in the single-kill one.  The
peering, reservation and double-flip cases run on the port's OSD, with
the port's PG log and store classes.  The ``ProcCluster`` case lives in
``tests/test_torch_proc_cluster.py``.

Every scenario runs under ``asyncio.timeout`` (``LIMIT_S``).
"""

import asyncio
import json
import types

import pytest

from ceph_tpu.rados.storm import StormDriver as RefStormDriver

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.msg import messages
from ceph_tpu_torch.osd import peering
from ceph_tpu_torch.osd.daemon import OI_KEY, CollectionId, ObjectId
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.pg_log import (
    Eversion,
    PGLogEntry,
    add_log_entry_to_txn,
    meta_oid,
    read_log,
    stash_name,
)
from ceph_tpu_torch.rados import ClientLoad, MiniCluster, StormDriver
from ceph_tpu_torch.store import Transaction

LIMIT_S = 90.0
PAYLOAD = bytes(range(256)) * 32  # 8 KiB


def run(coro):
    async def bounded():
        async with asyncio.timeout(LIMIT_S):
            return await coro
    return asyncio.run(bounded())


async def _ec_cluster(n_osds=4, pg_num=8, **kw):
    cluster = MiniCluster(n_osds=n_osds, device="cpu", **kw)
    await cluster.start()
    cl = await cluster.client()
    await cl.create_pool("ec", "erasure", pg_num=pg_num)  # isa k2m1
    return cluster, cl


def _plan_matches(churn: dict) -> None:
    assert churn["predicted"] == churn["actual"]
    assert churn["predicted"]  # a kill must remap something
    assert churn["plan"]["pgs_remapped"] == len(churn["predicted"])


class _Planned:
    """Wraps the driver's kill: the map before it and after the victim
    is down, planned by ``plan_between`` (the scenarios but the
    single-kill one do not plan)."""

    def __init__(self, driver: StormDriver):
        self.driver = driver
        self.plans: list[dict] = []
        cluster = driver.cluster
        kill, down = cluster.kill_osd, cluster.wait_for_osd_down

        async def kill_osd(osd_id, crash=False):
            self._pre = driver.snapshot_map()
            await kill(osd_id, crash=crash)

        async def wait_for_osd_down(osd_id, timeout=10.0):
            await down(osd_id, timeout)
            self.plans.append(driver.plan_between(self._pre, driver.snapshot_map()))

        cluster.kill_osd = kill_osd
        cluster.wait_for_osd_down = wait_for_osd_down

    def check(self, n: int) -> None:
        assert len(self.plans) == n
        for churn in self.plans:
            _plan_matches(churn)


class TestStormMatrix:
    def test_single_kill_storm(self):
        """Scenario 1: one OSD dies under load and rejoins.  Invariants
        hold, the device churn plan predicts EXACTLY the PGs the live
        cluster remapped, and the recovery work is visible as traced
        spans + klass=recovery flight records."""

        async def main():
            cluster, cl = await _ec_cluster()
            try:
                load = ClientLoad(cl.io_ctx("ec"), prefix="sk")
                load.start(writers=2)
                driver = StormDriver(cluster, cl, ["ec"])
                assert driver.device.type == "cpu"
                result = await driver.scenario_single_kill(load)
                assert result["ops_acked"] > 0
                _plan_matches(result["churn"])
                remaps = sum(
                    o.perf.get("churn").get("pgs_remapped")
                    for o in cluster.osds.values()
                )
                assert remaps > 0

                prov = tracing._providers.get(tracing.STACK_PROVIDER)
                rec_traces = {
                    e["trace"] for e in prov.events()
                    if e.get("event") == "span" and "-rec-" in str(
                        e.get("trace"))
                }
                assert rec_traces, "no traced recovery passes"
                pushed = [
                    t for t in rec_traces
                    if any(h["hop"] == "recovery_push"
                           for h in tracing.op_waterfall(t)["hops"])
                ]
                assert pushed, "no recovery_push spans in the waterfall"
                scans = [
                    t for t in rec_traces
                    if any(h["hop"] == "peering_scan"
                           for h in tracing.op_waterfall(t)["hops"])
                ]
                assert scans, "no peering_scan spans in the waterfall"

                rec_launches = []
                for osd in cluster.osds.values():
                    d = osd.ec_dispatch.flight.dump()
                    rec_launches += [
                        r for r in d["launches"]
                        if r.get("klass") == "recovery"
                    ]
                assert rec_launches, "no recovery-class device launches"
                found = False
                for osd in cluster.osds.values():
                    for t in rec_traces:
                        rec = osd.ec_dispatch.flight.lookup(t)
                        if rec is not None:
                            assert rec["klass"] == "recovery"
                            found = True
                assert found, "recovery trace not findable in flight"
            finally:
                await cluster.stop()

        run(main())

    def test_rolling_churn(self):
        """Scenario 2: rolling multi-OSD kill/rejoin; invariants hold,
        kicks were delivered for every epoch and each kill's plan
        equals its remap."""

        async def main():
            cluster, cl = await _ec_cluster(n_osds=5)
            try:
                load = ClientLoad(cl.io_ctx("ec"), prefix="roll")
                load.start(writers=2)
                driver = StormDriver(cluster, cl, ["ec"])
                planned = _Planned(driver)
                result = await driver.scenario_rolling(load)
                assert result["ops_acked"] > 0
                assert result["kicks"] > 0
                assert result["victims"] == [3, 4]
                planned.check(2)
            finally:
                await cluster.stop()

        run(main())

    def test_backfill_vs_recovery_contention(self):
        """Scenario 3: osd_max_backfills=1 and a rejoining member that
        owes many PGs recovery — the AsyncReservers must actually
        queue (reservation_waits) while every invariant holds."""

        async def main():
            cluster, cl = await _ec_cluster(n_osds=4, pg_num=16)
            try:
                load = ClientLoad(
                    cl.io_ctx("ec"), prefix="bf", objects=24,
                    pause=0.005,
                )
                load.start(writers=3)
                driver = StormDriver(cluster, cl, ["ec"])
                planned = _Planned(driver)
                result = await driver.scenario_backfill_contention(load)
                assert result["ops_acked"] > 0
                assert result["reservation_waits"] > 0, \
                    "osd_max_backfills=1 never queued a reservation"
                planned.check(1)
            finally:
                await cluster.stop()

        run(main())

    def test_scrub_storm_collides_with_recovery(self):
        """Scenario 4: an operator deep-scrub wave over every PG races
        live recovery; nothing tears, everything reaches clean."""

        async def main():
            cluster, cl = await _ec_cluster()
            try:
                load = ClientLoad(cl.io_ctx("ec"), prefix="ss")
                load.start(writers=2)
                driver = StormDriver(cluster, cl, ["ec"])
                planned = _Planned(driver)
                result = await driver.scenario_scrub_storm(load)
                assert result["ops_acked"] > 0
                assert result["storm_scrubs"] > 0
                planned.check(1)
            finally:
                await cluster.stop()

        run(main())

    def test_accel_death_mid_recovery(self):
        """Scenario 5: recovery batches route through the accelerator
        fleet and the serving accelerator dies mid-recovery — batches
        fail over with zero failed ops, and the survivor's scheduler and
        flight saw the RECOVERY class."""

        async def main():
            cluster = MiniCluster(
                n_osds=4, device="cpu",
                config_overrides={
                    "accel_beacon_interval": 0.05,
                    "osd_ec_accel_retry_interval": 0.1,
                },
            )
            await cluster.start()
            try:
                accs = [await cluster.start_accel() for _ in range(2)]
                cluster.set_accel_mode("prefer")
                async with asyncio.timeout(10):
                    while not all(
                        len(o.accel_client._map_clients) == 2
                        for o in cluster.osds.values()
                    ):
                        await asyncio.sleep(0.02)
                cl = await cluster.client()
                await cl.create_pool("ec", "erasure", pg_num=8)
                load = ClientLoad(
                    cl.io_ctx("ec"), prefix="ad", objects=16,
                    size=8192, pause=0.005,
                )
                load.start(writers=3)
                driver = StormDriver(cluster, cl, ["ec"])
                planned = _Planned(driver)
                result = await driver.scenario_accel_death(load)
                assert result["ops_acked"] > 0
                planned.check(1)
                survivor = accs[1]
                launches = survivor.dispatch.flight.dump()["launches"]
                rec = [r for r in launches
                       if r.get("klass") == "recovery"]
                assert rec, "accel never served a recovery-class batch"
                st = survivor.scheduler._state["recovery"]
                assert st.pace_calls > 0, \
                    "accel scheduler never saw the recovery class"
                assert survivor.scheduler.dump()["classes"][
                    "recovery"]["pace_calls"] > 0
            finally:
                await cluster.stop()

        run(main())


def test_plan_between_equals_the_references_on_the_same_maps():
    """The same pre and post maps (a 4-OSD map with an EC pool, one OSD
    marked down) planned by the port's driver on the CPU and diffed by
    the reference's scalar ``actual_remapped``: the same remapped PGs."""
    import ceph_tpu.osd.osdmap as ref_osdmap

    async def main():
        cluster, cl = await _ec_cluster()
        try:
            driver = StormDriver(cluster, cl, ["ec"])
            pre = driver.snapshot_map()
            await cluster.kill_osd(3)
            await cluster.wait_for_osd_down(3)
            post = driver.snapshot_map()
            return driver.plan_between(pre, post), pre.to_dict(), post.to_dict()
        finally:
            await cluster.stop()

    churn, pre, post = run(main())
    _plan_matches(churn)
    ref_actual = RefStormDriver.actual_remapped(
        ref_osdmap.OSDMap.from_dict(pre), ref_osdmap.OSDMap.from_dict(post))
    assert churn["predicted"] == ref_actual
    assert OSDMap.from_dict(post).epoch > OSDMap.from_dict(pre).epoch


class TestPeeringReentrancy:
    def test_back_to_back_kicks_coalesce_not_stack(self):
        """Map epochs delivered faster than passes complete must
        COALESCE into one pending pass, never run concurrently."""

        async def main():
            async with MiniCluster(n_osds=1, device="cpu") as cluster:
                osd = next(iter(cluster.osds.values()))
                await asyncio.sleep(0.1)  # boot-time kicks drain
                concurrency = {"now": 0, "max": 0, "runs": 0}

                async def slow_pass(self):
                    concurrency["now"] += 1
                    concurrency["runs"] += 1
                    concurrency["max"] = max(
                        concurrency["max"], concurrency["now"]
                    )
                    try:
                        await asyncio.sleep(0.15)
                    finally:
                        concurrency["now"] -= 1

                osd.recovery._recover_all = types.MethodType(
                    slow_pass, osd.recovery
                )
                prec = osd.perf.get("recovery")
                kicks0 = prec.get("kicks")
                co0 = prec.get("coalesced_kicks")
                for _ in range(6):
                    osd.recovery.kick()
                    await asyncio.sleep(0.03)  # mid-pass kicks
                async with asyncio.timeout(5):
                    while osd.recovery._pass_running or \
                            osd.recovery._wakeup.is_set():
                        await asyncio.sleep(0.02)
                await asyncio.sleep(0.2)
                assert prec.get("kicks") - kicks0 == 6
                assert prec.get("coalesced_kicks") - co0 >= 4
                assert concurrency["max"] == 1, "passes overlapped"
                assert concurrency["runs"] <= 3

        run(main())

    def test_mid_pass_epoch_is_interrupted_and_rerun(self):
        """A map landing mid-pass is counted and the pass re-runs on
        the new epoch (the snapshot rule)."""

        async def main():
            async with MiniCluster(n_osds=2, device="cpu") as cluster:
                cl = await cluster.client()
                await cl.create_pool("rep", "replicated", size=2)
                pool = cl.osdmap.lookup_pool("rep")
                lead = next(
                    cl.osdmap.pg_to_up_acting_osds(pg)[3]
                    for pg in cl.osdmap.pgs_of_pool(pool.id)
                    if cl.osdmap.pg_to_up_acting_osds(pg)[3] >= 0
                )
                osd0 = cluster.osds[lead]
                prec = osd0.perf.get("recovery")
                before = prec.get("interrupted_passes")

                async def slow_pg(pg, pool, acting):
                    await asyncio.sleep(0.2)

                osd0.recovery._recover_pg = slow_pg
                task = asyncio.ensure_future(
                    osd0.recovery._recover_all()
                )
                await asyncio.sleep(0.05)  # snapshot taken, pass busy
                newer = OSDMap.from_dict(osd0.osdmap.to_dict())
                newer.epoch += 1
                osd0.osdmap = newer  # the mid-pass push
                await task
                assert prec.get("interrupted_passes") >= before + 1
                assert osd0.recovery._pass_map is None

        run(main())


class TestReservationPreemption:
    def test_higher_priority_pg_preempts_revocable_grant(self):
        """With one remote slot, a held low-priority grant is revoked
        when a strictly-higher-priority PG requests — the primary is
        told (op=revoke), counted, and re-queued."""

        async def main():
            async with MiniCluster(n_osds=2, device="cpu") as cluster:
                target = cluster.osds[0]
                target.config.set("osd_max_backfills", 1)
                sent: list = []

                class _Conn:
                    def send(self, msg):
                        sent.append(msg)

                conn = _Conn()
                target.recovery.handle_reserve(
                    conn, messages.MRecoveryReserve(
                        pgid="9.0", tid=1, from_osd=1,
                        op="request", prio=1,
                    )
                )
                await asyncio.sleep(0.05)
                assert [m.op for m in sent] == ["grant"]
                target.recovery.handle_reserve(
                    conn, messages.MRecoveryReserve(
                        pgid="9.1", tid=2, from_osd=1,
                        op="request", prio=9,
                    )
                )
                await asyncio.sleep(0.05)
                ops = [m.op for m in sent]
                assert "revoke" in ops and ops.count("grant") == 2
                assert target.remote_reserver.preemptions == 1

                primary = cluster.osds[1]
                prec = primary.perf.get("recovery")
                before = prec.get("reservations_revoked")
                primary.recovery.handle_reserve(
                    conn, messages.MRecoveryReserve(
                        pgid="9.0", tid=0, from_osd=0,
                        op="revoke", prio=0,
                    )
                )
                assert prec.get("reservations_revoked") == before + 1
                assert primary.recovery._retry_needed
                assert primary.recovery._wakeup.is_set()

        run(main())


async def _ec_pool(cl, name="ecpool", profile=None):
    code, status, _ = await cl.command({
        "prefix": "osd erasure-code-profile set", "name": "p22",
        "profile": profile,
    })
    assert code == 0, status
    await cl.create_pool(name, "erasure", erasure_code_profile="p22")
    return cl.io_ctx(name)


def _inject_partial_write(store, pg, shard, oid, prior: Eversion, data: bytes) -> Eversion:
    """What a mid-RMW sub-write leaves on ONE shard's store (stash, chunk,
    object info and log entry in one transaction), in the port's
    classes."""
    v2 = Eversion(prior.epoch, prior.version + 1)
    cid = CollectionId(f"{pg}s{shard}")
    soid = ObjectId(oid, shard)
    sname = stash_name(oid, v2)
    txn = (
        Transaction()
        .create_collection(cid)
        .try_stash(cid, soid, ObjectId(sname, shard))
        .write(cid, soid, 0, data)
        .setattr(cid, soid, OI_KEY, json.dumps(
            {"size": len(data), "version": v2.to_list()}
        ).encode())
    )
    add_log_entry_to_txn(txn, cid, shard, PGLogEntry("modify", oid, v2, prior, stash=sname))
    store.apply(txn)
    return v2


def _newest_entry(store, pg, shard, oid) -> PGLogEntry | None:
    cid = CollectionId(f"{pg}s{shard}")
    entries = [e for e in read_log(store, cid, shard) if e.oid == oid]
    return max(entries, key=lambda e: e.version) if entries else None


class TestDoubleFlipDivergence:
    def test_find_best_info_double_flip_interval_ordering(self):
        """Across TWO primary flips the les interval order dominates
        totally, whatever the versions say."""
        infos = {
            0: peering.PGShardInfo(2, Eversion(9, 99), 40),
            1: peering.PGShardInfo(5, Eversion(9, 98), 39),
            2: peering.PGShardInfo(7, Eversion(3, 1), 1),
            3: peering.PGShardInfo(7, Eversion(3, 2), 2),
        }
        assert peering.find_best_info(infos) == 3
        del infos[2], infos[3]
        assert peering.find_best_info(infos) == 1

    def test_divergent_rollback_survives_double_primary_flip(self):
        """Partition -> stale-interval writes (decodable) -> heal ->
        SECOND flip before the PG is clean.  The interval-3 primary must
        still fence the stale pair on les and roll their entries back —
        acked v1 bytes survive, the never-acked write dies, and the
        rollback is counted."""

        async def main():
            async with MiniCluster(n_osds=6, device="cpu") as cluster:
                cl = await cluster.client()
                io = await _ec_pool(
                    cl, profile={"plugin": "isa",
                                 "technique": "reed_sol_van",
                                 "k": "2", "m": "2"},
                )
                await io.write_full("obj", PAYLOAD)  # v1 ACKED
                pool = cl.osdmap.lookup_pool("ecpool")
                pg, acting, prim = cl.osdmap.object_to_acting("obj", pool.id)

                def les_of(osd_id, shard):
                    st = cluster.stores[osd_id]
                    try:
                        omap = st.omap_get(
                            CollectionId(f"{pg}s{shard}"), meta_oid(shard)
                        )
                    except KeyError:
                        return 0
                    raw = omap.get(peering.INFO_KEY)
                    return json.loads(raw).get("les", 0) if raw else 0

                async with asyncio.timeout(15):
                    while any(
                        les_of(o, s) == 0 for s, o in enumerate(acting)
                    ):
                        cluster.osds[prim].recovery.kick()
                        await asyncio.sleep(0.1)

                zombies = [(0, acting[0]), (1, acting[1])]
                for _s, o in zombies:
                    await cluster.kill_osd(o, crash=True)
                    await cluster.wait_for_osd_down(o)
                async with asyncio.timeout(20):
                    while await io.read("obj") != PAYLOAD:
                        await asyncio.sleep(0.1)
                async with asyncio.timeout(20):
                    while True:
                        els = [
                            les_of(o, s) for s, o in enumerate(acting)
                            if o not in (z[1] for z in zombies)
                            and o in cluster.osds
                        ]
                        if els and all(
                            v > cl.osdmap.epoch - 10 and v >= 2
                            for v in els
                        ) and len(set(els)) == 1:
                            break
                        await asyncio.sleep(0.1)

                v2s = []
                for s, o in zombies:
                    st = cluster.stores[o]
                    prior = _newest_entry(st, pg, s, "obj").version
                    chunk_len = len(
                        st.read(CollectionId(f"{pg}s{s}"), ObjectId("obj", s))
                    )
                    v2s.append(_inject_partial_write(
                        st, pg, s, "obj", prior, b"\xbb" * chunk_len
                    ))

                for _s, o in zombies:
                    await cluster.restart_osd(o)
                    await cluster.wait_for_osd_up(o)
                _pg2, acting2, prim2 = cl.osdmap.object_to_acting("obj", pool.id)
                if prim2 in cluster.osds and prim2 not in (
                    z[1] for z in zombies
                ):
                    await cluster.kill_osd(prim2, crash=True)
                    await cluster.wait_for_osd_down(prim2)

                async with asyncio.timeout(30):
                    while not all(
                        (e := _newest_entry(cluster.stores[o], pg, s, "obj"))
                        is not None and e.version < v2s[0]
                        for s, o in zombies
                    ):
                        await asyncio.sleep(0.1)
                assert await io.read("obj") == PAYLOAD
                rollbacks = sum(
                    o.perf.get("recovery").get("divergent_rollbacks")
                    for o in cluster.osds.values()
                )
                assert rollbacks > 0

        run(main())


def test_storm_driver_plans_on_the_card_unless_asked(monkeypatch):
    """``StormDriver`` takes its plan's device from ``device=`` first,
    then from the cluster; a cluster without one leaves the card, which
    raises here without CUDA."""
    import torch

    from ceph_tpu_torch.device import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert StormDriver(cpu, None, []).device.type == "cpu"
    assert StormDriver(object(), None, [], device="cpu").device == "cpu"
    m = OSDMap()
    with pytest.raises(DeviceUnavailableError):
        StormDriver(object(), None, []).plan_between(m, m)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_an_acked_write_of_an_unstamped_interval_survives_the_old_primarys_return(package):
    """The rolling storm's loss, made deterministic.  With the primary
    down, object ``b`` is written and ACKED on the three other shards;
    no recovery pass stamps that interval's last_epoch_started, while
    the old primary's own shard carries the highest one.  Back up, the
    old primary is the authoritative member and its log lacks ``b``, so
    the others' entries for ``b`` look divergent.  The port rolls back
    only what it can prove was never acked, so ``b`` is pushed to the
    returning shard and reads back; the reference rolls ``b`` back on
    every holder, and the acked write is gone."""
    if package == "port":
        P = types.SimpleNamespace(MiniCluster=MiniCluster, kw={"device": "cpu"},
                                  CollectionId=CollectionId, meta_oid=meta_oid,
                                  INFO_KEY=peering.INFO_KEY, Transaction=Transaction)
    else:
        from ceph_tpu.osd import peering as ref_peering
        from ceph_tpu.osd.daemon import CollectionId as RefCollectionId
        from ceph_tpu.osd.pg_log import meta_oid as ref_meta_oid
        from ceph_tpu.rados import MiniCluster as RefMiniCluster
        from ceph_tpu.store import Transaction as RefTransaction

        P = types.SimpleNamespace(MiniCluster=RefMiniCluster, kw={}, CollectionId=RefCollectionId,
                                  meta_oid=ref_meta_oid, INFO_KEY=ref_peering.INFO_KEY,
                                  Transaction=RefTransaction)

    async def main():
        async with P.MiniCluster(n_osds=4, **P.kw) as cluster:
            cl = await cluster.client()
            code, status, _ = await cl.command({
                "prefix": "osd erasure-code-profile set", "name": "p22",
                "profile": {"plugin": "isa", "k": "2", "m": "2"}})
            assert code == 0, status
            await cl.create_pool("ec", "erasure", erasure_code_profile="p22", pg_num=1)
            io = cl.io_ctx("ec")
            await io.write_full("a", PAYLOAD)
            pool = cl.osdmap.lookup_pool("ec")
            pg, acting, prim = cl.osdmap.object_to_acting("a", pool.id)
            assert acting.index(prim) == 0
            await cluster.kill_osd(prim, crash=True)
            await cluster.wait_for_osd_down(prim)
            await io.write_full("b", PAYLOAD[::-1])  # ACKED on shards 1-3
            # the old primary's shard carries the highest les
            st = cluster.stores[prim]
            cid = P.CollectionId(f"{pg}s0")
            st.apply(P.Transaction().omap_setkeys(
                cid, P.meta_oid(0), {P.INFO_KEY: json.dumps({"les": 10**6}).encode()}))
            await cluster.restart_osd(prim)
            await cluster.wait_for_osd_up(prim)

            def holders():
                return [s for s, o in enumerate(acting) if "b" in {
                    x.name for x in cluster.stores[o].list_objects(P.CollectionId(f"{pg}s{s}"))}]

            async with asyncio.timeout(15):
                while True:
                    cluster.osds[prim].recovery.kick()
                    held = holders()
                    if len(held) < 2:  # fewer than k: undecodable
                        return f"lost: held by shards {held}"
                    if len(held) == 4 and await io.read("b") == PAYLOAD[::-1]:
                        return "kept"
                    await asyncio.sleep(0.2)

    got = run(main())
    assert got == "kept" if package == "port" else got.startswith("lost"), got
