"""The port's recovery held against the reference's, on the CPU.

Twins of the first five cases of ``tests/test_recovery.py`` (the thrash
case is left out): each scenario runs on the reference's ``MiniCluster``
and on the port's (``MiniCluster(device="cpu")``), waits for recovery to
bring the rejoined OSD to the primary's version, and then holds the two
runs equal: the reads, and every OSD's store, rebuilt chunks included
(each shard's bytes, crc table and object info, exact equality, and
each PG shard's log).  One EC case also runs with the port's
``native.host_engine_active`` patched to False, so that the backfill's
decode and re-encode take the dispatcher's batching lane with the plain
versions of the kernels, as a CUDA codec takes the kernel lane on the
card.  Every wait is bounded (``wait_until``, ``LIMIT_S``).
"""

import pytest

import ceph_tpu_torch.utils.native as port_native
from tests.test_torch_rados import (
    PORT,
    acting_of,
    shard_version,
    twin,
    wait_shard_version,
    wait_until,
)


async def _ec_rejoined_shard_backfilled(P, cluster, rec):
    cl = await cluster.client()
    await cl.create_pool("ecpool", "erasure")
    io = cl.io_ctx("ecpool")
    v1, v2 = bytes([1]) * 8192, bytes([2]) * 8192
    await io.write_full("obj", v1)
    pg, acting, primary = await acting_of(cl, "ecpool", "obj")
    victim = next(o for o in acting if o != primary)
    shard = acting.index(victim)
    await cluster.kill_osd(victim)
    await cluster.wait_for_osd_down(victim)
    await io.write_full("obj", v2)       # victim misses this
    await io.write_full("newobj", v2)    # and this entirely
    await cluster.restart_osd(victim)
    await cluster.wait_for_osd_up(victim)
    # recovery rebuilds the stale + missing shard chunks
    want = shard_version(P, cluster.stores[primary], pg, acting.index(primary), "obj")
    await wait_shard_version(P, cluster, pg, shard, victim, "obj", want)
    pg2, acting2, primary2 = await acting_of(cl, "ecpool", "newobj")
    if victim in acting2:
        want2 = shard_version(P, cluster.stores[primary2], pg2,
                              acting2.index(primary2), "newobj")
        await wait_shard_version(P, cluster, pg2, acting2.index(victim), victim,
                                 "newobj", want2)
    rec.append(("obj", await io.read("obj")))
    rec.append(("newobj", await io.read("newobj")))
    assert rec[-2][1] == v2 and rec[-1][1] == v2


def test_ec_rejoined_shard_backfilled():
    """Objects written while a shard OSD was down are rebuilt on rejoin."""
    twin(_ec_rejoined_shard_backfilled, n_osds=4)


def test_ec_rejoined_shard_backfilled_on_the_batching_lane(monkeypatch):
    """The same backfill with the port's host engine gated off: the
    recovery read's decode and its re-encode are batched launches of the
    plain kernels, none native-direct, none replayed."""
    monkeypatch.setattr(port_native, "host_engine_active",
                        lambda device=None: False)
    lanes = []

    async def scenario(P, cluster, rec):
        await _ec_rejoined_shard_backfilled(P, cluster, rec)
        if P is PORT:
            for osd in cluster.osds.values():
                lanes.append(osd.ec_dispatch.dump()["totals"])
            pushed = sum(o.perf.get("recovery").get("pushes")
                         for o in cluster.osds.values())
            assert pushed > 0

    twin(scenario, n_osds=4)
    assert sum(t["native_direct"] for t in lanes) == 0
    assert sum(t["lanes"]["device"]["batches"] for t in lanes) > 0
    assert sum(t["failovers"] + t["fallback_direct"] for t in lanes) == 0


def test_ec_delete_propagates_on_rejoin():
    """An object deleted while a shard was down is removed on rejoin
    (no resurrection from the stale shard)."""

    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", bytes(8192))
        pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        victim = next(o for o in acting if o != primary)
        shard = acting.index(victim)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        await io.remove("obj")
        await cluster.restart_osd(victim)
        await cluster.wait_for_osd_up(victim)
        store = cluster.stores[victim]
        await wait_until(lambda: not store.exists(
            P.store.CollectionId(f"{pg}s{shard}"), P.store.ObjectId("obj", shard)))

    twin(scenario, n_osds=4)


def test_replicated_backfill_on_rejoin():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("rep", "replicated", size=3)
        io = cl.io_ctx("rep")
        await io.write_full("a", b"v1")
        pg, acting, primary = await acting_of(cl, "rep", "a")
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        await io.write_full("a", b"v2-new-content")
        await io.write_full("b", b"fresh")
        await cluster.restart_osd(victim)
        await cluster.wait_for_osd_up(victim)
        store = cluster.stores[victim]
        cid = P.store.CollectionId(str(pg))
        await wait_until(
            lambda: store.exists(cid, P.store.ObjectId("a"))
            and bytes(store.read(cid, P.store.ObjectId("a"))) == b"v2-new-content")
        pgb, actingb, _primaryb = await acting_of(cl, "rep", "b")
        if victim in actingb:
            await wait_until(lambda: store.exists(
                P.store.CollectionId(str(pgb)), P.store.ObjectId("b")))
        # the whole-object push carries the version: settle on it too
        want = shard_version(P, cluster.stores[primary], pg, -1, "a")
        await wait_shard_version(P, cluster, pg, -1, victim, "a", want)

    twin(scenario, n_osds=3)


def test_replicated_delete_propagates_on_rejoin():
    """Replicated deletes are logged as deletes, so recovery removes the
    object from a rejoined replica instead of resurrecting it."""

    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("rep", "replicated", size=3)
        io = cl.io_ctx("rep")
        await io.write_full("doomed", b"to-be-deleted")
        pg, acting, primary = await acting_of(cl, "rep", "doomed")
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        await io.remove("doomed")
        await cluster.restart_osd(victim)
        await cluster.wait_for_osd_up(victim)
        store = cluster.stores[victim]
        await wait_until(lambda: not store.exists(
            P.store.CollectionId(str(pg)), P.store.ObjectId("doomed")))
        with pytest.raises(P.rados.RadosError):
            await io.read("doomed")

    twin(scenario, n_osds=3)


def test_replicated_partial_write_recovers():
    """Partial writes update the OI version, so recovery can tell which
    replica is current after a rejoin."""

    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("rep", "replicated", size=3)
        io = cl.io_ctx("rep")
        await io.write_full("obj", b"AAAAAAAA")
        pg, acting, primary = await acting_of(cl, "rep", "obj")
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        await io.write("obj", b"BB", offset=2)   # partial overwrite
        await io.write("obj", b"CC", offset=10)  # partial extend
        await cluster.restart_osd(victim)
        await cluster.wait_for_osd_up(victim)
        want = b"AABBAAAA\x00\x00CC"
        store = cluster.stores[victim]
        cid = P.store.CollectionId(str(pg))
        await wait_until(
            lambda: store.exists(cid, P.store.ObjectId("obj"))
            and bytes(store.read(cid, P.store.ObjectId("obj"))) == want)
        want_v = shard_version(P, cluster.stores[primary], pg, -1, "obj")
        await wait_shard_version(P, cluster, pg, -1, victim, "obj", want_v)
        rec.append(("read", await io.read("obj")))
        rec.append(("stat", await io.stat("obj")))
        assert rec[-2][1] == want and rec[-1][1] == len(want)

    twin(scenario, n_osds=3)
