"""The port's cache tiering (``ceph_tpu_torch/osd/tiering.py``) held
against the reference's, on the CPU.

Each case of ``tests/test_tiering.py`` runs twice: on the reference's
``MiniCluster`` and on the port's (``MiniCluster(device="cpu")``), the same
ops in the same order.  Each run keeps the reference case's checks and
records what it reads (client reads, where the object lives, its dirty
marker, the base copy's xattrs, the tier commands' codes); the two records
must be equal.  Once the overlay is up, the tiering agents' 1 s
background tick is held (``tiering.stop()``) and every agent pass is
driven by hand, as the reference cases drive theirs, so that no check
races the tick.

The hit sets' persisted forms cross both ways: a ``BloomHitSet``'s bytes
and a ``HitSetTracker``'s omap written by one package load in the other's,
with the same bits, counts and temperatures, and one package's bloom bytes
equal the other's for the same inserts.

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import types

import pytest

import ceph_tpu.rados as ref_rados
import ceph_tpu.store as ref_store
from ceph_tpu.osd import osdmap as ref_osdmap
from ceph_tpu.osd import tiering as ref_tiering

import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.store as port_store
from ceph_tpu_torch.osd import osdmap as port_osdmap
from ceph_tpu_torch.osd import tiering as port_tiering

LIMIT_S = 30.0

REF = types.SimpleNamespace(name="ref", rados=ref_rados, store=ref_store,
                            osdmap=ref_osdmap, tiering=ref_tiering, kw={})
PORT = types.SimpleNamespace(name="port", rados=port_rados, store=port_store,
                             osdmap=port_osdmap, tiering=port_tiering, kw={"device": "cpu"})


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def twin(scenario, **cluster_kw):
    """Run ``scenario(P, cluster, rec)`` on the reference's cluster and on
    the port's; the two records must be equal.  Returns the port's."""
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            rec = []
            async with P.rados.MiniCluster(**cluster_kw, **P.kw) as cluster:
                await scenario(P, cluster, rec)
            return rec
        out[P.name] = run(main())
    assert out["port"] == out["ref"]
    return out["port"]


async def _overlay(cl, cluster, **tier_kw):
    for osd in cluster.osds.values():
        osd.tiering.stop()  # the agent passes are the case's own
    for cmd in (
        {"prefix": "osd tier add", "pool": "base", "tierpool": "cache"},
        {"prefix": "osd tier cache-mode", "pool": "cache", "mode": "writeback", **tier_kw},
        {"prefix": "osd tier set-overlay", "pool": "base", "tierpool": "cache"},
    ):
        code, status, _ = await cl.command(cmd)
        assert code == 0, (cmd, status)
    async with asyncio.timeout(10):
        while cl.osdmap.lookup_pool("base").read_tier < 0:
            await asyncio.sleep(0.05)


async def _tiered(cl, cluster, base_type="erasure", **tier_kw):
    """base + cache pools with the overlay installed."""
    if base_type == "erasure":
        await cl.create_pool("base", "erasure")
    else:
        await cl.create_pool("base", "replicated", size=2)
    await cl.create_pool("cache", "replicated", size=2)
    await _overlay(cl, cluster, **tier_kw)


def _primary_store(P, cluster, cl, pool_name, oid):
    pool = cl.osdmap.lookup_pool(pool_name)
    pg, _acting, prim = cl.osdmap.object_to_acting(oid, pool.id)
    ec = pool.type == P.osdmap.POOL_TYPE_ERASURE
    cid = P.store.CollectionId(f"{pg}s0" if ec else str(pg))
    return cluster.osds[prim], cid, P.store.ObjectId(oid, 0 if ec else -1)


def _dirty(P, osd, cid, oid) -> bool:
    return P.tiering.DIRTY_KEY in osd.store.getattrs(cid, oid)


async def _agent_pass_all(cluster):
    for osd in cluster.osds.values():
        await osd.tiering._agent_pass()


async def _evict(P, cluster, cl, oid):
    osd, cid, soid = _primary_store(P, cluster, cl, "cache", oid)
    pool = cl.osdmap.lookup_pool("cache")
    pg, acting, _p = cl.osdmap.object_to_acting(oid, pool.id)
    await osd.tiering._evict_object(pg, pool, acting, cid, soid)
    return osd, cid, soid


# -- hit sets (no cluster) -----------------------------------------------------


def _bloom(T, target, names):
    hs = T.BloomHitSet(target_objects=target)
    for n in names:
        hs.insert(n)
    return hs


def test_bloom_membership_and_bounded_memory():
    """Memory is fixed by the target, membership holds for inserted names,
    the false-positive rate stays near 1 %, and the two packages set the
    same bits."""
    names = [f"obj-{i}" for i in range(5000)]
    got = {}
    for P in (REF, PORT):
        hs = P.tiering.BloomHitSet(target_objects=5000)
        size0 = len(hs.bits)
        for n in names:
            hs.insert(n)
        assert len(hs.bits) == size0  # no growth, ever
        assert all(f"obj-{i}" in hs for i in range(0, 5000, 7))
        fp = sum(1 for i in range(20000) if f"ghost-{i}" in hs)
        assert fp < 20000 * 0.05, f"false positive rate too high: {fp}"
        got[P.name] = (hs.nbits, hs.k, bytes(hs.bits), fp)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT), (PORT, PORT)],
                         ids=["port_to_reference", "reference_to_port", "port"])
def test_bloom_serialization_roundtrip(writer, reader):
    hs = _bloom(writer.tiering, 100, [f"x{i}" for i in range(50)])
    raw = hs.to_bytes()
    assert raw == _bloom(reader.tiering, 100, [f"x{i}" for i in range(50)]).to_bytes()
    hs2 = reader.tiering.BloomHitSet.from_bytes(raw)
    assert hs2.nbits == hs.nbits and hs2.k == hs.k
    assert all(f"x{i}" in hs2 for i in range(50))
    assert len(hs2) == 50
    assert hs2.to_bytes() == raw


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT), (PORT, PORT)],
                         ids=["port_to_reference", "reference_to_port", "port"])
def test_tracker_omap_roundtrip(writer, reader):
    tr = writer.tiering.HitSetTracker(count=3, period=1000.0)
    tr.record("hot")
    tr.sets[-1] = (tr.sets[-1][0] - 2000.0, tr.sets[-1][1])
    tr.record("hot")  # rotated: hot now in two sets
    kv = tr.to_omap()
    assert set(kv) == {"hitset_n", "hitset/0", "hitset/1"}
    tr2 = reader.tiering.HitSetTracker.from_omap(3, 1000.0, kv)
    assert tr2 is not None
    assert tr2.temperature("hot") == 2
    assert tr2.temperature("cold") == 0
    # the sets' bytes (after each entry's 8-byte age) cross unchanged
    assert [hs.to_bytes() for _t, hs in tr2.sets] == [kv[f"hitset/{i}"][8:] for i in range(2)]


def test_hit_set_rotation_and_temperature():
    got = {}
    for P in (REF, PORT):
        tr = P.tiering.HitSetTracker(count=3, period=1000.0)
        tr.record("a")
        tr.record("b")
        seen = [tr.temperature("a"), tr.temperature("ghost")]
        tr.sets[-1] = (tr.sets[-1][0] - 2000.0, tr.sets[-1][1])  # force a rotation
        tr.record("a")
        seen += [tr.temperature("a"), tr.temperature("b")]
        for _ in range(4):  # the window's cap
            tr.sets[-1] = (tr.sets[-1][0] - 2000.0, tr.sets[-1][1])
            tr.record("x")
        assert len(tr.sets) <= 3
        seen += [len(tr.sets), tr.temperature("b")]
        assert seen == [1, 0, 2, 1, 3, 0]
        got[P.name] = (seen, [hs.to_bytes() for _t, hs in tr.sets])
    assert got["port"] == got["ref"]


# -- the tier on a cluster -----------------------------------------------------


def test_persisted_temperature_survives_primary_restart():
    """The agent archives hit sets to the replicated pg meta omap; a fresh
    tracker (new primary or restart) resumes them."""
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster, base_type="replicated")
        io = cl.io_ctx("base")
        await io.write_full("warm", b"w" * 100)
        await _agent_pass_all(cluster)  # records + persists
        osd, cid, _ = _primary_store(P, cluster, cl, "cache", "warm")
        pool = cl.osdmap.lookup_pool("cache")
        pg, _a, _p = cl.osdmap.object_to_acting("warm", pool.id)
        before = osd.tiering.tracker(pg, pool).temperature("warm")
        osd.tiering._hit_sets.clear()  # a restart drops the in-memory trackers
        after = osd.tiering.tracker(pg, pool).temperature("warm")
        assert before >= 1 and after >= 1, "hit-set archive lost across tracker reload"
        omap = osd.store.omap_get(cid, P.store.ObjectId("_pgmeta_", -1))
        rec.append(("archive", sorted(k for k in omap if k.startswith("hitset"))))

    twin(scenario, n_osds=4)


def test_tier_commands_lifecycle_and_validation():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("base", "erasure")
        await cl.create_pool("cache", "replicated", size=2)
        await cl.create_pool("ec2", "erasure")
        codes = []
        for prefix, tier in (
            ("osd tier add", "ec2"),  # EC pools cannot be cache tiers
            ("osd tier add", "cache"),
            ("osd tier set-overlay", "cache"),  # overlay before cache-mode
        ):
            codes.append((await cl.command({"prefix": prefix, "pool": "base",
                                            "tierpool": tier}))[0])
        codes.append((await cl.command({"prefix": "osd tier cache-mode", "pool": "cache",
                                        "mode": "writeback"}))[0])
        for prefix in ("osd tier set-overlay", "osd tier remove",  # remove with overlay up
                       "osd tier remove-overlay", "osd tier remove"):
            codes.append((await cl.command({"prefix": prefix, "pool": "base",
                                            "tierpool": "cache"}))[0])
            if prefix == "osd tier set-overlay":
                base = cl.osdmap.lookup_pool("base")
                cache = cl.osdmap.lookup_pool("cache")
                assert base.read_tier == cache.id == base.write_tier
                assert cache.tier_of == base.id
        signs = [c < 0 for c in codes]
        assert signs == [True, False, True, False, False, True, False, False], codes
        rec.append(("codes", signs))

    twin(scenario, n_osds=4)


def test_write_lands_dirty_in_cache_then_flushes_to_base():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster)
        io = cl.io_ctx("base")  # the client speaks to the BASE name
        data = b"tiered payload " * 100
        await io.write_full("obj", data)
        osd, cid, oid = _primary_store(P, cluster, cl, "cache", "obj")
        bosd, bcid, boid = _primary_store(P, cluster, cl, "base", "obj")
        state = [osd.store.exists(cid, oid), _dirty(P, osd, cid, oid),
                 bosd.store.exists(bcid, boid)]
        await _agent_pass_all(cluster)  # the flush: base gets it, dirty clears
        state += [bosd.store.exists(bcid, boid), _dirty(P, osd, cid, oid)]
        assert await io.read("obj") == data  # served from the cache unchanged
        await io.write("obj", b"XX", offset=0)  # a re-write dirties again
        state.append(_dirty(P, osd, cid, oid))
        assert state == [True, True, False, True, False, True]
        rec.append(("state", state))

    twin(scenario, n_osds=4)


def test_read_miss_promotes_from_base():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("base", "erasure")  # seeded before tiering exists
        io = cl.io_ctx("base")
        await io.write_full("cold", b"written pre-tiering" * 50)
        await io.setxattr("cold", "k", b"v")
        await cl.create_pool("cache", "replicated", size=2)
        await _overlay(cl, cluster)
        assert await io.read("cold") == b"written pre-tiering" * 50  # promoted + served
        assert await io.getxattr("cold", "k") == b"v"
        osd, cid, oid = _primary_store(P, cluster, cl, "cache", "cold")
        assert osd.store.exists(cid, oid)
        assert not _dirty(P, osd, cid, oid)  # promoted copies are clean
        assert osd.tiering.stats["promotes"] >= 1
        rec.append(("promotes", osd.tiering.stats["promotes"]))

    twin(scenario, n_osds=4)


def test_delete_propagates_to_base():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster)
        io = cl.io_ctx("base")
        await io.write_full("dead", b"soon gone")
        await _agent_pass_all(cluster)  # flushed to base
        bosd, bcid, boid = _primary_store(P, cluster, cl, "base", "dead")
        assert bosd.store.exists(bcid, boid)
        await io.remove("dead")
        async with asyncio.timeout(10):
            while bosd.store.exists(bcid, boid):
                await asyncio.sleep(0.05)
        with pytest.raises(P.rados.RadosError) as ei:
            await io.read("dead")
        rec.append(("read", ei.value.code))

    twin(scenario, n_osds=4)


def test_flush_removes_stale_base_xattrs():
    """An xattr deleted on the cache copy must not resurrect from the
    base after flush, evict and re-promote."""
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster, base_type="replicated")
        io = cl.io_ctx("base")
        await io.write_full("obj", b"payload")
        await io.setxattr("obj", "keep", b"k")
        await io.setxattr("obj", "drop", b"d")
        await _agent_pass_all(cluster)  # flush both to base
        await io.rmxattr("obj", "drop")  # re-dirties the cache copy
        await _agent_pass_all(cluster)  # the flush must rm it on the base
        bosd, bcid, boid = _primary_store(P, cluster, cl, "base", "obj")
        user = sorted(k for k in bosd.store.getattrs(bcid, boid)
                      if k.startswith(bosd.USER_XATTR_PREFIX))
        assert user == [bosd.USER_XATTR_PREFIX + "keep"], user
        await _evict(P, cluster, cl, "obj")  # evict the clean copy, re-promote via read
        assert await io.read("obj") == b"payload"
        xs = await io.getxattrs("obj")
        assert xs == {"keep": b"k"}, xs
        rec.append(("base xattrs", user, xs))

    twin(scenario, n_osds=4)


def test_failed_base_delete_keeps_whiteout_no_resurrect():
    """If propagating an acked delete to the base fails, the object stays
    deleted (the whiteout blocks re-promotion) and the agent finishes the
    base delete later."""
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster, base_type="replicated")
        io = cl.io_ctx("base")
        await io.write_full("doomed", b"data")
        await _agent_pass_all(cluster)  # flushed to base
        bosd, bcid, boid = _primary_store(P, cluster, cl, "base", "doomed")
        assert bosd.store.exists(bcid, boid)
        originals = {}
        for osd in cluster.osds.values():  # break delete propagation everywhere
            orig = osd.tiering._pool_op
            originals[osd.osd_id] = orig

            async def failing(pool_id, oid, ops, blobs, *a, _orig=orig, **kw):
                if any(o.get("op") == "delete" for o in ops):
                    return None  # base unreachable
                return await _orig(pool_id, oid, ops, blobs, *a, **kw)

            osd.tiering._pool_op = failing
        await io.remove("doomed")  # acked despite the base failure
        assert bosd.store.exists(bcid, boid)
        with pytest.raises(P.rados.RadosError) as ei:
            await io.read("doomed")  # must NOT re-promote
        rec.append(("read while pending", ei.value.code))
        for osd in cluster.osds.values():  # heal; the agent retries the delete
            osd.tiering._pool_op = originals[osd.osd_id]
        await _agent_pass_all(cluster)
        async with asyncio.timeout(10):
            while bosd.store.exists(bcid, boid):
                await asyncio.sleep(0.05)
                await _agent_pass_all(cluster)
        with pytest.raises(P.rados.RadosError) as ei:
            await io.read("doomed")
        cosd, ccid, _ = _primary_store(P, cluster, cl, "cache", "doomed")
        assert cosd.tiering._pending_whiteouts(ccid) == []  # cleaned once confirmed
        rec.append(("read after", ei.value.code))

    twin(scenario, n_osds=4)


def test_evict_cold_objects_and_repromote():
    evicted = {}

    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster, hit_set_period=0.2, hit_set_count=2)
        code, _s, _ = await cl.command({"prefix": "osd pool set", "pool": "cache",
                                        "var": "target_max_objects", "val": "4"})
        assert code == 0
        io = cl.io_ctx("base")
        payloads = {f"o{i}": bytes([i + 1]) * 500 for i in range(8)}
        for k, v in payloads.items():
            await io.write_full(k, v)
        await _agent_pass_all(cluster)  # flush everything
        await asyncio.sleep(0.6)  # age the hit sets: everything goes cold
        for osd in cluster.osds.values():
            for tr in osd.tiering._hit_sets.values():
                tr._rotate()
        await asyncio.sleep(0.6)
        await _agent_pass_all(cluster)  # the evict pass
        evicted[P.name] = sum(o.tiering.stats["evictions"] for o in cluster.osds.values())
        assert evicted[P.name] > 0, "no cold objects were evicted"
        for k, v in payloads.items():  # every object reads back (re-promoted)
            assert await io.read(k) == v, k
        rec.append(("reads", sorted(payloads)))

    twin(scenario, n_osds=4)
    assert evicted["port"] > 0 and evicted["ref"] > 0


def test_base_pool_name_is_transparent_through_cycles():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster)
        io = cl.io_ctx("base")
        for rnd in range(4):
            data = bytes([65 + rnd]) * (300 + rnd)
            await io.write_full("obj", data)
            if rnd % 2:
                await _agent_pass_all(cluster)
            assert await io.read("obj") == data
            rec.append(("read", rnd))
        await _agent_pass_all(cluster)
        assert await io.read("obj") == bytes([68]) * 303
        bosd, bcid, boid = _primary_store(P, cluster, cl, "base", "obj")
        rec.append(("base", bosd.store.exists(bcid, boid)))

    twin(scenario, n_osds=4)


def test_xattr_on_miss_promotes_not_clobbers():
    """A bare setxattr on an object held only in the base promotes first;
    the later flush carries the base data, not an empty cache shell."""
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster)
        io = cl.io_ctx("base")
        await io.write_full("obj", b"precious base bytes")
        await _agent_pass_all(cluster)  # flushed to base
        osd, cid, oid = await _evict(P, cluster, cl, "obj")
        assert not osd.store.exists(cid, oid)
        await io.setxattr("obj", "tag", b"T")  # an xattr-only op on the miss
        assert await io.read("obj") == b"precious base bytes"
        await _agent_pass_all(cluster)  # flush
        bosd, bcid, boid = _primary_store(P, cluster, cl, "base", "obj")
        assert bosd.store.exists(bcid, boid)
        assert await io.read("obj") == b"precious base bytes"
        assert await io.getxattr("obj", "tag") == b"T"
        rec.append(("promotes", osd.tiering.stats["promotes"]))

    twin(scenario, n_osds=4)


def test_omap_survives_flush_evict_promote_cycle():
    """A replicated base: EC pools have no omap, so omap objects tier only
    over replicated bases."""
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster, base_type="replicated")
        io = cl.io_ctx("base")
        await io.write_full("obj", b"d")
        await io.omap_set("obj", {"k1": b"v1", "k2": b"v2"})
        await _agent_pass_all(cluster)  # flush data + omap to base
        osd, cid, oid = await _evict(P, cluster, cl, "obj")
        assert not osd.store.exists(cid, oid)
        got = await io.omap_get("obj")  # re-promoted on read
        assert got == {"k1": b"v1", "k2": b"v2"}
        rec.append(("omap", got))

    twin(scenario, n_osds=4)


def test_cache_mode_none_rejected_while_overlay_up():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await _tiered(cl, cluster)
        code, _s, _ = await cl.command({"prefix": "osd tier cache-mode", "pool": "cache",
                                        "mode": "none"})
        assert code < 0  # the overlay still routes clients here
        rec.append(("code", code))

    twin(scenario, n_osds=4)


# -- a cache PG's persisted hit sets, across the packages ---------------------


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port_to_reference", "reference_to_port"])
def test_a_cache_pgs_hit_set_archive_crosses_the_packages(tmp_path, writer, reader):
    """One package's OSDs archive a cache PG's hit sets to BlueStore; the
    other package's OSDs, mounting the same stores, resume the tracker
    from that archive with the same temperatures and the same bloom
    bytes."""
    async def write():
        async with writer.rados.MiniCluster(n_osds=4, store_kind="blue",
                                            store_dir=str(tmp_path), **writer.kw) as cluster:
            cl = await cluster.client()
            await _tiered(cl, cluster, base_type="replicated", hit_set_period=3600.0, hit_set_count=2)
            io = cl.io_ctx("base")
            for name in ("warm", "hot"):
                await io.write_full(name, name.encode())
            await _agent_pass_all(cluster)  # records + persists
            osd, cid, _ = _primary_store(writer, cluster, cl, "cache", "warm")
            pool = cl.osdmap.lookup_pool("cache")
            pg, _a, _p = cl.osdmap.object_to_acting("warm", pool.id)
            tr = osd.tiering.tracker(pg, pool)
            return str(pg), [hs.to_bytes() for _t, hs in tr.sets]

    async def read(pgid):
        async with reader.rados.MiniCluster(n_osds=4, store_kind="blue",
                                            store_dir=str(tmp_path), **reader.kw) as cluster:
            cl = await cluster.client()
            await cl.wait_for_pool("cache")
            pool = cl.osdmap.lookup_pool("cache")
            pg, _a, prim = cl.osdmap.object_to_acting("warm", pool.id)
            assert str(pg) == pgid
            tr = cluster.osds[prim].tiering.tracker(pg, pool)
            return tr.temperature("warm"), [hs.to_bytes() for _t, hs in tr.sets]

    pgid, written = run(write())
    temperature, got = run(read(pgid))
    assert temperature >= 1
    assert got == written
