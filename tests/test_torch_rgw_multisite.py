"""The port's multisite sync (``ceph_tpu_torch.rgw.ZoneSyncer``) held
against the reference's, on the CPU.

Twins of the six cases of ``tests/test_rgw_multisite.py``: full sync,
then incremental replay with dedup to the newest op and delete
propagation; a bucket made after the first pass; the trim gap that
forces a full resync; active-active first contact keeping each zone's
local writes; reconcile deletes only of tracked entries (and ``mirror``
mode); ACLs and user metadata carried by both phases.  Each runs on the
reference's ``MiniCluster`` with the reference's stores and syncers and
on the port's with the port's (``tests/test_torch_rgw.py``'s ``twin``:
the same seeded keys and stepping clock in both, so the datalog keys,
cursors and entries' times agree), recording every pass's phase and
count and every read; the two zones' pools (users, buckets, index
entries, datalogs, sync cursors and origin sets) must then be equal
between the packages, byte for byte.

One more case crosses the packages: a cursor and origin set written by
one package's syncer are resumed by the other's.
"""

import pytest

from tests.test_torch_rgw import PORT, REF, run, twin


async def _zones(r):
    cl = await r.cluster.client()
    RGWStore = r.P.rgw.RGWStore
    return await RGWStore.create(cl, zone="a"), await RGWStore.create(cl, zone="b")


def _syncer(r, *a, **kw):
    return r.P.rgw.ZoneSyncer(*a, **kw)


async def _gone(r, store, bucket, key):
    with pytest.raises(Exception):
        await store.get_object(bucket, key)
    r.note(f"gone {bucket}/{key}", True)


def test_full_then_incremental():
    async def scenario(r):
        src, dst = await _zones(r)
        u = await r.call("user", src.create_user("alice"))
        await src.create_bucket("b1", "alice")
        await src.put_object("b1", "k1", b"one")
        await src.put_object("b1", "k2", b"two")
        s = _syncer(r, src, dst, "zone-a")
        res = await r.call("full", s.sync())
        assert res["phase"] == "full" and res["applied"] == 2
        du = await r.call("dst user", dst.get_user("alice"))
        assert du["access_key"] == u["access_key"]
        assert (await r.call("k1", dst.get_object("b1", "k1")))[0] == b"one"
        await src.put_object("b1", "k3", b"three")
        await src.put_object("b1", "k3", b"three-v2")
        await src.delete_object("b1", "k1")
        res = await r.call("incremental", s.sync())
        assert res["phase"] == "incremental"
        assert (await r.call("k3", dst.get_object("b1", "k3")))[0] == b"three-v2"
        await _gone(r, dst, "b1", "k1")
        assert (await r.call("steady", s.sync()))["applied"] == 0
        r.note("datalog", await src.datalog())

    twin(scenario)


def test_new_bucket_flows_incrementally():
    async def scenario(r):
        src, dst = await _zones(r)
        await src.create_user("bob")
        s = _syncer(r, src, dst, "zone-a")
        await r.call("full", s.sync())
        await src.create_bucket("fresh", "bob")
        await src.put_object("fresh", "obj", b"payload")
        res = await r.call("incremental", s.sync())
        assert res["phase"] == "incremental" and res["applied"] == 1
        assert (await r.call("obj", dst.get_object("fresh", "obj")))[0] == b"payload"
        assert (await r.call("info", dst.bucket_info("fresh")))["owner"] == "bob"

    twin(scenario)


def test_trim_gap_triggers_full_resync():
    async def scenario(r):
        S = r.P.store
        src, dst = await _zones(r)
        await src.create_user("u")
        await src.create_bucket("b", "u")
        s = _syncer(r, src, dst, "zone-a")
        await src.put_object("b", "k0", b"v0")
        await r.call("first", s.sync())
        await src.put_object("b", "kmiss", b"lost-from-log")
        # the entries the peer never saw are trimmed, as _log_change would
        log = await src._omap(src.meta, S.DATALOG_OBJ)
        keys = sorted(k for k in log if not k.startswith("~"))
        await src.meta.omap_set(S.DATALOG_OBJ, {S.DATALOG_TRIMMED_KEY: keys[-1].encode()})
        await src.meta.omap_rmkeys(S.DATALOG_OBJ, keys)
        await src.put_object("b", "k1", b"v1")
        res = await r.call("resync", s.sync())
        assert res["phase"] == "full"
        for key, want in (("k1", b"v1"), ("k0", b"v0"), ("kmiss", b"lost-from-log")):
            assert (await r.call(key, dst.get_object("b", key)))[0] == want

    twin(scenario)


def test_active_active_first_contact_preserves_local_writes():
    async def scenario(r):
        a, b = await _zones(r)
        await a.create_user("u")
        await a.create_bucket("ba", "u")
        await a.put_object("ba", "ka", b"from-a")
        await b.create_user("u")
        await b.create_bucket("bb", "u")
        await b.put_object("bb", "kb", b"from-b")
        sab = _syncer(r, a, b, "zone-a")
        sba = _syncer(r, b, a, "zone-b")
        assert (await r.call("a->b", sab.sync()))["phase"] == "full"
        assert (await r.call("b kb", b.get_object("bb", "kb")))[0] == b"from-b"
        assert (await r.call("b->a", sba.sync()))["phase"] == "full"
        assert (await r.call("a ka", a.get_object("ba", "ka")))[0] == b"from-a"
        assert (await r.call("b ka", b.get_object("ba", "ka")))[0] == b"from-a"
        assert (await r.call("a kb", a.get_object("bb", "kb")))[0] == b"from-b"

    twin(scenario)


def test_full_resync_deletes_only_tracked_entries():
    async def scenario(r):
        a, b = await _zones(r)
        await a.create_user("u")
        await a.create_bucket("ba", "u")
        await a.put_object("ba", "ka", b"from-a")
        sab = _syncer(r, a, b, "zone-a")
        await r.call("full", sab.sync())
        await a.delete_object("ba", "ka")
        await b.put_object("ba", "local", b"mine")
        await r.call("reconcile", sab._full_sync())
        await _gone(r, b, "ba", "ka")
        assert (await r.call("local", b.get_object("ba", "local")))[0] == b"mine"
        await r.call("mirror", _syncer(r, a, b, "zone-a", delete_mode="mirror")._full_sync())
        await _gone(r, b, "ba", "local")

    twin(scenario)


def test_sync_carries_acl_and_user_metadata():
    async def scenario(r):
        src, dst = await _zones(r)
        await src.create_user("alice")
        await src.create_bucket("b", "alice")
        await src.put_object("b", "k-full", b"one", acl="public-read", meta={"color": "teal"})
        s = _syncer(r, src, dst, "zone-a")
        await r.call("full", s.sync())
        _d, e = await r.call("k-full", dst.get_object("b", "k-full"))
        assert e.get("acl") == "public-read" and e.get("meta") == {"color": "teal"}
        await src.put_object("b", "k-inc", b"two", meta={"rev": "9"})
        assert (await r.call("incremental", s.sync()))["phase"] == "incremental"
        _d, e = await r.call("k-inc", dst.get_object("b", "k-inc"))
        assert e.get("meta") == {"rev": "9"}

    twin(scenario)


@pytest.mark.parametrize("first", ["ref", "port"])
def test_a_sync_state_resumes_in_the_other_package(first):
    """A full pass by one package's syncer, then an incremental pass by
    the other's over the same zones and cursor, on the reference's
    cluster: the second picks up exactly the changes after the first."""
    A, B = (REF, PORT) if first == "ref" else (PORT, REF)

    async def main():
        async with REF.rados.MiniCluster(n_osds=3) as cluster:
            mon = cluster.monmap or cluster.mon.addr
            zones = {}
            for P in (A, B):
                cl = await P.rados.RadosClient(mon).connect()
                zones[P.name] = (await P.rgw.RGWStore.create(cl, zone="a"),
                                 await P.rgw.RGWStore.create(cl, zone="b"))
            src, _dst = zones[A.name]
            await src.create_user("u")
            await src.create_bucket("b", "u")
            await src.put_object("b", "k0", b"v0")
            res = await A.rgw.ZoneSyncer(*zones[A.name], "zone-a").sync()
            assert res == {"phase": "full", "applied": 1}
            await zones[B.name][0].put_object("b", "k1", b"v1")
            await src.delete_object("b", "k0")
            res = await B.rgw.ZoneSyncer(*zones[B.name], "zone-a").sync()
            assert res == {"phase": "incremental", "applied": 2}
            dst = zones[A.name][1]
            assert (await dst.get_object("b", "k1"))[0] == b"v1"
            with pytest.raises(A.rgw.RGWError):
                await dst.get_object("b", "k0")

    run(main())
