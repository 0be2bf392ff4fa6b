"""The port's object classes (``ceph_tpu_torch.cls``) on its OSD, held
against the reference's, on the CPU.

Each case of ``tests/test_cls_external.py``, ``tests/test_cls_rgw_numops.py``,
``tests/test_cls_version_log.py`` and ``tests/test_watch_cls.py`` runs twice:
on the reference's ``MiniCluster`` and on the port's
(``MiniCluster(device="cpu")``), the same ops in the same order.  Each run
keeps the reference case's own checks and records its answers (method
outputs, errnos, the fields the case checks); the two records must be
equal.  The RGW cases drive the reference's ``RGWStore`` through the
reference's client, so on the port's run the bucket-index class runs in
the port's OSD.  External class files import
``ceph_tpu_torch.cls`` for the port's run and ``ceph_tpu.cls`` for the
reference's.

Two more cases: class state that the port's OSDs wrote to BlueStore reads
back through the reference's OSDs over the same stores, and the other way
round; and the two packages' class registries stay apart in one process.

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import sys
import textwrap
import types

import pytest

import ceph_tpu.cls as ref_cls
import ceph_tpu.rados as ref_rados
import ceph_tpu.store as ref_store
import ceph_tpu_torch.cls as port_cls
import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.store as port_store

LIMIT_S = 30.0
EOPNOTSUPP = 95
EIO = 5
ECANCELED = 125

REF = types.SimpleNamespace(name="ref", rados=ref_rados, store=ref_store,
                            cls_module="ceph_tpu.cls", kw={})
PORT = types.SimpleNamespace(name="port", rados=port_rados, store=port_store,
                             cls_module="ceph_tpu_torch.cls", kw={"device": "cpu"})


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def twin(scenario, **cluster_kw):
    """Run ``scenario(P, cluster, rec)`` on the reference's cluster and on
    the port's; it appends what it reads to ``rec``.  The two records
    must be equal; returns the port's."""
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            rec = []
            kw = {key: (v(P) if callable(v) else v) for key, v in cluster_kw.items()}
            async with P.rados.MiniCluster(**kw, **P.kw) as cluster:
                await scenario(P, cluster, rec)
            return rec
        out[P.name] = run(main())
    assert out["port"] == out["ref"]
    return out["port"]


async def answer(io, oid, kls, method, inp):
    """A method's output, or its errno: either is the result compared."""
    try:
        return await io.exec(oid, kls, method, inp)
    except Exception as e:  # the errno is the result being compared
        return ("errno", getattr(e, "code", type(e).__name__))


def failed(got) -> bool:
    return isinstance(got, tuple) and got[0] == "errno"


async def ref_client(cluster):
    """The reference's client on either package's cluster (the RGW cases:
    the reference's ``RGWStore`` speaks only to its own client)."""
    return await ref_rados.RadosClient(cluster.monmap or cluster.mon.addr).connect()


@pytest.fixture(autouse=True)
def _isolate_cls_registries():
    """Both packages' class registries are process-global: snapshot and
    restore them so an external class loaded by one case can't leak into
    the next."""
    saved = []
    for mod in (ref_cls, port_cls):
        mod._load_builtins()
        saved.append((mod, dict(mod._classes), dict(mod._external_status)))
    yield
    for mod, classes, status in saved:
        mod._classes.clear()
        mod._classes.update(classes)
        mod._external_status.clear()
        mod._external_status.update(status)


# -- external classes (tests/test_cls_external.py) ----------------------------

WORKING = textwrap.dedent("""
    from {module} import (
        CLS_METHOD_RD, CLS_METHOD_WR, MethodContext, register_class,
    )

    cls = register_class("extecho")


    @cls.method("echo", CLS_METHOD_RD)
    def echo(ctx: MethodContext, input: dict) -> dict:
        return {{"echo": input.get("msg", "")}}


    @cls.method("bump", CLS_METHOD_RD | CLS_METHOD_WR)
    def bump(ctx: MethodContext, input: dict) -> dict:
        raw = ctx.omap_get_keys(["n"]).get("n")
        n = int(raw) if raw else 0
        ctx.omap_set({{"n": str(n + 1).encode()}})
        return {{"n": n + 1}}
""")

BROKEN = "raise RuntimeError('bad class file')\n"

NON_REGISTERING = "x = 1  # loads fine but registers nothing\n"

HALF_REGISTERED = textwrap.dedent("""
    from {module} import CLS_METHOD_RD, register_class

    cls = register_class("exthalf")


    @cls.method("a", CLS_METHOD_RD)
    def a(ctx, input):
        return {{"ok": True}}


    raise RuntimeError("died after registering method a")
""")


@pytest.fixture()
def class_dirs(tmp_path):
    """One class directory a package, its files importing that package's
    ``cls``."""
    dirs = {}
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        (d / "cls_extecho.py").write_text(WORKING.format(module=P.cls_module))
        (d / "cls_extbroken.py").write_text(BROKEN)
        (d / "cls_extsilent.py").write_text(NON_REGISTERING)
        (d / "cls_exthalf.py").write_text(HALF_REGISTERED.format(module=P.cls_module))
        dirs[P.name] = str(d)
    return dirs


async def _obj_io(cluster, pool="p", **pool_kw):
    cl = await cluster.client()
    await cl.create_pool(pool, "replicated", **pool_kw)
    io = cl.io_ctx(pool)
    await io.write_full("obj", b"x")
    return io


def test_external_class_served_like_builtin(class_dirs):
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        out = await io.exec("obj", "extecho", "echo", {"msg": "hi"})
        assert out["echo"] == "hi"
        rec.append(("echo", out))
        for want in (1, 2, 3):  # stateful RMW through omap
            out = await io.exec("obj", "extecho", "bump", {})
            assert out["n"] == want
            rec.append(("bump", out))
        rec.append(("omap", await io.omap_get("obj")))

    twin(scenario, n_osds=3,
         config_overrides=lambda P: {"osd_class_dir": class_dirs[P.name]})


def test_broken_class_file_is_EIO_not_a_miss(class_dirs):
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        for name in ("extbroken", "extsilent"):
            for _ in range(2):  # and it STAYS broken on retry
                got = await answer(io, "obj", name, "any", {})
                assert got == ("errno", -EIO), name
                rec.append((name, got))
        # a file that registers a method THEN crashes must not serve the
        # surviving half
        for _ in range(2):
            got = await answer(io, "obj", "exthalf", "a", {})
            assert got == ("errno", -EIO)
            rec.append(("exthalf", got))

    twin(scenario, n_osds=3,
         config_overrides=lambda P: {"osd_class_dir": class_dirs[P.name]})


def test_missing_class_or_no_dir_stays_op_not_supported(class_dirs):
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        for name in ("nosuchclass", "../evil"):  # path traversal: a plain miss
            got = await answer(io, "obj", name, "m", {})
            assert got == ("errno", -EOPNOTSUPP)
            rec.append((name, got))

    twin(scenario, n_osds=3,
         config_overrides=lambda P: {"osd_class_dir": class_dirs[P.name]})


def test_builtins_unaffected_without_class_dir():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        out = await io.exec("obj", "numops", "add", {"key": "k", "value": "2"})
        assert out["value"] == "2"
        rec.append(("add", out))
        got = await answer(io, "obj", "extecho", "echo", {})
        assert got == ("errno", -EOPNOTSUPP)
        rec.append(("extecho", got))

    twin(scenario, n_osds=3)


# -- numops and the RGW bucket index (tests/test_cls_rgw_numops.py) -----------


def test_numops_add_mul_and_badmsg():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("p", "replicated")
        io = cl.io_ctx("p")
        for method, value in (("add", 5), ("add", -2), ("mul", 2.5)):
            rec.append((method, await io.exec("ctr", "numops", method,
                                              {"key": "n", "value": value})))
        assert [r[1]["value"] for r in rec] == ["5", "3", "7.5"]
        # a non-numeric stored value answers EBADMSG like the reference
        await io.omap_set("ctr", {"bad": b"not-a-number"})
        got = await answer(io, "ctr", "numops", "add", {"key": "bad", "value": 1})
        assert got == ("errno", -74)
        rec.append(("bad", got))
        rec.append(("omap", await io.omap_get("ctr")))

    twin(scenario, n_osds=3)


def test_numops_concurrent_adds_lose_nothing():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("p", "replicated")
        io = cl.io_ctx("p")
        await asyncio.gather(*(io.exec("ctr", "numops", "add", {"key": "n", "value": 1})
                               for _ in range(100)))
        out = await io.exec("ctr", "numops", "add", {"key": "n", "value": 0})
        assert out["value"] == "100"
        rec.append(("n", out))

    twin(scenario, n_osds=3)


async def _rgw(cluster):
    from ceph_tpu.rgw.store import RGWStore

    cl = await ref_client(cluster)
    return cl, await RGWStore.create(cl)


def rgw_twin(body):
    """``body(store, rec)`` on the reference's ``RGWStore`` over each
    package's cluster."""
    async def scenario(P, cluster, rec):
        cl, store = await _rgw(cluster)
        try:
            await body(store, rec)
        finally:
            await cl.shutdown()

    return twin(scenario, n_osds=3)


def _stats(st):
    return st["num_objects"], st["size_bytes"]


def test_rgw_header_tracks_puts_and_deletes():
    async def body(store, rec):
        await store.create_user("u", "Display")
        await store.create_bucket("b", "u")
        for i in range(5):
            await store.put_object("b", f"k{i}", bytes(32 * (i + 1)))
        rec.append(("five", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (5, 32 * 15)
        await store.put_object("b", "k0", bytes(64))  # replaces, not double-counts
        rec.append(("overwrite", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (5, 64 + 32 * 14)
        await store.delete_object("b", "k4")
        rec.append(("delete", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (4, 64 + 32 * 9)

    rgw_twin(body)


def test_rgw_concurrent_puts_keep_header_exact():
    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        await asyncio.gather(*(store.put_object("b", f"k{i:03d}", bytes(100))
                               for i in range(40)))
        rec.append(("stats", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (40, 4000)
        chk = await store.check_index("b")
        assert chk["consistent"], chk
        rec.append(("check", chk["consistent"]))

    rgw_twin(body)


def test_rgw_paged_listing_via_class():
    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        for i in range(12):
            await store.put_object("b", f"d/{i:02d}", b"x")
        seen, marker = [], ""
        while True:
            out = await store.list_objects("b", prefix="d/", marker=marker, max_keys=5)
            page = [c["key"] for c in out["contents"]]
            rec.append(("page", page, out["truncated"]))
            seen += page
            if not out["truncated"]:
                break
            marker = out["next_marker"]
        assert seen == [f"d/{i:02d}" for i in range(12)]

    rgw_twin(body)


def test_rgw_check_and_rebuild_fix_corrupt_header():
    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        await store.put_object("b", "k", bytes(500))
        await store.index.exec(".index.b", "rgw", "init", {})  # behind the class's back
        chk = await store.check_index("b")
        assert not chk["consistent"]
        fixed = await store.check_index("b", fix=True)
        assert fixed["header"] == {"entries": 1, "bytes": 500}
        rec.append(("check", chk["consistent"], fixed["header"]))
        rec.append(("stats", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (1, 500)

    rgw_twin(body)


def test_rgw_dot_prefixed_object_keys_are_ordinary():
    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        await store.put_object("b", ".hidden", b"secret")
        await store.put_object("b", "plain", b"data")
        rec.append(("stats", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (2, len(b"secret") + len(b"data"))
        out = await store.list_objects("b")
        rec.append(("keys", [c["key"] for c in out["contents"]]))
        assert rec[-1][1] == [".hidden", "plain"]
        data, _e = await store.get_object("b", ".hidden")
        assert data == b"secret"
        await store.delete_object("b", ".hidden")
        await store.delete_object("b", "plain")
        await store.delete_bucket("b")  # now truly empty

    rgw_twin(body)


def test_rgw_meta_lookalike_keys_are_ordinary_objects():
    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        tricky = [".upload.x", ".upload.x.deadbeef.part.00001", "m:upload.y", "o:z"]
        for i, key in enumerate(tricky):
            await store.put_object("b", key, bytes(10 + i))
        rec.append(("stats", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1][0] == len(tricky)
        out = await store.list_objects("b")
        rec.append(("keys", sorted(c["key"] for c in out["contents"])))
        assert rec[-1][1] == sorted(tricky)
        chk = await store.check_index("b")
        assert chk["consistent"]
        for key in tricky:
            data, _e = await store.get_object("b", key)
            assert data == bytes(10 + tricky.index(key))
            await store.delete_object("b", key)
        await store.delete_bucket("b")

    rgw_twin(body)


def test_rgw_multipart_meta_invisible_to_stats_and_listing():
    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        upload = await store.init_multipart("b", "big")
        await store.upload_part("b", "big", upload, 1, bytes(256))
        rec.append(("stats", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (0, 0)
        out = await store.list_objects("b")
        assert out["contents"] == []
        # but the in-flight upload blocks bucket deletion
        with pytest.raises(Exception, match="not empty"):
            await store.delete_bucket("b")
        await store.complete_multipart("b", "big", upload)
        rec.append(("done", _stats(await store.bucket_stats("b"))))
        assert rec[-1][1] == (1, 256)

    rgw_twin(body)


def test_rgw_quota_blocks_growth_atomically():
    from ceph_tpu.rgw.store import RGWError

    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        await store.set_bucket_quota("b", max_objects=2)
        await store.put_object("b", "o1", b"x" * 100)
        await store.put_object("b", "o2", b"y" * 100)
        with pytest.raises(RGWError) as ei:
            await store.put_object("b", "o3", b"z")
        assert ei.value.code == -122
        rec.append(("objects cap", ei.value.code))
        await store.put_object("b", "o1", b"x" * 50)  # overwrite is not growth
        await store.delete_object("b", "o2")  # delete frees a slot
        await store.put_object("b", "o3", b"z")
        await store.set_bucket_quota("b", max_bytes=100)
        await store.put_object("b", "o1", b"s" * 10)  # shrinking passes
        with pytest.raises(RGWError) as ei:
            await store.put_object("b", "o1", b"G" * 4096)
        assert ei.value.code == -122
        rec.append(("bytes cap", ei.value.code))
        await store.set_bucket_quota("b")  # 0 clears
        await store.put_object("b", "o1", b"G" * 4096)
        with pytest.raises(RGWError):
            await store.set_bucket_quota("nope", max_objects=1)
        rec.append(("stats", _stats(await store.bucket_stats("b"))))

    rgw_twin(body)


def test_rgw_quota_over_http_is_403():
    from ceph_tpu.rgw.http import S3Server
    from tests.test_rgw import _http

    async def body(store, rec):
        user = await store.create_user("alice")
        await store.create_bucket("b", "alice")
        await store.set_bucket_quota("b", max_objects=1)
        srv = S3Server(store)
        addr = await srv.start()
        try:
            st1, _, _ = await _http(addr, "PUT", "/b/one", body=b"1", creds=user)
            st2, _, payload = await _http(addr, "PUT", "/b/two", body=b"2", creds=user)
        finally:
            await srv.stop()
        assert (st1, st2) == (200, 403) and b"quota" in payload
        rec.append(("status", st1, st2))

    rgw_twin(body)


def test_rgw_byte_quota_bounds_multipart_parts():
    from ceph_tpu.rgw.store import RGWError

    async def body(store, rec):
        await store.create_user("u", "D")
        await store.create_bucket("b", "u")
        await store.set_bucket_quota("b", max_bytes=8192)
        up = await store.init_multipart("b", "big")
        await store.upload_part("b", "big", up, 1, b"P" * 4096)
        for part, data in ((9, b"X" * 16384), (2, b"Q" * 8192)):
            with pytest.raises(RGWError) as ei:
                await store.upload_part("b", "big", up, part, data)
            assert ei.value.code == -122
            rec.append(("part", part, ei.value.code))
            if part == 9:
                await store.upload_part("b", "big", up, 1, b"P" * 4096)  # a retry
        await store.upload_part("b", "big", up, 2, b"Q" * 4096)
        out = await store.complete_multipart("b", "big", up)
        assert out["size"] == 8192
        data, _e = await store.get_object("b", "big")
        assert data == b"P" * 4096 + b"Q" * 4096
        rec.append(("size", out["size"]))

    rgw_twin(body)


# -- version and log (tests/test_cls_version_log.py) --------------------------


def test_version_set_inc_read():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        rec.append(("read", await io.exec("obj", "version", "read", {})))
        assert rec[-1][1]["objv"] == {"ver": 0, "tag": ""}
        await io.exec("obj", "version", "set", {"ver": 5, "tag": "t1"})
        rec.append(("inc", await io.exec("obj", "version", "inc", {})))
        assert rec[-1][1]["objv"] == {"ver": 6, "tag": "t1"}
        rec.append(("read", await io.exec("obj", "version", "read", {})))

    twin(scenario, n_osds=3)


def test_version_conditional_bump_fences_stale_writer():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        await io.exec("obj", "version", "set", {"ver": 3, "tag": "a"})
        for method, conds in (
            ("inc_conds", [{"ver": 3, "cmp": "eq"}, {"tag": "a", "cmp": "eq"}]),
            ("inc_conds", [{"ver": 3, "cmp": "eq"}]),  # stale writer: fenced
            ("check_conds", [{"ver": 4, "cmp": "ge"}]),
            ("check_conds", [{"ver": 100, "cmp": "ge"}]),
        ):
            rec.append((method, await answer(io, "obj", "version", method, {"conds": conds})))
        assert rec[0][1]["objv"]["ver"] == 4 and rec[2][1]["objv"]["ver"] == 4
        assert rec[1][1] == rec[3][1] == ("errno", -ECANCELED)

    twin(scenario, n_osds=3)


def _entries(names, ts=None, section="s", data=""):
    return {"entries": [{"ts": float(t if ts is None else ts), "section": section,
                         "name": n, "data": data} for t, n in enumerate(names)]}


def _names(out):
    return [e["name"] for e in out["entries"]]


def test_log_add_list_window_and_paging():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        await io.exec("obj", "log", "add", {"entries": [
            {"ts": float(t), "section": "data", "name": f"e{t}", "data": f"payload{t}"}
            for t in range(10)]})
        got, marker = [], ""
        while True:
            out = await io.exec("obj", "log", "list", {"max_entries": 3, "marker": marker})
            rec.append(("page", out))
            got.extend(out["entries"])
            if not out["truncated"]:
                break
            marker = out["marker"]
        assert [e["name"] for e in got] == [f"e{t}" for t in range(10)]
        out = await io.exec("obj", "log", "list", {"from": 3.0, "to": 7.0})
        assert _names(out) == ["e3", "e4", "e5", "e6"]
        rec.append(("window", out))
        out = await io.exec("obj", "log", "info", {})
        assert out["header"]["max_time"] == 9.0
        rec.append(("info", out))

    twin(scenario, n_osds=3)


def test_log_trim_window_and_marker():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        await io.exec("obj", "log", "add", _entries([f"e{t}" for t in range(8)]))
        out = await io.exec("obj", "log", "trim", {"from": 0.0, "to": 3.0})
        assert out["removed"] == 3
        rec.append(("trim", out))
        out = await io.exec("obj", "log", "list", {})
        assert _names(out) == [f"e{t}" for t in range(3, 8)]
        rec.append(("list", out))
        out = await io.exec("obj", "log", "trim", {"to_marker": out["entries"][1]["marker"]})
        assert out["removed"] == 2
        rec.append(("trim to marker", out))
        out = await io.exec("obj", "log", "list", {})
        assert _names(out) == ["e5", "e6", "e7"]
        rec.append(("list", out))

    twin(scenario, n_osds=3)


def test_log_truncated_reflects_window_not_prefix():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        await io.exec("obj", "log", "add", _entries([f"e{t}" for t in range(12)]))
        out = await io.exec("obj", "log", "list", {"from": 0.0, "to": 4.0, "max_entries": 3})
        assert _names(out) == ["e0", "e1", "e2"] and out["truncated"]
        rec.append(("page 1", out))
        out = await io.exec("obj", "log", "list", {"from": 0.0, "to": 4.0, "max_entries": 3,
                                                   "marker": out["marker"]})
        assert _names(out) == ["e3"] and not out["truncated"]
        rec.append(("page 2", out))
        out = await io.exec("obj", "log", "list", {"from": 0.0, "to": 3.0, "max_entries": 3})
        assert len(out["entries"]) == 3 and not out["truncated"]  # exact fit
        rec.append(("exact fit", out))
        out = await io.exec("obj", "log", "list", {"max_entries": 12})
        assert len(out["entries"]) == 12 and not out["truncated"]
        rec.append(("unbounded", out))

    twin(scenario, n_osds=3)


def test_log_out_of_order_timestamps_never_collide():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        await io.exec("obj", "log", "add", _entries(["late"], ts=100.0))
        for n in ("early1", "early2"):
            await io.exec("obj", "log", "add", _entries([n], ts=50.0))
        out = await io.exec("obj", "log", "list", {})
        assert _names(out) == ["early1", "early2", "late"]
        rec.append(("list", out))

    twin(scenario, n_osds=3)


def test_log_same_timestamp_entries_stay_distinct_and_ordered():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster)
        for batch in range(3):  # separate calls, same ts
            await io.exec("obj", "log", "add", _entries([f"b{batch}"], ts=1.0))
        out = await io.exec("obj", "log", "list", {})
        assert _names(out) == ["b0", "b1", "b2"]
        rec.append(("list", out))

    twin(scenario, n_osds=3)


# -- lock, refcount, errors, watch/notify (tests/test_watch_cls.py) -----------


def _lock(name, entity, cookie, **kw):
    return {"name": name, "entity": entity, "cookie": cookie, **kw}


def test_lock_exclusive_lifecycle():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster, size=3)
        for method, inp in (
            ("lock", _lock("L", "a", "1")),
            ("lock", _lock("L", "a", "1")),  # the same owner may re-acquire
            ("lock", _lock("L", "b", "2")),  # another owner is rejected
            ("get_info", {"name": "L"}),
            ("unlock", _lock("L", "a", "1")),
            ("lock", _lock("L", "b", "2")),  # free now
        ):
            rec.append((method, await answer(io, "obj", "lock", method, inp)))
        assert failed(rec[2][1]) and not any(failed(r[1]) for r in rec[3:])
        assert rec[3][1]["lockers"][0]["entity"] == "a"

    twin(scenario, n_osds=3)


def test_lock_shared_locks_and_break():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster, size=3)
        for ent in ("a", "b"):
            await io.exec("obj", "lock", "lock", _lock("S", ent, "c", type=2))
        for method, inp in (
            ("get_info", {"name": "S"}),
            ("lock", _lock("S", "c", "z", type=1)),  # exclusive blocked while shared held
            ("break_lock", _lock("S", "a", "c")),  # fence a dead owner
            ("get_info", {"name": "S"}),
            ("list_locks", {}),
        ):
            rec.append((method, await answer(io, "obj", "lock", method, inp)))
        assert len(rec[0][1]["lockers"]) == 2 and failed(rec[1][1])
        assert len(rec[3][1]["lockers"]) == 1 and rec[4][1]["names"] == ["S"]

    twin(scenario, n_osds=3)


def test_lock_race_one_winner():
    async def scenario(P, cluster, rec):
        cl1 = await cluster.client()
        cl2 = await cluster.client()
        await cl1.create_pool("p", "replicated", size=3)
        await cl2.wait_for_pool("p")
        io1, io2 = cl1.io_ctx("p"), cl2.io_ctx("p")
        await io1.write_full("obj", b"x")
        results = await asyncio.gather(*(
            answer(io, "obj", "lock", "lock", _lock("L", e, "c"))
            for io, e in [(io1, "a"), (io2, "b")] * 4))
        wins = [r == {} for r in results]
        assert wins.count(True) >= 1
        info = await io1.exec("obj", "lock", "get_info", {"name": "L"})
        assert len(info["lockers"]) == 1
        # which client wins is the race's; that one owner holds it is not
        rec.append(("lockers", len(info["lockers"])))

    twin(scenario, n_osds=3)


def test_lock_expiry():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster, size=3)
        await io.exec("obj", "lock", "lock", _lock("L", "a", "1", duration=0.05))
        await asyncio.sleep(0.1)
        # expired: another owner may take it
        rec.append(("lock", await answer(io, "obj", "lock", "lock", _lock("L", "b", "2"))))
        assert rec[-1][1] == {}

    twin(scenario, n_osds=3)


def test_refcount_get_put():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("p", "replicated", size=3)
        io = cl.io_ctx("p")
        await io.write_full("obj", b"shared")
        for method, tag in (("get", "t1"), ("get", "t2"), ("put", "t1"), ("put", "t2"),
                            ("read", None)):
            rec.append((method, await io.exec("obj", "refcount", method,
                                              {"tag": tag} if tag else {})))
        assert [r[1].get("count") for r in rec[:3]] == [1, 2, 1]
        assert not rec[2][1]["last"] and rec[3][1]["last"] and rec[4][1]["refs"] == []

    twin(scenario, n_osds=3)


def test_cls_unknown_class_and_method():
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster, size=3)
        for kls, method in (("nope", "m"), ("lock", "nope")):
            rec.append((kls, await answer(io, "obj", kls, method, {})))
            assert failed(rec[-1][1])

    twin(scenario, n_osds=3)


def test_cls_rejected_on_ec_pool():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ec", "erasure")
        io = cl.io_ctx("ec")
        await io.write_full("obj", b"x" * 100)
        got = await answer(io, "obj", "lock", "lock", _lock("L", "a", "1"))
        assert got == ("errno", -EOPNOTSUPP)
        rec.append(("lock", got))

    twin(scenario, n_osds=4)


def test_cls_write_clones_after_snap():
    """A cls mutation is a mutation: the first one after a snap must
    clone, so snap reads see pre-snap cls state."""
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("p", "replicated", size=3)
        io = cl.io_ctx("p")
        await io.write_full("obj", b"data-v1")
        await io.exec("obj", "refcount", "get", {"tag": "t1"})
        s1 = await io.create_snap("s1")
        await io.exec("obj", "refcount", "get", {"tag": "t2"})
        ss = await io.list_snaps("obj")
        assert [c["cloneid"] for c in ss["clones"]] == [s1]
        rec.append(("snaps", ss))
        io.set_read(s1)
        assert await io.read("obj") == b"data-v1"
        io.set_read(None)
        refs = await io.exec("obj", "refcount", "read", {})
        assert refs["refs"] == ["t1", "t2"]
        rec.append(("refs", refs))

    twin(scenario, n_osds=3)


def test_cls_write_replicates():
    """cls state written via the txn reaches the replicas."""
    async def scenario(P, cluster, rec):
        io = await _obj_io(cluster, size=3)
        await io.exec("obj", "lock", "lock", _lock("L", "a", "1"))
        m = cluster.mon.osdmap
        pg, acting, _p = m.object_to_acting("obj", m.lookup_pool("p").id)
        cid = P.store.CollectionId(str(pg))
        raws = [bytes(cluster.osds[o].store.getattr(cid, P.store.ObjectId("obj"), "c_lock.L"))
                for o in acting]
        assert all(b"lockers" in r for r in raws) and len(set(raws)) == 1
        rec.append(("xattr", raws[0]))

    twin(scenario, n_osds=3)


def test_watch_notify_reaches_watchers():
    async def scenario(P, cluster, rec):
        cls_ = [await cluster.client() for _ in range(3)]
        await cls_[0].create_pool("p", "replicated", size=3)
        for c in cls_[1:]:
            await c.wait_for_pool("p")
        io1, io2, io3 = (c.io_ctx("p") for c in cls_)
        await io1.write_full("obj", b"x")
        got1, got2 = [], []
        c1 = await io1.watch("obj", lambda n, p: got1.append(p))
        c2 = await io2.watch("obj", lambda n, p: got2.append(p))
        res = await io3.notify("obj", b"hello")
        assert sorted(res["acks"]) == sorted([c1, c2]) and res["missed"] == []
        assert got1 == [b"hello"] and got2 == [b"hello"]
        rec.append(("notify", len(res["acks"]), res["missed"], got1, got2))
        await io2.unwatch(c2)  # unwatch stops delivery
        res = await io3.notify("obj", b"again")
        assert list(res["acks"]) == [c1] and got2 == [b"hello"]
        rec.append(("again", len(res["acks"]), got1, got2))

    twin(scenario, n_osds=3)


def test_watch_missing_object_fails():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("p", "replicated", size=3)
        io = cl.io_ctx("p")
        with pytest.raises(P.rados.RadosError) as ei:
            await io.watch("ghost", lambda n, p: None)
        rec.append(("watch", ei.value.code))

    twin(scenario, n_osds=3)


def test_watch_dead_watcher_does_not_hang_notify():
    async def scenario(P, cluster, rec):
        cl1 = await cluster.client()
        cl2 = await cluster.client()
        await cl1.create_pool("p", "replicated", size=3)
        await cl2.wait_for_pool("p")
        io1, io2 = cl1.io_ctx("p"), cl2.io_ctx("p")
        await io1.write_full("obj", b"x")
        await io2.watch("obj", lambda n, p: None)
        await cl2.shutdown()  # watcher dies without unwatch
        await asyncio.sleep(0.1)
        res = await io1.notify("obj", b"anyone?", timeout=2.0)
        assert res["acks"] == {} and res["missed"] == []
        rec.append(("notify", res))

    twin(scenario, n_osds=3)


def test_watch_async_callback_and_ec_pool():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ec", "erasure")
        io = cl.io_ctx("ec")
        await io.write_full("obj", b"x" * 100)
        got = []

        async def cb(notifier, payload):
            await asyncio.sleep(0.01)
            got.append(payload)

        await io.watch("obj", cb)
        res = await io.notify("obj", b"ec-notify")
        assert len(res["acks"]) == 1 and got == [b"ec-notify"]
        rec.append(("notify", len(res["acks"]), got))

    twin(scenario, n_osds=4)


def test_notify_retried_fires_callbacks_once():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("p", "replicated", size=3)
        io = cl.io_ctx("p")
        await io.write_full("o", b"x")
        fired = []

        async def cb(notifier, payload):
            fired.append(bytes(payload))
            return b"ack"

        await io.watch("o", cb)
        out = await io.notify("o", b"hello")
        assert len(out["acks"]) == 1 and not out["missed"]
        # the retry: the SAME op (same nid) resent the way operate() would
        op = [{"op": "notify", "data": 0, "timeout": 5.0, "nid": f"{cl.name}.dup"}]
        r1 = await cl.operate("p", "o", op, [b"retry-me"])
        r2 = await cl.operate("p", "o", op, [b"retry-me"])
        assert r1.result == 0 and r2.result == 0
        assert len(r1.out[0]["acks"]) == 1 and len(r2.out[0]["acks"]) == 1
        await asyncio.sleep(0.1)
        assert fired == [b"hello", b"retry-me"]  # not 3 firings
        rec.append(("fired", fired))

    twin(scenario, n_osds=3)


# -- class state across the packages, and the registries ----------------------


async def _write_cls_state(io):
    """One call of each built-in that keeps state on the object."""
    await io.exec("obj", "lock", "lock", _lock("L", "a", "1"))
    await io.exec("obj", "refcount", "get", {"tag": "t1"})
    await io.exec("obj", "version", "set", {"ver": 7, "tag": "v"})
    await io.exec("obj", "numops", "add", {"key": "n", "value": 3})
    await io.exec("obj", "log", "add", _entries(["e0", "e1"]))


async def _read_cls_state(io):
    out = {}
    for kls, method, inp in (("lock", "get_info", {"name": "L"}), ("refcount", "read", {}),
                             ("version", "read", {}), ("log", "list", {})):
        out[kls] = await io.exec("obj", kls, method, inp)
    out["omap"] = await io.omap_get("obj")
    out["xattrs"] = await io.getxattrs("obj")
    return out


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port_to_reference", "reference_to_port"])
def test_class_state_crosses_the_packages_in_the_stores(tmp_path, writer, reader):
    """Class state (``c_`` xattrs, omap) that one package's OSDs wrote to
    BlueStore reads back through the other package's OSDs mounting the
    same stores (and the same mon store), with equal answers."""
    async def write():
        async with writer.rados.MiniCluster(n_osds=3, store_kind="blue",
                                            store_dir=str(tmp_path), **writer.kw) as cluster:
            io = await _obj_io(cluster, size=3)
            await _write_cls_state(io)
            state = await _read_cls_state(io)
            # a method's stored xattrs, byte for byte, on every replica
            m = cluster.mon.osdmap
            pg, acting, _p = m.object_to_acting("obj", m.lookup_pool("p").id)
            cid = writer.store.CollectionId(str(pg))
            raw = {o: {k: bytes(v) for k, v in cluster.stores[o].getattrs(
                cid, writer.store.ObjectId("obj")).items() if k.startswith("c_")}
                for o in acting}
            return state, raw

    async def read():
        async with reader.rados.MiniCluster(n_osds=3, store_kind="blue",
                                            store_dir=str(tmp_path), **reader.kw) as cluster:
            cl = await cluster.client()
            await cl.wait_for_pool("p")
            io = cl.io_ctx("p")
            state = await _read_cls_state(io)
            m = cluster.mon.osdmap
            pg, acting, _p = m.object_to_acting("obj", m.lookup_pool("p").id)
            cid = reader.store.CollectionId(str(pg))
            raw = {o: {k: bytes(v) for k, v in cluster.stores[o].getattrs(
                cid, reader.store.ObjectId("obj")).items() if k.startswith("c_")}
                for o in acting}
            # and the reader's OSDs go on from the crossed state
            bumped = await io.exec("obj", "refcount", "get", {"tag": "t2"})
            return state, raw, bumped

    written, raw_w = run(write())
    got, raw_r, bumped = run(read())
    assert got == written
    assert raw_r == raw_w and all(raw_w.values())
    assert bumped["count"] == 2


def test_the_two_registries_stay_apart(tmp_path):
    """The port's built-ins and external classes register only in
    ``ceph_tpu_torch.cls``; a class file that registers into the
    reference's registry is answered by the port's OSD as loaded but never
    registered (-EIO)."""
    port_cls._load_builtins()
    ref_cls._load_builtins()
    assert port_cls.list_classes() == ref_cls.list_classes()
    for name in port_cls.list_classes():
        assert port_cls.get_class(name) is not ref_cls.get_class(name)
        assert type(port_cls.get_class(name)) is port_cls.ObjectClass
        assert type(ref_cls.get_class(name)) is ref_cls.ObjectClass
    (tmp_path / "cls_refonly.py").write_text(textwrap.dedent("""
        from ceph_tpu.cls import CLS_METHOD_RD, register_class

        register_class("refonly").method("hi", CLS_METHOD_RD)(lambda ctx, inp: {"hi": 1})
    """))
    (tmp_path / "cls_portonly.py").write_text(WORKING.format(module="ceph_tpu_torch.cls")
                                              .replace('"extecho"', '"portonly"'))
    with pytest.raises(port_cls.ClsLoadError, match="never registered"):
        port_cls.get_class("refonly", class_dir=str(tmp_path))
    assert "refonly" not in port_cls.list_classes()
    assert "refonly" in ref_cls.list_classes()  # the file ran, into the other registry
    assert port_cls.get_class("portonly", class_dir=str(tmp_path)) is not None
    assert "portonly" not in ref_cls.list_classes()
    # the spec names differ: neither loader's module shadows the other's
    assert not any(m.startswith("ceph_tpu_external_cls_portonly") for m in sys.modules)

    async def main():
        async with PORT.rados.MiniCluster(n_osds=3, device="cpu", config_overrides={
                "osd_class_dir": str(tmp_path)}) as cluster:
            io = await _obj_io(cluster)
            return (await answer(io, "obj", "refonly", "hi", {}),
                    await io.exec("obj", "portonly", "echo", {"msg": "m"}))

    refonly, echo = run(main())
    assert refonly == ("errno", -EIO)
    assert echo == {"echo": "m"}


def test_chip_smoke_cls_answers_are_the_references():
    """``chip_smoke.py`` phase 14 holds the port's answers to
    ``CLS_CALLS`` against the answers written beside them (it imports
    nothing of the reference): those are the reference OSD's answers to
    the same calls, and the port's on the CPU too."""
    import chip_smoke

    for P in (REF, PORT):
        async def main(P=P):
            async with P.rados.MiniCluster(n_osds=3, **P.kw) as cluster:
                io = await _obj_io(cluster, pool="cls", size=3)
                return [await io.exec("obj", kls, method, inp)
                        for kls, method, inp, _want in chip_smoke.CLS_CALLS]

        assert run(main()) == [want for *_call, want in chip_smoke.CLS_CALLS], P.name
