"""The port's RBD (``ceph_tpu_torch.rbd``: images, snapshots, clones) held
against the reference's, on the CPU.

- **Twins** of every case of ``tests/test_rbd.py`` (lifecycle, I/O across
  objects, discard, resize, snapshots, header watch coherence, the
  exclusive lock, ``du``) and of ``tests/test_rbd_clone.py`` (protected
  snaps, copy-up, a cached clone, discard over the parent, the overlap,
  flatten, the children registry).  Each runs one scenario on the
  reference's ``MiniCluster`` with the reference's ``RBD`` and ``Image``,
  and on the port's (``MiniCluster(device="cpu")``) with the port's.  Each
  keeps the reference case's own checks and records what it reads: image
  reads, ``stat``, listings, lock owners, ``du`` and every ``RbdError``'s
  errno.  After the scenario, every head object of every pool is recorded
  through the cluster's own client: its bytes, its xattrs and its omap
  (the directory, the headers with their snapshot tables, the children
  registry, the lock).  The two records must be equal, byte for byte.
- An image's id comes from ``secrets.token_hex``, so :func:`twin` runs each
  package under ``tests/test_torch_rgw.py``'s ``deterministic`` with one
  seeded ``token_hex`` in both packages' ``rbd.image``.
- **The CLI** (the two CLI workflows and the export-diff chain): one run on
  the port's cluster each crosses the packages.  The steps alternate
  between the port's ``rbd_cli`` and the reference's, every reading step
  prints the same from both, both packages' ``export-diff`` write the same
  stream byte for byte, and each package's ``import-diff`` applies the
  other's stream.

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import types

import pytest

import ceph_tpu.rados as ref_rados
import ceph_tpu.rbd as ref_rbd
import ceph_tpu.rbd.image as ref_image
import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.rbd as port_rbd
import ceph_tpu_torch.rbd.image as port_image
from ceph_tpu.tools import rbd_cli as ref_rbd_cli
from ceph_tpu_torch.tools import rbd_cli
from tests.test_torch_rgw import assert_same_records, deterministic, pool_state

LIMIT_S = 30.0
RBD_MODULES = ("ceph_tpu.rbd.", "ceph_tpu_torch.rbd.")
ORDER = 14  # 16 KiB objects: small enough to cross boundaries in tests
OBJ = 1 << ORDER

REF = types.SimpleNamespace(name="ref", rados=ref_rados, rbd=ref_rbd, kw={})
PORT = types.SimpleNamespace(name="port", rados=port_rados, rbd=port_rbd, kw={"device": "cpu"})
CLI = {"port": rbd_cli.main, "ref": ref_rbd_cli.main}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


class Run:
    """One package's run of a scenario: its cluster and what it records."""

    def __init__(self, P, cluster):
        self.P = P
        self.cluster = cluster
        self.rec: list = []
        self.RBD, self.Image = P.rbd.RBD, P.rbd.Image

    def note(self, what, value):
        self.rec.append((what, value))
        return value

    async def call(self, what, coro):
        return self.note(what, await coro)

    async def fails(self, what, coro):
        """A call that must raise ``RbdError``; its errno is recorded."""
        with pytest.raises(self.P.rbd.RbdError) as e:
            await coro
        return self.note(what, ("errno", e.value.code))

    def fails_now(self, what, fn, *a):
        with pytest.raises(self.P.rbd.RbdError) as e:
            fn(*a)
        return self.note(what, ("errno", e.value.code))

    async def pool(self, name="rbd", **kw):
        """A client, a replicated pool and its ``IoCtx``."""
        cl = await self.cluster.client()
        await cl.create_pool(name, "replicated", **kw)
        return cl, cl.io_ctx(name)


def twin(scenario, n_osds=3):
    """Run ``scenario(run)`` on each package's cluster with one seeded
    image id generator; then record every pool's head objects.  The
    records must be equal."""
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            async with P.rados.MiniCluster(n_osds=n_osds, **P.kw) as cluster:
                r = Run(P, cluster)
                await scenario(r)
                r.note("pools", await pool_state(cluster, ("",)))
                return r.rec

        with deterministic(callers=RBD_MODULES, secret_modules=(ref_image, port_image)):
            out[P.name] = run(main())
    assert_same_records(out["port"], out["ref"])


class Cli:
    """The two packages' ``rbd_cli`` against one cluster, each ``main`` on
    a worker thread (it runs its own event loop), its output captured."""

    def __init__(self, capsys, mon, pool="rbd"):
        self.capsys, self.mon, self.pool = capsys, mon, pool

    async def __call__(self, who, *a, rc=0):
        self.capsys.readouterr()
        got = await asyncio.get_running_loop().run_in_executor(
            None, CLI[who], ["-m", self.mon, "-p", self.pool, *a])
        out = self.capsys.readouterr()
        assert got == rc, (who, a, out.err)
        return out.out

    async def both(self, *a):
        """A reading step: both packages print the same."""
        port, ref = await self("port", *a), await self("ref", *a)
        assert port == ref, a
        return port


# -- tests/test_rbd.py -------------------------------------------------------------


class TestImageLifecycle:
    def test_create_list_info_remove(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            rbd = r.RBD(io)
            await rbd.create("img1", 10 * OBJ, order=ORDER)
            await rbd.create("img2", 4 * OBJ, order=ORDER)
            assert await r.call("list", rbd.list()) == ["img1", "img2"]
            await r.fails("create again", rbd.create("img1", OBJ))
            img = await r.Image.open(io, "img1")
            st = await r.call("stat", img.stat())
            assert st["size"] == 10 * OBJ and st["object_size"] == OBJ
            await img.close()
            await rbd.remove("img2")
            assert await r.call("list after", rbd.list()) == ["img1"]
            await r.fails("open removed", r.Image.open(io, "img2"))

        twin(scenario)

    def test_rename(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            rbd = r.RBD(io)
            await rbd.create("old", OBJ, order=ORDER)
            await rbd.rename("old", "new")
            assert await r.call("list", rbd.list()) == ["new"]

        twin(scenario)


class TestImageIO:
    def test_write_read_across_objects(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            await r.RBD(io).create("img", 8 * OBJ, order=ORDER)
            img = await r.Image.open(io, "img")
            data = bytes(range(256)) * ((2 * OBJ + 512) // 256)
            off = OBJ - 200
            await img.write(off, data)
            assert await img.read(off, len(data)) == data
            assert await r.call("sparse", img.read(5 * OBJ, 100)) == b"\x00" * 100
            await img.write(off + OBJ, b"MARK")
            got = await r.call("interior", img.read(off + OBJ - 2, 8))
            assert got == data[OBJ - 2: OBJ] + b"MARK" + data[OBJ + 4: OBJ + 6]
            await r.fails("overrun", img.write(8 * OBJ - 2, b"overrun"))
            await img.close()

        twin(scenario)

    def test_discard(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            await r.RBD(io).create("img", 4 * OBJ, order=ORDER)
            img = await r.Image.open(io, "img")
            await img.write(0, b"\xff" * (3 * OBJ))
            await img.discard(OBJ, OBJ)
            await img.discard(100, 50)
            got = await r.call("read", img.read(0, 3 * OBJ))
            assert got[:100] == b"\xff" * 100
            assert got[100:150] == b"\x00" * 50
            assert got[OBJ: 2 * OBJ] == b"\x00" * OBJ
            assert got[2 * OBJ:] == b"\xff" * OBJ
            await img.close()

        twin(scenario)

    def test_resize(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            await r.RBD(io).create("img", 4 * OBJ, order=ORDER)
            img = await r.Image.open(io, "img")
            await img.write(0, b"\xaa" * (4 * OBJ))
            await img.resize(2 * OBJ + 100)
            assert r.note("size", img.size_bytes) == 2 * OBJ + 100
            await r.fails("past size", img.write(2 * OBJ + 50, b"too-long" * 20))
            await img.resize(4 * OBJ)
            got = await r.call("read", img.read(0, 4 * OBJ))
            assert got[: 2 * OBJ + 100] == b"\xaa" * (2 * OBJ + 100)
            assert got[2 * OBJ + 100:] == b"\x00" * (2 * OBJ - 100)
            await img.close()

        twin(scenario)


class TestImageSnapshots:
    def test_snapshot_read_rollback_remove(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            rbd = r.RBD(io)
            await rbd.create("img", 4 * OBJ, order=ORDER)
            img = await r.Image.open(io, "img")
            gen1 = b"g1" * OBJ
            await img.write(0, gen1)
            await img.snap_create("s1")
            gen2 = b"G2!" * OBJ
            await img.write(0, gen2)
            img.set_snap("s1")
            assert await r.call("at s1", img.read(0, len(gen1))) == gen1
            await r.fails("write at snap", img.write(0, b"nope"))
            img.set_snap(None)
            assert await img.read(0, len(gen2)) == gen2
            await img.snap_rollback("s1")
            got = await r.call("rolled back", img.read(0, len(gen2)))
            assert got[: len(gen1)] == gen1
            assert got[len(gen1):] == b"\x00" * (len(gen2) - len(gen1))
            await img.snap_remove("s1")
            r.fails_now("set removed snap", img.set_snap, "s1")
            await img.close()
            await rbd.create("img2", OBJ, order=ORDER)
            img2 = await r.Image.open(io, "img2")
            await img2.snap_create("keep")
            await r.fails("remove with snaps", rbd.remove("img2"))
            await img2.snap_remove("keep")
            await img2.close()
            await rbd.remove("img2")

        twin(scenario)

    def test_snapshot_size_tracked(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            await r.RBD(io).create("img", 4 * OBJ, order=ORDER)
            img = await r.Image.open(io, "img")
            await img.write(0, b"x" * OBJ)
            await img.snap_create("small")
            await img.resize(8 * OBJ)
            await img.write(6 * OBJ, b"y" * OBJ)
            img.set_snap("small")
            assert await r.call("at small", img.read(0, 8 * OBJ)) == (
                b"x" * OBJ + b"\x00" * (3 * OBJ))
            img.set_snap(None)
            await img.snap_rollback("small")
            assert r.note("size", img.size_bytes) == 4 * OBJ
            await img.close()

        twin(scenario)


class TestMultiClient:
    def test_header_watch_coherence(self):
        async def scenario(r):
            cl1, _io = await r.pool(size=3)
            cl2 = await r.cluster.client()
            await cl2.wait_for_pool("rbd")
            await r.RBD(cl1.io_ctx("rbd")).create("img", 2 * OBJ, order=ORDER)
            img1 = await r.Image.open(cl1.io_ctx("rbd"), "img")
            img2 = await r.Image.open(cl2.io_ctx("rbd"), "img")
            await img1.resize(6 * OBJ)
            for _ in range(100):
                if img2.size_bytes == 6 * OBJ:
                    break
                await asyncio.sleep(0.02)
            assert r.note("seen", img2.size_bytes) == 6 * OBJ
            await img1.close()
            await img2.close()

        twin(scenario)

    def test_exclusive_lock(self):
        async def scenario(r):
            cl1, _io = await r.pool(size=3)
            cl2 = await r.cluster.client()
            await cl2.wait_for_pool("rbd")
            await r.RBD(cl1.io_ctx("rbd")).create("img", OBJ, order=ORDER)
            img1 = await r.Image.open(cl1.io_ctx("rbd"), "img")
            img2 = await r.Image.open(cl2.io_ctx("rbd"), "img")
            await img1.lock_acquire()
            await r.fails("second owner", img2.lock_acquire())
            owners = await r.call("owners", img2.lock_owners())
            assert owners[0]["entity"] == cl1.name
            r.note("pools locked", await pool_state(r.cluster, ("",)))
            await img2.break_lock(cl1.name)
            await img2.lock_acquire()
            await img2.lock_release()
            await img1.close()
            await img2.close()

        twin(scenario)


def test_du_reports_sparse_allocation():
    async def scenario(r):
        _cl, io = await r.pool()
        size = 8 << 20
        await r.RBD(io).create("img", size, order=20)
        img = await r.Image.open(io, "img")
        try:
            d = await r.call("du empty", img.du())
            assert d["provisioned"] == size and d["used"] == 0
            await img.write(0, b"a" * 4096)
            await img.write(5 << 20, b"b" * 4096)
            d = await r.call("du two", img.du())
            assert d["objects"] == 2
            assert 8192 <= d["used"] <= 2 << 20
            assert d["used"] < d["provisioned"]
            await img.discard(0, 1 << 20)
            assert (await r.call("du one", img.du()))["objects"] == 1
        finally:
            await img.close()

    twin(scenario)


class TestRbdCLI:
    def test_cli_workflow(self, tmp_path, capsys):
        """import, ls, info, snap, export and rm on the port's cluster, the
        steps alternating between the packages' CLIs."""

        async def main():
            async with port_rados.MiniCluster(n_osds=3, device="cpu") as cluster:
                cli = Cli(capsys, cluster.mon.addr)
                src = tmp_path / "disk.bin"
                src.write_bytes(bytes(range(256)) * 300)
                cl = await cluster.client()
                await cl.create_pool("rbd", "replicated", size=3)
                await cli("port", "import", str(src), "disk")
                assert "disk" in await cli.both("ls")
                info = await cli.both("info", "disk")
                assert f"size {src.stat().st_size} bytes" in info
                await cli("ref", "snap", "create", "disk@s1")
                assert "s1" in await cli.both("snap", "ls", "disk")
                for who in CLI:
                    out = tmp_path / f"disk.{who}"
                    await cli(who, "export", "disk", str(out))
                    assert out.read_bytes() == src.read_bytes()
                await cli("port", "snap", "rm", "disk@s1")
                await cli("ref", "rm", "disk")
                assert await cli.both("ls") == ""

        run(main())


def test_export_diff_import_diff_chain(tmp_path, capsys):
    """Full and incremental diffs replay a source image's history onto a
    destination, snapshots included; both packages' ``export-diff`` write
    the same streams, and each package's ``import-diff`` applies the
    other's (on the port's cluster over durable stores)."""

    async def main():
        async with port_rados.MiniCluster(n_osds=3, store_dir=str(tmp_path / "stores"),
                                          device="cpu") as cluster:
            cl = await cluster.client()
            await cl.create_pool("rbd", "replicated")
            io = cl.io_ctx("rbd")
            size = 4 << 20
            await port_rbd.RBD(io).create("src", size, order=20)
            img = await port_rbd.Image.open(io, "src")
            await img.write(0, b"v1-base" * 1000)
            await img.write(2 << 20, b"v1-tail" * 1000)
            await img.snap_create("s1")
            await img.write(0, b"v2-base" * 1000)
            await img.discard(2 << 20, 1 << 20)
            await img.snap_create("s2")
            img.set_snap("s1")
            s1_bytes = await img.read(0, size)
            img.set_snap("s2")
            s2_bytes = await img.read(0, size)
            img.set_snap(None)
            await img.close()

            cli = Cli(capsys, cluster.mon.addr)
            streams = {}
            for who in CLI:
                full, inc = tmp_path / f"full.{who}", tmp_path / f"inc.{who}"
                await cli(who, "export-diff", "src", str(full), "--snap", "s1")
                await cli(who, "export-diff", "src", str(inc), "--from-snap", "s1",
                          "--snap", "s2")
                streams[who] = (full, inc)
            (full, inc), (ref_full, ref_inc) = streams["port"], streams["ref"]
            assert full.read_bytes() == ref_full.read_bytes()
            assert inc.read_bytes() == ref_inc.read_bytes()
            assert inc.stat().st_size < full.stat().st_size

            await cli("port", "create", "dst", "--size", str(size), "--order", "20")
            await cli("port", "import-diff", str(inc), "dst", rc=1)  # no s1 yet
            await cli("port", "import-diff", str(ref_full), "dst")
            await cli("ref", "import-diff", str(inc), "dst")
            dst = await port_rbd.Image.open(io, "dst")
            try:
                assert set(dst.snaps) == {"s1", "s2"}
                dst.set_snap("s1")
                assert await dst.read(0, size) == s1_bytes
                dst.set_snap("s2")
                assert await dst.read(0, size) == s2_bytes
            finally:
                await dst.close()

            # a truncated stream is a clean error with no to-snap
            trunc = tmp_path / "trunc.diff"
            trunc.write_bytes(full.read_bytes()[: full.stat().st_size // 2])
            await cli("ref", "create", "dstt", "--size", str(size), "--order", "20")
            await cli("port", "import-diff", str(trunc), "dstt", rc=1)
            dstt = await port_rbd.Image.open(io, "dstt")
            try:
                assert dstt.snaps == {}
            finally:
                await dstt.close()

            # a different destination order is rejected, not corrupted
            await cli("port", "create", "dst22", "--size", str(size))
            await cli("port", "import-diff", str(full), "dst22", rc=1)

            # a clone's full export carries parent-backed holes
            img = await port_rbd.Image.open(io, "src")
            await img.snap_protect("s2")
            await img.close()
            await cli("ref", "clone", "src@s2", "kid")
            kdiff = {}
            for who in CLI:
                kdiff[who] = tmp_path / f"kid.{who}"
                await cli(who, "export-diff", "kid", str(kdiff[who]))
            assert kdiff["port"].read_bytes() == kdiff["ref"].read_bytes()
            await cli("port", "create", "kid2", "--size", str(size), "--order", "20")
            await cli("port", "import-diff", str(kdiff["ref"]), "kid2")
            kid2 = await port_rbd.Image.open(io, "kid2")
            try:
                assert await kid2.read(0, size) == s2_bytes
            finally:
                await kid2.close()

    run(main())


# -- tests/test_rbd_clone.py -------------------------------------------------------


async def _clone_setup(r, cache_bytes=0):
    _cl, io = await r.pool(size=3)
    rbd = r.RBD(io)
    await rbd.create("base", 4 * OBJ, order=ORDER)
    base = await r.Image.open(io, "base")
    golden = bytes(range(256)) * (3 * OBJ // 256)  # 3 of 4 objects
    await base.write(0, golden)
    await base.snap_create("gold")
    await base.snap_protect("gold")
    await rbd.clone("base", "gold", "child")
    child = await r.Image.open(io, "child", cache_bytes=cache_bytes)
    return io, rbd, base, child, golden


class TestClone:
    def test_requires_protected_snap(self):
        async def scenario(r):
            _cl, io = await r.pool(size=3)
            rbd = r.RBD(io)
            await rbd.create("base", OBJ, order=ORDER)
            img = await r.Image.open(io, "base")
            await img.snap_create("s")
            await r.fails("not protected", rbd.clone("base", "s", "c"))
            await r.fails("no snap", rbd.clone("base", "nope", "c"))
            await img.close()

        twin(scenario)

    def test_read_through_and_copy_up(self):
        async def scenario(r):
            io, rbd, base, child, golden = await _clone_setup(r)
            assert await r.call("through", child.read(0, len(golden))) == golden
            assert await child.read(3 * OBJ, OBJ) == b"\x00" * OBJ
            await base.write(0, b"\xdd" * OBJ)
            assert (await child.read(0, OBJ)) == golden[:OBJ]
            await child.write(100, b"CHILD")
            got = await r.call("copied up", child.read(0, OBJ))
            assert got[100:105] == b"CHILD"
            assert got[:100] == golden[:100] and got[105:] == golden[105:OBJ]
            assert await child.read(OBJ, OBJ) == golden[OBJ: 2 * OBJ]
            base.set_snap("gold")
            assert (await base.read(0, OBJ))[100:105] == golden[100:105]
            await base.close()
            await child.close()

        twin(scenario)

    def test_clone_with_cache(self):
        async def scenario(r):
            io, rbd, base, child, golden = await _clone_setup(r, cache_bytes=1 << 20)
            assert await child.read(0, 2 * OBJ) == golden[: 2 * OBJ]
            await child.write(10, b"X")
            got = await r.call("cached", child.read(0, 64))
            assert got[10:11] == b"X" and got[:10] == golden[:10]
            await child.close()
            child2 = await r.Image.open(io, "child")
            got = await r.call("reopened", child2.read(0, 64))
            assert got[10:11] == b"X" and got[11:64] == golden[11:64]
            await child2.close()
            await base.close()

        twin(scenario)

    def test_discard_masks_parent(self):
        async def scenario(r):
            io, rbd, base, child, golden = await _clone_setup(r)
            await child.discard(0, OBJ)
            assert await child.read(0, OBJ) == b"\x00" * OBJ
            await child.discard(OBJ + 50, 20)
            got = await r.call("read", child.read(OBJ, OBJ))
            assert got[:50] == golden[OBJ: OBJ + 50]
            assert got[50:70] == b"\x00" * 20
            assert got[70:] == golden[OBJ + 70: 2 * OBJ]
            await base.close()
            await child.close()

        twin(scenario)

    def test_overlap_shrinks_with_resize(self):
        async def scenario(r):
            io, rbd, base, child, golden = await _clone_setup(r)
            await child.resize(OBJ)
            await child.resize(4 * OBJ)
            got = await r.call("read", child.read(0, 4 * OBJ))
            assert got[:OBJ] == golden[:OBJ]
            assert got[OBJ:] == b"\x00" * (3 * OBJ)
            await base.close()
            await child.close()

        twin(scenario)


class TestFlattenAndGuards:
    def test_flatten_detaches(self):
        async def scenario(r):
            io, rbd, base, child, golden = await _clone_setup(r)
            assert await r.call("children", base.list_children("gold")) == ["child"]
            await r.fails("unprotect with child", base.snap_unprotect("gold"))
            await r.fails("remove protected", base.snap_remove("gold"))
            await child.flatten()
            assert child.parent is None
            assert await r.call("flat", child.read(0, len(golden))) == golden
            await base.snap_unprotect("gold")
            await base.snap_remove("gold")
            await base.close()
            await rbd.remove("base")
            assert await child.read(0, OBJ) == golden[:OBJ]
            await child.close()

        twin(scenario)

    def test_child_remove_releases_parent(self):
        async def scenario(r):
            io, rbd, base, child, golden = await _clone_setup(r)
            await child.close()
            await rbd.remove("child")
            assert await r.call("children", base.list_children("gold")) == []
            await base.snap_unprotect("gold")
            await base.close()

        twin(scenario)


class TestCloneCLI:
    def test_cli_clone_workflow(self, tmp_path, capsys):
        async def main():
            async with port_rados.MiniCluster(n_osds=3, device="cpu") as cluster:
                cli = Cli(capsys, cluster.mon.addr)
                src = tmp_path / "img.bin"
                src.write_bytes(b"golden-image" * 1000)
                cl = await cluster.client()
                await cl.create_pool("rbd", "replicated", size=3)
                await cli("ref", "import", str(src), "golden")
                await cli("port", "snap", "create", "golden@v1")
                await cli("ref", "snap", "protect", "golden@v1")
                await cli("port", "clone", "golden@v1", "vm1")
                assert "vm1" in await cli.both("children", "golden@v1")
                for who in CLI:
                    out = tmp_path / f"out.{who}"
                    await cli(who, "export", "vm1", str(out))
                    assert out.read_bytes() == src.read_bytes()
                await cli("ref", "flatten", "vm1")
                assert (await cli.both("children", "golden@v1")).strip() == ""
                await cli("port", "snap", "unprotect", "golden@v1")

        run(main())
