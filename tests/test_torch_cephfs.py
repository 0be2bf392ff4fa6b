"""The port's CephFS (``ceph_tpu_torch.mds``: the MDS and its client) held
against the reference's, on the CPU.

- **Twins** of every case of ``tests/test_cephfs.py`` (namespace ops,
  file I/O through the striper, journal replay and failover) and of
  ``tests/test_mds_multiactive.py`` (two active ranks, subtree export,
  per-rank failover, rank-striped inos, a mount with rank 0 vacant).
  Each runs one scenario on the reference's ``MiniCluster`` with the
  reference's ``MDSDaemon`` and ``CephFSClient``, and on the port's
  (``MiniCluster(device="cpu")``) with the port's.  Each keeps the
  reference case's own checks and records what it reads: every
  ``readdir``, ``stat`` and file read, and every ``FSError``'s errno.
  After the scenario, every object of the two CephFS pools is recorded
  through the cluster's own client: its bytes, its xattrs and, in the
  replicated metadata pool, its omap (the directories with their embedded
  inodes, each rank's journal, the allocator, the subtree map).  The two
  records must be equal, byte for byte.
- Inodes carry an ``mtime`` from ``time.time``, so :func:`twin` runs each
  package under ``tests/test_torch_rgw.py``'s ``deterministic`` with the
  stepping clock answering callers in the MDS modules only.
- The failover twins run both packages' clusters with a 0.5 s mon lease
  (so a silent MDS is failed over after 1.5 s, not 3 s) and a 0.1 s MDS
  beacon; the scenario is otherwise the reference case's.
- **The CLI** (``TestCephfsCLI``): one run on the port's cluster crosses
  the packages: the steps alternate between the port's ``cephfs_cli`` and
  the reference's, and every listing, ``stat`` and ``get`` prints the same
  from both.

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import types

import pytest

import ceph_tpu.mds as ref_mds
import ceph_tpu.rados as ref_rados
import ceph_tpu_torch.mds as port_mds
import ceph_tpu_torch.rados as port_rados
from ceph_tpu.common import Config as RefConfig
from ceph_tpu_torch.common import Config
from ceph_tpu.mds.daemon import MAX_MDS_RANKS as REF_MAX_MDS_RANKS
from ceph_tpu.tools import cephfs_cli as ref_cephfs_cli
from ceph_tpu_torch.mds.daemon import MAX_MDS_RANKS, ROOT_INO
from ceph_tpu_torch.tools import cephfs_cli
from tests.test_torch_rados import PORT as RADOS_PORT, REF as RADOS_REF
from tests.test_torch_rgw import assert_same_records, deterministic, pool_state, shard_state

LIMIT_S = 30.0
FS_MODULES = ("ceph_tpu.mds.", "ceph_tpu_torch.mds.")
FS_POOLS = (".cephfs",)
# the mon fails a silent MDS over after 3 leases; the MDSs beacon fast
FAST_FAILOVER = {"mon": {"mon_lease_interval": 0.5},
                 "daemons": {"mgr_beacon_interval": 0.1}}

REF = types.SimpleNamespace(name="ref", rados=ref_rados, mds=ref_mds, osd=RADOS_REF,
                            Config=RefConfig, kw={})
PORT = types.SimpleNamespace(name="port", rados=port_rados, mds=port_mds, osd=RADOS_PORT,
                             Config=Config, kw={"device": "cpu"})


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


class Run:
    """One package's run of a scenario: its cluster and what it records."""

    def __init__(self, P, cluster):
        self.P = P
        self.cluster = cluster
        self.rec: list = []

    def note(self, what, value):
        self.rec.append((what, value))
        return value

    async def call(self, what, coro):
        return self.note(what, await coro)

    async def fails(self, what, coro):
        """A call that must raise ``FSError``; its errno is recorded."""
        with pytest.raises(self.P.mds.FSError) as e:
            await coro
        return self.note(what, ("errno", e.value.code))

    async def mds(self, name="mds.a", **kw):
        """Start an MDS and wait until one is active."""
        mds = await self.cluster.start_mds(name, **kw)
        await self.cluster.wait_for_active_mds()
        return mds

    async def fs(self):
        cl = await self.cluster.client()
        return await self.P.mds.CephFSClient.mount(cl)

    async def wait_active(self, name, limit=20):
        async with asyncio.timeout(limit):
            while self.cluster.mon.osdmap.mds_name != name:
                await asyncio.sleep(0.05)
        await self.cluster.wait_for_active_mds()


def twin(scenario, n_osds=3, shards=False, config=None):
    """Run ``scenario(run)`` on each package's cluster under the
    deterministic MDS clock; then record the CephFS pools' objects (and
    with ``shards`` every OSD store's shards, crc tables and object
    sizes).  ``config`` holds the mon's overrides (``"mon"``) and every
    other daemon's (``"daemons"``).  The records must be equal."""
    config = config or {}
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            mon = config.get("mon")
            async with P.rados.MiniCluster(
                    n_osds=n_osds, config_overrides=config.get("daemons"),
                    mon_config=P.Config(overrides=mon) if mon else None,
                    **P.kw) as cluster:
                r = Run(P, cluster)
                await scenario(r)
                r.note("pools", await pool_state(cluster, FS_POOLS))
                if shards:
                    r.note("shards", shard_state(P, cluster))
                return r.rec

        with deterministic(callers=FS_MODULES, secret_modules=()):
            out[P.name] = run(main())
    assert_same_records(out["port"], out["ref"])


def test_the_ino_stripe_is_the_references_and_the_mons():
    from ceph_tpu_torch.mon.monitor import MAX_MDS_RANKS as MON_MAX_MDS_RANKS

    assert (MAX_MDS_RANKS, ROOT_INO) == (REF_MAX_MDS_RANKS, 1)
    assert MON_MAX_MDS_RANKS == MAX_MDS_RANKS


# -- tests/test_cephfs.py --------------------------------------------------------


class TestNamespace:
    def test_mkdir_readdir_stat(self):
        async def scenario(r):
            await r.mds()
            fs = await r.fs()
            await fs.mkdir("/home")
            await fs.mkdir("/home/alice")
            await fs.mkdir("/home/bob")
            await r.fails("mkdir exists", fs.mkdir("/home"))
            await r.fails("mkdir no parent", fs.mkdir("/no/such/parent"))
            root = await r.call("readdir /", fs.readdir("/"))
            assert list(root) == ["home"]
            home = await r.call("readdir /home", fs.readdir("/home"))
            assert list(home) == ["alice", "bob"]
            st = await r.call("stat", fs.stat("/home/alice"))
            assert st["type"] == "dir"
            assert await fs.exists("/home/alice")
            assert not await fs.exists("/home/carol")

        twin(scenario)

    def test_rmdir_rules(self):
        async def scenario(r):
            await r.mds()
            fs = await r.fs()
            await fs.mkdir("/d")
            await fs.mkdir("/d/sub")
            await r.fails("rmdir not empty", fs.rmdir("/d"))
            await fs.rmdir("/d/sub")
            await fs.rmdir("/d")
            assert not await fs.exists("/d")

        twin(scenario)

    def test_rename(self):
        async def scenario(r):
            await r.mds()
            fs = await r.fs()
            await fs.mkdir("/a")
            await fs.mkdir("/b")
            await fs.write_file("/a/f", b"content")
            await fs.rename("/a/f", "/b/g")
            assert not await fs.exists("/a/f")
            assert await r.call("read", fs.read_file("/b/g")) == b"content"
            await fs.write_file("/b/h", b"other")
            await r.fails("rename onto existing", fs.rename("/b/g", "/b/h"))

        twin(scenario)


class TestFileIO:
    def test_write_read_files(self):
        async def scenario(r):
            await r.mds()
            fs = await r.fs()
            await fs.mkdir("/data")
            big = bytes(range(256)) * 2000  # 512000: multiple stripes
            await fs.write_file("/data/big.bin", big)
            assert await fs.read_file("/data/big.bin") == big
            st = await r.call("stat", fs.stat("/data/big.bin"))
            assert st["size"] == len(big)
            f = await fs.open("/data/big.bin", create=False)
            assert await r.call("pread", f.read(1000, 64)) == big[1000:1064]
            await f.write(b"PATCH", 5)
            await f.close()
            got = await r.call("read patched", fs.read_file("/data/big.bin"))
            assert got[5:10] == b"PATCH" and got[:5] == big[:5]
            r.note("pools patched", await pool_state(r.cluster, FS_POOLS))
            await fs.write_file("/data/big.bin", b"tiny")
            assert await r.call("read tiny", fs.read_file("/data/big.bin")) == b"tiny"
            await fs.unlink("/data/big.bin")
            await r.fails("read unlinked", fs.read_file("/data/big.bin"))

        twin(scenario)


class TestJournalAndFailover:
    def test_mds_restart_preserves_namespace(self):
        async def scenario(r):
            await r.mds("mds.a")
            fs = await r.fs()
            await fs.mkdir("/keep")
            await fs.write_file("/keep/f", b"xyz")
            await r.cluster.kill_mds("mds.a")
            await r.cluster.start_mds("mds.b")
            await r.wait_active("mds.b")
            assert sorted(await r.call("readdir", fs.readdir("/"))) == ["keep"]
            assert await r.call("read", fs.read_file("/keep/f")) == b"xyz"
            await fs.mkdir("/keep/more")

        twin(scenario, config=FAST_FAILOVER)

    def test_no_ino_reuse_after_failover(self):
        async def scenario(r):
            await r.mds("mds.a")
            fs = await r.fs()
            olds = {}
            for i in range(5):
                olds[f"/f{i}"] = f"old-{i}".encode()
                await fs.write_file(f"/f{i}", olds[f"/f{i}"])
            await r.cluster.kill_mds("mds.a")
            await r.cluster.start_mds("mds.b")
            await r.wait_active("mds.b")
            await fs.write_file("/fresh", b"new-data")
            assert await fs.read_file("/fresh") == b"new-data"
            for path, want in olds.items():
                assert await fs.read_file(path) == want
            inos = set()
            for name, inode in (await r.call("readdir", fs.readdir("/"))).items():
                assert inode["ino"] not in inos, f"{name} reuses an ino"
                inos.add(inode["ino"])

        twin(scenario, config=FAST_FAILOVER)

    def test_journal_replay_after_partial_apply(self):
        async def scenario(r):
            mds = await r.mds("mds.a")
            fs = await r.fs()
            await fs.mkdir("/d")
            # the torn mutation: journal an event the dirs never saw
            ev = {"kind": "link", "dir": 1, "name": "ghostdir",
                  "inode": {"ino": 999, "type": "dir"}}
            await mds._journal(ev)
            await r.cluster.kill_mds("mds.a")
            await r.cluster.start_mds("mds.b")
            await r.wait_active("mds.b")
            assert sorted(await r.call("readdir", fs.readdir("/"))) == ["d", "ghostdir"]
            assert (await r.call("stat", fs.stat("/ghostdir")))["ino"] == 999

        twin(scenario, config=FAST_FAILOVER)


class TestCephfsCLI:
    def test_cli_workflow(self, tmp_path, capsys):
        """One run on the port's cluster: the steps alternate between the
        two packages' CLIs, and the reading steps print the same from
        both."""
        mains = {"port": cephfs_cli.main, "ref": ref_cephfs_cli.main}

        async def main():
            async with port_rados.MiniCluster(n_osds=3, device="cpu") as cluster:
                await cluster.start_mds()
                await cluster.wait_for_active_mds()
                mon = cluster.mon.addr
                loop = asyncio.get_running_loop()

                async def cephfs(who, *a):
                    capsys.readouterr()
                    rc = await loop.run_in_executor(None, mains[who], ["-m", mon, *a])
                    out = capsys.readouterr()
                    assert rc == 0, (who, a, out.err)
                    return out.out

                async def both(*a):
                    port, ref = await cephfs("port", *a), await cephfs("ref", *a)
                    assert port == ref, a
                    return port

                src = tmp_path / "local.txt"
                src.write_bytes(b"hello fs" * 100)
                await cephfs("port", "mkdir", "/docs")
                await cephfs("ref", "put", str(src), "/docs/readme")
                assert "readme" in await both("ls", "/docs")
                for who in mains:
                    out = tmp_path / f"back.{who}"
                    await cephfs(who, "get", "/docs/readme", str(out))
                    assert out.read_bytes() == src.read_bytes()
                assert '"size": 800' in await both("stat", "/docs/readme")
                await cephfs("port", "mv", "/docs/readme", "/docs/renamed")
                assert "renamed" in await both("ls", "/docs")
                await both("statfs")
                await cephfs("ref", "rm", "/docs/renamed")
                await cephfs("port", "rmdir", "/docs")
                assert await both("ls", "/") == ""

        run(main())


# -- tests/test_mds_multiactive.py -----------------------------------------------


async def _two_active(r, names=("mds.a", "mds.b")):
    for n in names:
        await r.cluster.start_mds(n)
    await r.cluster.wait_for_active_mds()
    cl = await r.cluster.client()
    code, status, _out = await cl.command({"prefix": "fs set max_mds", "val": 2})
    assert code == 0, status
    async with asyncio.timeout(10):
        while sum(1 for m in r.cluster.mdss.values() if m.active) < 2:
            await asyncio.sleep(0.02)
    ranks = {m.rank: m for m in r.cluster.mdss.values() if m.active}
    assert set(ranks) == {0, 1}
    r.note("ranks", {rank: m.name for rank, m in ranks.items()})
    return cl, ranks


class TestMultiActive:
    def test_two_ranks_and_subtree_export(self):
        async def scenario(r):
            _cl, ranks = await _two_active(r)
            fs = await r.fs()
            await fs.mkdir("/shared")
            await fs.mkdir("/shared/sub")
            out = await r.call("export", fs.export_subtree("/shared", 1))
            assert out["rank"] == 1
            served = {0: [], 1: []}
            for rank, mds in ranks.items():
                orig = mds._op_mkdir

                async def traced(args, _r=rank, _orig=orig):
                    res = await _orig(args)
                    served[_r].append(args["path"])
                    return res

                mds._op_mkdir = traced
            await fs.mkdir("/shared/sub/deep")  # redirect -> rank 1
            await fs.mkdir("/top")              # rank 0 (root)
            assert r.note("served", served) == {0: ["/top"], 1: ["/shared/sub/deep"]}
            assert list(await r.call("readdir", fs.readdir("/shared/sub"))) == ["deep"]
            st = await r.call("stat deep", fs.stat("/shared/sub/deep"))
            assert (st["ino"] - ROOT_INO) % MAX_MDS_RANKS == 1
            st0 = await r.call("stat top", fs.stat("/top"))
            assert (st0["ino"] - ROOT_INO) % MAX_MDS_RANKS == 0

        twin(scenario)

    def test_cross_subtree_rename_is_exdev(self):
        async def scenario(r):
            await _two_active(r)
            fs = await r.fs()
            await fs.mkdir("/a")
            await fs.mkdir("/b")
            await fs.export_subtree("/b", 1)
            await fs.write_file("/a/f", b"x")
            assert (await r.fails("cross rename", fs.rename("/a/f", "/b/f")))[1] == -18
            await fs.rename("/a/f", "/a/g")
            assert await r.call("read", fs.read_file("/a/g")) == b"x"

        twin(scenario)

    def test_rank_failover_rejoins_with_journal(self):
        async def scenario(r):
            cl, ranks = await _two_active(r)
            await r.cluster.start_mds("mds.c")  # standby
            fs = await r.fs()
            await fs.mkdir("/exp")
            await fs.export_subtree("/exp", 1)
            await fs.write_file("/exp/file", b"survives")
            victim = ranks[1].name
            await r.cluster.kill_mds(victim)
            code, _s, _o = await cl.command({"prefix": "mds fail", "name": victim})
            assert code == 0
            async with asyncio.timeout(15):
                while not any(m.active and m.rank == 1 for m in r.cluster.mdss.values()):
                    await asyncio.sleep(0.05)
            successor = next(m for m in r.cluster.mdss.values() if m.active and m.rank == 1)
            assert r.note("successor", successor.name) == "mds.c"
            assert await r.call("read", fs.read_file("/exp/file")) == b"survives"
            await fs.write_file("/exp/more", b"new writes ok")
            assert await r.call("read more", fs.read_file("/exp/more")) == b"new writes ok"

        twin(scenario, config=FAST_FAILOVER)

    def test_ino_allocators_never_collide(self):
        async def scenario(r):
            await _two_active(r)
            fs = await r.fs()
            await fs.mkdir("/r0")
            await fs.mkdir("/r1")
            await fs.export_subtree("/r1", 1)
            inos = set()
            for i in range(12):
                await fs.write_file(f"/r0/f{i}", b"0")
                await fs.write_file(f"/r1/f{i}", b"1")
            for i in range(12):
                inos.add((await fs.stat(f"/r0/f{i}"))["ino"])
                inos.add((await fs.stat(f"/r1/f{i}"))["ino"])
            assert len(r.note("inos", sorted(inos))) == 24, "ino collision across ranks"

        twin(scenario)

    def test_client_mounts_with_rank0_vacant(self):
        async def scenario(r):
            cl, ranks = await _two_active(r)
            fs = await r.fs()
            await fs.mkdir("/sub")
            await fs.export_subtree("/sub", 1)
            await fs.write_file("/sub/f", b"alive")
            victim = ranks[0].name
            await r.cluster.kill_mds(victim)
            code, _s, _o = await cl.command({"prefix": "mds fail", "name": victim})
            assert code == 0
            async with asyncio.timeout(10):
                while True:
                    m = cl.osdmap
                    tbl = m.mds_rank_table() if m else []
                    if len(tbl) > 1 and not tbl[0][1] and tbl[1][1]:
                        break
                    await asyncio.sleep(0.05)
            fs2 = await r.fs()  # a fresh mount bootstraps via rank 1
            assert await r.call("read", fs2.read_file("/sub/f")) == b"alive"

        twin(scenario, config=FAST_FAILOVER)
