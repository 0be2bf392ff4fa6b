"""The port's client tools held against the reference's, on the CPU.

- The five client cases of ``tests/test_tools.py`` (``rados`` verbs end
  to end, the omap verbs, ``ceph osd tree``, ``ceph osd map``, ``rados
  cppool``) run the port's CLIs against the port's
  ``MiniCluster(device="cpu")``.
- The same commands print the same lines from both packages, each CLI
  against its own package's cluster built the same way: ``ceph osd
  tree``, ``ceph osd dump`` (addresses and the fsid masked), ``rados
  lspools``, ``rados ls``, ``rados listomapvals``; ``rados bench``'s
  line is compared by its shape, its numbers being timings.
- ``objectstore_tool`` and ``monstore_tool`` (the cases of
  ``tests/test_kv_tools.py`` from its objectstore tool on) run over a
  store written by the other package, and both packages' tools print
  the same listings and dumps of it.
- ``rgw_admin`` (``user create|ls|info|rm``, ``bucket ls|stats``,
  ``quota set|get`` and an error) prints what the reference's prints, each
  tool against its own package's cluster built the same way, with the
  gateway's keys and clock made deterministic as in
  ``tests/test_torch_rgw.py``.
- ``vstart`` (``tests/test_vstart.py`` and the monmap case of
  ``tests/test_monmaptool.py``) boots with ``--device cpu`` and serves
  the port's ``rados``, ``ceph`` and ``rbd`` (a journaled image imported,
  mirrored into a second pool and exported), in process and with
  ``--multiprocess``; with ``--rgw`` it serves S3 (a signed PUT and GET
  over HTTP) and its ``admin`` user reads the same through the port's and
  the reference's ``rgw_admin``; with ``--mds`` it prints the MDS's line
  and serves CephFS, and the port's ``cephfs_cli`` prints what the
  reference's prints (``ls``, ``stat``, ``cat``, ``statfs``); ``--mds`` and
  ``--rgw`` are refused with ``--multiprocess``, as the reference refuses
  them, and without ``--device`` it needs CUDA.

Every cluster body runs under ``asyncio.timeout`` and every child
process is waited on with a bound.
"""

import asyncio
import base64
import hashlib
import json
import os
import pathlib
import re
import selectors
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

import ceph_tpu.rados as ref_rados
import ceph_tpu.rgw as ref_rgw
from ceph_tpu.mon.store import MonitorDBStore as RefMonitorDBStore
from ceph_tpu.store.wal import WalStore as RefWalStore
from ceph_tpu.tools import ceph_cli as ref_ceph_cli
from ceph_tpu.tools import cephfs_cli as ref_cephfs_cli
from ceph_tpu.tools import monstore_tool as ref_monstore_tool
from ceph_tpu.tools import objectstore_tool as ref_objectstore_tool
from ceph_tpu.tools import rados_cli as ref_rados_cli
from ceph_tpu.tools import rgw_admin as ref_rgw_admin

import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.rgw as port_rgw
from ceph_tpu_torch.device import DeviceUnavailableError
from ceph_tpu_torch.mon.store import MonitorDBStore
from ceph_tpu_torch.store.wal import WalStore
from ceph_tpu_torch.tools import (
    ceph_cli, cephfs_cli, monstore_tool, objectstore_tool, rados_cli, rbd_cli, rgw_admin,
    vstart)
from tests.test_torch_rgw import deterministic, http as rgw_http, PORT as RGW_PORT

REPO = pathlib.Path(__file__).resolve().parent.parent
LIMIT_S = 60.0

REF = types.SimpleNamespace(
    name="ref", rados=ref_rados, rados_cli=ref_rados_cli, ceph_cli=ref_ceph_cli,
    rgw=ref_rgw, rgw_admin=ref_rgw_admin, objectstore_tool=ref_objectstore_tool, monstore_tool=ref_monstore_tool,
    WalStore=RefWalStore, MonitorDBStore=RefMonitorDBStore, kw={})
PORT = types.SimpleNamespace(
    name="port", rados=port_rados, rados_cli=rados_cli, ceph_cli=ceph_cli,
    rgw=port_rgw, rgw_admin=rgw_admin, objectstore_tool=objectstore_tool, monstore_tool=monstore_tool,
    WalStore=WalStore, MonitorDBStore=MonitorDBStore, kw={"device": "cpu"})


def run(coro):
    async def bounded():
        async with asyncio.timeout(LIMIT_S):
            return await coro
    return asyncio.run(bounded())


def cluster(**kw):
    return port_rados.MiniCluster(device="cpu", **kw)


def in_thread(fn, argv):
    """A CLI owns its event loop: run it on a worker thread."""
    return asyncio.get_running_loop().run_in_executor(None, fn, argv)


# -- the client cases of tests/test_tools.py ----------------------------------


def test_rados_cli_end_to_end(tmp_path, capsys):
    """put/get/ls/stat/xattr/scrub/rm through the port's CLI."""

    async def main():
        async with cluster(n_osds=3) as c:
            mon = c.mon.addr

            def run_cli(*argv):
                return in_thread(rados_cli.main, ["-m", mon, *argv])

            assert await run_cli("mkpool", "data", "erasure") == 0
            assert await run_cli("lspools") == 0
            assert "data" in capsys.readouterr().out
            src = tmp_path / "in.bin"
            src.write_bytes(b"cli payload" * 100)
            assert await run_cli("-p", "data", "put", "obj1", str(src)) == 0
            dst = tmp_path / "out.bin"
            assert await run_cli("-p", "data", "get", "obj1", str(dst)) == 0
            assert dst.read_bytes() == src.read_bytes()
            assert await run_cli("-p", "data", "ls") == 0
            assert "obj1" in capsys.readouterr().out
            assert await run_cli("-p", "data", "stat", "obj1") == 0
            assert "size 1100" in capsys.readouterr().out
            assert await run_cli("-p", "data", "setxattr", "obj1", "k", "v") == 0
            assert await run_cli("-p", "data", "listxattr", "obj1") == 0
            assert "k" in capsys.readouterr().out
            assert await run_cli("-p", "data", "scrub") == 0
            assert "0 errors" in capsys.readouterr().out
            assert await run_cli("-p", "data", "rm", "obj1") == 0
            assert await run_cli("-p", "data", "ls") == 0
            assert "obj1" not in capsys.readouterr().out

    run(main())


def test_rados_cli_omap_verbs(capsys):
    async def main():
        async with cluster(n_osds=3) as c:
            mon = c.mon.addr

            def run_cli(*argv):
                return in_thread(rados_cli.main, ["-m", mon, *argv])

            assert await run_cli("mkpool", "meta", "replicated") == 0
            cl = await c.client()
            io = cl.io_ctx("meta")
            await io.write_full("obj", b"x")
            capsys.readouterr()
            assert await run_cli("-p", "meta", "setomapval", "obj", "alpha", "1") == 0
            assert await run_cli("-p", "meta", "setomapval", "obj", "beta", "2") == 0
            assert await run_cli("-p", "meta", "listomapkeys", "obj") == 0
            assert capsys.readouterr().out.splitlines()[-2:] == ["alpha", "beta"]
            assert await run_cli("-p", "meta", "getomapval", "obj", "beta") == 0
            assert capsys.readouterr().out.endswith("2")
            assert await run_cli("-p", "meta", "listomapvals", "obj") == 0
            out = capsys.readouterr().out
            assert "alpha (1 bytes):" in out and "beta (1 bytes):" in out
            assert await run_cli("-p", "meta", "rmomapkey", "obj", "alpha") == 0
            assert await run_cli("-p", "meta", "listomapkeys", "obj") == 0
            assert "alpha" not in capsys.readouterr().out
            assert await run_cli("-p", "meta", "getomapval", "obj", "ghost") == 1

    run(main())


def test_ceph_osd_tree(capsys):
    async def main():
        async with cluster(n_osds=4, crush_hosts=[[0, 1], [2, 3]]) as c:
            await c.kill_osd(3)
            await c.wait_for_osd_down(3)
            assert await in_thread(ceph_cli.main, ["-m", c.mon.addr, "osd", "tree"]) == 0
            lines = capsys.readouterr().out.splitlines()
            assert lines[0].split() == [
                "ID", "CLASS", "WEIGHT", "TYPE", "NAME", "STATUS", "REWEIGHT"]
            assert sum("host" in ln for ln in lines) == 2
            assert any("osd.3" in ln and "down" in ln for ln in lines)
            assert any("osd.0" in ln and "up" in ln for ln in lines)

    run(main())


def test_ceph_osd_map(capsys):
    async def main():
        async with cluster(n_osds=3) as c:
            mon = c.mon.addr
            cl = await c.client()
            await cl.create_pool("data", "replicated", size=3)
            pool = cl.osdmap.lookup_pool("data")
            pg, acting, primary = cl.osdmap.object_to_acting("thing", pool.id)
            assert await in_thread(ceph_cli.main, ["-m", mon, "osd", "map", "data", "thing"]) == 0
            out = capsys.readouterr().out
            assert f"({pg})" in out and f"p{primary}" in out and str(acting) in out
            assert await in_thread(ceph_cli.main, ["-m", mon, "osd", "map", "nope", "thing"]) == 1

    run(main())


def test_rados_cppool(capsys):
    async def main():
        async with cluster(n_osds=3) as c:
            cl = await c.client()
            await cl.create_pool("a", "replicated")
            await cl.create_pool("b", "replicated")
            io = cl.io_ctx("a")
            await io.write_full("o1", b"one")
            await io.write_full("o2", b"two")
            await io.setxattr("o1", "k", b"v")
            await io.omap_set("o2", {"mk": b"mv"})
            assert await in_thread(rados_cli.main, ["-m", c.mon.addr, "cppool", "a", "b"]) == 0
            assert "copied 2 object(s)" in capsys.readouterr().out
            dio = cl.io_ctx("b")
            assert await dio.read("o1") == b"one"
            assert await dio.getxattr("o1", "k") == b"v"
            assert (await dio.omap_get("o2"))["mk"] == b"mv"

    run(main())


# -- the same output from both packages' CLIs ---------------------------------

_ADDR = re.compile(r"127\.0\.0\.1:\d+")
BENCH_LINE = re.compile(r"^(write|seq): \d+ ops, \d+\.\d MB in \d+\.\d\ds = \d+\.\d\d MB/s, "
                        r"\d+\.\d ops/s$")


def _mask(text: str) -> str:
    text = _ADDR.sub("ADDR", text)
    return re.sub(r'"fsid": "[^"]*"', '"fsid": "FSID"', text)


def _outputs(P, capsys) -> list:
    """Build a cluster, drive each CLI command, keep what it printed."""
    async def main():
        out = []
        async with P.rados.MiniCluster(n_osds=4, crush_hosts=[[0, 1], [2, 3]], **P.kw) as c:
            mon = c.mon.addr
            cl = await c.client()
            await cl.create_pool("data", "replicated", size=3)
            await cl.create_pool("ecp", "erasure")
            io = cl.io_ctx("data")
            for name in ("alpha", "beta", "gamma", "delta"):
                await io.write_full(name, name.encode() * 10)
            await io.omap_set("alpha", {"k1": b"v1", "k2": b"\x00\x01"})
            await c.kill_osd(3)
            await c.wait_for_osd_down(3)
            capsys.readouterr()
            for fn, argv in (
                (P.ceph_cli.main, ["osd", "tree"]),
                (P.ceph_cli.main, ["osd", "dump"]),
                (P.rados_cli.main, ["lspools"]),
                (P.rados_cli.main, ["-p", "data", "ls"]),
                (P.rados_cli.main, ["-p", "data", "listomapvals", "alpha"]),
                (P.rados_cli.main, ["bench", "data", "1", "write", "--object-size", "4096"]),
                (P.rados_cli.main, ["bench", "data", "1", "seq"]),
            ):
                rc = await in_thread(fn, ["-m", mon, *argv])
                out.append((argv, rc, capsys.readouterr().out))
        return out

    return run(main())


def test_cli_output_equals_the_references(capsys):
    ref, port = _outputs(REF, capsys), _outputs(PORT, capsys)
    assert [(a, rc) for a, rc, _ in port] == [(a, rc) for a, rc, _ in ref]
    assert all(rc == 0 for _, rc, _ in port)
    for (argv, _, got), (_, _, want) in zip(port, ref):
        if argv[0] == "bench":
            for text in (got, want):
                lines = text.splitlines()
                assert len(lines) == 1 and BENCH_LINE.match(lines[0]), text
        else:
            assert _mask(got) == _mask(want), argv
    tree = port[0][2]
    assert "osd.3" in tree and "down" in tree
    dump = json.loads(port[1][2])
    assert {p["name"] for p in dump["pools"].values()} >= {"data", "ecp"}
    assert sorted(port[3][2].split()) == ["alpha", "beta", "delta", "gamma"]


RGW_ADMIN_STEPS = (
    (["user", "create", "--uid", "alice", "--display-name", "Alice A"], 0),
    (["user", "create", "--uid", "bob"], 0),
    (["user", "ls"], 0),
    (["user", "info", "--uid", "alice"], 0),
    (["user", "info", "--uid", "ghost"], 1),
    (["bucket", "ls"], 0),
    (["bucket", "ls", "--uid", "alice"], 0),
    (["bucket", "stats", "--bucket", "photos"], 0),
    (["quota", "set", "--bucket", "photos", "--max-objects", "10"], 0),
    (["quota", "set", "--bucket", "photos", "--max-size", "4096"], 0),
    (["quota", "get", "--bucket", "photos"], 0),
    (["quota", "get", "--bucket", "nosuch"], 1),
    (["user", "rm", "--uid", "alice"], 1),  # owns a bucket
    (["user", "rm", "--uid", "bob"], 0),
    (["user", "ls"], 0),
)


def _rgw_admin_outputs(P, capsys) -> list:
    """Each ``rgw_admin`` step against the package's own cluster, with a
    bucket of two objects made between the users and the buckets."""
    async def main():
        out = []
        async with P.rados.MiniCluster(n_osds=3, **P.kw) as c:
            mon = c.mon.addr
            capsys.readouterr()
            for argv, want_rc in RGW_ADMIN_STEPS:
                if argv == ["bucket", "ls"]:
                    s = await P.rgw.RGWStore.create(await c.client())
                    await s.create_bucket("photos", "alice")
                    await s.put_object("photos", "a", b"x" * 100)
                    await s.put_object("photos", "b", b"y" * 28)
                rc = await in_thread(P.rgw_admin.main, ["-m", mon, *argv])
                got = capsys.readouterr()
                assert rc == want_rc, (argv, got.err)
                out.append((argv, rc, got.out, got.err))
        return out

    with deterministic():
        return run(main())


def test_rgw_admin_output_equals_the_references(capsys):
    ref, port = _rgw_admin_outputs(REF, capsys), _rgw_admin_outputs(PORT, capsys)
    for got, want in zip(port, ref, strict=True):
        assert got == want, got[0]
    info = json.loads(port[3][2])
    assert info["uid"] == "alice" and info["display_name"] == "Alice A"
    assert json.loads(port[7][2])["num_objects"] == 2
    assert json.loads(port[10][2]) == {"max_objects": 10, "max_bytes": 4096}
    assert port[14][2].split() == ["alice"]


# -- the offline store tools, across the packages ----------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_objectstore_tool_reads_the_other_packages_store(writer, tmp_path, capsys):
    """A store written by one package's cluster, listed, dumped,
    exported, imported and trimmed by the other package's tool; both
    tools print the same listings and dump."""
    W, T = (REF, PORT) if writer == "ref" else (PORT, REF)

    async def build():
        async with W.rados.MiniCluster(n_osds=3, store_dir=str(tmp_path / "stores"),
                                       **W.kw) as c:
            cl = await c.client()
            await cl.create_pool("p", "replicated", size=3)
            io = cl.io_ctx("p")
            await io.write_full("alpha", b"alpha-data")
            await io.setxattr("alpha", "k", b"v")
            await io.omap_set("alpha", {"ok": b"ov"})
            await io.write_full("beta", b"beta-data")

    run(build())
    data_path = str(tmp_path / "stores" / "osd.0")

    def tool(P, *argv):
        capsys.readouterr()
        assert P.objectstore_tool.main(["--data-path", *argv]) == 0
        return capsys.readouterr().out

    pgs = tool(T, data_path, "--op", "list-pgs")
    assert pgs.split(), "no pgs found"
    listing = tool(T, data_path, "--op", "list")
    rows = [json.loads(line) for line in listing.splitlines()]
    assert {"alpha", "beta"} <= {r[1] for r in rows}
    pgid = next(r[0] for r in rows if r[1] == "alpha")
    dumped = tool(T, data_path, "--op", "dump", "--pgid", pgid, "--oid", "alpha")
    dump = json.loads(dumped)
    assert base64.b64decode(dump["data"]) == b"alpha-data"
    assert "u_k" in dump["attrs"] and "ok" in dump["omap"]
    # the writer's own tool prints the same
    assert tool(W, data_path, "--op", "list-pgs") == pgs
    assert tool(W, data_path, "--op", "list") == listing
    assert tool(W, data_path, "--op", "dump", "--pgid", pgid, "--oid", "alpha") == dumped

    exp = str(tmp_path / "pg.export")
    tool(T, data_path, "--op", "export", "--pgid", pgid, "--file", exp)
    dst = str(tmp_path / "fresh")
    s = T.WalStore(dst)
    s.mkfs()
    s.mount()
    s.umount()
    tool(T, dst, "--op", "import", "--file", exp)
    out = json.loads(tool(T, dst, "--op", "dump", "--pgid", pgid, "--oid", "alpha"))
    assert base64.b64decode(out["data"]) == b"alpha-data"
    tool(T, dst, "--op", "remove", "--pgid", pgid, "--oid", "alpha")
    assert "alpha" not in tool(T, dst, "--op", "list")
    assert "alpha" not in tool(W, dst, "--op", "list")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_monstore_tool_reads_the_other_packages_store(writer, tmp_path, capsys):
    W, T = (REF, PORT) if writer == "ref" else (PORT, REF)
    store = str(tmp_path / "mon")
    s = W.MonitorDBStore(store)
    s.save({"epoch": 1, "pools": {}}, election_epoch=3)
    s.save({"epoch": 2, "pools": {}}, election_epoch=3)
    s.close()
    outs = {}
    for P in (T, W):
        capsys.readouterr()
        got = []
        for argv, rc in (([store, "dump"], 0), ([store, "get-osdmap", "--version", "1"], 0),
                         ([store, "get-osdmap", "--version", "9"], 1)):
            assert P.monstore_tool.main(argv) == rc
            got.append(capsys.readouterr())
        outs[P.name] = got
    dump, osdmap, missing = outs[T.name]
    assert json.loads(dump.out)["last_committed"] == 2
    assert json.loads(dump.out)["versions"] == [1, 2]
    assert json.loads(osdmap.out)["epoch"] == 1
    assert "no osdmap version 9" in missing.err
    assert outs["port"] == outs["ref"]


# -- vstart ----------------------------------------------------------------------


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p))


def _start_vstart(*argv) -> tuple[subprocess.Popen, dict]:
    """``vstart`` in its own process, read until "ready" (60 s bound)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.vstart", *argv],
        env=_env(), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + 60
    buf = ""
    try:
        while time.monotonic() < deadline and "\nready" not in "\n" + buf:
            if not sel.select(timeout=1.0):
                continue
            chunk = os.read(proc.stdout.fileno(), 4096).decode()
            if not chunk:
                break
            buf += chunk
    finally:
        sel.close()
    lines = {}
    for line in buf.splitlines():
        if ":" in line:
            k, _, v = line.partition(":")
            lines[k.strip()] = v.strip()
    if "\nready" not in "\n" + buf:
        _stop_vstart(proc)
        raise AssertionError(f"vstart never became ready:\n{buf}")
    return proc, lines


def _stop_vstart(proc) -> None:
    proc.send_signal(signal.SIGINT)
    try:
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _cli(mod, mon, *args) -> str:
    r = subprocess.run(
        [sys.executable, "-m", f"ceph_tpu_torch.tools.{mod}", "-m", mon, *args],
        env=_env(), cwd=str(REPO), capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, (mod, args, r.stderr)
    return r.stdout


def _cli_here(capsys, fn, mon, *args) -> str:
    """A CLI's ``main`` in this process, against a cluster in another."""
    capsys.readouterr()
    assert fn(["-m", mon, *args]) == 0, capsys.readouterr().err
    return capsys.readouterr().out


def test_vstart_serves_clis(tmp_path, capsys):
    proc, lines = _start_vstart("--osds", "3", "--mgr", "--device", "cpu")
    try:
        mon = lines["mon"]
        _cli_here(capsys, rados_cli.main, mon, "mkpool", "p", "replicated")
        src = tmp_path / "f.bin"
        src.write_bytes(b"vstart!" * 100)
        _cli_here(capsys, rados_cli.main, mon, "-p", "p", "put", "obj", str(src))
        assert "obj" in _cli_here(capsys, rados_cli.main, mon, "-p", "p", "ls")
        status = _cli_here(capsys, ceph_cli.main, mon, "status")
        assert "3 up" in status and "mgr" in status
        # a journaled image and a one-way mirror through the CLI
        _cli_here(capsys, rados_cli.main, mon, "mkpool", "rbd1", "replicated")
        _cli_here(capsys, rados_cli.main, mon, "mkpool", "rbd2", "replicated")
        _cli_here(capsys, rbd_cli.main, mon, "-p", "rbd1", "create", "vol",
                  "--size", "1048576", "--journaling")
        img = tmp_path / "img.bin"
        img.write_bytes(b"M" * 65536)
        _cli_here(capsys, rbd_cli.main, mon, "-p", "rbd1", "import", str(img), "vol")
        out = _cli_here(capsys, rbd_cli.main, mon, "-p", "rbd1", "mirror", "bootstrap", "vol",
                        "--dest-pool", "rbd2")
        assert "bootstrapped" in out
        exp = tmp_path / "out.bin"
        _cli_here(capsys, rbd_cli.main, mon, "-p", "rbd2", "export", "vol", str(exp))
        assert exp.read_bytes()[:65536] == b"M" * 65536
    finally:
        _stop_vstart(proc)


def test_vstart_mds_serves_cephfs(tmp_path, capsys):
    """``vstart --mds`` prints the MDS's line and serves CephFS; the
    port's ``cephfs_cli`` (in its own process for the writes) and the
    reference's print the same listings, ``stat``, ``cat`` and ``statfs``."""
    proc, lines = _start_vstart("--osds", "3", "--mds", "--device", "cpu")
    try:
        mon = lines["mon"]
        assert re.fullmatch(r"mds\.1 @ 127\.0\.0\.1:\d+", lines["mds"]), lines
        src = tmp_path / "f.txt"
        src.write_bytes(b"served by vstart's mds\n" * 40)
        _cli("cephfs_cli", mon, "mkdir", "/docs")
        _cli("cephfs_cli", mon, "put", str(src), "/docs/f")
        outs = {}
        for who, fn in (("port", cephfs_cli.main), ("ref", ref_cephfs_cli.main)):
            outs[who] = [_cli_here(capsys, fn, mon, *a) for a in (
                ("ls", "/"), ("ls", "/docs"), ("stat", "/docs/f"), ("cat", "/docs/f"),
                ("statfs",))]
        assert outs["port"] == outs["ref"]
        assert outs["port"][1].split() == ["-", str(src.stat().st_size), "f"]
        assert outs["port"][3] == src.read_text()
    finally:
        _stop_vstart(proc)


def test_vstart_multiprocess_serves_clis(tmp_path, capsys):
    """``--multiprocess`` boots each daemon as its own process over the
    port's ``ProcCluster`` with the OSDs on ``--device``."""
    store = tmp_path / "stores"
    proc, lines = _start_vstart("--multiprocess", "--osds", "2", "--store-dir", str(store),
                                "--device", "cpu")
    try:
        mon = lines["mon"]
        assert {"osd.0", "osd.1"} <= set(lines)
        _cli_here(capsys, rados_cli.main, mon, "mkpool", "p", "replicated", "--size", "2")
        assert "p" in _cli_here(capsys, rados_cli.main, mon, "lspools").split()
        tree = _cli_here(capsys, ceph_cli.main, mon, "osd", "tree")
        assert all(f"osd.{i}" in tree for i in (0, 1)) and "down" not in tree
    finally:
        _stop_vstart(proc)
    logs = (store / "logs" / "osd.0.log").read_text()
    assert "osd.0 up at" in logs


def test_monmap_file_bootstraps_clis(tmp_path):
    monmap = str(tmp_path / "monmap.json")
    proc, _lines = _start_vstart("--osds", "3", "--mons", "3", "--write-monmap", monmap,
                                 "--device", "cpu")
    try:
        from ceph_tpu_torch.tools.monmaptool import load_monmap

        assert len(load_monmap(monmap)["mons"]) == 3
        _cli("rados_cli", monmap, "mkpool", "p", "replicated")
        assert "p" in _cli("rados_cli", monmap, "lspools").split()
    finally:
        _stop_vstart(proc)


@pytest.mark.parametrize("flag", ["--mds"])
def test_vstart_refuses_what_is_not_ported(flag, tmp_path):
    """What the reference's vstart refuses, the port's refuses: an MDS
    with ``--multiprocess``."""
    with pytest.raises(SystemExit, match=f"does not support {flag}"):
        vstart.main(["--multiprocess", "--osds", "1", "--device", "cpu", flag,
                     "--store-dir", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()


def test_vstart_rgw_serves_s3(tmp_path):
    """``vstart --rgw`` serves the gateway: a signed PUT and GET round-trip
    over HTTP with the ``admin`` user's keys, and ``rgw_admin user info``
    prints the same from the port's tool and the reference's.  With
    ``--multiprocess`` the gateway is refused, as the reference's is."""
    proc, lines = _start_vstart("--osds", "3", "--rgw", "--device", "cpu")
    try:
        mon = lines["mon"]
        url, _, access = lines["rgw"].partition("  ")
        addr = url.removeprefix("http://")
        infos = {}
        for tool in ("ceph_tpu_torch.tools.rgw_admin", "ceph_tpu.tools.rgw_admin"):
            r = subprocess.run([sys.executable, "-m", tool, "-m", mon, "user", "info", "--uid",
                                "admin"], env=_env(), cwd=str(REPO), capture_output=True,
                               text=True, timeout=60)
            assert r.returncode == 0, (tool, r.stderr)
            infos[tool] = r.stdout
        assert infos["ceph_tpu_torch.tools.rgw_admin"] == infos["ceph_tpu.tools.rgw_admin"]
        user = json.loads(infos["ceph_tpu.tools.rgw_admin"])
        assert access == f"(AWS {user['access_key']}:...)"

        async def s3():
            body = b"served by vstart" * 64
            assert (await rgw_http(RGW_PORT, addr, "PUT", "/vb", creds=user))[0] == 200
            st, h, _ = await rgw_http(RGW_PORT, addr, "PUT", "/vb/o", body=body, creds=user)
            assert st == 200 and h["etag"] == hashlib.md5(body).hexdigest()
            st, _, got = await rgw_http(RGW_PORT, addr, "GET", "/vb/o", creds=user)
            assert st == 200 and got == body
            assert (await rgw_http(RGW_PORT, addr, "GET", "/vb/o"))[0] == 403

        run(s3())
    finally:
        _stop_vstart(proc)
    with pytest.raises(SystemExit, match="does not support --rgw"):
        vstart.main(["--multiprocess", "--rgw", "--osds", "1", "--device", "cpu",
                     "--store-dir", str(tmp_path / "s")])


def test_vstart_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(DeviceUnavailableError):
        vstart.main(["--osds", "1"])
    with pytest.raises(DeviceUnavailableError):
        vstart.main(["--multiprocess", "--osds", "1", "--store-dir", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()
