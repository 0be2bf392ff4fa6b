"""The port's ``ProcCluster`` held to the reference's multi-process
cases, on the CPU.

The four cases of ``tests/test_multiprocess.py`` run on the port's
``ProcCluster(..., device="cpu")``: every mon and OSD its own
``python -m ceph_tpu_torch.tools.daemon`` process, OSDs SIGKILLed under
load and remounted from their stores on disk.  The reference's slow
storm case runs here as slow too, and plans its churn on the CPU.
Besides:

- ``ProcCluster()`` without a device raises at construction when CUDA is
  absent;
- a daemon that dies at start fails ``wait_healthy`` at once, with the
  tail of its log;
- every OSD child runs the port's daemon with ``--device cpu`` (its
  argv; ``tests/test_torch_isolation.py`` shows the children import
  nothing of ``jax`` or ``ceph_tpu``);
- the port's ``RadosClient`` serves IO against the reference's
  ``ProcCluster``;
- four faults of the reference's OSD that a loaded cluster of processes
  shows, each case run on both packages' ``MiniCluster``: an OSD whose
  map lags its client's (a pool created a moment ago) waits for the
  newer map instead of answering ``-ENOENT`` (the reference's answer
  made its first write after ``create_pool`` fail now and then); a
  rebooted OSD is not failed for its last life's silence; a stalled
  event loop reports no peer; a running OSD marked down boots again.

To keep the cases steady under a loaded host: at most 4 OSD processes
a cluster, a 2 s heartbeat, 120 s for the cluster to come up, every
body under ``asyncio.timeout`` and every child waited on with a bound
(``ProcCluster.stop``).  Each cluster logs under ``tmp_path``; a failed
start prints every daemon's log tail.
"""

import asyncio
import contextlib
import os
import pathlib
import random
import re

import pytest
import torch

from ceph_tpu_torch.device import DeviceUnavailableError
from ceph_tpu_torch.rados import MiniCluster, ProcCluster, RadosClient

LIMIT_S = 240.0
HEALTHY_S = 120.0
UP_S = 120.0


def run(coro, limit=LIMIT_S):
    async def bounded():
        async with asyncio.timeout(limit):
            return await coro
    return asyncio.run(bounded())


def _log_tails(log_dir: pathlib.Path) -> str:
    out = []
    for p in sorted(log_dir.glob("*.log")):
        out.append(f"--- {p.name}\n{p.read_bytes()[-2000:].decode(errors='replace')}")
    return "\n".join(out)


@contextlib.asynccontextmanager
async def proc_cluster(tmp_path, n_osds=3, cls=ProcCluster, **kw):
    """A started cluster under ``tmp_path`` (stores in ``c``, logs in
    ``logs``), stopped on the way out."""
    log_dir = tmp_path / "logs"
    if cls is ProcCluster:
        kw.setdefault("device", "cpu")
    pc = cls(str(tmp_path / "c"), n_osds=n_osds, heartbeat_interval=2.0,
             log_dir=str(log_dir), **kw)
    try:
        try:
            await (pc.start(timeout=HEALTHY_S) if cls is ProcCluster
                   else _start_reference(pc))
        except BaseException:
            print(_log_tails(log_dir))
            raise
        yield pc
    finally:
        await pc.stop()


async def _start_reference(pc) -> None:
    """The reference's ``start`` with this file's wait for health."""
    os.makedirs(pc.store_dir, exist_ok=True)
    for r in range(pc.n_mons):
        pc.spawn_mon(r)
    for i in range(pc.n_osds):
        pc.spawn_osd(i)
    await pc.wait_healthy(HEALTHY_S)


async def read_retry(io, name, tries=8):
    for t in range(tries):
        try:
            return await io.read(name)
        except Exception:
            if t == tries - 1:
                raise
            await asyncio.sleep(1.0)


class TestProcCluster:
    def test_boot_io_and_teardown(self, tmp_path):
        """IO through three OSD processes of the port's daemon."""

        async def main():
            async with proc_cluster(tmp_path) as pc:
                cl = await pc.client()
                await cl.create_pool("p", "replicated", size=3)
                io = cl.io_ctx("p")
                await io.write_full("hello", b"from another process")
                assert await io.read("hello") == b"from another process"
                pids = {p.pid for p in pc.osd_procs.values()}
                assert len(pids) == 3
                for i, proc in pc.osd_procs.items():
                    argv = proc.args
                    assert argv[1:6] == ["-m", "ceph_tpu_torch.tools.daemon", "osd", "--id", str(i)]
                    assert argv[argv.index("--device") + 1] == "cpu"

        run(main())

    def test_sigkill_thrash_ec_with_remount(self, tmp_path):
        """The kill -9 thrash loop: an EC pool keeps serving writes while
        OSD processes are SIGKILLed and remounted from their on-disk
        stores; every object byte-verifies at the end."""

        async def main():
            async with proc_cluster(tmp_path, n_osds=4) as pc:
                cl = await pc.client()
                await cl.create_pool("ec", "erasure")  # default k2m1
                io = cl.io_ctx("ec")
                model: dict[str, bytes] = {}
                rng = random.Random(7)

                async def put(i, r):
                    payload = bytes([r * 37 % 256]) * (500 + 31 * i)
                    await io.write_full(f"obj{i}", payload)
                    model[f"obj{i}"] = payload

                async def put_retry(i, r, tries=6):
                    for t in range(tries):
                        try:
                            return await put(i, r)
                        except Exception:
                            if t == tries - 1:
                                raise
                            await asyncio.sleep(1.0)

                for i in range(12):
                    await put(i, 0)

                for rnd in range(1, 3):
                    victim = rng.randrange(4)
                    writers = [asyncio.ensure_future(put(i, rnd)) for i in range(12)]
                    await asyncio.sleep(0.05)
                    pc.kill9_osd(victim)
                    await pc.wait_osd_state(cl, victim, up=False, timeout=UP_S)
                    results = await asyncio.gather(*writers, return_exceptions=True)
                    for i, res in enumerate(results):
                        if isinstance(res, Exception):
                            await put_retry(i, rnd)
                    assert await read_retry(io, "obj0") == model["obj0"]
                    await pc.restart_osd(victim)
                    await pc.wait_osd_state(cl, victim, up=True, timeout=UP_S)

                await asyncio.sleep(1.0)
                for name, want in model.items():
                    got = await read_retry(io, name)
                    assert got == want, f"{name}: {len(got)} bytes != {len(want)}"

        run(main())

    def test_kill9_mid_ec_write_storm_no_acked_loss(self, tmp_path):
        """A storm of concurrent EC writes is in flight when an OSD is
        kill -9'd.  After restart: every write that ACKED reads back
        byte-identical; an un-acked one reads as some complete
        version, never a torn mix."""

        async def main():
            async with proc_cluster(tmp_path, n_osds=4) as pc:
                cl = await pc.client()
                await cl.create_pool("ec", "erasure")  # default k2m1
                io = cl.io_ctx("ec")
                acked: dict[str, bytes] = {}
                versions: dict[str, list[bytes]] = {}

                def payload(i, r):
                    return bytes([(r * 41 + i) % 256]) * (700 + 53 * i)

                for i in range(10):
                    await io.write_full(f"s{i}", payload(i, 0))
                    acked[f"s{i}"] = payload(i, 0)
                    versions[f"s{i}"] = [payload(i, 0)]

                async def storm_put(i, r):
                    data = payload(i, r)
                    versions[f"s{i}"].append(data)
                    await io.write_full(f"s{i}", data)
                    acked[f"s{i}"] = data

                writers = [asyncio.ensure_future(storm_put(i, 1)) for i in range(10)]
                await asyncio.sleep(0.03)  # mid-flight, not drained
                pc.kill9_osd(0)
                await pc.wait_osd_state(cl, 0, up=False, timeout=UP_S)
                results = await asyncio.gather(*writers, return_exceptions=True)
                await pc.restart_osd(0)
                await pc.wait_osd_state(cl, 0, up=True, timeout=UP_S)
                await asyncio.sleep(1.5)  # peering + recovery settle

                failed = [i for i, r in enumerate(results) if isinstance(r, Exception)]
                for i in range(10):
                    got = await read_retry(io, f"s{i}")
                    if i in failed:
                        assert got in versions[f"s{i}"], f"s{i}: torn ({len(got)} bytes)"
                    else:
                        assert got == acked[f"s{i}"], f"s{i}: ACKED write lost"
                for i in range(10):
                    assert await read_retry(io, f"s{i}") in versions[f"s{i}"]

        run(main())

    def test_sigkilled_store_remounts_from_disk_alone(self, tmp_path):
        """Write, SIGKILL every OSD (no umount, no checkpoint), restart:
        the data comes back from journal replay in fresh processes."""

        async def main():
            async with proc_cluster(tmp_path) as pc:
                cl = await pc.client()
                await cl.create_pool("p", "replicated", size=3)
                io = cl.io_ctx("p")
                for i in range(8):
                    await io.write_full(f"k{i}", bytes([i]) * 2000)
                for i in range(3):
                    pc.kill9_osd(i)
                for i in range(3):
                    await pc.restart_osd(i)
                await pc.wait_healthy(HEALTHY_S)
                for i in range(8):
                    assert await io.read(f"k{i}") == bytes([i]) * 2000

        run(main())


def test_without_cuda_the_default_raises_at_construction(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(DeviceUnavailableError):
        ProcCluster(str(tmp_path / "c"))
    with pytest.raises(DeviceUnavailableError):
        ProcCluster(str(tmp_path / "c"), device="cuda")
    assert not (tmp_path / "c").exists()
    pc = ProcCluster(str(tmp_path / "c"), n_osds=2, device="cpu")
    assert pc.device.type == "cpu" and not pc.osd_procs


def test_a_daemon_that_dies_at_start_fails_wait_healthy_at_once(tmp_path):
    """An option the table does not know ends every OSD process at
    boot; ``wait_healthy`` names the first it finds gone and quotes its
    log, long before its timeout."""

    async def main():
        pc = ProcCluster(str(tmp_path / "c"), n_osds=2, log_dir=str(tmp_path / "logs"),
                         osd_config={"no_such_option": 1}, device="cpu")
        t0 = asyncio.get_running_loop().time()
        try:
            with pytest.raises(RuntimeError) as e:
                await pc.start(timeout=HEALTHY_S)
        finally:
            await pc.stop()
        return str(e.value), asyncio.get_running_loop().time() - t0

    text, took = run(main())
    assert re.search(r"osd\.[01] exited with code 1", text), text
    assert "the tail of its log" in text and "no_such_option" in text, text
    assert took < HEALTHY_S / 2


def test_port_client_against_the_reference_proc_cluster(tmp_path):
    """The reference's daemons in their processes, the port's client in
    this one: the frames cross, the IO round-trips."""
    from ceph_tpu.rados.proc_cluster import ProcCluster as RefProcCluster

    async def main():
        async with proc_cluster(tmp_path, cls=RefProcCluster) as pc:
            cl = await RadosClient(pc.monmap).connect()
            try:
                await cl.create_pool("ec", "erasure")
                io = cl.io_ctx("ec")
                data = bytes(range(256)) * 40
                await io.write_full("x", data)
                assert await read_retry(io, "x") == data
                assert "x" in await cl.list_objects("ec")
            finally:
                await cl.shutdown()

    run(main())


@pytest.mark.parametrize("package", ["port", "reference"])
def test_an_osd_whose_map_lags_waits_for_the_clients_epoch(package):
    """The primary's map lacks a pool its client already sees (the map
    push is held back).  The port's OSD waits for that epoch and serves
    the write; the reference's answers -ENOENT."""
    if package == "port":
        cluster_cls, kw = MiniCluster, {"device": "cpu"}
    else:
        from ceph_tpu.rados import MiniCluster as cluster_cls
        kw = {}

    async def main():
        async with cluster_cls(n_osds=1, **kw) as cluster:
            osd = cluster.osds[0]
            handle = osd._handle_map

            def late(msg, conn=None):
                asyncio.get_running_loop().call_later(0.5, handle, msg, conn)

            osd._handle_map = late
            cl = await cluster.client()
            await cl.create_pool("p", "replicated", size=1, pg_num=1)
            assert cl.osdmap.epoch > osd.osdmap.epoch
            io = cl.io_ctx("p")
            try:
                await io.write_full("o", b"x")
            except Exception as e:
                return getattr(e, "code", e)
            return await io.read("o")

    got = run(main(), limit=60)
    assert got == (b"x" if package == "port" else -2)


@pytest.mark.slow
class TestProcClusterStorm:
    def test_proc_cluster_sigkill_storm(self, tmp_path):
        """The matrix's single-kill shape on the port's multi-process
        cluster: SIGKILL of an OSD process under client load, restart
        through journal replay, the same invariants over the wire, and
        the churn planned on the CPU from the client's maps equal to
        the live remap."""
        from ceph_tpu_torch.rados import ClientLoad, StormDriver

        async def main():
            async with proc_cluster(tmp_path) as pc:
                cl = await pc.client()
                await cl.create_pool("rep", "replicated", size=3)
                load = ClientLoad(cl.io_ctx("rep"), prefix="pk", objects=8,
                                  size=2048, pause=0.01)
                load.start(writers=2)
                driver = StormDriver(pc, cl, ["rep"], clean_timeout=150)
                await asyncio.sleep(0.5)
                pre = driver.snapshot_map()
                pc.kill9_osd(2)
                await pc.wait_osd_state(cl, 2, up=False, timeout=UP_S)
                churn = driver.plan_between(pre, driver.snapshot_map())
                await asyncio.sleep(0.5)  # degraded-window writes
                await pc.restart_osd(2)
                await pc.wait_osd_state(cl, 2, up=True, timeout=UP_S)
                result = await driver.check_invariants(load)
                assert result["ops_acked"] > 0
                assert result["pgs_scrubbed"] > 0
                assert churn["predicted"] == churn["actual"] and churn["predicted"]

        run(main())


# -- the slice on the card: chip_smoke phase 15 rehearsed on the CPU ----------

PHASE15_OBJECT = 16 << 10


def test_phase15_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.run_storm`` and ``run_proc_cluster`` on the CPU at
    16 KiB objects and 4 OSDs: the storm's two scenarios on an
    in-process cluster of 4 with pools A and B cut to isa k=2 m=2 and
    cauchy_good k=2 m=2, their dispatchers on the batching lane with the
    plain kernels (and the plain straw2 draw) counting as launches here;
    then 4 OSD processes (``--device cpu``) through the kill, the
    restart, ``rados bench`` for 1 s and the ``ceph`` CLI.  Left out, as
    they need the card: the OSD processes naming a CUDA device in their
    admin sockets, the trace window on one of them, and their device-lane
    batches (a CPU codec in those processes takes the native C lane)."""
    import numpy as np

    import chip_smoke
    import ceph_tpu_torch.utils.native as port_native
    from ceph_tpu_torch.ops import crush_torch, gf_cuda, gf_torch

    monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)

    def counting(name, plain):
        def counted(*a, **kw):
            with gf_cuda._LAUNCHES_LOCK:
                gf_cuda.launches[name] += 1
            return plain(*a, **kw)
        return counted

    for name, fn in (("gf_matmul", "gf_matmul_u32"), ("bitmatrix_xor", "bitmatrix_matmul_u32")):
        monkeypatch.setattr(gf_torch, fn, counting(name, getattr(gf_torch, fn)))
    monkeypatch.setattr(crush_torch, "straw2", counting("crush_straw2", crush_torch.straw2_plain))
    pools = {
        "a": ({"plugin": "isa", "k": "2", "m": "2"}, 4096),
        "b": ({"plugin": "jerasure", "technique": "cauchy_good", "k": "2", "m": "2",
               "packetsize": "4096"}, 32768),
    }
    for attr, value in (("STORM_OSDS", 4), ("STORM_POOLS", pools),
                        ("STORM_PG_NUM", {"a": 4, "b": 2}), ("STORM_OBJECT_SIZE", PHASE15_OBJECT),
                        ("PROC_OSDS", 4), ("PROC_OBJECTS", 16), ("PROC_STORM_OBJECTS", 4),
                        ("PROC_BENCH_S", 1), ("STORM_PHASE_LIMIT_S", 120.0)):
        monkeypatch.setattr(chip_smoke, attr, value)
    cpu = torch.device("cpu")
    args = os.environ.get("CEPH_TPU_ARGS")
    storm = chip_smoke.run_storm(cpu, np.random.default_rng(15), root=str(tmp_path / "a"))
    assert all(storm[name] > 0 for name in gf_cuda.SOURCES), storm
    proc = chip_smoke.run_proc_cluster(cpu, np.random.default_rng(15), root=str(tmp_path / "b"))
    assert proc == {name: 0 for name in gf_cuda.SOURCES}
    assert os.environ.get("CEPH_TPU_ARGS") == args  # the sockets' option is put back


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_rebooted_osd_is_not_failed_by_its_last_lives_silence(package):
    """osd.2 is killed, marked down and left down past the heartbeat
    grace, then restarted.  The port's peers drop a down peer's last
    reply time, so the new incarnation gets a whole grace; the
    reference's peers find its old silence on their first ping round and
    report it, and the mon marks the new osd.2 down within a second of
    its boot."""
    if package == "port":
        cluster_cls, kw = MiniCluster, {"device": "cpu"}
    else:
        from ceph_tpu.rados import MiniCluster as cluster_cls
        kw = {}

    async def main():
        async with cluster_cls(n_osds=3, heartbeat_interval=0.2, **kw) as cluster:
            for osd in cluster.osds.values():
                osd.heartbeat_grace = 1.0
            await asyncio.sleep(0.6)  # a few ping rounds
            await cluster.kill_osd(2, crash=True)
            await cluster.wait_for_osd_down(2)
            await asyncio.sleep(1.5)  # past the grace
            await cluster.restart_osd(2)
            cluster.osds[2].heartbeat_grace = 1.0
            await cluster.wait_for_osd_up(2)
            await asyncio.sleep(0.8)  # the peers' next rounds, within a grace
            return cluster.mon.osdmap.is_up(2)

    assert run(main(), limit=60) is (package == "port")


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_stalled_loop_reports_no_peer(package):
    """The event loop of a 3-OSD cluster blocks for three heartbeat
    graces.  The port's OSDs see their own loop ran late and judge no
    peer that round, so every OSD stays up; the reference's read the
    stall as their peers' silence and report them."""
    import time as _time

    if package == "port":
        cluster_cls, kw = MiniCluster, {"device": "cpu"}
    else:
        from ceph_tpu.rados import MiniCluster as cluster_cls
        kw = {}

    async def main():
        async with cluster_cls(n_osds=3, heartbeat_interval=0.2, **kw) as cluster:
            for osd in cluster.osds.values():
                osd.heartbeat_grace = 0.5
            await asyncio.sleep(0.6)  # a few ping rounds
            _time.sleep(1.5)  # the whole loop stalls
            await asyncio.sleep(0.3)
            return [cluster.mon.osdmap.is_up(i) for i in range(3)]

    got = run(main(), limit=60)
    assert all(got) if package == "port" else not all(got), got


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_running_osd_marked_down_boots_again(package):
    """``osd down 1`` marks a running OSD down: the port's OSD sees the
    map and announces itself again, so it is up within a second; the
    reference's stays down."""
    if package == "port":
        cluster_cls, kw = MiniCluster, {"device": "cpu"}
    else:
        from ceph_tpu.rados import MiniCluster as cluster_cls
        kw = {}

    async def main():
        async with cluster_cls(n_osds=3, **kw) as cluster:
            cl = await cluster.client()
            code, status, _ = await cl.command({"prefix": "osd down", "id": 1})
            assert code == 0, status
            await cluster.wait_for_osd_down(1)
            try:
                await cluster.wait_for_osd_up(1, timeout=1.0)
            except TimeoutError:
                return False
            return True

    assert run(main(), limit=60) is (package == "port")
