"""The port's OSD, RADOS client and MiniCluster held against the
reference's, on the CPU.

Each case of ``tests/test_rados_e2e.py`` runs twice: once on the
reference's ``MiniCluster`` and once on the port's
(``MiniCluster(device="cpu")``), the same scenario with the same
payloads.  Both runs must give the same read results and leave the same
state in every OSD's store: each object's bytes on each shard, its
``StripeHashes`` crc table and object info (exact equality of the
xattr bytes), and each PG shard's log (op, oid, version).  One case
runs with the port's ``native.host_engine_active`` patched to False,
so that the OSDs' dispatchers take the batching lane with the plain
versions of the kernels (the lane a CUDA codec takes on the card).
Clients and clusters of the two packages also cross: the port's client
against the reference's cluster, and the reference's client against the
port's.

The port's refusals are checked here too: ``osd_ec_mesh`` (ROADMAP
Queue A item 8) and ``start_mds`` (item 11c), each raising an error that
names its item.  A client op's trace id and client reach the port OSD's
dispatcher flight record.

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import json
import os
import signal
import sys
import types

import numpy as np
import pytest

import ceph_tpu.rados as ref_rados
import ceph_tpu.store as ref_store
from ceph_tpu.osd import pg_log as ref_pg_log
from ceph_tpu.osd.ec_util import StripeHashes as RefStripeHashes

import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.store as port_store
import ceph_tpu_torch.utils.native as port_native
from ceph_tpu_torch.common import tracing as port_tracing
from ceph_tpu_torch.osd import pg_log as port_pg_log
from ceph_tpu_torch.osd.ec_util import StripeHashes as PortStripeHashes

LIMIT_S = 30.0
PAYLOAD = bytes(range(256)) * 64  # 16 KiB, non-trivial content
OI_KEY = "_"

REF = types.SimpleNamespace(
    name="ref", rados=ref_rados, store=ref_store, pg_log=ref_pg_log,
    StripeHashes=RefStripeHashes, kw={},
)
PORT = types.SimpleNamespace(
    name="port", rados=port_rados, store=port_store, pg_log=port_pg_log,
    StripeHashes=PortStripeHashes, kw={"device": "cpu"},
)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def store_state(P, cluster) -> dict:
    """Every head object in every OSD's store: its bytes, its crc table,
    its object info and its user xattrs, and every PG shard's log as
    (op, oid, version).  Rollback stashes, the PG meta object's other
    keys (peering info, past intervals) and clones are left out: their
    trimming runs in the background."""
    state = {}
    for osd, store in enumerate(cluster.stores):
        down = osd not in cluster.osds  # killed: its store is unmounted
        if down:
            store.mount()
        try:
            state.update(_one_store_state(P, osd, store))
        finally:
            if down:
                store.umount()
    return state


def _one_store_state(P, osd, store) -> dict:
    state = {}
    for cid in store.list_collections():
        _base, _, s = cid.pg.partition("s")
        shard = int(s) if s else -1
        log = P.pg_log.read_log(store, cid, shard)
        if log:
            state[(osd, cid.pg, "log")] = [
                (e.op, e.oid, e.version.to_list()) for e in log
            ]
        for oid in store.list_objects(cid):
            if oid.name == "_pgmeta_" or P.pg_log.is_stash_name(oid.name):
                continue
            attrs = store.getattrs(cid, oid)
            state[(osd, cid.pg, oid.name)] = {
                "data": bytes(store.read(cid, oid)),
                "attrs": {k: bytes(v) for k, v in attrs.items()},
            }
    return state


def twin(scenario, **cluster_kw):
    """Run ``scenario(P, cluster, rec)`` on the reference's cluster and
    on the port's; the scenario appends what it reads to ``rec``.
    Returns both records after holding them equal, reads and stores."""
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            rec = []
            async with P.rados.MiniCluster(**cluster_kw, **P.kw) as cluster:
                await scenario(P, cluster, rec)
                rec.append(("stores", store_state(P, cluster)))
            return rec
        out[P.name] = run(main())
    ref, port = out["ref"], out["port"]
    assert [k for k, _ in port] == [k for k, _ in ref]
    for (what, got), (_, want) in zip(port, ref):
        if what == "stores":
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key] == want[key], key
        else:
            assert got == want, what
    return ref, port


async def read_or_errno(io, oid, **kw):
    try:
        return await io.read(oid, **kw)
    except Exception as e:  # the errno is the result being compared
        return getattr(e, "code", type(e).__name__)


async def acting_of(cl, pool, oid):
    p = cl.osdmap.lookup_pool(pool)
    return cl.osdmap.object_to_acting(oid, p.id)


# -- replicated pools --------------------------------------------------------


def test_replicated_put_get_stat_delete():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("rbd", "replicated", size=3)
        io = cl.io_ctx("rbd")
        await io.write_full("obj1", PAYLOAD)
        rec.append(("read", await io.read("obj1")))
        rec.append(("stat", await io.stat("obj1")))
        rec.append(("partial", await io.read("obj1", offset=256, length=16)))
        await io.write("obj1", b"XYZ", offset=0)
        rec.append(("overwritten", await io.read("obj1")))
        assert rec[-1][1][:4] == b"XYZ" + PAYLOAD[3:4]
        await io.remove("obj1")
        with pytest.raises(P.rados.RadosError):
            await io.read("obj1")

    twin(scenario, n_osds=3)


def test_replicated_data_on_all_replicas():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("rep", "replicated", size=3)
        io = cl.io_ctx("rep")
        await io.write_full("o", b"payload")
        pg, acting, _primary = await acting_of(cl, "rep", "o")
        cid = P.store.CollectionId(str(pg))
        for osd in acting:
            assert cluster.stores[osd].read(cid, P.store.ObjectId("o")) == b"payload"
        rec.append(("acting", acting))

    twin(scenario, n_osds=3)


# -- EC pools -----------------------------------------------------------------


def test_ec_put_get_roundtrip_default_profile():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")  # k=2 m=1 default
        io = cl.io_ctx("ecpool")
        for oid, data in (("obj", PAYLOAD), ("odd", PAYLOAD[:5000]), ("tiny", b"x")):
            await io.write_full(oid, data)
            got = await io.read(oid)
            assert got == data
            rec.append((oid, got))
            rec.append((oid + " stat", await io.stat(oid)))

    twin(scenario, n_osds=4)


def test_ec_chunks_land_on_positional_shards():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        pg, acting, _primary = await acting_of(cl, "ecpool", "obj")
        assert len(acting) == 3
        for shard, osd in enumerate(acting):
            store = cluster.stores[osd]
            cid = P.store.CollectionId(f"{pg}s{shard}")
            soid = P.store.ObjectId("obj", shard)
            chunk = store.read(cid, soid)
            hashes = P.StripeHashes.from_dict(
                json.loads(store.getattr(cid, soid, P.StripeHashes.XATTR_KEY)))
            assert hashes.verify(shard, 0, np.frombuffer(chunk, dtype=np.uint8))
            entries = P.pg_log.read_log(store, cid, shard)
            assert [(e.op, e.oid) for e in entries] == [("modify", "obj")]
        rec.append(("acting", acting))

    twin(scenario, n_osds=4)


def test_ec_degraded_read_after_shard_kill():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        _pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        got = await io.read("obj")
        assert got == PAYLOAD  # reconstructed
        rec.append(("degraded", got))

    twin(scenario, n_osds=4)


def test_ec_primary_failover():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        _pg, _acting, primary = await acting_of(cl, "ecpool", "obj")
        await cluster.kill_osd(primary)
        await cluster.wait_for_osd_down(primary)
        rec.append(("read", await io.read("obj")))
        await io.write_full("obj2", PAYLOAD[:1000])
        rec.append(("read2", await io.read("obj2")))
        assert rec[-2][1] == PAYLOAD and rec[-1][1] == PAYLOAD[:1000]

    twin(scenario, n_osds=4)


async def _k4m2_two_failures(P, cluster, rec):
    cl = await cluster.client()
    code, status, _ = await cl.command({
        "prefix": "osd erasure-code-profile set", "name": "rs42",
        "profile": {"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "4", "m": "2"},
    })
    assert code == 0, status
    await cl.create_pool("ec42", "erasure", erasure_code_profile="rs42")
    io = cl.io_ctx("ec42")
    big = bytes(range(256)) * 1024  # 256 KiB
    await io.write_full("big", big)
    _pg, acting, primary = await acting_of(cl, "ec42", "big")
    for v in [o for o in acting if o != primary][:2]:
        await cluster.kill_osd(v)
        await cluster.wait_for_osd_down(v)
    got = await io.read("big")
    assert got == big  # 2-erasure reconstruct
    rec.append(("two erasures", got))


def test_ec_k4m2_two_failures():
    twin(_k4m2_two_failures, n_osds=8)


def test_ec_k4m2_two_failures_on_the_batching_lane(monkeypatch):
    """The port's OSDs with the host engine's gate off: every encode and
    decode takes the dispatcher's batching lane with the plain versions
    of the kernels (the card's lane), none the native C lane."""
    monkeypatch.setattr(port_native, "host_engine_active",
                        lambda device=None: False)
    lanes = []

    async def scenario(P, cluster, rec):
        await _k4m2_two_failures(P, cluster, rec)
        if P is PORT:
            for osd in cluster.osds.values():
                lanes.append(osd.ec_dispatch.dump()["totals"])

    twin(scenario, n_osds=8)
    assert sum(t["native_direct"] for t in lanes) == 0
    assert sum(t["lanes"]["device"]["batches"] for t in lanes) > 0
    assert sum(t["failovers"] + t["fallback_direct"] for t in lanes) == 0


def test_ec_write_refused_below_min_size():
    async def scenario(P, cluster, rec):
        cl = await cluster.client(op_timeout=2.0, max_retries=2)
        await cl.create_pool("ecpool", "erasure")  # k=2 m=1, min_size=2
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", b"data")
        _pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        for o in acting:
            if o != primary:
                await cluster.kill_osd(o)
                await cluster.wait_for_osd_down(o)
        with pytest.raises(P.rados.RadosError):
            await io.write_full("obj2", b"nope")

    twin(scenario, n_osds=3)


def test_ec_object_not_found_and_delete_all_shards():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        rec.append(("ghost", await read_or_errno(io, "ghost")))
        assert rec[-1][1] == -2  # ENOENT
        await io.write_full("obj", PAYLOAD)
        await io.remove("obj")
        rec.append(("removed", await read_or_errno(io, "obj")))
        pg, acting, _primary = await acting_of(cl, "ecpool", "obj")
        for shard, osd in enumerate(acting):
            assert not cluster.stores[osd].exists(
                P.store.CollectionId(f"{pg}s{shard}"), P.store.ObjectId("obj", shard))

    twin(scenario, n_osds=4)


def test_ec_corrupt_chunk_detected_and_reconstructed():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        pg, acting, _primary = await acting_of(cl, "ecpool", "obj")
        cluster.stores[acting[0]].apply(P.store.Transaction().write(
            P.store.CollectionId(f"{pg}s0"), P.store.ObjectId("obj", 0), 0,
            b"\xff" * 64))
        got = await io.read("obj")
        assert got == PAYLOAD
        rec.append(("read", got))

    twin(scenario, n_osds=4)


def test_ec_corrupt_remote_chunk_detected():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        shard, osd = next((s, o) for s, o in enumerate(acting) if o != primary)
        cluster.stores[osd].apply(P.store.Transaction().write(
            P.store.CollectionId(f"{pg}s{shard}"), P.store.ObjectId("obj", shard),
            0, b"\xff" * 64))
        got = await io.read("obj")
        assert got == PAYLOAD
        rec.append(("read", got))

    twin(scenario, n_osds=4)


def test_ec_stale_shard_rejected_after_degraded_overwrite():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        v1, v2 = bytes([1]) * 8192, bytes([2]) * 8192
        await io.write_full("obj", v1)
        pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        await io.write_full("obj", v2)  # degraded: victim missed this
        await cluster.restart_osd(victim)
        await cluster.wait_for_osd_up(victim)
        got = await io.read("obj")
        assert got == v2, "stale chunk leaked into decode"
        rec.append(("read", got))
        rec.append(("stat", await io.stat("obj")))
        # the rejoined shard is backfilled to v2: settle before the stores
        # are compared
        await wait_shard_version(P, cluster, pg, acting.index(victim), victim,
                                 "obj", shard_version(P, cluster.stores[primary],
                                                      pg, acting.index(primary), "obj"))

    twin(scenario, n_osds=4)


def test_ec_delete_propagates_shard_failure():
    async def scenario(P, cluster, rec):
        cl = await cluster.client(op_timeout=3.0, max_retries=1)
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        _pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        store = cluster.stores[next(o for o in acting if o != primary)]
        orig_apply = store.apply

        def broken_apply(txn):
            raise OSError("injected store failure")

        store.apply = broken_apply
        try:
            with pytest.raises(P.rados.RadosError):
                await io.remove("obj")
        finally:
            store.apply = orig_apply

    twin(scenario, n_osds=4)


def test_many_objects_spread_over_pgs():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure", pg_num=16)
        io = cl.io_ctx("ecpool")
        objs = {f"obj-{i}": bytes([i % 256]) * (100 + 37 * i) for i in range(40)}
        # one after another: each PG's versions then follow the object
        # order in both runs (concurrent writes commit in arrival order)
        for k, v in objs.items():
            await io.write_full(k, v)
        reads = await asyncio.gather(*(io.read(k) for k in objs))
        assert all(got == objs[k] for k, got in zip(objs, reads))
        pool = cl.osdmap.lookup_pool("ecpool")
        assert len({str(cl.osdmap.object_locator_to_pg(k, pool.id)) for k in objs}) > 4
        rec.append(("reads", reads))

    twin(scenario, n_osds=4)


def test_osd_restart_serves_old_data():
    async def scenario(P, cluster, rec):
        cl = await cluster.client()
        await cl.create_pool("ecpool", "erasure")
        io = cl.io_ctx("ecpool")
        await io.write_full("obj", PAYLOAD)
        _pg, acting, primary = await acting_of(cl, "ecpool", "obj")
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.wait_for_osd_down(victim)
        await cluster.restart_osd(victim)
        await cluster.wait_for_osd_up(victim)
        got = await io.read("obj")
        assert got == PAYLOAD
        rec.append(("read", got))

    twin(scenario, n_osds=4)


# -- the recovery helpers shared with test_torch_recovery.py ------------------


def shard_version(P, store, pg, shard, oid):
    """The object info's version of one stored chunk, or None."""
    try:
        cid = P.store.CollectionId(f"{pg}s{shard}" if shard >= 0 else str(pg))
        raw = store.getattr(cid, P.store.ObjectId(oid, shard), OI_KEY)
        return tuple(json.loads(raw)["version"])
    except KeyError:
        return None


async def wait_until(pred, timeout=10.0):
    async with asyncio.timeout(timeout):
        while not pred():
            await asyncio.sleep(0.01)


async def wait_shard_version(P, cluster, pg, shard, osd, oid, want):
    await wait_until(
        lambda: shard_version(P, cluster.stores[osd], pg, shard, oid) == want)


# -- clients and clusters of the two packages cross ---------------------------


def _crossed(cluster_pkg, client_pkg):
    async def main():
        async with cluster_pkg.rados.MiniCluster(n_osds=4, **cluster_pkg.kw) as cluster:
            cl = await client_pkg.rados.RadosClient(cluster.monmap).connect()
            try:
                await cl.create_pool("ecpool", "erasure")
                io = cl.io_ctx("ecpool")
                await io.write_full("obj", PAYLOAD)
                assert await io.read("obj") == PAYLOAD
                assert await io.stat("obj") == len(PAYLOAD)
                pg, acting, primary = await acting_of(cl, "ecpool", "obj")
                victim = next(o for o in acting if o != primary)
                await cluster.kill_osd(victim)
                await cluster.wait_for_osd_down(victim)
                assert await io.read("obj") == PAYLOAD  # degraded
                with pytest.raises(client_pkg.rados.RadosError) as ei:
                    await io.read("ghost")
                assert ei.value.code == -2
                return store_state(cluster_pkg, cluster)
            finally:
                await cl.shutdown()
    return run(main())


def test_port_client_against_the_reference_cluster():
    state = _crossed(REF, PORT)
    assert state == _crossed(REF, REF)


def test_reference_client_against_the_port_cluster():
    state = _crossed(PORT, REF)
    assert state == _crossed(PORT, PORT)


# -- the trace context reaches the dispatcher ---------------------------------


@pytest.mark.parametrize("client_pkg", [PORT, REF], ids=["port", "reference"])
def test_client_trace_and_client_reach_the_dispatcher_flight_record(client_pkg):
    """The OSD that hosts the port's dispatcher sets the port's
    ``current_client`` and its messenger restores the frame's trace id
    into the port's ``current_trace``, so the flight record of the
    launch that carried an op names the op's trace and client, whichever
    package's client sent it."""
    from ceph_tpu.common import tracing as ref_tracing

    tracing = port_tracing if client_pkg is PORT else ref_tracing

    async def main():
        async with PORT.rados.MiniCluster(n_osds=4, **PORT.kw) as cluster:
            cl = await client_pkg.rados.RadosClient(cluster.monmap,
                                                    name="client.tenant").connect()
            try:
                await cl.create_pool("ecpool", "erasure")
                io = cl.io_ctx("ecpool")
                tok = tracing.current_trace.set("trace-hazard-1")
                try:
                    await io.write_full("obj", PAYLOAD)
                finally:
                    tracing.current_trace.reset(tok)
                _pg, _acting, primary = await acting_of(cl, "ecpool", "obj")
                rec = cluster.osds[primary].ec_dispatch.flight.lookup("trace-hazard-1")
                assert rec is not None and rec["kind"] == "enc"
                assert rec["slowest_trace"] == "trace-hazard-1"
                assert rec["clients"] == [cl.client_id]
            finally:
                await cl.shutdown()

    run(main())


# -- refusals -----------------------------------------------------------------


def test_osd_ec_mesh_is_refused():
    from ceph_tpu_torch.common import Config
    from ceph_tpu_torch.osd import OSD

    with pytest.raises(NotImplementedError, match="item 8"):
        OSD(0, "127.0.0.1:1", config=Config({"osd_ec_mesh": True}, env=""),
            device="cpu")


def test_start_mds_is_refused():
    async def main():
        async with PORT.rados.MiniCluster(n_osds=1, **PORT.kw) as cluster:
            with pytest.raises(NotImplementedError, match="item 11c"):
                await cluster.start_mds()

    run(main())


def test_osd_and_minicluster_raise_without_cuda_unless_asked_for_the_cpu():
    import torch

    from ceph_tpu_torch.device import DeviceUnavailableError
    from ceph_tpu_torch.osd import OSD

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(DeviceUnavailableError):
        OSD(0, "127.0.0.1:1")
    with pytest.raises(DeviceUnavailableError):
        OSD(0, "127.0.0.1:1", device="cuda")
    with pytest.raises(DeviceUnavailableError):
        PORT.rados.MiniCluster(n_osds=1)
    assert OSD(0, "127.0.0.1:1", device="cpu").device.type == "cpu"
    assert PORT.rados.MiniCluster(n_osds=1, device="cpu").device.type == "cpu"


def test_osd_role_serves_on_the_cpu_when_asked(tmp_path):
    """``python -m ceph_tpu_torch.tools.daemon osd --device cpu`` boots
    against a mon, is marked up, serves a write and stops on SIGTERM.
    Every wait on the child is bounded."""
    from ceph_tpu_torch.mon import Monitor

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    async def main():
        mon = Monitor(name="mon.0", rank=0, max_osds=1, failure_min_reporters=1)
        await mon.start()
        mon.set_monmap([mon.addr])
        await mon.start_quorum()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "ceph_tpu_torch.tools.daemon", "osd",
            "--id", "0", "--monmap", mon.addr, "--store", str(tmp_path / "osd.0"),
            "--heartbeat-interval", "0", "--device", "cpu",
            cwd=repo, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        try:
            line = (await asyncio.wait_for(proc.stdout.readline(), 20)).decode()
            assert line.startswith("osd.0 up at 127.0.0.1:"), line
            async with asyncio.timeout(10):
                while not mon.osdmap.is_up(0):
                    await asyncio.sleep(0.01)
            cl = await PORT.rados.RadosClient(mon.addr).connect()
            try:
                await cl.create_pool("one", "replicated", size=1, pg_num=1)
                io = cl.io_ctx("one")
                await io.write_full("obj", PAYLOAD)
                assert await io.read("obj") == PAYLOAD
            finally:
                await cl.shutdown()
            proc.send_signal(signal.SIGTERM)
            assert await asyncio.wait_for(proc.wait(), 20) == 0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await mon.stop()

    run(main())


# -- the slice on the card: chip_smoke phase 13 rehearsed on the CPU ----------

PHASE13_OBJECT = 16 << 10


def test_phase13_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.run_osd_cluster`` on the CPU at 16 KiB objects, 16
    in pool A, 4 in pool B and 4 late ones: the
    port's MiniCluster of 14 OSDs on BlueStores under ``tmp_path``, the
    OSDs' dispatchers on the batching lane with the plain kernels
    counting as launches (as the card's codecs take the kernels).  The
    phase checks its own reads, the stored chunks against the host
    engine and that no op left the lane; here both kernels must count."""
    import torch

    import chip_smoke
    from ceph_tpu_torch.ops import gf_cuda, gf_torch

    monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
    for name, fn in (("gf_matmul", "gf_matmul_u32"), ("bitmatrix_xor", "bitmatrix_matmul_u32")):
        plain = getattr(gf_torch, fn)

        def counted(*a, _plain=plain, _name=name, **kw):
            with gf_cuda._LAUNCHES_LOCK:
                gf_cuda.launches[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(gf_torch, fn, counted)
    monkeypatch.setattr(chip_smoke, "CLUSTER_OBJECT_SIZE", PHASE13_OBJECT)
    monkeypatch.setattr(chip_smoke, "CLUSTER_A_OBJECTS", 16)
    monkeypatch.setattr(chip_smoke, "CLUSTER_B_OBJECTS", 4)
    monkeypatch.setattr(chip_smoke, "CLUSTER_LATE_OBJECTS", 4)
    monkeypatch.setattr(chip_smoke, "CLUSTER_PHASE_LIMIT_S", 60.0)
    launches = chip_smoke.run_osd_cluster(torch.device("cpu"), np.random.default_rng(13),
                                          root=str(tmp_path))
    assert launches["gf_matmul"] > 0 and launches["bitmatrix_xor"] > 0


def test_osd_admin_socket_names_its_device(tmp_path):
    """The OSD's admin socket serves the reference's commands; its
    ``arch`` body names the device its codecs live on."""
    from ceph_tpu_torch.common import admin_command

    async def main():
        overrides = {"admin_socket": str(tmp_path / "{name}.asok")}
        async with PORT.rados.MiniCluster(n_osds=1, config_overrides=overrides,
                                          **PORT.kw) as cluster:
            path = str(tmp_path / "osd.0.asok")
            status = await admin_command(path, "status")
            assert status["name"] == "osd.0" and status["addr"] == cluster.osds[0].addr
            arch = await admin_command(path, "arch")
            assert arch["platform"] == "cpu" and arch["device_kind"] == "cpu"
            assert "totals" in await admin_command(path, "dump_ec_dispatch")

    run(main())
