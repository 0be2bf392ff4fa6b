"""The port's scrub and repair (``ceph_tpu_torch/osd/scrub.py``) held
against the reference's, on the CPU.

Each case of ``tests/test_scrub.py`` runs twice: on the reference's
``MiniCluster`` and on the port's (``MiniCluster(device="cpu")``), with the
same payloads (made from a seed) and the same corruptions made behind the
OSDs' backs.  Each run keeps the reference case's checks and records its
scrub reports and reads; the two records must be equal, and so must every
OSD's store after the scrub (each shard's bytes, crc table and object
info, and the PG logs) where the case ends with the cluster settled.

More cases: one scrub that finds every kind of fault at once (crc, size,
attr, missing, a two-shard loss) gives the reference's report and
repairs; the repaired shards equal the bytes and crc tables the writes
left, on both lanes of the port's codec (the native C lane and the
batching lane with the plain versions of the kernels, the card's lane);
and a device fault raised by the repair decode (``KernelLaunchError`` and
its kin) reaches the scrub's reply as an error with nothing repaired,
while a data fault keeps the reference's answer (reported, not repaired).

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import json
import types

import numpy as np
import pytest

import ceph_tpu.rados as ref_rados
import ceph_tpu.store as ref_store
from ceph_tpu.osd import daemon as ref_daemon
from ceph_tpu.osd import pg_log as ref_pg_log
from ceph_tpu.osd.ec_util import StripeHashes as RefStripeHashes

import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.store as port_store
import ceph_tpu_torch.utils.native as port_native
from ceph_tpu_torch.device import DeviceUnavailableError
from ceph_tpu_torch.ops import gf_cuda, gf_torch
from ceph_tpu_torch.osd import daemon as port_daemon
from ceph_tpu_torch.osd import ec_util as port_ec_util
from ceph_tpu_torch.osd import pg_log as port_pg_log
from ceph_tpu_torch.osd.ec_util import StripeHashes as PortStripeHashes
from tests.test_torch_rados import store_state

LIMIT_S = 30.0
EIO = 5
SEED = 20261018

REF = types.SimpleNamespace(name="ref", rados=ref_rados, store=ref_store, pg_log=ref_pg_log,
                            StripeHashes=RefStripeHashes, OSD=ref_daemon.OSD, kw={})
PORT = types.SimpleNamespace(name="port", rados=port_rados, store=port_store,
                             pg_log=port_pg_log, StripeHashes=PortStripeHashes,
                             OSD=port_daemon.OSD, kw={"device": "cpu"})


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def payload(n: int, salt: int = 0) -> bytes:
    return np.random.default_rng(SEED + salt).integers(0, 256, n, dtype=np.uint8).tobytes()


def twin(scenario, stores=True, **cluster_kw):
    """Run ``scenario(P, cluster, rec)`` on the reference's cluster and on
    the port's; the two records must be equal, and with ``stores`` every
    OSD's store after it too.  Returns the port's record."""
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            rec = []
            async with P.rados.MiniCluster(**cluster_kw, **P.kw) as cluster:
                await scenario(P, cluster, rec)
                if stores:
                    rec.append(("stores", store_state(P, cluster)))
            return rec
        out[P.name] = run(main())
    ref, port = out["ref"], out["port"]
    assert [k for k, *_ in port] == [k for k, *_ in ref]
    for got, want in zip(port, ref):
        assert got == want, got[0]
    return port


def _corrupt_shard(P, cluster, osd_id, cid, oid, data=b"\xde\xad\xbe\xef"):
    """Flip bytes of a stored shard behind the OSD's back (bitrot)."""
    cluster.osds[osd_id].store.apply(P.store.Transaction().write(cid, oid, 0, data))


def _find_shard_holder(cluster, oid_name, shard=None):
    """(osd_id, cid, oid) of an EC shard of the object (of ``shard`` if
    given)."""
    for osd_id, osd in cluster.osds.items():
        for cid in osd.store.list_collections():
            for oid in osd.store.list_objects(cid):
                if oid.name == oid_name and oid.shard >= 0 and shard in (None, oid.shard):
                    return osd_id, cid, oid
    raise AssertionError(f"no shard {shard} of {oid_name} found")


def _errors(reports):
    return sorted((e["oid"] or "", -1 if e.get("shard") is None else e["shard"], e["kind"])
                  for r in reports for e in r["errors"])


# -- the twins of tests/test_scrub.py -----------------------------------------


def test_scrub_clean_cluster_is_quiet():
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("ecpool", "erasure")
        io = client.io_ctx("ecpool")
        for i in range(5):
            await io.write_full(f"obj{i}", payload(512 + 64 * i, i))
        reports = await client.scrub_pool("ecpool")
        assert reports and all(r["clean"] for r in reports), reports
        assert sum(r["objects"] for r in reports) == 5
        assert sum(r["repaired"] for r in reports) == 0
        rec.append(("reports", reports))

    twin(scenario, n_osds=4)


def test_scrub_detects_and_repairs_ec_bitrot():
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("ecpool", "erasure")  # k=2 m=1
        io = client.io_ctx("ecpool")
        data = payload(3000)
        await io.write_full("victim", data)
        _corrupt_shard(P, cluster, *_find_shard_holder(cluster, "victim"))
        reports = await client.scrub_pool("ecpool")
        assert any(e[0] == "victim" and e[2] == "crc" for e in _errors(reports)), reports
        assert sum(r["repaired"] for r in reports) >= 1
        rec.append(("reports", reports))
        reports2 = await client.scrub_pool("ecpool")
        assert all(r["clean"] for r in reports2), reports2
        assert await io.read("victim") == data
        rec.append(("rescrub", reports2))

    twin(scenario, n_osds=4)


def test_scrub_repairs_multiple_corruptions():
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("ecpool", "erasure")
        io = client.io_ctx("ecpool")
        blobs = {f"o{i}": payload(1200 + i * 100, i) for i in range(4)}
        for n, b in blobs.items():
            await io.write_full(n, b)
        for name in ("o1", "o3"):  # one shard of each of two objects
            _corrupt_shard(P, cluster, *_find_shard_holder(cluster, name), b"\xff" * 8)
        reports = await client.scrub_pool("ecpool")
        assert {"o1", "o3"} <= {e["oid"] for r in reports for e in r["errors"]}, reports
        rec.append(("reports", reports))
        reports2 = await client.scrub_pool("ecpool")
        assert all(r["clean"] for r in reports2), reports2
        for n, b in blobs.items():
            assert await io.read(n) == b

    twin(scenario, n_osds=5)


def test_scrub_detects_and_repairs_replicated_bitrot():
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("rep", "replicated", size=3)
        io = client.io_ctx("rep")
        data = payload(2048)
        await io.write_full("victim", data)
        # corrupt a NON-primary replica (majority digest must win)
        pool = client.osdmap.lookup_pool("rep")
        pg, acting, primary = client.osdmap.object_to_acting("victim", pool.id)
        target = next(o for o in acting if o != primary)
        cid = P.store.CollectionId(str(pg))
        _corrupt_shard(P, cluster, target, cid, P.store.ObjectId("victim"), b"ROT")
        reports = await client.scrub_pool("rep")
        assert ("victim", target, "crc") in _errors(reports), reports
        assert sum(r["repaired"] for r in reports) >= 1
        rec.append(("reports", reports))
        reports2 = await client.scrub_pool("rep")
        assert all(r["clean"] for r in reports2), reports2
        assert await io.read("victim") == data
        copies = {bytes(cluster.osds[o].store.read(cid, P.store.ObjectId("victim")))
                  for o in acting}
        assert copies == {data}  # every replica byte-identical again

    twin(scenario, n_osds=3)


def test_scrub_repairs_corrupt_hinfo_xattr():
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("ecpool", "erasure")
        io = client.io_ctx("ecpool")
        data = payload(4096)
        await io.write_full("victim", data)
        osd_id, cid, oid = _find_shard_holder(cluster, "victim")
        cluster.osds[osd_id].store.apply(
            P.store.Transaction().setattr(cid, oid, "hinfo_key", b"not json"))
        reports = await client.scrub_pool("ecpool")
        assert any(e[2] == "attr" for e in _errors(reports)), reports
        rec.append(("reports", reports))
        reports2 = await client.scrub_pool("ecpool")
        assert all(r["clean"] for r in reports2), reports2
        assert await io.read("victim") == data

    twin(scenario, n_osds=4)


def test_scrub_detects_truncated_shard():
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("ecpool", "erasure")
        io = client.io_ctx("ecpool")
        data = payload(3 * 8192)  # multi-stripe: a one-chunk truncation is possible
        await io.write_full("victim", data)
        osd_id, cid, oid = _find_shard_holder(cluster, "victim")
        store = cluster.osds[osd_id].store
        old = store.stat(cid, oid)
        assert old > 4096
        store.apply(P.store.Transaction().truncate(cid, oid, old - 4096))
        reports = await client.scrub_pool("ecpool")
        assert any(e[0] == "victim" and e[2] == "size" for e in _errors(reports)), reports
        rec.append(("reports", reports))
        reports2 = await client.scrub_pool("ecpool")
        assert all(r["clean"] for r in reports2), reports2
        assert await io.read("victim") == data

    twin(scenario, n_osds=4)


def test_scrub_digest_tie_reports_not_repairs():
    """size=2 replicated pool, the primary's copy rots: a 1-1 digest tie
    has no authoritative copy, so scrub flags it and overwrites neither."""
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("rep2", "replicated", size=2)
        io = client.io_ctx("rep2")
        await io.write_full("victim", payload(1024))
        pool = client.osdmap.lookup_pool("rep2")
        pg, acting, primary = client.osdmap.object_to_acting("victim", pool.id)
        cid, oid = P.store.CollectionId(str(pg)), P.store.ObjectId("victim")
        before = {o: bytes(cluster.osds[o].store.read(cid, oid)) for o in acting}
        _corrupt_shard(P, cluster, primary, cid, oid, b"ROT")
        reports = await client.scrub_pool("rep2")
        assert any(e[2] == "inconsistent" for e in _errors(reports)), reports
        assert sum(r["repaired"] for r in reports) == 0
        other = next(o for o in acting if o != primary)
        assert bytes(cluster.osds[other].store.read(cid, oid)) == before[other]
        rec.append(("reports", reports))

    twin(scenario, n_osds=2)


def test_scrub_does_not_resurrect_deleted_object():
    """A delete while a replica is down: the scrub right after its rejoin
    must not bring the object back.  What recovery has done by then is a
    race, so only the reads are compared."""
    async def scenario(P, cluster, rec):
        client = await cluster.client()
        await client.create_pool("rep", "replicated", size=3)
        io = client.io_ctx("rep")
        await io.write_full("ghost", b"boo")
        pool = client.osdmap.lookup_pool("rep")
        _pg, acting, primary = client.osdmap.object_to_acting("ghost", pool.id)
        down = next(o for o in acting if o != primary)
        await cluster.kill_osd(down)
        await cluster.wait_for_osd_down(down)
        await io.remove("ghost")
        await cluster.restart_osd(down)
        await cluster.wait_for_osd_up(down)
        await client.scrub_pool("rep")  # the stale member still lists the object
        with pytest.raises(P.rados.RadosError) as ei:
            await io.read("ghost")
        rec.append(("read", ei.value.code))

    twin(scenario, stores=False, n_osds=3)


def test_background_scrub_loop_repairs():
    """Periodic scrub (scrub_interval > 0) finds and fixes bitrot without
    an operator command."""
    async def scenario(P, cluster, rec):
        for osd_id in list(cluster.osds):
            await cluster.kill_osd(osd_id)
        for osd_id in range(cluster.n_osds):
            osd = P.OSD(osd_id, cluster.mon.addr, store=cluster.stores[osd_id],
                        scrub_interval=0.2, **P.kw)
            await osd.start()
            cluster.osds[osd_id] = osd
        client = await cluster.client()
        await client.create_pool("ecpool", "erasure")
        io = client.io_ctx("ecpool")
        data = payload(1024)
        await io.write_full("victim", data)
        _corrupt_shard(P, cluster, *_find_shard_holder(cluster, "victim"))
        async with asyncio.timeout(10):
            while sum(o.scrub.errors_repaired for o in cluster.osds.values()) < 1:
                await asyncio.sleep(0.05)
        assert await io.read("victim") == data
        rec.append(("repaired", sum(o.scrub.errors_repaired for o in cluster.osds.values())))

    # the repaired count is the loop's, and the loop's timing is the
    # clock's: compare the read and the stores, which it must have healed
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            rec = []
            async with P.rados.MiniCluster(n_osds=4, **P.kw) as cluster:
                await scenario(P, cluster, rec)
                state = store_state(P, cluster)
            return rec, state
        out[P.name] = run(main())
    assert out["port"][0][0][1] >= 1 and out["ref"][0][0][1] >= 1
    assert out["port"][1] == out["ref"][1]


# -- the same corruptions, the same reports and the same repaired bytes -------


POOL_PROFILE = {"plugin": "isa", "k": "3", "m": "2"}
STRIPE_UNIT = 4096
MIXED = {  # object: (the shards rotted, how)
    "o0": ((1,), "crc"),
    "o1": ((2,), "size"),
    "o2": ((0,), "attr"),
    "o3": ((0, 3), "crc"),  # two erasures: the full GF decode
    "o4": ((4,), "missing"),
}


async def _mixed_pool(cluster):
    cl = await cluster.client()
    code, status, _ = await cl.command({"prefix": "osd erasure-code-profile set",
                                        "name": "k3m2", "profile": dict(POOL_PROFILE)})
    assert code == 0, status
    await cl.create_pool("ec", "erasure", erasure_code_profile="k3m2", pg_num=4,
                         stripe_unit=STRIPE_UNIT)
    io = cl.io_ctx("ec")
    blobs = {name: payload(3 * 3 * STRIPE_UNIT + 1000 * i, i)
             for i, name in enumerate(MIXED)}
    for name, data in blobs.items():
        await io.write_full(name, data)
    return cl, io, blobs


def _shard_state(P, cluster, names):
    """Each EC shard of the named objects: (bytes, crc table, object info)."""
    out = {}
    for osd_id, osd in cluster.osds.items():
        for cid in osd.store.list_collections():
            for oid in osd.store.list_objects(cid):
                if oid.name in names and oid.shard >= 0:
                    attrs = osd.store.getattrs(cid, oid)
                    out[(oid.name, oid.shard)] = (
                        bytes(osd.store.read(cid, oid)),
                        bytes(attrs[P.StripeHashes.XATTR_KEY]), bytes(attrs["_"]))
    return out


def _inject(P, cluster, cases=MIXED):
    """Rot the shards of ``cases`` behind the OSDs' backs."""
    T = P.store.Transaction
    for name, (shards, how) in cases.items():
        for s in shards:
            osd_id, cid, oid = _find_shard_holder(cluster, name, s)
            store = cluster.osds[osd_id].store
            if how == "crc":
                store.apply(T().write(cid, oid, 100, b"\xba\xad" * 8))
            elif how == "size":
                store.apply(T().truncate(cid, oid, store.stat(cid, oid) - STRIPE_UNIT))
            elif how == "attr":
                store.apply(T().setattr(cid, oid, P.StripeHashes.XATTR_KEY, b"{garbage"))
            else:
                store.apply(T().remove(cid, oid))


def test_scrub_reports_every_fault_kind_as_the_reference():
    async def scenario(P, cluster, rec):
        cl, io, blobs = await _mixed_pool(cluster)
        _inject(P, cluster)
        reports = await cl.scrub_pool("ec", repair=False)
        want = sorted((n, s, how) for n, (shards, how) in MIXED.items() for s in shards)
        assert _errors(reports) == want, reports
        assert sum(r["repaired"] for r in reports) == 0
        rec.append(("report, no repair", reports))
        reports = await cl.scrub_pool("ec")
        assert _errors(reports) == want
        assert sum(r["repaired"] for r in reports) == len(want)  # counted per shard
        rec.append(("report, repair", reports))
        again = await cl.scrub_pool("ec")
        assert all(r["clean"] for r in again), again
        for name, data in blobs.items():
            assert await io.read(name) == data

    twin(scenario, n_osds=5)


@pytest.mark.parametrize("lane", ["native", "batching"])
def test_repaired_shards_equal_the_written_bytes_and_crc_tables(monkeypatch, lane):
    """Every repaired shard is, byte for byte, the shard the write left
    (data, crc table, object info), in both packages.  On the batching
    lane the port's repair decodes run the plain versions of the kernels
    (``gf_torch``), the route a codec on the card takes."""
    decodes = []
    if lane == "batching":
        monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
        for name in ("gf_matmul_u32", "xor_parity_u32"):
            def counted(*a, _plain=getattr(gf_torch, name), _name=name, **kw):
                decodes.append(_name)
                return _plain(*a, **kw)

            monkeypatch.setattr(gf_torch, name, counted)

    async def scenario(P, cluster, rec):
        cl, io, blobs = await _mixed_pool(cluster)
        written = _shard_state(P, cluster, set(MIXED))
        _inject(P, cluster)
        del decodes[:]
        await cl.scrub_pool("ec")
        repaired = _shard_state(P, cluster, set(MIXED))
        assert repaired == written
        for (name, s), (data, hinfo, _oi) in repaired.items():
            table = P.StripeHashes.from_dict(json.loads(hinfo))
            assert table.verify(s, 0, np.frombuffer(data, dtype=np.uint8)), (name, s)
        rec.append(("shards", repaired))

    twin(scenario, n_osds=5)
    if lane == "batching":
        # one repair decode an object on the plain kernels: a lost data
        # shard of o0, o1, o2 is the XOR program (ISA's first parity row is
        # all ones), o3's two-shard loss and o4's parity take gf_matmul
        assert sorted(decodes) == ["gf_matmul_u32"] * 2 + ["xor_parity_u32"] * 3


@pytest.mark.parametrize("fault", [
    gf_cuda.KernelLaunchError("gf_matmul launch failed: an illegal memory access"),
    gf_cuda.KernelBuildError("nvcc failed"),
    DeviceUnavailableError("CUDA is not available"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["launch", "build", "unavailable", "cuda_error"])
def test_a_device_fault_in_the_repair_decode_answers_the_scrub_with_the_error(
        monkeypatch, fault):
    """The reference's repair swallows any decode error and leaves the
    object unrepaired; the port lets a fault of the card out: the
    ``MOSDScrub`` is answered -EIO with the fault's text, and nothing is
    reported as repaired."""
    def broken(*a, **kw):
        raise fault

    monkeypatch.setattr(port_ec_util, "decode", broken)

    async def main():
        async with PORT.rados.MiniCluster(n_osds=5, **PORT.kw) as cluster:
            cl, io, blobs = await _mixed_pool(cluster)
            before = _shard_state(PORT, cluster, {"o0"})
            _inject(PORT, cluster, {"o0": MIXED["o0"]})
            with pytest.raises(PORT.rados.RadosError) as ei:
                await cl.scrub_pool("ec")
            assert ei.value.code == -EIO and str(fault) in str(ei.value)
            assert sum(o.scrub.errors_repaired for o in cluster.osds.values()) == 0
            assert _shard_state(PORT, cluster, {"o0"}) != before  # still rotten
            # with the card back, the next scrub repairs it
            monkeypatch.undo()
            reports = await cl.scrub_pool("ec")
            assert sum(r["repaired"] for r in reports) == 1
            assert _shard_state(PORT, cluster, {"o0"}) == before
            assert await io.read("o0") == blobs["o0"]

    run(main())


def test_a_data_fault_in_the_repair_decode_keeps_the_reference_answer(monkeypatch):
    """A data fault (the decode refuses its inputs) is the reference's
    case: logged, reported, not repaired, and the scrub still answers."""
    def refuses(*a, **kw):
        raise ValueError("cannot decode")

    monkeypatch.setattr(port_ec_util, "decode", refuses)

    async def main():
        async with PORT.rados.MiniCluster(n_osds=5, **PORT.kw) as cluster:
            cl, _io, _blobs = await _mixed_pool(cluster)
            _inject(PORT, cluster, {"o0": MIXED["o0"]})
            reports = await cl.scrub_pool("ec")
            assert _errors(reports) == [("o0", 1, "crc")]
            assert sum(r["repaired"] for r in reports) == 0

    run(main())


def test_phase14_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.run_osd_scrub_tier`` on the CPU at 64 KiB objects, 8 in
    pool A and 4 through the tier, and 2, 1 and 1 PGs in pools A, B and the
    cache (each map epoch costs every OSD the host's CRUSH walk of every
    PG): the port's MiniCluster of 14 OSDs on
    BlueStores under ``tmp_path``, the OSDs' codecs on the batching lane
    with the plain kernels counting as launches (as the card's codecs take
    the kernels).  The phase checks its own reports, repaired shards,
    flushed shards, reads and class answers, and that no op left the
    lane; here both kernels must count."""
    import torch

    import chip_smoke

    monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
    for name, fn in (("gf_matmul", "gf_matmul_u32"), ("bitmatrix_xor", "bitmatrix_matmul_u32")):
        def counted(*a, _plain=getattr(gf_torch, fn), _name=name, **kw):
            with gf_cuda._LAUNCHES_LOCK:
                gf_cuda.launches[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(gf_torch, fn, counted)
    monkeypatch.setattr(chip_smoke, "SCRUB_OBJECT_SIZE", 64 << 10)
    monkeypatch.setattr(chip_smoke, "SCRUB_OBJECTS", 8)
    monkeypatch.setattr(chip_smoke, "TIER_OBJECTS", 4)
    monkeypatch.setattr(chip_smoke, "TIER_TARGET_MAX_OBJECTS", 1)
    monkeypatch.setattr(chip_smoke, "TIER_CACHE_PG_NUM", 1)
    monkeypatch.setattr(chip_smoke, "CLUSTER_PG_NUM", {"a": 2, "b": 1})
    monkeypatch.setattr(chip_smoke, "SCRUB_TIER_PHASE_LIMIT_S", 60.0)
    launches = chip_smoke.run_osd_scrub_tier(torch.device("cpu"), np.random.default_rng(14),
                                             root=str(tmp_path))
    assert launches["gf_matmul"] > 0 and launches["bitmatrix_xor"] > 0
