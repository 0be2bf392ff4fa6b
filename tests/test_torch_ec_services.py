"""The port's gateway and CephFS on erasure-coded data pools, held
against the reference's, on the CPU.

Twins of the three cases of ``tests/test_ec_services.py`` (S3 objects
and a multipart upload on an EC data pool; a read with an OSD down that
rebuilds from the survivors; a CephFS file on an EC data pool read
healthy and degraded), each with four profiles: the default
(jerasure reed_sol_van k=2 m=1), ``isa`` k=2 m=2, and ``isa`` k=2 m=2
again with the port's ``native.host_engine_active`` patched to False, so
that the OSDs' dispatchers take the batching lane with the plain versions
of the kernels, the lane a CUDA codec takes on the card; then ``isa``
``cauchy`` k=2 m=2 on that lane.  Each runs on the reference's
``MiniCluster`` and on the port's (``tests/test_torch_rgw.py``'s ``twin``,
with ``shards``, and ``tests/test_torch_cephfs.py``'s): the reads, the
gateway's or the file system's pools' objects and every OSD store's
shards, crc tables and object sizes must be equal.

The degraded read loses the OSD that holds data shard 0 of the object's
first backing object, so a decode must run (the reference's cases kill
osd.3 or osd.2, which may hold only parity).  On the batching lane the plain
``gf_matmul`` must run for the encodes and a plain kernel for the decode.
A one-shard decode of ``reed_sol_van`` rebuilds with the all-ones row of
its first parity, so it runs the port's XOR program (as an m = 1 code's
encode does); a ``cauchy`` matrix has no such row, so its decode must run
``gf_matmul``: the card's checks name such profiles.
"""

import numpy as np
import pytest

import ceph_tpu_torch.utils.native as port_native
from ceph_tpu_torch.ops import gf_torch

from tests.test_torch_cephfs import PORT as FS_PORT, twin as fs_twin
from tests.test_torch_rgw import PORT, twin

ISA = {"plugin": "isa", "k": "2", "m": "2"}
PROFILES = {  # name: (profile, the batching lane)
    "default": (None, False),
    "isa": (ISA, False),
    "isa-batching": (ISA, True),
    "isa-cauchy-batching": (dict(ISA, technique="cauchy"), True),
}


@pytest.fixture(params=list(PROFILES))
def profile(request, monkeypatch):
    """(name, profile, batching, calls): on the batching lane the port's
    plain kernels are counted, ``calls["gf_matmul"]`` and ``calls["xor"]``."""
    name = request.param
    prof, batching = PROFILES[name]
    calls = {"gf_matmul": 0, "xor": 0}
    if batching:
        monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
        for key, fn in (("gf_matmul", "gf_matmul_u32"), ("xor", "xor_parity_u32")):
            plain = getattr(gf_torch, fn)

            def counted(*a, _plain=plain, _key=key, **kw):
                calls[_key] += 1
                return _plain(*a, **kw)

            monkeypatch.setattr(gf_torch, fn, counted)
    return name, prof, batching, calls


async def _ec_store(r, profile):
    cl = await r.cluster.client()
    kw = {}
    if profile is not None:
        code, status, _ = await cl.command({"prefix": "osd erasure-code-profile set",
                                            "name": "rgwdata", "profile": dict(profile)})
        assert code == 0, status
        kw["data_profile"] = "rgwdata"
    s = await r.P.rgw.RGWStore.create(cl, data_pool_type="erasure", **kw)
    assert cl.osdmap.lookup_pool(".rgw.buckets").is_erasure()
    await s.create_user("u")
    await s.create_bucket("b", "u")
    return cl, s


def test_s3_over_ec_data_pool(profile):
    _name, prof, batching, calls = profile
    body = np.random.default_rng(21).integers(0, 256, 100_000, dtype=np.uint8).tobytes()

    async def scenario(r):
        _cl, s = await _ec_store(r, prof)
        before = dict(calls)
        await r.call("put", s.put_object("b", "k", body))
        got, _ = await r.call("get", s.get_object("b", "k"))
        assert got == body
        up = await r.call("init", s.init_multipart("b", "big"))
        await s.upload_part("b", "big", up, 1, b"P1" * 4000)
        await s.upload_part("b", "big", up, 2, b"P2" * 100)
        await r.call("complete", s.complete_multipart("b", "big", up))
        got, _ = await r.call("get big", s.get_object("b", "big"))
        assert got == b"P1" * 4000 + b"P2" * 100
        listing = await r.call("list", s.list_objects("b"))
        assert [c["key"] for c in listing["contents"]] == ["big", "k"]
        if r.P is PORT and batching:
            assert calls["gf_matmul"] > before["gf_matmul"], "no plain gf_matmul encode"

    twin(scenario, n_osds=4, shards=True)


def test_degraded_read_reconstructs(profile):
    name, prof, batching, calls = profile
    body = np.random.default_rng(22).integers(0, 256, 60_000, dtype=np.uint8).tobytes()

    async def scenario(r):
        cl, s = await _ec_store(r, prof)
        await r.call("put", s.put_object("b", "k", body))
        pool = cl.osdmap.lookup_pool(".rgw.buckets")
        _pg, acting, _primary = cl.osdmap.object_to_acting("b/k.0000000000000000", pool.id)
        victim = r.note("victim", acting[0])
        await r.cluster.kill_osd(victim)
        await r.cluster.wait_for_osd_down(victim)
        before = dict(calls)
        got, _ = await r.call("degraded get", s.get_object("b", "k"))
        assert got == body
        if r.P is PORT and batching:
            ran = {key: calls[key] - before[key] for key in calls}
            assert sum(ran.values()) > 0, "no plain kernel decode in the degraded read"
            if "cauchy" in name:
                assert ran["gf_matmul"] > 0, ran

    twin(scenario, n_osds=4, shards=True)


def test_fs_over_ec_data_pool(profile):
    """A file on the MDS's erasure-coded data pool, written, read, and
    read again with the OSD that holds data shard 0 of its first data
    object down."""
    name, prof, batching, calls = profile
    blob = np.random.default_rng(23).integers(0, 256, 200_000, dtype=np.uint8).tobytes()

    async def scenario(r):
        cl = await r.cluster.client()
        kw = {}
        if prof is not None:
            code, status, _ = await cl.command({"prefix": "osd erasure-code-profile set",
                                                "name": "fsdata", "profile": dict(prof)})
            assert code == 0, status
            kw["data_profile"] = "fsdata"
        await r.mds("mds.a", data_pool_type="erasure", **kw)
        assert cl.osdmap.lookup_pool(".cephfs.data").is_erasure()
        fs = await r.fs()
        await fs.mkdir("/d")
        before = dict(calls)
        await fs.write_file("/d/blob", blob)
        assert await r.call("read", fs.read_file("/d/blob")) == blob
        if r.P is FS_PORT and batching:
            assert calls["gf_matmul"] > before["gf_matmul"], "no plain gf_matmul encode"
        ino = (await r.call("stat", fs.stat("/d/blob")))["ino"]
        pool = cl.osdmap.lookup_pool(".cephfs.data")
        _pg, acting, _primary = cl.osdmap.object_to_acting(
            f"data.{ino:x}.0000000000000000", pool.id)
        victim = r.note("victim", acting[0])
        await r.cluster.kill_osd(victim)
        await r.cluster.wait_for_osd_down(victim)
        before = dict(calls)
        assert await r.call("degraded read", fs.read_file("/d/blob")) == blob
        if r.P is FS_PORT and batching:
            ran = {key: calls[key] - before[key] for key in calls}
            assert sum(ran.values()) > 0, "no plain kernel decode in the degraded read"
            if "cauchy" in name:
                assert ran["gf_matmul"] > 0, ran

    fs_twin(scenario, n_osds=4, shards=True)


def test_phase17_on_the_cpu(monkeypatch):
    """``chip_smoke.run_rgw`` on the CPU at 64 KiB objects, 4 of them and a
    multipart upload of 3 parts: the port's MiniCluster of 6 OSDs, zone a
    on isa cauchy k=4 m=2 and zone b on cauchy_good k=4 m=2, the OSDs'
    dispatchers on the batching lane with the plain kernels counting as
    launches (as the card's codecs take the kernels).  The phase checks
    its own GETs, the stored shards against a CPU codec's encode, that no
    op left the lane, and that both kernels encode and decode."""
    import torch

    import chip_smoke
    from ceph_tpu_torch.ops import gf_cuda

    monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
    for name, fn in (("gf_matmul", "gf_matmul_u32"), ("bitmatrix_xor", "bitmatrix_matmul_u32")):
        plain = getattr(gf_torch, fn)

        def counted(*a, _plain=plain, _name=name, **kw):
            with gf_cuda._LAUNCHES_LOCK:
                gf_cuda.launches[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(gf_torch, fn, counted)
    for name, value in (("RGW_OBJECTS", 4), ("RGW_OBJECT_SIZE", 64 << 10), ("RGW_PARTS", 3),
                        ("RGW_PART_SIZE", 64 << 10), ("RGW_RANGE", (1000, 30000)),
                        ("RGW_PHASE_LIMIT_S", 60.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    launches = chip_smoke.run_rgw(torch.device("cpu"), np.random.default_rng(17), {})
    assert launches["gf_matmul"] > 0 and launches["bitmatrix_xor"] > 0


def test_phase18_on_the_cpu(monkeypatch):
    """``chip_smoke.run_cephfs_rbd`` on the CPU at 64 KiB files, 8 of them,
    and a 1 MiB image: the port's MiniCluster of 6 OSDs with the MDS's data
    pool isa cauchy k=4 m=2, the OSDs' dispatchers on the batching lane
    with the plain kernels counting as launches (as the card's codecs take
    the kernels).  The phase checks its own reads, the stored shards
    against a CPU codec's encode, the namespace across the failover, the
    mirror's export, that no op left the lane, and that ``gf_matmul``
    encodes and decodes."""
    import torch

    import chip_smoke
    from ceph_tpu_torch.ops import gf_cuda

    monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
    plain = gf_torch.gf_matmul_u32

    def counted(*a, **kw):
        with gf_cuda._LAUNCHES_LOCK:
            gf_cuda.launches["gf_matmul"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(gf_torch, "gf_matmul_u32", counted)
    for name, value in (("CEPHFS_FILES", 8), ("CEPHFS_FILE_SIZE", 64 << 10),
                        ("CEPHFS_OVERWRITE", 16 << 10), ("RBD_IMAGE_SIZE", 1 << 20),
                        ("RBD_ORDER", 16), ("RBD_WRITE_SIZE", 64 << 10),
                        ("RBD_MIRROR_WRITE_SIZE", 16 << 10), ("CEPHFS_PHASE_LIMIT_S", 90.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    launches = chip_smoke.run_cephfs_rbd(torch.device("cpu"), np.random.default_rng(18), {})
    assert launches["gf_matmul"] > 0
