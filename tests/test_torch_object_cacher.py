"""The port's ``ObjectCacher`` held against the reference's, on the CPU.

Every case of ``tests/test_object_cacher.py`` runs twice: the
reference's cacher over the reference's ``MiniCluster``, and the port's
over the port's (``MiniCluster(device="cpu")``).  Each run checks what
the reference's case checks and records what it read, the errnos it
met and the cacher's ``stats()``; the two records must be equal.
``TestRbdCache`` drives each package's ``rbd.Image`` with its cache on,
under one seeded image id (``tests/test_torch_rbd.py``).
"""

import asyncio
import contextlib
import types

import pytest

import ceph_tpu.rados as ref_rados
import ceph_tpu.rbd as ref_rbd
import ceph_tpu.rbd.image as ref_image
from ceph_tpu.rados.object_cacher import ObjectCacher as RefObjectCacher

import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.rbd as port_rbd
import ceph_tpu_torch.rbd.image as port_image
from ceph_tpu_torch.rados import ObjectCacher
from tests.test_torch_rgw import deterministic, pool_state

LIMIT_S = 30.0

REF = types.SimpleNamespace(name="ref", rados=ref_rados, ObjectCacher=RefObjectCacher,
                            rbd=ref_rbd, kw={})
PORT = types.SimpleNamespace(name="port", rados=port_rados, ObjectCacher=ObjectCacher,
                             rbd=port_rbd, kw={"device": "cpu"})


def twin(scenario, context=contextlib.nullcontext):
    """``scenario(P, cluster, rec)`` on both packages' clusters, each run
    inside a fresh ``context()``; the records must match."""
    out = {}
    for P in (REF, PORT):
        async def main(P=P):
            rec = []
            async with asyncio.timeout(LIMIT_S):
                async with P.rados.MiniCluster(n_osds=3, **P.kw) as cluster:
                    cl = await cluster.client()
                    await cl.create_pool("p", "replicated", size=3)
                    await scenario(P, cluster, cl, rec)
            return rec
        with context():
            out[P.name] = asyncio.run(main())
    assert out["port"] == out["ref"]
    return out["port"]


async def errno_of(coro):
    with pytest.raises(Exception) as e:
        await coro
    assert type(e.value).__name__ == "RadosError"
    return e.value.code


class TestCacher:
    def test_read_cache_hits(self):
        async def scenario(P, cluster, cl, rec):
            io = cl.io_ctx("p")
            await io.write_full("o", b"abcdef" * 100)
            cache = P.ObjectCacher(io)
            assert await cache.read("o", 0, 6) == b"abcdef"
            assert await cache.read("o", 6, 6) == b"abcdef"
            assert cache.misses == 1 and cache.hits == 1
            rec.append(await errno_of(cache.read("ghost")))
            rec.append(cache.stats())

        twin(scenario)

    def test_write_back_vs_through(self):
        async def scenario(P, cluster, cl, rec):
            io1 = cl.io_ctx("p")
            io2 = (await cluster.client()).io_ctx("p")
            wb = P.ObjectCacher(io1, write_back=True)
            await wb.write_full("o", b"buffered")
            rec.append(await errno_of(io2.read("o")))  # not flushed yet
            await wb.flush()
            assert await io2.read("o") == b"buffered"
            wt = P.ObjectCacher(io1, write_back=False)
            await wt.write_full("o2", b"direct")
            assert await io2.read("o2") == b"direct"  # immediate
            rec += [wb.stats(), wt.stats()]

        twin(scenario)

    def test_partial_writes_compose(self):
        async def scenario(P, cluster, cl, rec):
            io = cl.io_ctx("p")
            cache = P.ObjectCacher(io)
            await cache.write("o", b"AAAA", 0)
            await cache.write("o", b"BB", 2)
            await cache.write("o", b"CC", 8)  # creates a hole
            assert await cache.read("o") == b"AABB\x00\x00\x00\x00CC"
            await cache.flush()
            assert await io.read("o") == b"AABB\x00\x00\x00\x00CC"
            rec.append(cache.stats())

        twin(scenario)

    def test_eviction_flushes_dirty(self):
        async def scenario(P, cluster, cl, rec):
            io = cl.io_ctx("p")
            cache = P.ObjectCacher(io, max_bytes=3000)
            for i in range(6):
                await cache.write_full(f"o{i}", bytes([i]) * 1000)
            st = cache.stats()
            assert st["bytes"] <= 3000
            assert st["objects"] <= 3
            await cache.flush()
            for i in range(6):
                assert await io.read(f"o{i}") == bytes([i]) * 1000
            rec += [st, cache.stats()]

        twin(scenario)

    def test_oversized_object_never_loses_writes(self):
        """An object bigger than the whole cache is not evicted out from
        under its own in-flight mutation."""

        async def scenario(P, cluster, cl, rec):
            io = cl.io_ctx("p")
            await io.write_full("big", b"\x11" * 2000)
            cache = P.ObjectCacher(io, max_bytes=1000)
            await cache.write("big", b"X", 0)
            assert (await cache.read("big", 0, 2))[:1] == b"X"
            await cache.flush()
            assert (await io.read("big"))[:1] == b"X"
            rec.append(cache.stats())

        twin(scenario)

    def test_invalidate_rereads(self):
        async def scenario(P, cluster, cl, rec):
            io1 = cl.io_ctx("p")
            io2 = (await cluster.client()).io_ctx("p")
            cache = P.ObjectCacher(io1)
            await io1.write_full("o", b"v1")
            assert await cache.read("o") == b"v1"
            await io2.write_full("o", b"v2")  # behind the cache's back
            assert await cache.read("o") == b"v1"  # stale by design
            await cache.invalidate("o")
            assert await cache.read("o") == b"v2"
            rec.append(cache.stats())

        twin(scenario)

    def test_remove_through_cache(self):
        async def scenario(P, cluster, cl, rec):
            io = cl.io_ctx("p")
            cache = P.ObjectCacher(io)
            await cache.write_full("o", b"x")
            await cache.flush()
            await cache.remove("o")
            rec.append(await errno_of(cache.read("o")))
            rec.append(await errno_of(io.read("o")))
            rec.append(cache.stats())

        twin(scenario)


class TestRbdCache:
    def test_cached_image_io_and_snap_consistency(self):
        order = 14
        obj = 1 << order

        async def scenario(P, cluster, cl, rec):
            await cl.create_pool("rbd", "replicated", size=3)
            await P.rbd.RBD(cl.io_ctx("rbd")).create("img", 4 * obj, order=order)
            img = await P.rbd.Image.open(cl.io_ctx("rbd"), "img", cache_bytes=1 << 20)
            data = bytes(range(256)) * (obj // 128)  # 2 objects
            await img.write(100, data)
            assert await img.read(100, len(data)) == data
            assert img._cache.hits > 0
            rec.append(img._cache.stats())
            # a snapshot must capture buffered writes (flush-first)
            await img.snap_create("s1")
            await img.write(100, b"\xee" * len(data))
            img.set_snap("s1")
            assert await img.read(100, len(data)) == data
            img.set_snap(None)
            # rollback drops cached (stale) state
            await img.snap_rollback("s1")
            assert await img.read(100, len(data)) == data
            rec.append(img._cache.stats())
            await img.close()
            # durable after close (flush on close)
            img2 = await P.rbd.Image.open(cl.io_ctx("rbd"), "img")
            assert await img2.read(100, len(data)) == data
            await img2.close()
            rec.append(await pool_state(cluster, ("rbd",)))

        twin(scenario, lambda: deterministic(callers=("ceph_tpu.rbd.", "ceph_tpu_torch.rbd."),
                                             secret_modules=(ref_image, port_image)))


class TestDiscardInvalidate:
    def test_discard_drops_dirty_without_flush(self):
        """invalidate(discard=True) does not push stale dirty buffers
        over another client's change; the default mode flushes."""

        async def scenario(P, cluster, cl, rec):
            io = cl.io_ctx("p")
            await io.write_full("o", b"remote-truth")
            cache = P.ObjectCacher(io, write_back=True)
            await cache.write("o", b"stale-local!")
            await cache.invalidate(discard=True)
            assert await io.read("o") == b"remote-truth"
            assert await cache.read("o") == b"remote-truth"
            await cache.write("o", b"mine-to-keep")
            await cache.invalidate()
            assert await io.read("o") == b"mine-to-keep"
            rec.append(cache.stats())

        twin(scenario)
