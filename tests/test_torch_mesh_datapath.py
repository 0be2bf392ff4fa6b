"""The port's mesh EC data path against the reference's, twin of
tests/test_mesh_datapath.py, every case.

A pool's k+m shard rows go through ``MeshEcEngine``: encode split over
the lanes, degraded-read reconstruct gathered onto the rebuilding
lanes, byte-identical to the host path.  The port's engine runs on 8
CPU lanes (``device="cpu"``), the reference's on jax's 8 virtual CPU
devices.  The engine cases hold the port's bytes against the port's
``ec_util``, the reference's ``MeshEcEngine`` and the reference's
``ec_util`` on the same seeded inputs; the service cases run a 4-OSD
``MiniCluster(..., device="cpu")`` with ``osd_ec_mesh`` on, whose
stored shard bytes equal the host path's, a mesh-off cluster's and the
reference's mesh-on cluster's.  Tolerance: none, the bytes are exact.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.osd.daemon import CollectionId as RefCollectionId
from ceph_tpu.osd.daemon import ObjectId as RefObjectId
from ceph_tpu.parallel.engine import MeshEcEngine as RefMeshEcEngine
from ceph_tpu.rados import MiniCluster as RefMiniCluster

from ceph_tpu_torch.models import registry
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_util import StripeInfo
from ceph_tpu_torch.parallel.engine import MeshEcEngine
from ceph_tpu_torch.rados import MiniCluster
from ceph_tpu_torch.store import CollectionId, ObjectId

PAYLOAD = bytes(range(256)) * 64  # 16 KiB
ASYNC_LIMIT_S = 60.0


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, ASYNC_LIMIT_S)

    return asyncio.run(bounded())


def _profile(k, m, technique="reed_sol_van"):
    return {"plugin": "isa", "technique": technique,
            "k": str(k), "m": str(m)}


def _codec(k, m):
    return registry.instance().factory("isa", _profile(k, m), device="cpu")


def _ref_codec(k, m):
    return ref_registry.instance().factory("isa", _profile(k, m))


def _ref_sinfo(sinfo):
    return ref_ec_util.StripeInfo(stripe_width=sinfo.stripe_width,
                                  chunk_size=sinfo.chunk_size)


_ENGINES: dict = {}


def _engines() -> tuple[MeshEcEngine, RefMeshEcEngine]:
    """One port engine (8 CPU lanes) and one reference engine (8 virtual
    devices), shared by the engine cases."""
    if not _ENGINES:
        _ENGINES["port"] = MeshEcEngine(device="cpu")
        _ENGINES["ref"] = RefMeshEcEngine()
    return _ENGINES["port"], _ENGINES["ref"]


class TestEngineBytes:
    """Mesh-path bytes == host-path bytes, pinned per shard."""

    @pytest.mark.parametrize("k,m", [(8, 3), (2, 1), (4, 2)])
    def test_encode_matches_ec_util(self, k, m):
        codec = _codec(k, m)
        chunk = codec.get_chunk_size(4096 * k)
        sinfo = StripeInfo(stripe_width=chunk * k, chunk_size=chunk)
        rng = np.random.default_rng(5)
        # 5 stripes: forces pg-axis padding (8 lanes -> bucket 8)
        buf = rng.integers(
            0, 256, size=(sinfo.stripe_width * 5,), dtype=np.uint8
        )
        eng, ref_eng = _engines()
        host = ec_util.encode(sinfo, codec, buf)
        mesh = eng.encode(sinfo, codec, buf)
        ref = ref_eng.encode(_ref_sinfo(sinfo), _ref_codec(k, m), buf)
        ref_host = ref_ec_util.encode(_ref_sinfo(sinfo), _ref_codec(k, m), buf)
        assert sorted(host) == sorted(mesh) == sorted(ref) == list(range(k + m))
        for s in host:
            np.testing.assert_array_equal(host[s], mesh[s])
            np.testing.assert_array_equal(np.asarray(ref[s]), mesh[s])
            np.testing.assert_array_equal(np.asarray(ref_host[s]), mesh[s])

    @pytest.mark.parametrize(
        "erased", [(0,), (8,), (0, 5), (1, 9, 10)]
    )
    def test_reconstruct_matches_ec_util(self, erased):
        k, m = 8, 3
        codec = _codec(k, m)
        chunk = codec.get_chunk_size(4096 * k)
        sinfo = StripeInfo(stripe_width=chunk * k, chunk_size=chunk)
        rng = np.random.default_rng(6)
        buf = rng.integers(
            0, 256, size=(sinfo.stripe_width * 3,), dtype=np.uint8
        )
        full = ec_util.encode(sinfo, codec, buf)
        surv = {s: v for s, v in full.items() if s not in erased}
        eng, ref_eng = _engines()
        host = ec_util.decode_concat(sinfo, codec, surv)
        mesh = eng.decode_concat(sinfo, codec, surv)
        ref = ref_eng.decode_concat(_ref_sinfo(sinfo), _ref_codec(k, m), surv)
        assert host == mesh == ref == buf.tobytes()

    def test_unsupported_codec_refused(self):
        eng, ref_eng = _engines()
        shec = registry.instance().factory(
            "shec", {"k": "4", "m": "3", "c": "2"}, device="cpu"
        )
        assert not eng.supports(shec)
        assert eng.supports(_codec(2, 1))
        cauchy = registry.instance().factory(
            "jerasure", {"technique": "cauchy_good", "k": "3", "m": "2"},
            device="cpu")
        assert not eng.supports(cauchy)
        assert not ref_eng.supports(ref_registry.instance().factory(
            "shec", {"k": "4", "m": "3", "c": "2"}))
        assert ref_eng.supports(_ref_codec(2, 1))


class TestServiceStack:
    """The OSD routes its EC write/read path through the mesh when
    osd_ec_mesh is on — proven by counters AND by the stored shard
    bytes matching the host path exactly."""

    def test_write_and_degraded_read_via_mesh(self):
        async def main():
            async with MiniCluster(
                n_osds=4, device="cpu", config_overrides={"osd_ec_mesh": True}
            ) as cluster:
                cl = await cluster.client()
                await cl.create_pool("ecpool", "erasure")  # isa k2m1
                io = cl.io_ctx("ecpool")
                await io.write_full("obj", PAYLOAD)

                pool = cl.osdmap.lookup_pool("ecpool")
                pg, acting, primary = cl.osdmap.object_to_acting(
                    "obj", pool.id
                )
                posd = cluster.osds[primary]
                assert posd.ec_mesh is not None
                assert posd.perf.get("ec").get("mesh_encode_calls") > 0
                assert posd.ec_dispatch.dump()["totals"]["lanes"]["mesh"][
                    "batches"] > 0

                # stored shard bytes == host-path encode of the payload
                codec, sinfo = posd._pool_codec(pool)
                padded = sinfo.pad_to_stripe(PAYLOAD)
                host = ec_util.encode(sinfo, codec, padded)
                for shard, osd in enumerate(acting):
                    got = cluster.stores[osd].read(
                        CollectionId(f"{pg}s{shard}"), ObjectId("obj", shard)
                    )
                    assert got == host[shard].tobytes(), (
                        f"mesh-path shard {shard} bytes != host path"
                    )

                # kill a data shard; the read must reconstruct via the
                # mesh's gathered reconstruct
                victim = acting[0]
                await cluster.kill_osd(victim)
                await cluster.wait_for_osd_down(victim)
                assert await io.read("obj") == PAYLOAD
                decs = sum(
                    o.perf.get("ec").get("mesh_decode_calls")
                    for o in cluster.osds.values()
                )
                assert decs > 0, "degraded read did not use the mesh path"

        run(main())

    def test_mesh_and_tcp_clusters_store_identical_bytes(self):
        """Mesh-path bytes == TCP-path bytes for the same logical write,
        and == the reference's mesh-path bytes."""

        async def stored_by(cluster_cls, ids, mesh_on, **kw):
            async with cluster_cls(
                n_osds=4,
                config_overrides=({"osd_ec_mesh": True} if mesh_on else None),
                **kw,
            ) as cluster:
                cl = await cluster.client()
                await cl.create_pool("ecpool", "erasure")
                io = cl.io_ctx("ecpool")
                await io.write_full("obj", PAYLOAD)
                pool = cl.osdmap.lookup_pool("ecpool")
                pg, acting, _p = cl.osdmap.object_to_acting("obj", pool.id)
                cid, oid = ids
                return {
                    s: bytes(cluster.stores[o].read(
                        cid(f"{pg}s{s}"), oid("obj", s)))
                    for s, o in enumerate(acting)
                }

        async def main():
            port_ids = (CollectionId, ObjectId)
            return (
                await stored_by(MiniCluster, port_ids, False, device="cpu"),
                await stored_by(MiniCluster, port_ids, True, device="cpu"),
                await stored_by(RefMiniCluster, (RefCollectionId, RefObjectId),
                                True),
            )

        tcp, mesh, ref_mesh = run(main())
        assert tcp == mesh == ref_mesh
        assert len(mesh) == 3
