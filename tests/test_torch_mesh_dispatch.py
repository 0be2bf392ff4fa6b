"""The port's mesh dispatcher lane (``ECDispatcher(mesh_engine=...)``
over ``ceph_tpu_torch.parallel.engine.MeshEcEngine``) against the
reference's, twin of tests/test_mesh_dispatch.py, every case.

The port's engine runs on CPU lanes (``device="cpu"``: 8 lanes unless
a count is given), the reference's on jax's 8 virtual CPU devices
(tests/conftest.py).  Pinned, as in the reference:

- the aligned bucketing rule (``bucket_stripes_aligned``), equal to the
  reference's;
- mesh-lane bytes identical to ``ec_util`` (and to the reference's
  ``ec_util`` on the reference's codec) across bucket boundaries,
  uneven remainders, w=16 codecs and mid-batch cancellation; a decode
  with no missing row stays off the mesh; the mesh outranks the native
  direct lane; an unaligned chunk size stays off the mesh;
- the prime-k reconstruct fallback (k=7 on 4 lanes gathers over 'pg');
- the launch-shape gate: 50 op sizes cost at most #buckets mesh_encode
  signatures in the port's profiler;
- the mesh families in ``dump_kernel_profile`` and the gather probe;
- failover: a fatal error mid-mesh-batch replays bit-identically on the
  host, attributed to the mesh lane; and live, on a 4-OSD MiniCluster,
  injected device loss mid-mesh-batch fails no client op and the canary
  re-promotes the mesh.

Crossed with the reference's ``MeshEcEngine``: the engine-level cases
give equal shard and reconstructed bytes on the same seeded inputs;
``mesh_key`` and ``reconstruct_axis`` are equal for n in {1, 2, 4, 8}
and k in {2, 3, 4, 6, 7, 8, 10}, and ``_recovery_rows`` for every
erasure of one and two rows of isa k=8 m=3; on a one-lane mesh the
dispatcher's routing (lane totals, mesh buckets, ``mesh_route``) equals
the reference's.  "The device lane" patches each package's
``native.host_engine_active`` to False, so CPU codecs take the batching
lanes.  Tolerance: none, the bytes are exact.
"""

import asyncio
import itertools

import numpy as np
import pytest

import jax

from ceph_tpu.models.matrix_codec import MatrixErasureCode as RefMatrixErasureCode
from ceph_tpu.osd import ec_dispatch as ref_ec_dispatch
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.parallel import distributed as ref_distributed
from ceph_tpu.parallel.engine import MeshEcEngine as RefMeshEcEngine
from ceph_tpu.utils import native as ref_native

from ceph_tpu_torch.models import registry
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.ops import matrices as mx
from ceph_tpu_torch.ops.profiler import profiler
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_dispatch import (
    ECDispatcher,
    bucket_stripes,
    bucket_stripes_aligned,
)
from ceph_tpu_torch.parallel import distributed
from ceph_tpu_torch.parallel.engine import MeshEcEngine
from ceph_tpu_torch.utils import native

ASYNC_LIMIT_S = 60.0


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, ASYNC_LIMIT_S)

    return asyncio.run(bounded())


CS = 512  # chunk_size; stripe_width = k * CS


def _sinfo(k: int, cs: int = CS) -> ec_util.StripeInfo:
    return ec_util.StripeInfo(stripe_width=cs * k, chunk_size=cs)


def _matrix(k: int, m: int, w: int) -> np.ndarray:
    return mx.rs_vandermonde(k, m, 16) if w == 16 else mx.isa_rs_vandermonde(k, m)


def _codec(k: int = 2, m: int = 1, w: int = 8) -> MatrixErasureCode:
    return MatrixErasureCode(k, m, w, _matrix(k, m, w), device="cpu")


def _ref_codec(k: int = 2, m: int = 1, w: int = 8) -> RefMatrixErasureCode:
    return RefMatrixErasureCode(k, m, w, _matrix(k, m, w))


def _ref_encode(sinfo, k, m, w, buf):
    """The reference's bytes: its own ec_util on its own codec."""
    rs = ref_ec_util.StripeInfo(stripe_width=sinfo.stripe_width,
                                chunk_size=sinfo.chunk_size)
    return ref_ec_util.encode(rs, _ref_codec(k, m, w), buf)


def _bufs(sinfo, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 256, size=(s * sinfo.stripe_width,),
                     dtype=np.uint8)
        for s in sizes
    ]


_ENGINES: dict = {}
_REF_ENGINES: dict = {}


def _engine(n: int | None = None) -> MeshEcEngine:
    """One shared engine per lane count (8 CPU lanes for None): the
    cases share many (codec, shape) programs."""
    eng = _ENGINES.get(n)
    if eng is None:
        eng = _ENGINES[n] = MeshEcEngine(n_devices=n, device="cpu")
    return eng


def _ref_engine(n: int | None = None) -> RefMeshEcEngine:
    eng = _REF_ENGINES.get(n)
    if eng is None:
        devs = jax.devices()
        eng = _REF_ENGINES[n] = RefMeshEcEngine(
            devices=devs[:n] if n else devs)
    return eng


def _assert_same_shards(got, want):
    assert set(got) == set(want)
    for s in want:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s])), (
            f"shard {s} diverged"
        )


@pytest.fixture
def device_lane(monkeypatch):
    monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)
    monkeypatch.setattr(ref_native, "host_engine_active", lambda: False)


# -- aligned bucketing --------------------------------------------------------


def test_bucket_stripes_aligned_rule():
    # quantum 8 (an 8-lane mesh): units bucket to powers of two
    assert [bucket_stripes_aligned(s, 8) for s in
            (1, 8, 9, 16, 17, 33)] == [8, 8, 16, 16, 32, 64]
    # bucketing off still mesh-aligns (lanes must stay balanced)
    assert [bucket_stripes_aligned(s, 8, bucket=False) for s in
            (1, 8, 9, 17)] == [8, 8, 16, 24]
    # quantum 1 degenerates to the plain power-of-two bucket
    assert all(
        bucket_stripes_aligned(s, 1) == bucket_stripes(s)
        for s in range(1, 40)
    )
    assert all(
        bucket_stripes_aligned(s, q, b)
        == ref_ec_dispatch.bucket_stripes_aligned(s, q, b)
        for s in range(1, 70) for q in (1, 2, 3, 4, 8) for b in (True, False)
    )


# -- the engines' geometry, crossed -------------------------------------------


def test_mesh_geometry_and_recovery_rows_equal_the_references():
    for n, k in itertools.product((1, 2, 4, 8), (2, 3, 4, 6, 7, 8, 10)):
        assert _engine(n).mesh_key(k) == _ref_engine(n).mesh_key(k), (n, k)
        assert _engine(n).reconstruct_axis(k) == \
            _ref_engine(n).reconstruct_axis(k), (n, k)
    k, m, w = 8, 3, 8
    P = mx.isa_rs_vandermonde(k, m)
    for missing in itertools.chain(itertools.combinations(range(k + m), 1),
                                   itertools.combinations(range(k + m), 2)):
        present = [r for r in range(k + m) if r not in missing]
        assert np.array_equal(
            distributed._recovery_rows(P, k, w, present, list(missing)),
            ref_distributed._recovery_rows(P, k, w, present, list(missing)),
        ), missing


# -- mesh-lane byte identity --------------------------------------------------


@pytest.mark.usefixtures("device_lane")
class TestMeshLaneBytes:
    """Dispatcher mesh-lane outputs bit-identical to the per-op oracle
    (ec_util, and the reference's) across bucket boundaries, uneven
    ΣS % mesh_size remainders, and w=16 codecs."""

    @pytest.mark.parametrize("sizes", [
        [1, 2],          # ΣS=3: uneven remainder vs any mesh size
        [5, 3],          # ΣS=8: snug on an 8-lane mesh
        [7, 6, 4],       # ΣS=17: crosses the 16-stripe bucket boundary
    ])
    def test_encode_identical_mixed_sizes(self, sizes):
        sinfo, codec = _sinfo(2), _codec(2, 1)
        bufs = _bufs(sinfo, sizes, seed=21)
        eng = _engine()

        async def main():
            disp = ECDispatcher(window=0.005, max_stripes=1 << 20,
                                mesh_engine=eng)
            outs = await asyncio.gather(
                *[disp.encode(sinfo, codec, b) for b in bufs]
            )
            st = disp.dump()
            await disp.stop()
            return outs, st

        outs, st = run(main())
        assert st["totals"]["lanes"]["mesh"]["batches"] >= 1
        assert st["totals"]["lanes"]["device"]["batches"] == 0
        # every mesh-lane launch was mesh-size aligned
        quantum = np.prod(eng.mesh_key(2))
        assert all(int(b) % quantum == 0 for b in st["mesh_buckets"])
        for b, got in zip(bufs, outs):
            _assert_same_shards(got, ec_util.encode(sinfo, codec, b))
            _assert_same_shards(got, _ref_encode(sinfo, 2, 1, 8, b))

    def test_decode_identical_through_mesh_lane(self):
        k, m = 2, 1
        sinfo, codec = _sinfo(k), _codec(k, m)
        bufs = _bufs(sinfo, [3, 5], seed=22)
        shard_sets = []
        for b in bufs:
            full = ec_util.encode(sinfo, codec, b)
            shard_sets.append(
                {s: np.asarray(v) for s, v in full.items() if s != 0}
            )

        async def main():
            disp = ECDispatcher(window=0.005, max_stripes=1 << 20,
                                mesh_engine=_engine())
            outs = await asyncio.gather(
                *[disp.decode_concat(sinfo, codec, sv)
                  for sv in shard_sets]
            )
            st = disp.dump()
            await disp.stop()
            return outs, st

        outs, st = run(main())
        assert st["totals"]["lanes"]["mesh"]["batches"] >= 1
        for b, got in zip(bufs, outs):
            assert bytes(got) == b.tobytes()

    def test_decode_without_missing_rows_skips_mesh(self):
        """All wanted rows present -> no reconstruct -> the mesh lane
        does not apply."""
        sinfo, codec = _sinfo(2), _codec(2, 1)
        (buf,) = _bufs(sinfo, [2], seed=23)
        full = ec_util.encode(sinfo, codec, buf)
        present = {s: np.asarray(v) for s, v in full.items()}

        async def main():
            disp = ECDispatcher(window=0.001, max_stripes=1 << 20,
                                mesh_engine=_engine())
            out = await disp.decode_concat(sinfo, codec, present)
            st = disp.dump()
            await disp.stop()
            return out, st

        out, st = run(main())
        assert bytes(out) == buf.tobytes()
        assert st["totals"]["lanes"]["mesh"]["batches"] == 0

    def test_w16_codec_identical(self):
        k, m = 4, 2
        sinfo, codec = _sinfo(k), _codec(k, m, w=16)
        bufs = _bufs(sinfo, [2, 3], seed=24)
        eng = _engine()
        assert eng.routes(sinfo, codec)

        async def main():
            disp = ECDispatcher(window=0.005, max_stripes=1 << 20,
                                mesh_engine=eng)
            outs = await asyncio.gather(
                *[disp.encode(sinfo, codec, b) for b in bufs]
            )
            # degraded read through the mesh reconstruct
            sv = {s: np.asarray(v) for s, v in outs[0].items() if s > 1}
            dec = await disp.decode_concat(sinfo, codec, sv)
            await disp.stop()
            return outs, dec

        outs, dec = run(main())
        for b, got in zip(bufs, outs):
            _assert_same_shards(got, ec_util.encode(sinfo, codec, b))
            _assert_same_shards(got, _ref_encode(sinfo, k, m, 16, b))
        assert bytes(dec) == bufs[0].tobytes()

    def test_mesh_lane_outranks_native_direct(self, monkeypatch):
        """osd_ec_mesh is an explicit operator opt-in: with the native
        C engine available the mesh still takes the lane."""
        monkeypatch.undo()  # the real gate: the native engine is on
        if not native.host_engine_active("cpu"):
            pytest.skip("native engine unavailable on this host")
        sinfo, codec = _sinfo(2), _codec(2, 1)
        (buf,) = _bufs(sinfo, [2], seed=25)

        async def main():
            disp = ECDispatcher(window=0.001, max_stripes=1 << 20,
                                mesh_engine=_engine())
            out = await disp.encode(sinfo, codec, buf)
            st = disp.dump()
            await disp.stop()
            return out, st

        out, st = run(main())
        assert st["totals"]["lanes"]["mesh"]["batches"] == 1
        assert st["totals"]["native_direct"] == 0
        _assert_same_shards(out, ec_util.encode(sinfo, codec, buf))

    def test_unaligned_chunk_size_stays_off_the_mesh(self):
        eng = _engine()
        codec = _codec(2, 1)
        assert eng.routes(_sinfo(2), codec)
        assert not eng.routes(
            ec_util.StripeInfo(stripe_width=12, chunk_size=6), codec
        )
        ref_codec = _ref_codec(2, 1)
        assert _ref_engine().routes(_sinfo(2), ref_codec)
        assert not _ref_engine().routes(
            ref_ec_util.StripeInfo(stripe_width=12, chunk_size=6), ref_codec
        )


def test_one_lane_routing_equals_the_references(device_lane):
    """On a one-lane mesh (one card) the dispatcher routes as the
    reference's does on one device: the same lanes, batches, mesh
    buckets and ``mesh_route`` answers for an encode, a degraded decode,
    a decode with every row present, a SHEC codec and an unaligned
    chunk size."""
    sinfo = _sinfo(2)
    odd = ec_util.StripeInfo(stripe_width=12, chunk_size=6)
    shec = registry.instance().factory("shec", {"k": "4", "m": "3", "c": "2"},
                                       device="cpu")
    shec_sinfo = _sinfo(4)
    buf, odd_buf, shec_buf = (_bufs(sinfo, [3], seed=40)[0],
                              np.arange(36, dtype=np.uint8),
                              _bufs(shec_sinfo, [2], seed=41)[0])

    async def drive(disp, codec, shec_codec, si, odd_si, shec_si):
        full = await disp.encode(si, codec, buf)
        lost = {s: np.asarray(v) for s, v in full.items() if s != 0}
        whole = {s: np.asarray(v) for s, v in full.items()}
        got = [bytes(await disp.decode_concat(si, codec, lost)),
               bytes(await disp.decode_concat(si, codec, whole))]
        await disp.encode(odd_si, codec, odd_buf)
        await disp.encode(shec_si, shec_codec, shec_buf)
        routes = [disp.mesh_route(si, codec),
                  disp.mesh_route(si, codec, missing=False),
                  disp.mesh_route(odd_si, codec),
                  disp.mesh_route(shec_si, shec_codec)]
        st = disp.dump()
        await disp.stop()
        return got, routes, st["totals"]["lanes"], st["mesh_buckets"], \
            st["buckets"], st["mesh_lane"]

    port = run(drive(ECDispatcher(window=0.001, mesh_engine=_engine(1)),
                     _codec(2, 1), shec, sinfo, odd, shec_sinfo))
    rs = lambda si: ref_ec_util.StripeInfo(si.stripe_width, si.chunk_size)  # noqa: E731
    from ceph_tpu.models import registry as ref_registry

    ref = run(drive(ref_ec_dispatch.ECDispatcher(window=0.001,
                                                 mesh_engine=_ref_engine(1)),
                    _ref_codec(2, 1),
                    ref_registry.instance().factory(
                        "shec", {"k": "4", "m": "3", "c": "2"}),
                    rs(sinfo), rs(odd), rs(shec_sinfo)))
    assert port == ref
    assert port[0] == [buf.tobytes()] * 2
    assert port[1] == [True, False, False, False]
    assert port[2]["mesh"]["batches"] == 2


# -- mid-batch cancellation on the mesh route ---------------------------------


def test_cancelled_waiter_does_not_wedge_mesh_batch(device_lane):
    sinfo, codec = _sinfo(2), _codec(2, 1)
    buf_a, buf_b = _bufs(sinfo, [1, 4], seed=26)

    async def main():
        disp = ECDispatcher(window=30.0, max_stripes=4,
                            mesh_engine=_engine())
        task_a = asyncio.ensure_future(disp.encode(sinfo, codec, buf_a))
        await asyncio.sleep(0)  # let A enqueue
        task_a.cancel()
        await asyncio.sleep(0)  # let the cancellation land on A
        out_b = await disp.encode(sinfo, codec, buf_b)  # size-flushes
        with pytest.raises(asyncio.CancelledError):
            await task_a
        st = disp.dump()
        await disp.stop()
        return out_b, st

    out_b, st = run(main())
    assert st["totals"]["cancelled"] == 1
    assert st["totals"]["lanes"]["mesh"]["ops"] == 1  # only B launched
    _assert_same_shards(out_b, ec_util.encode(sinfo, codec, buf_b))


# -- prime-k reconstruct fallback ---------------------------------------------


class TestPrimeKFallback:
    """gcd(k, n_devices) == 1: the 'shard' axis degenerates to 1 and
    the reconstruct must gather over 'pg' instead (k=7 on 4 lanes),
    with the reference's bytes."""

    def test_k7_on_4_devices_reconstructs(self):
        k, m = 7, 2
        eng = _engine(4)
        _mesh, pg, shard = eng.mesh_for(k)
        assert (pg, shard) == (4, 1)
        assert eng.reconstruct_axis(k) == "pg"
        codec = _codec(k, m)
        sinfo = _sinfo(k)
        (buf,) = _bufs(sinfo, [3], seed=27)
        full = ec_util.encode(sinfo, codec, buf)
        # two erasures: one data, one parity survivor mix
        surv = {s: np.asarray(v) for s, v in full.items()
                if s not in (0, 8)}
        host = ec_util.decode_concat(sinfo, codec, surv)
        mesh = eng.decode_concat(sinfo, codec, surv)
        ref = _ref_engine(4).decode_concat(
            ref_ec_util.StripeInfo(sinfo.stripe_width, CS),
            _ref_codec(k, m), surv)
        assert bytes(host) == bytes(mesh) == bytes(ref) == buf.tobytes()

    def test_k7_encode_matches_oracle(self):
        k, m = 7, 2
        eng = _engine(4)
        codec, sinfo = _codec(k, m), _sinfo(k)
        (buf,) = _bufs(sinfo, [5], seed=28)
        got = eng.encode(sinfo, codec, buf)
        _assert_same_shards(got, ec_util.encode(sinfo, codec, buf))
        _assert_same_shards(got, _ref_engine(4).encode(
            ref_ec_util.StripeInfo(sinfo.stripe_width, CS),
            _ref_codec(k, m), buf))

    def test_even_k_keeps_shard_axis(self):
        eng = _engine(4)
        assert eng.reconstruct_axis(8) == "shard"
        assert _ref_engine(4).reconstruct_axis(8) == "shard"


# -- the launch-shape gate on the mesh lane -----------------------------------


def test_mesh_size_sweep_jit_misses_bounded(device_lane):
    """50 distinct op sizes through the mesh lane cost at most
    #buckets x #mesh-slices mesh_encode signatures — the
    mesh_size x bucket alignment rule."""
    # a geometry no other case uses, so profiler signatures are fresh
    k, m = 3, 2
    sinfo = ec_util.StripeInfo(stripe_width=256 * k, chunk_size=256)
    codec = _codec(k, m)
    sizes = list(range(1, 51))
    bufs = _bufs(sinfo, sizes, seed=29)
    eng = _engine()
    quantum = int(np.prod(eng.mesh_key(k)))

    def _misses():
        e = profiler().dump().get("engines", {}).get("mesh_encode")
        return e["jit_cache"]["misses"] if e else 0

    before = _misses()

    async def main():
        # window 0 + per-op awaits: every op launches its own batch, so
        # the SWEEP (not coalescing) is what exercises the bucket table
        disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                            mesh_engine=eng)
        outs = []
        for b in bufs:
            outs.append(await disp.encode(sinfo, codec, b))
        st = disp.dump()
        await disp.stop()
        return outs, st

    outs, st = run(main())
    n_buckets = len({
        bucket_stripes_aligned(s, quantum) for s in sizes
    })
    mesh_slices = 1  # one codec, one geometry -> one (pg, shard) slice
    misses = _misses() - before
    assert 1 <= misses <= n_buckets * mesh_slices, (
        f"{misses} mesh signatures for {len(sizes)} sizes "
        f"(bound {n_buckets} x {mesh_slices})"
    )
    assert all(int(b) % quantum == 0 for b in st["mesh_buckets"])
    assert st["totals"]["lanes"]["mesh"]["pad_stripes"] > 0
    for b, got in zip(bufs[::7], outs[::7]):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))


# -- profiler visibility ------------------------------------------------------


def test_mesh_programs_distinct_in_kernel_profile(device_lane):
    k, m = 2, 1
    sinfo, codec = _sinfo(k, cs=1024), _codec(k, m)
    (buf,) = _bufs(sinfo, [4], seed=30)
    eng = _engine()
    out = eng.encode(sinfo, codec, buf)
    surv = {s: np.asarray(v) for s, v in out.items() if s != 0}
    assert eng.decode_concat(sinfo, codec, surv) == buf.tobytes()
    dump = profiler().dump()
    assert "mesh_encode" in dump["engines"]
    assert "mesh_reconstruct" in dump["engines"]
    enc = dump["engines"]["mesh_encode"]
    assert enc["calls"] >= 1
    # a first sighting is a recorded miss
    assert enc["jit_cache"]["misses"] >= 1
    # the prefix filter serves the mesh family alone
    only = profiler().dump(prefix="mesh")["engines"]
    assert only and all(n.startswith("mesh") for n in only)
    # ...and the per-engine histograms ride dump_histograms like every
    # other engine family
    assert "mesh_encode" in profiler().dump_histograms()


def test_gather_probe_reports_own_engine():
    eng = _engine()
    n = len(eng.devices)
    assert n == 8
    eng.probe_gather(8, 4 * n * 8)
    _ref_engine().probe_gather(8, 4 * n * 8)
    assert "mesh_gather" in profiler().dump()["engines"]
    # k=2 on 8 lanes splits the bytes 4 ways: 17 bytes do not split
    for e in (_engine(), _ref_engine()):
        with pytest.raises(ValueError):
            e.probe_gather(2, 17)


# -- mesh-lane failover (deterministic, dispatcher level) ---------------------


def test_mesh_lane_failover_replays_bit_identical(device_lane):
    """A fatal device error mid-mesh-batch replays the whole batch on
    the host fallback (no waiter sees the error, bytes identical) and
    the supervisor attributes the fatal to the mesh lane."""
    from ceph_tpu_torch.osd.ec_failover import EngineSupervisor

    sinfo, codec = _sinfo(2), _codec(2, 1)
    bufs = _bufs(sinfo, [2, 3], seed=31)
    sup = EngineSupervisor(enabled=True, probe_interval=30.0)

    async def main():
        disp = ECDispatcher(window=0.005, max_stripes=1 << 20,
                            mesh_engine=_engine(), supervisor=sup)
        disp.inject_engine_failure = 1  # every device launch dies
        outs = await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs]
        )
        st = disp.dump()
        await disp.stop()
        return outs, st

    outs, st = run(main())
    assert st["totals"]["failovers"] >= 1
    assert st["totals"]["replayed_ops"] == 2
    for b, got in zip(bufs, outs):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))
    assert sup.last_failure_lane == "mesh"
    assert sup.totals["mesh_fatal_errors"] >= 1


# -- live fault matrix: device loss mid-mesh-batch ----------------------------


class TestMeshFaultMatrix:
    def test_injected_loss_mid_mesh_batch_zero_failed_ops(self, device_lane):
        """Injected device loss mid-mesh-batch replays on the host
        fallback with ZERO failed client ops on a live MiniCluster; the
        canary re-promotes the mesh after the injection lifts."""
        from ceph_tpu_torch.osd.ec_failover import HEALTHY
        from ceph_tpu_torch.rados import MiniCluster

        async def main():
            async with MiniCluster(
                n_osds=4, device="cpu",
                config_overrides={
                    "osd_ec_mesh": True,
                    "osd_ec_probe_interval": 0.05,
                },
            ) as cluster:
                cl = await cluster.client()
                await cl.create_pool("ec", "erasure")  # isa k2m1
                io = cl.io_ctx("ec")
                model: dict[str, bytes] = {}

                async def storm(round_no: int, n: int = 8):
                    async def put(i):
                        data = bytes([round_no, i]) * (400 + 97 * i)
                        await io.write_full(f"o{i}", data)
                        model[f"o{i}"] = data
                    await asyncio.gather(*[put(i) for i in range(n)])

                def counters(key):
                    return sum(
                        osd.perf.get("ec").get(key)
                        for osd in cluster.osds.values()
                    )

                await storm(0)  # baseline: the mesh lane serves
                assert counters("mesh_batches") > 0
                assert counters("mesh_encode_calls") > 0

                for osd in cluster.osds.values():
                    osd.config.set("ec_inject_engine_failure", 1)
                await storm(1)  # NO op may fail
                assert counters("engine_failovers") > 0
                assert counters("replayed_ops") > 0
                # the replayed bytes read back bit-identical
                for name, want in model.items():
                    assert await io.read(name) == want, name
                # lift the injection: the canary probes the lane that
                # tripped and re-promotes
                for osd in cluster.osds.values():
                    osd.config.set("ec_inject_engine_failure", 0)
                async with asyncio.timeout(20):
                    while any(
                        osd.ec_supervisor.state != HEALTHY
                        for osd in cluster.osds.values()
                    ):
                        await asyncio.sleep(0.05)
                # recovered: a fresh storm runs clean on the mesh lane
                before = counters("engine_failovers")
                mesh_before = counters("mesh_batches")
                await storm(2)
                assert counters("engine_failovers") == before
                assert counters("mesh_batches") > mesh_before
                for name, want in model.items():
                    assert await io.read(name) == want, name

        run(main())
