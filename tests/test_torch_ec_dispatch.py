"""The port's EC microbatch dispatcher (ceph_tpu_torch.osd.ec_dispatch),
twin of tests/test_ec_dispatch.py, on device="cpu" codecs.

Pins the dispatcher's whole contract:
- bytes identical to per-op ec_util.encode/decode_concat (the numpy
  oracle underneath) across mixed op sizes and bucket-boundary sizes;
- flush-on-threshold vs flush-on-window policy, including the
  no-overshoot rule (a batch never pads past its bucket because one
  more op arrived);
- a cancelled (op-aborted) waiter is dropped without wedging the batch;
- the event loop keeps ticking while a long encode runs (liberation);
- the launch-shape gate: a 50-way size sweep costs at most O(#buckets)
  profiler misses, not O(#distinct sizes);
- ``dump()`` and the ``ec`` perf family have the reference's shape.

"The device lane" below is the port's gate patched off
(``native.host_engine_active``), so a CPU codec takes the dispatcher's
batching lane and the plain torch versions of the kernels; unpatched, a
CPU codec takes the native C direct lane.  The OSD integration test of
the reference waits for the port's OSD wiring (ROADMAP Queue A item 6).
"""

import asyncio
import time

import numpy as np
import pytest

from ceph_tpu.osd import ec_dispatch as ref_ec_dispatch
from ceph_tpu.osd import ec_perf as ref_ec_perf
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.models.matrix_codec import MatrixErasureCode as RefMatrixErasureCode
from ceph_tpu.common.perf_counters import PerfCountersCollection as RefCollection

from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.ops import matrices as mx
from ceph_tpu_torch.ops.profiler import profiler
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher, bucket_stripes
from ceph_tpu_torch.osd.ec_perf import create_ec_perf
from ceph_tpu_torch.utils import native


def run(coro):
    return asyncio.run(coro)


CS = 512  # chunk_size; stripe_width = k * CS


def _sinfo(k: int) -> ec_util.StripeInfo:
    return ec_util.StripeInfo(stripe_width=CS * k, chunk_size=CS)


def _codec(k: int = 2, m: int = 1) -> MatrixErasureCode:
    return MatrixErasureCode(k, m, 8, mx.isa_rs_vandermonde(k, m), device="cpu")


def _force_device_lane(monkeypatch):
    monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)


def _bufs(sinfo, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 256, size=(s * sinfo.stripe_width,),
                     dtype=np.uint8)
        for s in sizes
    ]


def _assert_same_shards(got, want):
    assert set(got) == set(want)
    for s in want:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s])), (
            f"shard {s} diverged"
        )


def test_bucket_stripes_boundaries():
    assert [bucket_stripes(s) for s in (1, 2, 3, 4, 5, 8, 9, 1023)] == \
        [1, 2, 4, 4, 8, 8, 16, 1024]


# -- byte identity vs the per-op oracle --------------------------------------


@pytest.mark.parametrize("force_device", [False, True])
def test_encode_bytes_identical_mixed_sizes(monkeypatch, force_device):
    """Coalesced output == per-op ec_util.encode == the reference's
    ec_util.encode, on both engine routes (native C direct lane, and
    the device batch+bucket path)."""
    if force_device:
        _force_device_lane(monkeypatch)
    k, m = 2, 1
    sinfo, codec = _sinfo(k), _codec(k, m)
    sizes = [1, 2, 3, 4, 5, 7, 8, 9]
    bufs = _bufs(sinfo, sizes)

    async def main():
        disp = ECDispatcher(window=0.005, max_stripes=1 << 20)
        outs = await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs]
        )
        await disp.stop()
        return outs

    outs = run(main())
    ref_sinfo = ref_ec_util.StripeInfo(sinfo.stripe_width, CS)
    ref_codec = RefMatrixErasureCode(k, m, 8, mx.isa_rs_vandermonde(k, m))
    for b, got in zip(bufs, outs):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))
        _assert_same_shards(got, ref_ec_util.encode(ref_sinfo, ref_codec, b))


@pytest.mark.parametrize("stripes", [1, 8, 9, 16, 17])
def test_encode_bucket_boundary_sizes(monkeypatch, stripes):
    """S=1, S=2^n, S=2^n+1 single-op batches survive the pad+slice."""
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    (buf,) = _bufs(sinfo, [stripes], seed=stripes)

    async def main():
        disp = ECDispatcher(window=0.0, max_stripes=1 << 20)
        out = await disp.encode(sinfo, codec, buf)
        await disp.stop()
        return out

    _assert_same_shards(run(main()), ec_util.encode(sinfo, codec, buf))


@pytest.mark.parametrize("force_device", [False, True])
def test_decode_bytes_identical(monkeypatch, force_device):
    """Coalesced decode_concat == per-op ec_util.decode_concat for a
    degraded read (data shard missing) across mixed sizes, and the
    dispatcher's lane count says how it was served."""
    if force_device:
        _force_device_lane(monkeypatch)
    k, m = 2, 1
    sinfo, codec = _sinfo(k), _codec(k, m)
    sizes = [1, 2, 4, 5]
    bufs = _bufs(sinfo, sizes, seed=3)
    # survivors: drop data shard 0 everywhere -> same present set, so
    # the requests share one queue key and truly coalesce
    chunk_maps = []
    for b in bufs:
        enc = ec_util.encode(sinfo, codec, b)
        chunk_maps.append({1: enc[1], 2: enc[2]})

    async def main():
        disp = ECDispatcher(window=0.005, max_stripes=1 << 20)
        outs = await asyncio.gather(
            *[disp.decode_concat(sinfo, codec, c) for c in chunk_maps]
        )
        st = disp.dump()
        await disp.stop()
        return outs, st

    outs, st = run(main())
    for b, c, got in zip(bufs, chunk_maps, outs):
        assert got == ec_util.decode_concat(sinfo, codec, c)
        assert got == b.tobytes()
    if force_device:  # all four requests coalesced into one launch
        assert st["totals"]["batches"] == 1
        assert st["totals"]["ops"] == 4
        assert st["totals"]["native_direct"] == 0
    else:
        assert st["totals"]["native_direct"] == 4


# -- flush policy ------------------------------------------------------------


def test_flush_on_threshold_beats_window(monkeypatch):
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    bufs = _bufs(sinfo, [2, 2], seed=1)

    async def main():
        # window absurdly long: only the size threshold can flush
        disp = ECDispatcher(window=30.0, max_stripes=4)
        t0 = time.monotonic()
        outs = await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs]
        )
        took = time.monotonic() - t0
        st = disp.dump()
        await disp.stop()
        return outs, st, took

    outs, st, took = run(main())
    assert took < 5.0  # did NOT wait for the 30 s window
    assert st["totals"]["flush_reasons"]["size"] == 1
    assert st["totals"]["flush_reasons"]["window"] == 0
    assert st["totals"]["batches"] == 1 and st["totals"]["ops"] == 2
    for b, got in zip(bufs, outs):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))


def test_flush_on_window(monkeypatch):
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    (buf,) = _bufs(sinfo, [2], seed=2)

    async def main():
        # threshold unreachable: only the window can flush
        disp = ECDispatcher(window=0.01, max_stripes=1 << 20)
        out = await disp.encode(sinfo, codec, buf)
        st = disp.dump()
        await disp.stop()
        return out, st

    out, st = run(main())
    assert st["totals"]["flush_reasons"]["window"] == 1
    assert st["totals"]["flush_reasons"]["size"] == 0
    _assert_same_shards(out, ec_util.encode(sinfo, codec, buf))


def test_no_bucket_overshoot(monkeypatch):
    """An op that would push the batch past the threshold flushes the
    queued ops at their snug bucket first — pad waste stays bounded by
    the bucket below max_stripes, not doubled past it."""
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    # 3+3 stripes fill toward max_stripes=4: admitting the second op
    # would make 6 -> bucket 8 (100% overshoot); instead op 1 launches
    # at bucket 4 and op 2 at bucket 4
    bufs = _bufs(sinfo, [3, 3], seed=4)

    async def main():
        disp = ECDispatcher(window=0.01, max_stripes=4)
        outs = await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs]
        )
        st = disp.dump()
        await disp.stop()
        return outs, st

    outs, st = run(main())
    assert st["totals"]["batches"] == 2
    assert set(st["buckets"]) == {"4"}
    assert st["totals"]["pad_stripes"] == 2  # 1 per 3-stripe launch
    for b, got in zip(bufs, outs):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))


def test_cancelled_waiter_does_not_wedge_batch(monkeypatch):
    """Op abort: a cancelled queued waiter is dropped; the surviving
    ops' batch still launches and answers."""
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    buf_a, buf_b = _bufs(sinfo, [1, 4], seed=5)

    async def main():
        disp = ECDispatcher(window=30.0, max_stripes=4)
        task_a = asyncio.ensure_future(disp.encode(sinfo, codec, buf_a))
        await asyncio.sleep(0)  # let A enqueue
        task_a.cancel()
        await asyncio.sleep(0)  # let the cancellation land on A's future
        out_b = await disp.encode(sinfo, codec, buf_b)  # size-flushes
        with pytest.raises(asyncio.CancelledError):
            await task_a
        st = disp.dump()
        await disp.stop()
        return out_b, st

    out_b, st = run(main())
    assert st["totals"]["cancelled"] == 1
    assert st["totals"]["ops"] == 1  # only B was launched
    _assert_same_shards(out_b, ec_util.encode(sinfo, codec, buf_b))


def test_batch_failure_reaches_every_waiter(monkeypatch):
    """A codec blowing up inside the worker thread rejects all waiters
    instead of wedging them."""
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    bufs = _bufs(sinfo, [1, 2], seed=6)

    def boom(*a, **kw):
        raise RuntimeError("device on fire")

    async def main():
        disp = ECDispatcher(window=0.005, max_stripes=1 << 20)
        monkeypatch.setattr(ec_util, "encode", boom)
        res = await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs],
            return_exceptions=True,
        )
        await disp.stop()
        return res

    res = run(main())
    assert len(res) == 2
    assert all(isinstance(r, RuntimeError) for r in res)


# -- event-loop liberation ---------------------------------------------------


def test_event_loop_survives_long_encode(monkeypatch):
    """The liberation bound: while a (deliberately slow) encode runs in
    the dispatcher's worker thread, the event loop keeps scheduling —
    the heartbeat-tick survival property, measured as max loop stall."""
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    (buf,) = _bufs(sinfo, [2], seed=7)

    real_encode = ec_util.encode

    def slow_encode(*a, **kw):
        time.sleep(0.6)  # a long device call, in the worker thread
        return real_encode(*a, **kw)

    monkeypatch.setattr(ec_util, "encode", slow_encode)

    async def main():
        disp = ECDispatcher(window=0.0, max_stripes=1 << 20)
        gaps = []

        async def ticker():
            last = time.monotonic()
            while True:
                await asyncio.sleep(0.01)
                now = time.monotonic()
                gaps.append(now - last)
                last = now

        t = asyncio.ensure_future(ticker())
        out = await disp.encode(sinfo, codec, buf)
        t.cancel()
        await disp.stop()
        return out, max(gaps)

    out, worst_stall = run(main())
    _assert_same_shards(out, real_encode(sinfo, codec, buf))
    # the encode slept 0.6 s; a blocked loop would show a ~0.6 s gap
    # (threshold leaves headroom for scheduler noise on loaded hosts)
    assert worst_stall < 0.35, (
        f"event loop stalled {worst_stall:.3f}s behind the encode"
    )


# -- the anti-compile-storm gate ---------------------------------------------


def test_size_sweep_jit_misses_bounded_by_buckets(monkeypatch):
    """50 distinct op sizes through the dispatcher cost at most
    #buckets launch signatures (the port profiler's first-sighting
    misses on ``ec_shards``), not 50 — what the bucketing exists for."""
    _force_device_lane(monkeypatch)
    # a geometry no other test uses, so profiler signatures are fresh
    k, m = 5, 2
    sinfo = ec_util.StripeInfo(stripe_width=256 * k, chunk_size=256)
    codec = _codec(k, m)
    sizes = list(range(1, 51))
    bufs = _bufs(sinfo, sizes, seed=8)

    def _misses():
        eng = profiler().dump()["engines"].get("ec_shards")
        return eng["jit_cache"]["misses"] if eng else 0

    before = _misses()

    async def main():
        # window 0 + per-op awaits: every op launches its own batch, so
        # the SWEEP (not coalescing) is what exercises the bucket table
        disp = ECDispatcher(window=0.0, max_stripes=1 << 20)
        for b in bufs:
            await disp.encode(sinfo, codec, b)
        st = disp.dump()
        await disp.stop()
        return st

    st = run(main())
    n_buckets = len({bucket_stripes(s) for s in sizes})  # 1..64 -> 7
    misses = _misses() - before
    assert 1 <= misses <= n_buckets, (
        f"{misses} jit signatures for {len(sizes)} sizes "
        f"(bucket count {n_buckets})"
    )
    assert set(int(b) for b in st["buckets"]) <= \
        {bucket_stripes(s) for s in sizes}
    assert st["totals"]["pad_stripes"] > 0  # bucketing actually padded


# -- perf-counter wiring -----------------------------------------------------


def test_perf_counters_and_histogram_land(monkeypatch):
    _force_device_lane(monkeypatch)
    from ceph_tpu_torch.common.perf_counters import (
        PerfCounters, PerfHistogramAxis,
    )

    pec = PerfCounters("ec")
    pec.add_gauge("encode_gbps").add_gauge("decode_gbps")
    pec.add_counter("dispatch_batches").add_counter("dispatch_ops")
    pec.add_counter("dispatch_cancelled")
    pec.add_counter("dispatch_flush_size")
    pec.add_counter("dispatch_flush_window")
    pec.add_counter("dispatch_flush_stop")
    pec.add_counter("dispatch_pad_stripes")
    pec.add_counter("dispatch_pad_bytes")
    pec.add_counter("dispatch_native_direct")
    pec.add_avg("dispatch_occupancy")
    pec.add_histogram(
        "dispatch_batch_size_histogram",
        axes=[PerfHistogramAxis("ops", min=1.0, buckets=12)],
    )
    # per-lane split: the device lane feeds its own series
    pec.add_counter("dispatch_batches_device")
    pec.add_counter("dispatch_ops_device")
    pec.add_counter("dispatch_pad_stripes_device")
    pec.add_counter("dispatch_pad_bytes_device")
    pec.add_avg("dispatch_occupancy_device")
    pec.add_histogram(
        "dispatch_batch_size_device_histogram",
        axes=[PerfHistogramAxis("ops", min=1.0, buckets=12)],
    )
    sinfo, codec = _sinfo(2), _codec()
    bufs = _bufs(sinfo, [3, 5], seed=9)

    async def main():
        disp = ECDispatcher(perf=pec, window=0.005, max_stripes=8)
        await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs]
        )
        await disp.stop()

    run(main())
    d = pec.dump()
    assert d["dispatch_batches"] == 1
    assert d["dispatch_ops"] == 2
    assert d["dispatch_flush_size"] == 1
    assert d["dispatch_pad_stripes"] == 0  # 3+5 = 8, an exact bucket
    assert d["dispatch_occupancy"]["avgcount"] == 1
    assert d["dispatch_batch_size_histogram"]["histogram"]["count"] == 1
    # the per-lane split attributes the launch to the device route
    assert d["dispatch_batches_device"] == 1
    assert d["dispatch_ops_device"] == 2
    assert d["dispatch_occupancy_device"]["avgcount"] == 1
    assert (d["dispatch_batch_size_device_histogram"]["histogram"]
            ["count"] == 1)


def test_native_direct_lane(monkeypatch):
    """With the native C engine active, requests skip coalescing but
    still run in the worker pool (and are counted)."""
    if not native.host_engine_active("cpu"):
        pytest.skip("native engine unavailable on this host")
    sinfo, codec = _sinfo(2), _codec()
    bufs = _bufs(sinfo, [2, 3], seed=10)

    async def main():
        disp = ECDispatcher(window=30.0, max_stripes=4)
        outs = await asyncio.gather(
            *[disp.encode(sinfo, codec, b) for b in bufs]
        )
        st = disp.dump()
        await disp.stop()
        return outs, st

    outs, st = run(main())
    assert st["totals"]["native_direct"] == 2
    assert st["totals"]["batches"] == 0  # nothing queued
    for b, got in zip(bufs, outs):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))


# -- the shape of the admin surfaces ------------------------------------------


def _shape(d):
    """Keys of nested dicts, leaves replaced by their type's name."""
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    return type(d).__name__


def test_dump_has_the_reference_shape(monkeypatch):
    """``dump()`` keeps all three lane rows, the two bucket tables and
    the config block: the same keys as the reference's on the same
    traffic."""
    _force_device_lane(monkeypatch)
    monkeypatch.setattr(ref_ec_dispatch.ec_util.native, "host_engine_active",
                        lambda: False)
    sinfo = _sinfo(2)
    ref_sinfo = ref_ec_util.StripeInfo(sinfo.stripe_width, CS)
    bufs = _bufs(sinfo, [1, 3], seed=11)

    async def main(disp, si, codec):
        await asyncio.gather(*[disp.encode(si, codec, b) for b in bufs])
        st = disp.dump()
        await disp.stop()
        return st

    port = run(main(ECDispatcher(window=0.005), sinfo, _codec()))
    ref = run(main(ref_ec_dispatch.ECDispatcher(window=0.005), ref_sinfo,
                   RefMatrixErasureCode(2, 1, 8, mx.isa_rs_vandermonde(2, 1))))
    assert _shape(port) == _shape(ref)
    assert port["totals"] == ref["totals"]
    assert set(port["totals"]["lanes"]) == {"device", "mesh", "remote"}
    assert port["buckets"] == ref["buckets"] == {"4": 1}


def test_ec_perf_family_matches_reference():
    """create_ec_perf registers the reference's keys, types and axes."""
    port, ref = PerfCountersCollection(), RefCollection()
    create_ec_perf(port)
    ref_ec_perf.create_ec_perf(ref)
    assert port.schema() == ref.schema()
    assert _shape(port.dump()) == _shape(ref.dump())


@pytest.mark.parametrize("name", ["mesh_engine", "remote"])
def test_unported_lanes_refuse(name):
    """The mesh lane is refused until it is ported (Queue A item 8).
    The remote lane is ported; it refuses only an object that is not a
    remote-lane client (tests/test_torch_accel_service.py drives it)."""
    match = "Queue A item" if name == "mesh_engine" else "remote-lane client"
    with pytest.raises(ValueError, match=match):
        ECDispatcher(**{name: object()})


# -- QoS pacing and the worker threads ----------------------------------------


class _Scheduler:
    """Duck-typed QoS scheduler: records each pace() call."""

    def __init__(self):
        self.paced = []

    async def pace(self, klass, cost):
        self.paced.append((klass, cost))
        await asyncio.sleep(0)


def test_background_stripes_pace_and_classes_never_share_a_launch(monkeypatch):
    _force_device_lane(monkeypatch)
    sinfo, codec = _sinfo(2), _codec()
    bufs = _bufs(sinfo, [2, 3, 1], seed=12)
    sched = _Scheduler()

    async def main():
        disp = ECDispatcher(window=0.005, max_stripes=1 << 20, scheduler=sched)
        outs = await asyncio.gather(
            disp.encode(sinfo, codec, bufs[0]),
            disp.encode(sinfo, codec, bufs[1], klass="recovery"),
            disp.encode(sinfo, codec, bufs[2], klass="recovery"),
        )
        st = disp.dump()
        flights = disp.flight.dump()["launches"]
        await disp.stop()
        return outs, st, flights

    outs, st, flights = run(main())
    assert sched.paced == [("recovery", 3.0), ("recovery", 1.0)]  # client ops pass
    assert st["totals"]["batches"] == 2
    assert sorted((f["klass"], f["ops"]) for f in flights) == [("client", 1), ("recovery", 2)]
    for b, got in zip(bufs, outs):
        _assert_same_shards(got, ec_util.encode(sinfo, codec, b))


def test_launch_counts_survive_concurrent_workers():
    """The dispatcher's worker threads bump the kernels' launch counts
    at once: no update may be lost (the counts gate chip_smoke.py)."""
    import sys
    import threading

    from ceph_tpu_torch.ops import gf_cuda

    before = gf_cuda.launches["gf_matmul"]
    per_thread, threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [gf_cuda._launched("gf_matmul", 0)
                                                    for _ in range(per_thread)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert gf_cuda.launches["gf_matmul"] - before == per_thread * threads
