"""The port's accelerator fault domain (ceph_tpu_torch.osd.ec_failover
and the dispatcher's failover), twin of tests/test_ec_failover.py's
TestClassification, TestHostFallbackEngine, TestDispatcherFailover,
TestLaunchDeadline and TestRepromotion, on device="cpu" codecs.

Pins the contract:
- failure classification: CUDA errors / OOM / kernel build or launch
  failures / the injected fault are fatal (trip + replay), data-shape
  errors surface to the caller;
- host fallback engines are bit-identical to the device engines
  (matrix w=8/w=16, bitmatrix, LRC and SHEC codecs), and to the
  reference's;
- a fatal error mid-batch replays the in-flight batch on the fallback —
  no waiter ever sees a device error — and advances the breaker
  HEALTHY -> SUSPECT -> TRIPPED;
- while TRIPPED, requests route around the device, and the canary probe
  re-promotes once the fault lifts;
- a HUNG launch fails over at the launch deadline and keeps the wedged
  thread on the HeartbeatMap clock.

"The device lane" is the port's gate patched off
(``native.host_engine_active``): a CPU codec then takes the batching
lane and the plain torch versions of the kernels.  TestQosSqueeze and
TestFaultMatrixLive need the OSD and wait for the port's OSD wiring
(ROADMAP Queue A item 6).
"""

import asyncio
import time

import numpy as np
import pytest

import torch

from ceph_tpu.common.heartbeat_map import HeartbeatMap
from ceph_tpu.models import matrix_codec as ref_matrix_codec
from ceph_tpu.models.registry import instance as ref_instance
from ceph_tpu.osd import ec_util as ref_ec_util

from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.models import matrix_codec as mc
from ceph_tpu_torch.models.matrix_codec import (
    BitmatrixErasureCode,
    EngineFault,
    MatrixErasureCode,
    classify_engine_error,
)
from ceph_tpu_torch.models.registry import instance
from ceph_tpu_torch.ops import matrices as mx
from ceph_tpu_torch.ops.gf_cuda import KernelBuildError, KernelLaunchError
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
from ceph_tpu_torch.osd.ec_failover import (
    HEALTHY,
    PROBING,
    SUSPECT,
    TRIPPED,
    EngineSupervisor,
)
from ceph_tpu_torch.utils import native


def run(coro):
    return asyncio.run(coro)


def _sinfo(k: int, cs: int = 512) -> ec_util.StripeInfo:
    return ec_util.StripeInfo(stripe_width=cs * k, chunk_size=cs)


def _codec(k: int = 2, m: int = 1) -> MatrixErasureCode:
    return MatrixErasureCode(k, m, 8, mx.isa_rs_vandermonde(k, m), device="cpu")


def _force_device_lane(monkeypatch):
    monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)


def _buf(sinfo, stripes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(stripes * sinfo.stripe_width,),
                        dtype=np.uint8)


def _same_shards(got, want):
    assert set(got) == set(want)
    for s in want:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s])), s


# -- failure classification ---------------------------------------------------


class TestClassification:
    def test_data_errors_surface(self):
        for exc in (ValueError("shape"), TypeError("t"),
                    IOError("cannot decode: 1 chunks available"),
                    KeyError("k"), IndexError("i")):
            assert classify_engine_error(exc) == "data", exc

    def test_device_errors_are_fatal(self):
        accel = getattr(torch, "AcceleratorError", RuntimeError)
        for exc in (KernelLaunchError("gf_matmul launch failed: cudaError_t 700"),
                    KernelBuildError("nvcc failed"),
                    torch.OutOfMemoryError("CUDA out of memory"),
                    accel("CUDA error: an illegal memory access"),
                    EngineFault("injected"),
                    RuntimeError("CUDA error: device-side assert"),
                    MemoryError()):
            assert classify_engine_error(exc) == "fatal", exc

    def test_same_verdicts_as_the_reference(self):
        cases = [ValueError("shape"), TypeError("t"), KeyError("k"),
                 IOError("cannot decode"), RuntimeError("unknown"),
                 MemoryError(), AssertionError("a")]
        for exc in cases:
            assert classify_engine_error(exc) \
                == ref_matrix_codec.classify_engine_error(exc), exc
        assert classify_engine_error(EngineFault("x")) \
            == ref_matrix_codec.classify_engine_error(
                ref_matrix_codec.EngineFault("x")) == "fatal"


# -- host fallback bit-identity ----------------------------------------------


class TestHostFallbackEngine:
    def test_matrix_w8_encode_decode_identical(self):
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 5, seed=1)
        want = ec_util.encode(sinfo, codec, buf)
        _same_shards(ec_util.encode_fallback(sinfo, codec, buf), want)
        chunks = {1: want[1], 2: want[2]}  # degraded: shard 0 missing
        assert bytes(
            ec_util.decode_concat_fallback(sinfo, codec, chunks)
        ) == bytes(ec_util.decode_concat(sinfo, codec, chunks))

    def test_matrix_w16_host_oracle_identical(self):
        c = MatrixErasureCode(3, 2, 16, mx.rs_vandermonde(3, 2, 16), device="cpu")
        rng = np.random.default_rng(2)
        data = rng.integers(0, 256, size=(3, 512), dtype=np.uint8)
        want = np.asarray(c.encode_chunks(data))
        assert np.array_equal(want, c.encode_chunks_host(data))
        full = np.concatenate([data, want], axis=0)
        present = [1, 2, 3, 4]
        got_dev = np.asarray(c.decode_chunks(present, full[present], [0]))
        got_host = np.asarray(
            c.decode_chunks_host(present, full[present], [0])
        )
        assert np.array_equal(got_dev, got_host)

    def test_bitmatrix_host_oracle_identical(self):
        bc = BitmatrixErasureCode(2, 1, 4, mx.cauchy_good(2, 1, 4), 8, device="cpu")
        bs = ec_util.StripeInfo(stripe_width=2 * 64, chunk_size=64)
        buf = _buf(bs, 3, seed=3)
        want = ec_util.encode(bs, bc, buf)
        _same_shards(ec_util.encode_fallback(bs, bc, buf), want)
        chunks = {1: want[1], 2: want[2]}
        assert bytes(
            ec_util.decode_concat_fallback(bs, bc, chunks)
        ) == bytes(ec_util.decode_concat(bs, bc, chunks))

    def test_fallback_rejects_bad_shapes_like_the_device_path(self):
        sinfo, codec = _sinfo(2), _codec()
        with pytest.raises(ValueError):
            ec_util.encode_fallback(sinfo, codec, b"x" * 100)

    def test_lrc_host_oracle_identical_and_device_free(self):
        """A layered LRC codec must replay on its inner HOST oracles —
        a fallback that re-entered a device engine would re-raise the
        fault it is recovering from."""
        c = instance().factory("lrc", {
            "k": "4", "m": "2", "l": "3",
            "crush-failure-domain": "host",
        }, device="cpu")
        rng = np.random.default_rng(4)
        data = rng.integers(0, 256, size=(4, 256), dtype=np.uint8)
        want = np.asarray(c.encode_chunks(data))
        assert np.array_equal(want, c.encode_chunks_host(data))
        n = c.get_chunk_count()
        full = np.zeros((n, 256), dtype=np.uint8)
        full[c.chunk_mapping] = data
        data_pos = set(c.chunk_mapping)
        full[[i for i in range(n) if i not in data_pos]] = want
        missing = [c.chunk_mapping[0]]
        present = [i for i in range(n) if i not in missing]
        got_dev = np.asarray(c.decode_chunks(present, full[present],
                                             missing))
        got_host = np.asarray(
            c.decode_chunks_host(present, full[present], missing)
        )
        assert np.array_equal(got_dev, got_host)
        # ...and the host route really never enters a device engine
        def no_device(*a, **kw):
            raise AssertionError("host oracle entered a device engine")

        real = mc._apply
        mc._apply = no_device
        try:
            c.encode_chunks_host(data)
            c.decode_chunks_host(present, full[present], missing)
        finally:
            mc._apply = real

    def test_shec_host_oracle_uses_the_span_solve(self):
        """SHEC is non-MDS: its host reconstruct must run the SAME span
        solve as the device path, not the inherited MDS recovery
        matrix."""
        c = instance().factory("shec", {"k": "4", "m": "3", "c": "2"}, device="cpu")
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, size=(4, 256), dtype=np.uint8)
        want = np.asarray(c.encode_chunks(data))
        assert np.array_equal(want, c.encode_chunks_host(data))
        full = np.concatenate([data, want], axis=0)
        present = [1, 2, 3, 4, 5, 6]
        got_dev = np.asarray(c.decode_chunks(present, full[present], [0]))
        got_host = np.asarray(
            c.decode_chunks_host(present, full[present], [0])
        )
        assert np.array_equal(got_dev, got_host)


# -- dispatcher failover ------------------------------------------------------


class TestDispatcherFailover:
    def test_fatal_error_mid_batch_replays_no_waiter_fails(
        self, monkeypatch
    ):
        """The acceptance core: injection fires mid-batch, every waiter
        still gets oracle-identical bytes; failovers/replayed_ops
        count; the breaker walks HEALTHY -> SUSPECT -> TRIPPED."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        bufs = [_buf(sinfo, s, seed=s) for s in (2, 3)]
        wants = [ec_util.encode(sinfo, codec, b) for b in bufs]

        async def main():
            sup = EngineSupervisor(probe_interval=30.0)  # no re-promote
            disp = ECDispatcher(window=0.005, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            outs = await asyncio.gather(
                *[disp.encode(sinfo, codec, b) for b in bufs]
            )
            assert sup.state == SUSPECT  # first fatal: half-open
            out2 = await disp.encode(sinfo, codec, bufs[0])
            assert sup.state == TRIPPED  # second within the window
            st = disp.dump()
            # tripped: the fallback-direct lane serves (no device call,
            # hence no further failover events)
            out3 = await disp.encode(sinfo, codec, bufs[1])
            st2 = disp.dump()
            await disp.stop()
            return outs, out2, out3, st, st2

        outs, out2, out3, st, st2 = run(main())
        for got, want in zip(outs, wants):
            _same_shards(got, want)
        _same_shards(out2, wants[0])
        _same_shards(out3, wants[1])
        assert st["totals"]["failovers"] == 2
        assert st["totals"]["replayed_ops"] == 3  # 2 coalesced + 1
        assert st2["totals"]["failovers"] == 2  # lane change, no new
        assert st2["totals"]["fallback_direct"] == 1
        assert st2["engine_health"]["state"] == "tripped"

    def test_data_error_surfaces_and_breaker_stays_closed(
        self, monkeypatch
    ):
        """A shape bug is the CALLER's: it must raise (not replay) and
        must not move the breaker."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=5)

        def bad_encode(*a, **kw):
            raise ValueError("batch alignment")

        async def main():
            sup = EngineSupervisor(probe_interval=30.0)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            with pytest.raises(ValueError):
                real = ec_util.encode
                ec_util.encode = bad_encode
                try:
                    await disp.encode(sinfo, codec, buf)
                finally:
                    ec_util.encode = real
            assert sup.state == HEALTHY
            assert sup.totals["data_errors"] == 1
            assert disp._totals["failovers"] == 0
            await disp.stop()

        run(main())

    def test_live_disable_restores_fail_fast(self, monkeypatch):
        """osd_ec_engine_failover=false (live): fatal errors surface to
        the waiters — the pre-failover contract."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=6)

        async def main():
            sup = EngineSupervisor(enabled=False, probe_interval=30.0)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            with pytest.raises(EngineFault):
                await disp.encode(sinfo, codec, buf)
            await disp.stop()

        run(main())

    def test_live_disable_while_tripped_clears_degraded(
        self, monkeypatch
    ):
        """Disabling the failover while TRIPPED must restore the
        pre-failover world completely: state back to HEALTHY (gauge
        clears -> ACCEL_DEGRADED drops) and the QoS capacity squeeze
        released — a breaker the operator turned off must not keep
        throttling the cluster."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()

        async def main():
            degraded = []
            sup = EngineSupervisor(probe_interval=30.0,
                                   on_degraded=degraded.append)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            for seed in (20, 21):  # two fatals: SUSPECT then TRIPPED
                await disp.encode(sinfo, codec, _buf(sinfo, 2, seed=seed))
            assert sup.state == TRIPPED and degraded == [True]
            sup.set_enabled(False)
            assert sup.state == HEALTHY
            assert degraded == [True, False]
            # fail-fast contract is back, and the inline lanes follow
            with pytest.raises(EngineFault):
                await disp.encode(sinfo, codec, _buf(sinfo, 2, seed=22))
            await disp.stop()

        run(main())

    def test_inline_shutdown_lane_routes_around_a_tripped_device(
        self, monkeypatch
    ):
        """The _stopping inline path runs ON the event loop: with the
        breaker TRIPPED it must use the host fallback — an inline
        device call there would have no deadline, no watchdog pin, and
        would stall the heartbeat tasks themselves."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=23)

        async def main():
            sup = EngineSupervisor(probe_interval=30.0)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            for seed in (24, 25):
                await disp.encode(sinfo, codec, _buf(sinfo, 2, seed=seed))
            assert sup.state == TRIPPED
            await disp.stop()  # the inline lane is now the ONLY lane

            def device_wedges(*a, **kw):
                raise AssertionError("tripped inline lane hit the device")

            real = ec_util.encode
            ec_util.encode = device_wedges
            try:
                out = await disp.encode(sinfo, codec, buf)
            finally:
                ec_util.encode = real
            want = ec_util.encode_fallback(sinfo, codec, buf)
            assert all(
                np.array_equal(np.asarray(out[s]), np.asarray(want[s]))
                for s in want
            )

        run(main())

    def test_fallback_failure_surfaces_the_fallback_error(
        self, monkeypatch
    ):
        """If the replay itself fails, THAT error reaches the waiters
        (it describes the actual state of the bytes)."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=7)

        def bad_fallback(*a, **kw):
            raise ValueError("host engine also broken")

        monkeypatch.setattr(ec_util, "encode_fallback", bad_fallback)

        async def main():
            sup = EngineSupervisor(probe_interval=30.0)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            with pytest.raises(ValueError, match="host engine"):
                await disp.encode(sinfo, codec, buf)
            await disp.stop()

        run(main())

    def test_decode_replays_too(self, monkeypatch):
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 4, seed=8)
        enc = ec_util.encode(sinfo, codec, buf)
        chunks = {1: enc[1], 2: enc[2]}

        async def main():
            sup = EngineSupervisor(probe_interval=30.0)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            out = await disp.decode_concat(sinfo, codec, chunks)
            st = disp.dump()
            await disp.stop()
            return out, st

        out, st = run(main())
        assert bytes(out) == buf.tobytes()
        assert st["totals"]["failovers"] == 1


# -- launch deadline + HeartbeatMap -------------------------------------------


class TestLaunchDeadline:
    def test_hang_fails_over_at_deadline_and_pins_watchdog(
        self, monkeypatch
    ):
        """ec_inject_launch_hang: the waiters fail over at
        osd_ec_launch_deadline (far before the hang resolves), the
        breaker trips, launch_deadline_timeouts counts, and the wedged
        thread stays pinned on the HeartbeatMap handle — grace blows
        while it is stuck, clears when it returns."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=9)
        want = ec_util.encode(sinfo, codec, buf)

        async def main():
            hb = HeartbeatMap("t")
            handle = hb.add_worker("ec_device_launch", 0.3, 0.0)
            sup = EngineSupervisor(probe_interval=30.0)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup, launch_deadline=0.2,
                                hb_handle=handle)
            disp.inject_launch_hang = 0.9
            t0 = time.monotonic()
            out = await disp.encode(sinfo, codec, buf)
            took = time.monotonic() - t0
            assert took < 0.7  # failed over at the deadline, not the hang
            assert sup.state == TRIPPED
            assert disp._totals["deadline_timeouts"] == 1
            # the wedged thread is still on the clock...
            assert handle.timeout != 0.0
            await asyncio.sleep(0.2)
            assert not hb.is_healthy()  # grace blown -> health warn
            # ...until it finally returns, which unpins it
            await asyncio.sleep(1.0)
            assert handle.timeout == 0.0
            assert hb.is_healthy()
            # the executor was respawned: the dispatcher still serves
            out2 = await disp.encode(sinfo, codec, buf)
            await disp.stop()
            return out, out2

        out, out2 = run(main())
        _same_shards(out, want)
        _same_shards(out2, want)


    def test_wedged_canaries_never_starve_the_fallback_lane(
        self, monkeypatch
    ):
        """Review finding: while the device stays wedged, every canary
        probe times out too — each one must respawn the executor like a
        launch does, or two wedged probes eat both worker slots and the
        fallback serving lane deadlocks (exactly the silent freeze the
        feature exists to prevent)."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=11)
        want = ec_util.encode(sinfo, codec, buf)

        async def main():
            sup = EngineSupervisor(probe_interval=0.05)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup, launch_deadline=0.1,
                                max_workers=2)
            disp.inject_launch_hang = 5.0  # wedged until far past test
            out = await disp.encode(sinfo, codec, buf)  # trips
            assert sup.state == TRIPPED
            # let several canaries wedge and time out
            await asyncio.sleep(0.5)
            assert sup.totals["probes"] >= 2
            # the fallback lane must still serve promptly: if the
            # wedged probes kept their worker slots this would hang
            t0 = time.monotonic()
            outs = await asyncio.wait_for(
                asyncio.gather(*[
                    disp.encode(sinfo, codec, buf) for _ in range(4)
                ]),
                timeout=5.0,
            )
            assert time.monotonic() - t0 < 3.0
            disp.inject_launch_hang = 0.0
            await disp.stop()
            return out, outs

        out, outs = run(main())
        _same_shards(out, want)
        for o in outs:
            _same_shards(o, want)


# -- canary re-promotion ------------------------------------------------------


class TestRepromotion:
    def test_probe_repromotes_after_injection_lifts(self, monkeypatch):
        _force_device_lane(monkeypatch)

        pec = PerfCounters("ec")
        pec.add_gauge("engine_state")
        pec.add_counter("engine_failovers")
        pec.add_counter("replayed_ops")
        pec.add_counter("launch_deadline_timeouts")
        sinfo, codec = _sinfo(2), _codec()
        buf = _buf(sinfo, 2, seed=10)
        want = ec_util.encode(sinfo, codec, buf)

        async def main():
            degraded_edges = []
            sup = EngineSupervisor(
                probe_interval=0.03, perf=pec,
                on_degraded=degraded_edges.append,
            )
            disp = ECDispatcher(perf=pec, window=0.0,
                                max_stripes=1 << 20, supervisor=sup)
            disp.inject_engine_failure = 1
            await disp.encode(sinfo, codec, buf)  # SUSPECT
            await disp.encode(sinfo, codec, buf)  # TRIPPED
            assert pec.get("engine_state") == TRIPPED
            assert degraded_edges == [True]
            # probes keep failing while injection is armed
            await asyncio.sleep(0.15)
            assert sup.state in (TRIPPED, PROBING)
            assert sup.totals["probes"] >= 1
            disp.inject_engine_failure = 0  # lift the fault
            async with asyncio.timeout(10):
                while sup.state != HEALTHY:
                    await asyncio.sleep(0.02)
            assert degraded_edges == [True, False]
            assert pec.get("engine_state") == HEALTHY
            assert sup.totals["promotions"] == 1
            # back on the device path: no new failover events
            before = disp._totals["failovers"]
            out = await disp.encode(sinfo, codec, buf)
            assert disp._totals["failovers"] == before
            assert disp._totals["fallback_direct"] == 0
            await disp.stop()
            return out

        _same_shards(run(main()), want)
        assert pec.get("engine_failovers") == 2
        assert pec.get("replayed_ops") == 2

    def test_decode_trip_canary_probes_the_reconstruct_program(
        self, monkeypatch
    ):
        """A breaker tripped by DECODE failures must re-promote on a
        decode canary: a device whose reconstruct program is broken
        but whose encode works would otherwise flap TRIPPED->HEALTHY->
        TRIPPED forever."""
        _force_device_lane(monkeypatch)
        sinfo, codec = _sinfo(2), _codec()
        shards = ec_util.encode_fallback(sinfo, codec,
                                         _buf(sinfo, 2, seed=11))
        survivors = {1: shards[1], 2: shards[2]}
        probed = {"dec": 0, "enc": 0}
        real_dec, real_enc = ec_util.decode_concat, ec_util.encode

        def spy_dec(*a, **kw):
            probed["dec"] += 1
            return real_dec(*a, **kw)

        def spy_enc(*a, **kw):
            probed["enc"] += 1
            return real_enc(*a, **kw)

        async def main():
            sup = EngineSupervisor(probe_interval=0.03)
            disp = ECDispatcher(window=0.0, max_stripes=1 << 20,
                                supervisor=sup)
            disp.inject_engine_failure = 1
            for _ in range(2):  # two fatal DECODE launches: TRIPPED
                await disp.decode_concat(sinfo, codec, survivors)
            assert sup.state == TRIPPED
            assert disp._last_trip[0] == "dec"
            disp.inject_engine_failure = 0
            monkeypatch.setattr(ec_util, "decode_concat", spy_dec)
            monkeypatch.setattr(ec_util, "encode", spy_enc)
            async with asyncio.timeout(10):
                while sup.state != HEALTHY:
                    await asyncio.sleep(0.02)
            await disp.stop()

        run(main())
        assert probed["dec"] >= 1  # the canary drove the RECONSTRUCT
        assert probed["enc"] == 0  # ...not an encode stand-in

    def test_wedged_canary_does_not_retrip(self):
        """A canary that blows the launch deadline while PROBING must
        route back to TRIPPED without re-tripping: no inflated trip
        totals, no re-fired on_degraded edge, no reset since_s."""
        degraded = []
        sup = EngineSupervisor(probe_interval=30.0,
                               on_degraded=degraded.append)
        sup.record_failure(EngineFault("x"))
        sup.record_failure(EngineFault("x"))
        assert sup.state == TRIPPED and sup.totals["trips"] == 1
        t_trip = sup.last_transition
        sup.state = PROBING  # what _probe_loop sets around the canary
        sup.record_timeout(0.5)  # the canary wedged
        assert sup.totals["trips"] == 1  # still the ONE real trip
        assert sup.totals["timeouts"] == 1
        assert degraded == [True]  # no duplicate degraded edge
        assert sup.last_transition == t_trip

    def test_engine_state_gauge_survives_perf_reset(self, monkeypatch):
        """An admin `perf reset` zeroes gauges; refresh_gauge (run off
        the OSD report tick) must re-assert engine_state or a TRIPPED
        OSD would read healthy at the mgr and silently clear
        ACCEL_DEGRADED."""

        pec = PerfCounters("ec")
        pec.add_gauge("engine_state")
        sup = EngineSupervisor(probe_interval=30.0, perf=pec)
        sup.record_failure(EngineFault("x"))
        sup.record_failure(EngineFault("x"))
        assert pec.get("engine_state") == TRIPPED
        pec.reset()
        assert pec.get("engine_state") == HEALTHY  # the lie
        sup.refresh_gauge()
        assert pec.get("engine_state") == TRIPPED


# -- the host replay engine against the reference ------------------------------


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "16"}),
    ("jerasure", {"technique": "cauchy_good", "k": "3", "m": "2", "packetsize": "16"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
])
def test_fallback_bytes_equal_reference(plugin, profile):
    """The port's *_fallback lane gives the reference's *_fallback
    bytes for the same seeded input."""
    port = instance().factory(plugin, dict(profile), device="cpu")
    ref = ref_instance().factory(plugin, dict(profile))
    k = port.get_data_chunk_count()
    cs = port.get_chunk_size(k * 256)
    sinfo, ref_sinfo = ec_util.StripeInfo(k * cs, cs), ref_ec_util.StripeInfo(k * cs, cs)
    buf = np.random.default_rng(31).integers(0, 256, size=3 * k * cs, dtype=np.uint8)
    want = ref_ec_util.encode_fallback(ref_sinfo, ref, buf)
    _same_shards(ec_util.encode_fallback(sinfo, port, buf), want)
    survivors = {s: v for s, v in want.items() if s != 1}
    assert bytes(ec_util.decode_concat_fallback(sinfo, port, survivors)) \
        == bytes(ref_ec_util.decode_concat_fallback(ref_sinfo, ref, survivors)) \
        == buf.tobytes()


def test_host_matmul_takes_the_native_engine_and_falls_back(monkeypatch):
    """The replay engine multiplies through the native library when it
    loads; a library that cannot be built leaves the numpy oracle, with
    the same bytes."""
    c = _codec(4, 2)
    data = np.random.default_rng(5).integers(0, 256, size=(4, 4096), dtype=np.uint8)
    want = np.asarray(c.encode_chunks(data))
    calls = []
    real = native.encode
    monkeypatch.setattr(native, "encode", lambda *a: calls.append(1) or real(*a))
    assert np.array_equal(c.encode_chunks_host(data), want) and calls

    def unbuildable(*a):
        raise OSError("g++ not found")

    monkeypatch.setattr(native, "encode", unbuildable)
    assert np.array_equal(c.encode_chunks_host(data), want)
