"""The port's kernel trace windows (ceph_tpu_torch.ops.device_trace)
against the reference's contract.

- **Bucket rules** on a hand-written Kineto-shaped fixture
  (``tests/golden/kineto_trace_events.json``): a kernel, an H2D and a
  D2H copy, a memset, an NCCL all-gather kernel, and ``cuda_runtime`` /
  ``cuda_driver`` / ``cpu_op`` / ``python_function`` /
  ``user_annotation`` / ``gpu_user_annotation`` / flow noise with
  correlation ids.
- **Attribution** by correlation: a device event lands in the engine
  whose tap interval holds the host call that issued it, even when the
  event itself runs inside another engine's interval; an event with no
  launch call falls back to the reference's overlap rule.  The output
  keys equal the reference's ``summarize_events`` on its own fixture.
- **The window service**, as the reference's ``TestWindowService``: one
  window at a time, expiry, structured refusals; a card window refused
  without CUDA, and one that captured no CUDA event an error.
- **A CPU window round trip** through a port ``ECDispatcher`` with the
  plain versions: the session opened and closed on its own thread, the
  tap's interval notes, and ``merge_device_time`` reaching
  ``dump_kernel_profile``.
- **The flight recorder and the op tracker**: an op's dump names the
  launch that carried it, through the dispatcher's ``flight.lookup``.

Tolerances: exact, except seconds, which are sums of microsecond
durations held to 1e-9.
"""

import asyncio
import gzip
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu.ops import device_trace as ref_device_trace

from ceph_tpu_torch.common.op_tracker import OpTracker
from ceph_tpu_torch.common.tracing import current_trace
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.ops import device_trace
from ceph_tpu_torch.ops import matrices as mx
from ceph_tpu_torch.ops.device_trace import (
    ANCHOR_NAME,
    BUCKETS,
    DeviceTracer,
    FlightRecorder,
    busy_seconds,
    capture_check,
    classify_trace_event,
    device_spans,
    parse_trace_dir,
    summarize_events,
)
from ceph_tpu_torch.ops.profiler import profiler
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
from ceph_tpu_torch.utils import native

GOLDEN = pathlib.Path(__file__).parent / "golden"
KINETO = GOLDEN / "kineto_trace_events.json"
REF_FIXTURE = GOLDEN / "device_trace_events.json"

ASYNC_LIMIT_S = 60.0
US = 1e-6


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, ASYNC_LIMIT_S)

    return asyncio.run(bounded())


def _codec(k: int = 2, m: int = 1) -> MatrixErasureCode:
    return MatrixErasureCode(k, m, 8, mx.isa_rs_vandermonde(k, m), device="cpu")


def _sinfo(k: int = 2, cs: int = 512) -> ec_util.StripeInfo:
    return ec_util.StripeInfo(stripe_width=cs * k, chunk_size=cs)


def _kineto(tmp_path, gz=False):
    d = tmp_path / "capture"
    d.mkdir()
    raw = KINETO.read_bytes()
    if gz:
        (d / "host.pt.trace.json.gz").write_bytes(gzip.compress(raw))
    else:
        (d / "host.pt.trace.json").write_bytes(raw)
    return parse_trace_dir(str(d))


# the fixture's anchor (ts 1000 us) on a perf_counter timeline at 50 s,
# and two engines' tap intervals: ec_shards holds the host calls of the
# first worker (1040..1440 us), gf_encode those of the second
# (2990..3050 us)
ANCHOR_PC = 50.0
OFFSET = ANCHOR_PC - 1000.0 * US
INTERVALS = [
    (OFFSET + 1040 * US, OFFSET + 1440 * US, "ec_shards", ("m", (8, 4096))),
    (OFFSET + 2990 * US, OFFSET + 3050 * US, "gf_encode", ("k", (2, 64))),
]


# -- classification -----------------------------------------------------------


class TestClassify:
    @pytest.mark.parametrize("cat,name,want", [
        ("kernel", "void gf_matmul_kernel<8, 3>(Plan, ...)", "fused_op"),
        ("kernel", "void at::native::vectorized_elementwise_kernel<4>(...)", "fused_op"),
        ("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         "collective"),
        ("kernel", "ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)", "collective"),
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", "dma"),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", "dma"),
        ("gpu_memset", "Memset (Device)", "dma"),
        ("cuda_runtime", "cudaLaunchKernel", None),
        ("cuda_runtime", "cudaMemcpyAsync", None),
        ("cuda_driver", "cuLaunchKernelEx", None),
        ("cpu_op", "aten::cat", None),
        ("python_function", "matrix_codec.py(196): run", None),
        ("user_annotation", ANCHOR_NAME, None),
        ("gpu_user_annotation", "ec_shards", None),
        ("Trace", "PyTorch Profiler (0)", None),
        ("", "all-gather.1", None),
    ])
    def test_kineto_categories(self, cat, name, want):
        assert classify_trace_event(name, {}, "", cat=cat) == want

    def test_flow_and_instant_events_are_noise(self):
        for ph in ("s", "f", "i", "M"):
            assert classify_trace_event("ac2g", {}, "", cat="ac2g", ph=ph) is None
            assert classify_trace_event("k", {}, "", cat="kernel", ph=ph) is None


# -- the Kineto fixture --------------------------------------------------------


class TestFixture:
    @pytest.mark.parametrize("gz", [False, True])
    def test_parse_and_buckets(self, tmp_path, gz):
        events, threads = _kineto(tmp_path, gz)
        assert threads[(4100, 4100)] == "thread 4100 (python3)"
        assert threads[(0, 7)] == "stream 7 "
        # the workers that launch carry no thread_name row
        assert (4100, 320861888) not in threads
        assert all(e["ph"] == "X" for e in events)
        s = summarize_events(events, threads, wall_s=0.005)
        assert s["op_events"] == 7
        assert s["buckets"] == {"fused_op": pytest.approx(70 * US, abs=1e-9),
                                "dma": pytest.approx(244 * US, abs=1e-9),
                                "collective": pytest.approx(100 * US, abs=1e-9)}
        assert s["engines"] == {}
        assert s["unattributed"] == s["buckets"]
        assert s["occupancy"] == round(414 * US / 0.005, 4)
        names = [op["name"] for op in s["top_ops"]]
        assert names[0].startswith("Memcpy DtoH")
        assert any("gf_matmul_kernel" in n for n in names)
        assert any("bitmatrix_xor_kernel" in n for n in names)

    def test_parse_empty_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            parse_trace_dir(str(tmp_path))

    def test_attribution_by_correlation(self, tmp_path):
        events, threads = _kineto(tmp_path)
        s = summarize_events(events, threads, intervals=INTERVALS,
                             anchor_offset=OFFSET, wall_s=0.005)
        shards, enc = s["engines"]["ec_shards"], s["engines"]["gf_encode"]
        # the late D2H copy runs inside gf_encode's interval but was
        # issued by ec_shards' call: it lands in ec_shards
        assert shards["dma"] == pytest.approx((60 + 4 + 180) * US, abs=1e-9)
        assert shards["fused_op"] == pytest.approx((40 + 10) * US, abs=1e-9)
        assert shards["collective"] == 0.0
        assert shards["events"] == 5
        assert shards["top_keys"] == {str(("m", (8, 4096))): pytest.approx(294 * US, abs=1e-9)}
        # the cuLaunchKernelEx NCCL launch, and the kernel with no launch call
        # (placed by its own time)
        assert enc["collective"] == pytest.approx(100 * US, abs=1e-9)
        assert enc["fused_op"] == pytest.approx(20 * US, abs=1e-9)
        assert enc["events"] == 2
        assert s["unattributed"] == {b: 0.0 for b in BUCKETS}

    def test_own_time_alone_would_misplace_the_late_copy(self, tmp_path):
        """Without the launch calls the reference's overlap rule puts
        the late D2H copy in the engine running when it ran."""
        events, threads = _kineto(tmp_path)
        bare = [e for e in events if e.get("cat") not in ("cuda_runtime", "cuda_driver")]
        s = summarize_events(bare, threads, intervals=INTERVALS,
                             anchor_offset=OFFSET)
        assert s["engines"]["gf_encode"]["dma"] == pytest.approx(180 * US, abs=1e-9)

    def test_far_events_stay_unattributed(self, tmp_path):
        events, threads = _kineto(tmp_path)
        far = [(t0 + 10.0, t1 + 10.0, e, k) for t0, t1, e, k in INTERVALS]
        s = summarize_events(events, threads, intervals=far, anchor_offset=OFFSET)
        assert s["engines"] == {}
        assert s["unattributed"] == s["buckets"]

    def test_output_keys_equal_the_references(self, tmp_path):
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        (ref_dir / "host.trace.json").write_bytes(REF_FIXTURE.read_bytes())
        ref_events, ref_threads = ref_device_trace.parse_trace_dir(str(ref_dir))
        ref = ref_device_trace.summarize_events(
            ref_events, ref_threads,
            intervals=[(0.0009, 0.0019, "gf_encode", "k-enc")],
            anchor_offset=0.0, wall_s=1.0)
        events, threads = _kineto(tmp_path)
        port = summarize_events(events, threads, intervals=INTERVALS,
                                anchor_offset=OFFSET, wall_s=1.0)
        assert set(port) == set(ref)
        assert set(port["buckets"]) == set(ref["buckets"]) == set(BUCKETS)
        assert set(port["unattributed"]) == set(ref["unattributed"])
        for e in port["engines"].values():
            assert set(e) == set(next(iter(ref["engines"].values())))
        assert set(port["top_ops"][0]) == set(ref["top_ops"][0])
        assert BUCKETS == ref_device_trace.BUCKETS

    def test_device_spans_and_busy_seconds(self, tmp_path):
        events, threads = _kineto(tmp_path)
        spans = device_spans(events, threads)
        assert len(spans) == 7
        # 1060-1120, 1130-1170, 1175-1185, 1186-1190, then 2995-3175
        # holding 3010-3110 and 3020-3040: overlaps counted once
        assert busy_seconds(spans) == pytest.approx(
            (60 + 40 + 10 + 4 + 180) * US, abs=1e-12)
        assert busy_seconds([]) == 0.0


class TestCaptureCheck:
    """A capture is held against the launches the window counted: the
    dump's ``capture`` key reports a short capture."""

    LAUNCHED = {"gf_matmul": 1, "bitmatrix_xor": 1, "crush_straw2": 0}

    def test_a_whole_capture(self, tmp_path):
        events, threads = _kineto(tmp_path)
        c = capture_check(events, self.LAUNCHED, threads, intervals=INTERVALS,
                          anchor_offset=OFFSET)
        assert c == {
            "kernels": {"bitmatrix_xor": {"launched": 1, "captured": 1},
                        "crush_straw2": {"launched": 0, "captured": 0},
                        "gf_matmul": {"launched": 1, "captured": 1}},
            "short": [],
            "intervals_without_device_events": 0,
        }

    def test_fewer_kernel_events_than_launches_is_short(self, tmp_path):
        events, threads = _kineto(tmp_path)
        c = capture_check(events, dict(self.LAUNCHED, gf_matmul=4), threads)
        assert c["short"] == ["gf_matmul"]
        assert c["kernels"]["gf_matmul"] == {"launched": 4, "captured": 1}
        # a launch whose kernel event the capture lost
        lost = [e for e in events if "gf_matmul_kernel" not in e.get("name", "")]
        c = capture_check(lost, self.LAUNCHED, threads)
        assert c["short"] == ["gf_matmul"]
        assert c["kernels"]["gf_matmul"] == {"launched": 1, "captured": 0}

    def test_a_tap_interval_with_no_device_event(self, tmp_path):
        events, threads = _kineto(tmp_path)
        # the second engine's interval loses its launches and kernels
        # (correlations 104 and 999): nothing of the capture falls in it
        lost = [e for e in events
                if (e.get("args") or {}).get("correlation") not in (104, 999)]
        c = capture_check(lost, self.LAUNCHED, threads, intervals=INTERVALS,
                          anchor_offset=OFFSET)
        assert c["intervals_without_device_events"] == 1
        assert c["short"] == ["bitmatrix_xor"]
        far = INTERVALS + [(OFFSET + 9.0, OFFSET + 9.001, "ec_shards", "k")]
        c = capture_check(events, self.LAUNCHED, threads, intervals=far,
                          anchor_offset=OFFSET)
        assert c["intervals_without_device_events"] == 1
        # without an anchor no interval can be placed
        c = capture_check(events, self.LAUNCHED, threads, intervals=INTERVALS)
        assert c["intervals_without_device_events"] == 2

    def test_the_dump_reports_a_short_capture(self, monkeypatch, tmp_path):
        """Through the window service: the launch counts move by more
        than the capture holds, and the dump's new ``capture`` key says
        so (the summary's keys keep their meaning)."""
        events, threads = _kineto(tmp_path)
        counts = iter([{"gf_matmul": 10, "bitmatrix_xor": 3, "crush_straw2": 0},
                       {"gf_matmul": 14, "bitmatrix_xor": 4, "crush_straw2": 0}])
        monkeypatch.setattr(device_trace, "_launch_counts", lambda: next(counts))
        monkeypatch.setattr(device_trace, "parse_trace_dir",
                            lambda _d: (events, threads))
        svc = DeviceTracer()
        assert svc.start(duration=5.0, device="cpu").get("success")
        r = svc.stop()
        assert r["capture"]["short"] == ["gf_matmul"]
        assert r["capture"]["kernels"]["gf_matmul"] == {"launched": 4, "captured": 1}
        assert r["capture"]["kernels"]["bitmatrix_xor"] == {"launched": 1, "captured": 1}
        assert r["op_events"] == 7 and svc.dump() == r


# -- the window service -------------------------------------------------------


class TestWindowService:
    def test_unavailable_paths_are_structured(self):
        svc = DeviceTracer()
        assert "unavailable" in svc.dump()  # nothing captured yet
        stopped = svc.stop()
        assert "unavailable" in stopped
        assert stopped["no_window"] is True
        st = svc.status()
        assert st["active"] is False and st["windows"] == 0

    def test_one_window_at_a_time_and_expiry(self):
        svc = DeviceTracer()
        st = svc.start(duration=0.2, label="w1", device="cpu")
        assert st.get("success"), st
        second = svc.start(duration=1.0, device="cpu")
        assert second.get("busy") and "already open" in second["error"]
        # an expired window closes on the next service call (or its
        # timer): the start -> launch -> dump round trip needs no stop
        time.sleep(0.3)
        d = svc.dump()
        assert "unavailable" not in d, d
        assert d["label"] == "w1" and d.get("expired") is True
        assert svc.status()["active"] is False
        assert svc.status()["windows"] == 1

    def test_duration_is_clamped(self):
        svc = DeviceTracer()
        st = svc.start(duration=600.0, device="cpu", max_duration=0.5)
        assert st["duration_s"] == 0.5
        assert "unavailable" not in svc.stop()

    def test_a_card_window_is_refused_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour without CUDA")
        svc = DeviceTracer()
        for device in ("cuda", torch.device("cuda", 0)):
            r = svc.start(device=device)
            assert "unavailable" in r and "CUDA" in r["unavailable"]
        assert svc.status()["active"] is False

    def test_a_card_window_with_no_cuda_event_is_an_error(self):
        svc = DeviceTracer()
        assert svc.start(duration=5.0, device="cpu").get("success")
        svc._session.cuda = True  # as a card window would be
        r = svc.stop()
        assert "captured no CUDA" in r["error"]
        assert svc.status()["failed_windows"] == 1
        assert svc.dump() == r

    def test_start_and_stop_from_other_threads(self):
        """The session belongs to a thread of its own: a start from one
        executor thread and a stop from another close it cleanly, and
        the anchor marker is in its capture."""
        svc = DeviceTracer()
        seen = {}
        real = device_trace.summarize_events

        def spy(events, *a, **kw):
            events = list(events)
            seen["names"] = {e.get("name") for e in events}
            seen["offset"] = kw.get("anchor_offset")
            return real(events, *a, **kw)

        device_trace.summarize_events = spy
        try:
            out = {}
            t = threading.Thread(target=lambda: out.update(
                start=svc.start(duration=5.0, device="cpu")))
            t.start()
            t.join(30)
            t = threading.Thread(target=lambda: out.update(stop=svc.stop()))
            t.start()
            t.join(30)
        finally:
            device_trace.summarize_events = real
        assert out["start"].get("success") and "unavailable" not in out["stop"]
        assert ANCHOR_NAME in seen["names"] and seen["offset"] is not None
        assert not any(th.name == "ktrace-session" for th in threading.enumerate())

    def test_dispatcher_window_round_trip_and_merge(self, monkeypatch):
        """A CPU window around a dispatcher batch on the plain versions:
        the tap notes the batch's interval at call time, the window
        closes with it, and the engines a capture attributes are merged
        into dump_kernel_profile.  The CPU has no CUDA event, so the
        test adds a launch call and a kernel inside each noted interval
        to the real capture before it is summarized."""
        monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)
        profiler().reset()
        sinfo, codec = _sinfo(), _codec()
        rng = np.random.default_rng(3)
        bufs = [rng.integers(0, 256, size=(4 * sinfo.stripe_width,), dtype=np.uint8)
                for _ in range(3)]
        svc = DeviceTracer()
        assert svc.start(duration=30.0, label="round trip", device="cpu").get("success")
        monkeypatch.setattr(profiler(), "trace_sink", svc)

        async def main():
            disp = ECDispatcher(window=0.002, max_stripes=1 << 20)
            out = await asyncio.gather(*[disp.encode(sinfo, codec, b) for b in bufs])
            await disp.stop()
            return out

        got = run(main())
        for b, shards in zip(bufs, got):
            want = ec_util.encode(sinfo, codec, b)
            assert all(np.array_equal(np.asarray(shards[s]), np.asarray(want[s]))
                       for s in want)
        session = svc._session
        with svc._lock:
            noted = list(svc._intervals)
        assert noted and {e for _t0, _t1, e, _k in noted} <= set(profiler().dump()["engines"])
        real_parse = device_trace.parse_trace_dir

        def parse_with_card_events(log_dir):
            events, threads = real_parse(log_dir)
            anchor = next(e for e in events if e.get("name") == ANCHOR_NAME)
            for i, (t0, t1, _e, _k) in enumerate(noted):
                ts = float(anchor["ts"]) + (t0 + (t1 - t0) / 2 - session.anchor_pc) / US
                events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                               "pid": 1, "tid": 2, "ts": ts, "dur": 0.0,
                               "args": {"correlation": 7000 + i}})
                events.append({"ph": "X", "cat": "kernel", "name": "gf_matmul_kernel",
                               "pid": 0, "tid": 7, "ts": ts + 5.0, "dur": 3.0,
                               "args": {"correlation": 7000 + i}})
            return events, threads

        monkeypatch.setattr(device_trace, "parse_trace_dir", parse_with_card_events)
        r = svc.stop()
        assert r["launch_intervals"] == len(noted)
        assert r["op_events"] == len(noted)
        assert r["unattributed"] == {b: 0.0 for b in BUCKETS}
        engines = {e for _t0, _t1, e, _k in noted}
        assert set(r["engines"]) == engines
        dumped = profiler().dump()["engines"]
        for e in engines:
            assert dumped[e]["device_trace"]["fused_op"] == pytest.approx(
                r["engines"][e]["fused_op"], abs=1e-9)
        assert svc.dump() == r


# -- the flight recorder and the op tracker -----------------------------------


class TestFlightRecorder:
    def test_op_tracker_dump_names_the_launch(self):
        """SLOW_OPS consultation: an op dump carries the launch that
        carried the op (in-flight and historic)."""
        fr = FlightRecorder()
        t = fr.begin(lane="device", kind="enc", klass="client", ops=1,
                     queue_wait_s=0.01, traces=["client.0:t5"])
        fr.end(t, device_wall_s=2.5, served="device")
        tracker = OpTracker()
        tracker.launch_lookup = fr.lookup
        op = tracker.create(trace="client.0:t5", tid=5)
        d = tracker.dump_ops_in_flight()
        assert d["ops"][0]["launch"]["lane"] == "device"
        tracker.finish(op)
        h = tracker.dump_historic_ops()
        assert h["ops"][0]["launch"]["device_wall_s"] == 2.5
        untraced = tracker.create(tid=6)
        assert "launch" not in tracker.dump_ops_in_flight()["ops"][-1]
        tracker.finish(untraced, completed=False)
        assert tracker.dump_historic_ops()["num_ops"] == 1

    def test_dispatcher_flight_lookup_feeds_the_tracker(self, monkeypatch):
        """The wiring the OSD daemon makes: ``launch_lookup`` is the
        dispatcher's ``flight.lookup``, so a traced op's dump names the
        batched launch that carried it."""
        monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)
        sinfo, codec = _sinfo(), _codec()
        rng = np.random.default_rng(5)
        bufs = [rng.integers(0, 256, size=(2 * sinfo.stripe_width,), dtype=np.uint8)
                for _ in range(3)]
        tracker = OpTracker()

        async def main():
            disp = ECDispatcher(window=0.002, max_stripes=1 << 20)
            tracker.launch_lookup = disp.flight.lookup

            async def one(i, b):
                tok = current_trace.set(f"client.0:t{i}")
                try:
                    op = tracker.create(trace=f"client.0:t{i}", tid=i)
                    await disp.encode(sinfo, codec, b)
                    tracker.finish(op)
                finally:
                    current_trace.reset(tok)

            await asyncio.gather(*[one(i, b) for i, b in enumerate(bufs)])
            await disp.stop()
            return disp.flight.dump()

        d = run(main())
        rec = d["launches"][-1]
        ops = tracker.dump_historic_ops()["ops"]
        assert len(ops) == 3
        for op in ops:
            assert op["launch"]["seq"] == rec["seq"]
            assert op["launch"]["lane"] == "device" and op["launch"]["ops"] == 3


def test_the_fixture_is_kineto_shaped():
    """The fixture keeps the keys the port reads from a capture."""
    doc = json.loads(KINETO.read_text())
    assert "baseTimeNanoseconds" in doc and doc["displayTimeUnit"] == "ms"
    kinds = {(e.get("ph"), e.get("cat")) for e in doc["traceEvents"]}
    for cat in ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime", "cuda_driver",
                "cpu_op", "python_function", "user_annotation"):
        assert ("X", cat) in kinds, cat
    for e in doc["traceEvents"]:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            assert "correlation" in e["args"] and "stream" in e["args"]
