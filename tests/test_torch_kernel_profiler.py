"""The port's kernel profiler (ceph_tpu_torch.ops.profiler), twin of
tests/test_kernel_profiler.py's TestProfilerCore, plus the codec taps
under the reference's engine names and ``dump()`` held against the
reference profiler's on the same records.
"""

import numpy as np
import pytest

from ceph_tpu.ops.profiler import KernelProfiler as RefKernelProfiler

from ceph_tpu_torch.models import registry
from ceph_tpu_torch.ops.profiler import KernelProfiler, profiler
from ceph_tpu_torch.utils import native


class TestProfilerCore:
    def test_miss_then_hit(self):
        p = KernelProfiler()
        with p.timed("eng", ("m", (2, 8)), nbytes=16, shape=(2, 8)):
            pass
        with p.timed("eng", ("m", (2, 8)), nbytes=16, shape=(2, 8)):
            pass
        with p.timed("eng", ("m", (2, 16)), nbytes=32, shape=(2, 16)):
            pass
        d = p.dump()["engines"]["eng"]
        assert d["calls"] == 3
        # two distinct signatures -> two first calls, one steady repeat
        assert d["jit_cache"] == {"misses": 2, "hits": 1}
        assert d["bytes"] == 64
        assert d["shapes"] == {"(2, 8)": 2, "(2, 16)": 1}
        assert d["compile_time"] >= 0 and d["exec_time"] >= 0

    def test_explicit_compiled_override(self):
        p = KernelProfiler()
        p.record("e", "k1", 0.5, compiled=False)  # steady-state record
        d = p.dump()["engines"]["e"]
        assert d["jit_cache"] == {"misses": 0, "hits": 1}
        assert d["exec_time"] == 0.5

    def test_exec_gbps_excludes_compile_call_bytes(self):
        """A first call's bytes must not inflate the steady-state rate:
        1 GB first in 10 s + 1 GB steady in 0.1 s is 10 GB/s, not 20."""
        p = KernelProfiler()
        p.record("e", "k", 10.0, nbytes=10 ** 9)   # miss (first call)
        p.record("e", "k", 0.1, nbytes=10 ** 9)    # hit (steady)
        d = p.dump()["engines"]["e"]
        assert d["bytes"] == 2 * 10 ** 9
        assert d["exec_gbps"] == 10.0

    def test_reset_keeps_compile_signatures(self):
        """A profiler reset clears the stats but NOT the seen-signature
        set: the built kernels and packed plans are still warm, so a
        post-reset call on an old signature counts as a hit."""
        p = KernelProfiler()
        p.record("e", "k", 0.1)
        p.reset()
        assert p.dump()["engines"] == {}
        p.record("e", "k", 0.1)
        assert p.dump()["engines"]["e"]["jit_cache"]["hits"] == 1

    def test_histogram_rides_along(self):
        p = KernelProfiler()
        p.record("e", "k", 0.002, nbytes=1 << 20)
        h = p.dump_histograms()["e"]
        assert h["count"] == 1
        assert [a["name"] for a in h["axes"]] == [
            "request_bytes", "latency"
        ]

    def test_non_aot_first_call_is_first_exec_not_compile(self):
        """A first call lands in ``first_exec_s`` with ``aot_split``
        false, in NEITHER compile_time nor exec_time."""
        p = KernelProfiler()
        p.record("e", "k", 3.0, nbytes=10 ** 9)   # first sighting
        p.record("e", "k", 0.1, nbytes=10 ** 9)   # steady state
        d = p.dump()["engines"]["e"]
        assert d["aot_split"] is False
        assert d["first_exec_s"] == 3.0
        assert d["compile_time"] == 0.0
        assert d["exec_time"] == 0.1
        assert d["jit_cache"] == {"misses": 1, "hits": 1}
        assert d["exec_gbps"] == 10.0

    def test_dump_top_n_and_device_share(self):
        p = KernelProfiler()
        p.record("heavy", "k", 8.0, compiled=False)
        p.record("light", "k", 1.0, compiled=False)
        p.record("mid", "k", 3.0, compiled=False)
        full = p.dump()
        assert full["total_seconds"] == pytest.approx(12.0)
        assert full["engines"]["heavy"]["device_share"] \
            == pytest.approx(8 / 12, abs=1e-3)
        assert "engines_omitted" not in full
        top = p.dump(top=2)
        assert set(top["engines"]) == {"heavy", "mid"}
        assert top["engines_omitted"] == 1
        assert top["engines"]["mid"]["device_share"] \
            == pytest.approx(3 / 12, abs=1e-3)
        assert p.dump(top=0)["engines"] == {}

    def test_failed_call_is_recorded_like_the_reference(self):
        """A call that raises still counts, in both packages, and the
        same shape in two containers is one dump key."""
        for p in (KernelProfiler(), RefKernelProfiler()):
            with pytest.raises(ZeroDivisionError):
                p.call_jitted("e", "k", lambda: 1 // 0, (), nbytes=4,
                              shape=(2, 2))
            p.record("e", "k", 0.1, shape=[2, 2], compiled=False)
            d = p.dump()["engines"]["e"]
            assert d["calls"] == 2 and d["shapes"] == {"(2, 2)": 2}
            assert d["jit_cache"] == {"misses": 1, "hits": 1}


def test_call_jitted_splits_first_call_from_steady_state():
    p = KernelProfiler()
    for _ in range(3):
        assert p.call_jitted("e", "sig", lambda x: x + 1, (1,), nbytes=8,
                             wrap=lambda o: o * 10) == 20
    d = p.dump()["engines"]["e"]
    assert d["jit_cache"] == {"misses": 1, "hits": 2}
    assert d["aot_split"] is False and d["calls"] == 3


class _FakeEvent:
    """Stands in for torch.cuda.Event: each record takes the next
    timestamp, 250 ms apart; passed once ``done`` is set."""

    clock = 0.0

    def __init__(self):
        self.ms, self.done, self.records = None, False, 0

    def record(self, stream):
        assert stream == "stream of cuda:0"
        _FakeEvent.clock += 250.0
        self.ms, self.done, self.records = _FakeEvent.clock, False, self.records + 1

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.ms - self.ms


class _OnCard:
    is_cuda = True
    device = "cuda:0"


def test_cuda_calls_are_timed_between_events_without_waiting(monkeypatch):
    """A call on a CUDA input records the device time between its two
    events, not the host clock, and only once the card has passed the
    second: a later host call records what has finished, oldest first,
    dump() waits for the rest, and read event pairs are reused."""
    from ceph_tpu_torch.ops import profiler as prof

    made = []

    def new_events():
        made.append((_FakeEvent(), _FakeEvent()))
        return made[-1]

    monkeypatch.setattr(prof, "_new_events", new_events)
    monkeypatch.setattr(prof, "_stream", lambda device: f"stream of {device}")
    p = KernelProfiler()
    assert p.call_jitted("e", "sig", lambda x: 7, (_OnCard(),), nbytes=8) == 7
    assert p.call_jitted("e", "sig", lambda x: 8, (_OnCard(),), nbytes=8) == 8
    assert len(made) == 2 and len(p._pending) == 2  # nothing waited for
    made[0][1].done = True  # the card passed the first call only
    p.call_jitted("e", "sig", lambda x: 9, (1,), nbytes=8)  # a host call
    assert len(p._pending) == 1
    d = p.dump()["engines"]["e"]
    assert not p._pending and d["calls"] == 3
    assert d["first_exec_s"] == 0.25  # the first CUDA call, in call order
    assert d["jit_cache"] == {"misses": 1, "hits": 2}
    assert d["exec_time"] >= 0.25  # the second CUDA call plus the host one
    p.call_jitted("e", "sig", lambda x: 10, (_OnCard(),), nbytes=8)
    assert len(made) == 2 and made[1][0].records == 2  # a read pair, reused


def test_held_cuda_calls_are_read_once_enough_are_held(monkeypatch):
    """CUDA calls are read without a host call once _SETTLE_AFTER are
    held, the finished ones only, and every call is counted in the end."""
    from ceph_tpu_torch.ops import profiler as prof

    made = []

    def new_events():
        made.append((_FakeEvent(), _FakeEvent()))
        return made[-1]

    monkeypatch.setattr(prof, "_new_events", new_events)
    monkeypatch.setattr(prof, "_stream", lambda device: f"stream of {device}")
    p = KernelProfiler()
    n = prof._SETTLE_AFTER
    for _ in range(n - 1):
        p.call_jitted("e", "sig", lambda x: x, (_OnCard(),))
    assert len(p._pending) == n - 1
    for start, end in made[:n // 2]:
        end.done = True
    p.call_jitted("e", "sig", lambda x: x, (_OnCard(),))
    assert len(p._pending) == n - n // 2
    assert p.dump()["engines"]["e"]["calls"] == n and not p._pending


def test_dump_matches_the_reference_profiler():
    """The same records give the same dump, apart from timestamps."""
    port, ref = KernelProfiler(), RefKernelProfiler()
    for p in (port, ref):
        p.record("gf_encode", ("m", (8, 64)), 0.25, nbytes=4096, shape=(8, 64))
        p.record("gf_encode", ("m", (8, 64)), 0.125, nbytes=4096, shape=(8, 64))
        p.record("ec_shards", ("m", (4, 8, 16)), 0.5, nbytes=1 << 20,
                 shape=(4, 8, 16), compiled=False)
    a, b = port.dump(), ref.dump()
    a.pop("since"), b.pop("since")
    assert a == b
    assert port.dump_histograms() == ref.dump_histograms()


@pytest.mark.parametrize("gate", ["native", "device"])
def test_codec_taps_use_the_reference_engine_names(gate, monkeypatch):
    if gate == "device":
        monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)
    p = profiler()
    p.reset()
    codec = registry.instance().factory("isa", {"k": "2", "m": "1"}, device="cpu")
    data = np.random.default_rng(0).integers(0, 256, size=(2, 512), dtype=np.uint8)
    parity = codec.encode_chunks(data)
    codec.encode_shards_u32(data.view(np.uint32).reshape(2, 1, 128).swapaxes(0, 1).copy())
    chunks = np.concatenate([data, parity])
    rebuilt = codec.decode_chunks((1, 2), chunks[1:], (0,))
    np.testing.assert_array_equal(rebuilt[0], data[0])
    bm = registry.instance().factory(
        "jerasure", {"technique": "cauchy_good", "k": "2", "m": "1",
                     "packetsize": "32"}, device="cpu")
    bdata = np.random.default_rng(1).integers(0, 256, size=(2, 256), dtype=np.uint8)
    bpar = bm.encode_chunks(bdata)
    bm.decode_chunks((1, 2), np.concatenate([bdata, bpar])[1:], (0,))
    engines = p.dump()["engines"]
    decode = "gf_decode_native" if gate == "native" else "gf_decode"
    for name in ("gf_encode", "ec_shards", decode, "bitmatrix_encode",
                 "bitmatrix_decode"):
        assert engines[name]["calls"] >= 1, (name, sorted(engines))
    assert engines["gf_encode"]["bytes"] >= data.size
    assert engines["bitmatrix_encode"]["shapes"] == {"(16, 32)": 1}  # packet rows


# -- the trace-window tap and the device buckets ------------------------------------


def test_merge_device_time():
    """A closed trace window's per-engine buckets fold into the
    matching entries (ops.device_trace merge) and reset clears them
    with everything else (twin of the reference's test)."""
    p = KernelProfiler()
    p.record("e", "k", 0.1, compiled=False)
    p.merge_device_time({"e": {"collective": 0.04, "fused_op": 0.01}})
    p.merge_device_time({"e": {"collective": 0.02}})
    d = p.dump()["engines"]["e"]["device_trace"]
    assert d == {"collective": 0.06, "fused_op": 0.01}
    p.reset()
    assert p.dump()["engines"] == {}


def test_merged_dump_matches_the_reference_profiler():
    """The same records and window merges give the same dump, the
    ``device_trace`` buckets included, apart from timestamps (an engine
    a window saw but no call recorded too)."""
    port, ref = KernelProfiler(), RefKernelProfiler()
    for p in (port, ref):
        p.record("ec_shards", ("m", (4, 8, 16)), 0.5, nbytes=1 << 20,
                 shape=(4, 8, 16), compiled=False)
        p.merge_device_time({"ec_shards": {"fused_op": 0.001, "dma": 0.2,
                                           "collective": 0.0},
                             "bitmatrix_encode": {"dma": 0.09}})
    a, b = port.dump(), ref.dump()
    a.pop("since"), b.pop("since")
    assert a == b
    assert a["engines"]["ec_shards"]["device_trace"]["dma"] == 0.2


class _Sink:
    """Stands in for an open DeviceTracer window."""

    active = True

    def __init__(self):
        self.notes = []

    def note_kernel(self, engine, key, seconds, nbytes=0, t_end_pc=None):
        self.notes.append((engine, key, seconds, nbytes, t_end_pc))


def test_a_window_gets_each_host_call_once():
    p = KernelProfiler()
    sink = p.trace_sink = _Sink()
    import time

    t0 = time.perf_counter()
    p.call_jitted("e", "sig", lambda x: x, (1,), nbytes=8)
    with p.timed("t", "k", nbytes=4):
        pass
    t1 = time.perf_counter()
    assert [(n[0], n[1], n[3]) for n in sink.notes] == [("e", "sig", 8), ("t", "k", 4)]
    for _e, _k, seconds, _n, t_end in sink.notes:
        assert t0 <= t_end - seconds <= t_end <= t1
    sink.active = False
    p.record("e", "sig", 0.1)
    assert len(sink.notes) == 2  # a closed window gets nothing


def test_a_window_gets_a_cuda_calls_host_interval_at_call_time(monkeypatch):
    """A CUDA call is read later, when the card has passed it, but the
    window gets its host interval at call time, once: the kernels it
    issued were launched inside that interval."""
    from ceph_tpu_torch.ops import profiler as prof
    import time

    monkeypatch.setattr(prof, "_new_events", lambda: (_FakeEvent(), _FakeEvent()))
    monkeypatch.setattr(prof, "_stream", lambda device: f"stream of {device}")
    p = KernelProfiler()
    sink = p.trace_sink = _Sink()
    t0 = time.perf_counter()
    p.call_jitted("e", "sig", lambda x: 7, (_OnCard(),), nbytes=8)
    t1 = time.perf_counter()
    assert len(p._pending) == 1 and len(sink.notes) == 1
    _e, _k, seconds, nbytes, t_end = sink.notes[0]
    assert nbytes == 8 and t0 <= t_end - seconds <= t_end <= t1
    d = p.dump()["engines"]["e"]  # reads the card's time: no second note
    assert d["calls"] == 1 and d["first_exec_s"] == 0.25
    assert len(sink.notes) == 1
