"""Kernel-boundary profiler for the EC codec entries and the kernels
behind them.

Counterpart of ``ceph_tpu/ops/profiler.py``: the process-global timing
tap every host-side kernel entry reports into, with the same
``record`` / ``timed`` / ``dump`` / ``dump_histograms`` behaviour and
output, so the two packages' ``dump_kernel_profile`` bodies read alike:

- **first call vs steady state**: each call is keyed on the caller's
  signature (matrix key + batch shape).  The first sighting of a
  signature counts as a cache ``miss`` and lands in ``first_exec_s``;
  repeats are ``hits`` and land in ``exec_time``.  There is no AOT
  compile to split off here: the Hopper kernels are built once per
  process and take the matrix as a runtime plan, so a first call's
  extra cost is the plan packing, the library load and, once, the
  build.  ``aot_split`` is always false.
- **device time, not enqueue time**: a call whose input is a CUDA
  tensor is timed on the card, between two CUDA events that
  :meth:`KernelProfiler.call_jitted` records on the tensor's stream
  around it.  Kernel launches return before the card finishes, so the
  host clock would read enqueue time; waiting for the card instead
  would make every device-resident call block.  The pair is read once
  the card has passed the second event, once 32 calls are held, at a
  host call, a ``dump`` or a ``reset``, so the call itself never
  waits, and is then kept for reuse: creating two events a call, or
  reading them on every call, costs the caller about as much as
  waiting for the card.
- **per-engine batch shapes** and **per-engine latency histograms**
  (bytes x seconds, log2), served by ``dump_histograms``.
- **the trace-window tap**: while an ``ops.device_trace`` window is
  open (``trace_sink``), every call reports its engine, key and HOST
  interval to the window at call time — for a CUDA call too, whose
  device time is read later — and :meth:`KernelProfiler.merge_device_time`
  folds a closed window's per-engine buckets back in, served as each
  engine's ``device_trace`` in ``dump``.

Import-light: torch is imported only where a CUDA call is timed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Hashable

from ..common.perf_counters import PerfHistogram, size_latency_axes

# kernel-call latencies start ~1 us (cached host dispatch) — a finer
# floor than the daemon op histograms
_KERNEL_AXES = dict(size_min=4096.0, lat_min=1e-6)


class _EngineStats:
    __slots__ = ("calls", "compile_calls", "cache_hits", "compile_time",
                 "exec_time", "bytes", "exec_bytes", "shapes", "hist",
                 "first_exec_time", "first_execs", "device")

    def __init__(self):
        self.calls = 0
        self.compile_calls = 0
        self.cache_hits = 0
        self.compile_time = 0.0
        self.exec_time = 0.0
        self.bytes = 0
        self.exec_bytes = 0  # cached-call bytes only, for exec_gbps
        self.shapes: dict[str, int] = {}
        self.hist = PerfHistogram(size_latency_axes(**_KERNEL_AXES))
        # first sightings of a signature: plan packing, library load
        # (and, once a process, the build) fused with the first
        # execution — kept out of BOTH compile_time and exec_time so
        # neither stat lies
        self.first_exec_time = 0.0
        self.first_execs = 0
        # per-bucket device-event seconds merged from closed trace
        # windows (ops.device_trace): fused_op / dma / collective
        self.device: dict[str, float] = {}


class KernelProfiler:
    """Process-global per-engine kernel timing (see module docstring).

    An *engine* is a kernel family as the codec layer routes it
    ("gf_encode", "ec_shards", "bitmatrix_decode", "crush_vec", ...);
    a *key* is the call signature the caller knows (matrix signature +
    batch shape), used to classify first calls vs steady-state calls.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._engines: dict[str, _EngineStats] = {}
        # signatures OUTLIVE reset(): the built kernels and the codecs'
        # packed plans are not dropped by a profiler reset, so a warmed
        # key stays a hit
        self._seen: set[tuple[str, Hashable]] = set()
        self._reset_at = time.time()
        # CUDA calls whose end event the card has not passed yet:
        # (engine, key, device, (start, end), nbytes, shape), in call
        # order; and read event pairs kept for reuse, per device (an
        # event is bound to the device it was first recorded on, and
        # creating one costs more than recording it)
        self._pending: deque = deque()
        self._free: dict[Any, list] = {}
        # ops.device_trace window sink: while a trace window is open,
        # every call reports its (engine, key, host interval) for
        # per-engine attribution of the captured device events.  One
        # attribute read when no window exists — zero-cost default.
        self.trace_sink: Any = None

    # -- recording -----------------------------------------------------------
    def record(self, engine: str, key: Hashable, seconds: float,
               nbytes: int = 0, shape: Any = None,
               compiled: bool | None = None, noted: bool = False) -> None:
        """``compiled`` overrides the first-sighting classification for
        callers that know (``compiled=False`` records a steady-state
        call, ``compiled=True`` a pure build).  An un-overridden first
        sighting lands in the ``first_exec`` bucket: its wall time fuses
        the one-time work with the first execution, so folding it into
        either compile_time or exec_time would lie.  A call that ended
        just now is reported to an open trace window as the interval of
        ``seconds`` ending now; ``noted`` says the caller reported it
        already (a CUDA call, recorded when the card has passed it)."""
        t_end = time.perf_counter()
        sig = (engine, key)
        with self._lock:
            st = self._engines.get(engine)
            if st is None:
                st = self._engines[engine] = _EngineStats()
            st.calls += 1
            st.bytes += int(nbytes)
            first = sig not in self._seen
            self._seen.add(sig)
            if compiled is True:
                st.compile_calls += 1
                st.compile_time += seconds
            elif compiled is None and first:
                st.compile_calls += 1  # a jit-cache miss either way
                st.first_execs += 1
                st.first_exec_time += seconds
            else:
                st.cache_hits += 1
                st.exec_time += seconds
                st.exec_bytes += int(nbytes)
            if shape is not None:
                shape = tuple(shape)  # a tuple is returned as it is
                s = _shape_names.get(shape)
                if s is None:
                    s = _shape_names[shape] = str(shape)
                st.shapes[s] = st.shapes.get(s, 0) + 1
        st.hist.sample(max(float(nbytes), 0.0), seconds)
        if not noted:
            self._note(engine, key, seconds, nbytes, t_end)

    def _note(self, engine: str, key: Hashable, seconds: float,
              nbytes: int, t_end: float) -> None:
        sink = self.trace_sink
        if sink is not None and sink.active:
            try:
                sink.note_kernel(engine, key, seconds, nbytes=nbytes,
                                 t_end_pc=t_end)
            except Exception:  # pragma: no cover - observability only
                pass

    @contextlib.contextmanager
    def timed(self, engine: str, key: Hashable, nbytes: int = 0,
              shape: Any = None, compiled: bool | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(engine, key, time.perf_counter() - t0,
                        nbytes=nbytes, shape=shape, compiled=compiled)

    def call_jitted(self, engine: str, key: Hashable, fn, args: tuple,
                    *, nbytes: int = 0, shape: Any = None, wrap=None):
        """Call a kernel entry under the profiler.  The first call on a
        signature is a miss (``first_exec_s``); repeats are steady
        state.  A call whose first CUDA tensor argument is on the card
        is timed there, between events on that tensor's stream, and
        recorded once the card has passed them (module docstring); any
        other call, and any call that raises, on the host clock.
        ``wrap`` post-processes the result INSIDE the timing (e.g. the
        copy back to host memory, so it stays accounted)."""
        device = next((a.device for a in args
                       if getattr(a, "is_cuda", False)), None)
        if device is not None:
            stream, events = _stream(device), self._event_pair(device)
            events[0].record(stream)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            if wrap is not None:
                out = wrap(out)
        except BaseException:
            self.record(engine, key, time.perf_counter() - t0,
                        nbytes=nbytes, shape=shape)
            raise
        if device is None:
            seconds = time.perf_counter() - t0
            if self._pending:  # earlier CUDA calls first, in call order
                self._settle(wait=False)
            self.record(engine, key, seconds, nbytes=nbytes, shape=shape)
        else:
            events[1].record(stream)
            # the host interval goes to an open window now: the kernels
            # this call issued were launched inside it
            t1 = time.perf_counter()
            self._note(engine, key, t1 - t0, nbytes, t1)
            with self._lock:
                self._pending.append(
                    (engine, key, device, events, nbytes, shape))
            if len(self._pending) >= _SETTLE_AFTER:
                # while the card runs this call, record the earlier ones
                self._settle(wait=False)
        return out

    def _event_pair(self, device):
        with self._lock:
            free = self._free.get(device)
            if free:
                return free.pop()
        return _new_events()

    def _settle(self, wait: bool) -> None:
        """Record the pending CUDA calls whose end event the card has
        passed, oldest first; with ``wait``, all of them."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                engine, key, device, (start, end), nbytes, shape = \
                    self._pending[0]
                if not wait and not end.query():
                    return
                self._pending.popleft()
            end.synchronize()
            self.record(engine, key, start.elapsed_time(end) / 1e3,
                        nbytes=nbytes, shape=shape, noted=True)
            with self._lock:
                free = self._free.setdefault(device, [])
                if len(free) < _FREE_EVENT_PAIRS:
                    free.append((start, end))

    def merge_device_time(self,
                          per_engine: dict[str, dict[str, float]]) -> None:
        """Fold a closed trace window's per-engine device-event buckets
        (ops.device_trace: fused_op / dma / collective seconds) into
        the matching engine entries, so ``dump_kernel_profile`` answers
        "where did the device time go?" next to the call stats.
        Accumulates across windows; cleared by :meth:`reset` like every
        other per-engine stat."""
        with self._lock:
            for engine, buckets in per_engine.items():
                st = self._engines.get(engine)
                if st is None:
                    st = self._engines[engine] = _EngineStats()
                for bucket, seconds in buckets.items():
                    st.device[bucket] = (
                        st.device.get(bucket, 0.0) + float(seconds)
                    )

    # -- views ---------------------------------------------------------------
    @staticmethod
    def _engine_seconds(st: _EngineStats) -> float:
        return st.compile_time + st.first_exec_time + st.exec_time

    def dump(self, prefix: str | None = None,
             top: int | None = None) -> dict:
        """JSON-able per-engine breakdown (``dump_kernel_profile``).
        ``prefix`` filters to one engine family (``dump(prefix="gf")``).
        ``top`` keeps only the N
        heaviest engines by recorded seconds (a busy daemon's dump
        stays readable without paging through every signature); each
        entry carries ``device_share`` — its recorded seconds over the
        window total — so the heavy hitters read at a glance."""
        self._settle(wait=True)
        with self._lock:
            picked = [
                (name, st)
                for name, st in sorted(self._engines.items())
                if prefix is None or name.startswith(prefix)
            ]
            total_s = sum(self._engine_seconds(st) for _n, st in picked)
            n_matched = len(picked)
            if top is not None and top >= 0:
                picked = sorted(
                    picked, key=lambda ns: -self._engine_seconds(ns[1])
                )[:top]
                picked.sort(key=lambda ns: ns[0])
            engines = {}
            for name, st in picked:
                engines[name] = {
                    "calls": st.calls,
                    "jit_cache": {
                        "misses": st.compile_calls,
                        "hits": st.cache_hits,
                    },
                    # always false here (no AOT compile to split off):
                    # each signature's first call is first_exec_s, in
                    # NEITHER compile_time nor exec_time
                    "aot_split": False,
                    "compile_time": round(st.compile_time, 6),
                    "first_exec_s": round(st.first_exec_time, 6),
                    "exec_time": round(st.exec_time, 6),
                    # steady-state bytes over steady-state time: mixing
                    # compile-call bytes in would inflate the rate by
                    # (1 + misses/hits)
                    "exec_gbps": round(
                        st.exec_bytes / st.exec_time / 1e9, 3
                    ) if st.exec_time > 0 else None,
                    "bytes": st.bytes,
                    "device_share": round(
                        self._engine_seconds(st) / total_s, 4
                    ) if total_s > 0 else 0.0,
                    "shapes": dict(st.shapes),
                    # per-bucket device-event seconds from the trace
                    # window(s) (ops.device_trace merge); absent until
                    # a window captured this engine
                    **({"device_trace": {
                        b: round(v, 6)
                        for b, v in sorted(st.device.items())
                    }} if st.device else {}),
                }
            return {
                "since": self._reset_at,
                "total_seconds": round(total_s, 6),
                **({"engines_omitted": n_matched - len(engines)}
                   if len(engines) < n_matched else {}),
                "engines": engines,
            }

    def dump_histograms(self) -> dict:
        self._settle(wait=True)
        with self._lock:
            return {
                name: st.hist.dump()
                for name, st in sorted(self._engines.items())
            }

    def reset(self) -> None:
        """Clear the accumulated stats (bench phase boundaries); the
        signature set survives — see __init__.  Calls still on the card
        are recorded first, so they land in the window they ran in."""
        self._settle(wait=True)
        with self._lock:
            self._engines.clear()
            self._reset_at = time.time()


_profiler: KernelProfiler | None = None
_profiler_lock = threading.Lock()


def profiler() -> KernelProfiler:
    global _profiler
    if _profiler is None:
        with _profiler_lock:
            if _profiler is None:
                _profiler = KernelProfiler()
    return _profiler


# batch shape -> its dump key, built once per shape and not on every call
_shape_names: dict[Any, str] = {}


# CUDA calls held before a call reads the finished ones (reading them
# on every call cost more than the two records); read event pairs kept
# per device, more in flight are made anew
_SETTLE_AFTER = 32
_FREE_EVENT_PAIRS = 64


def _stream(device):
    import torch

    return torch.cuda.current_stream(device)


def _new_events() -> tuple:
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
