"""Inside-the-kernel device tracing: ``torch.profiler`` trace windows,
the per-engine kernel / copy / collective breakdown, and the
device-launch flight recorder.

Counterpart of ``ceph_tpu/ops/device_trace.py``, with the same names,
lifecycle and output keys, so the two packages' ``kernel trace dump``
bodies read alike.  The reference's windows are ``jax.profiler``
sessions whose bucket rules read HLO event shapes; here a window is a
``torch.profiler.profile`` session (Kineto, CUPTI on the card) and the
rules read Kineto's chrome-trace shapes:

- :class:`DeviceTracer` — an on-demand **trace window** service around
  whatever the process is launching (dispatcher batches included: the
  card's kernel, copy and runtime-API activity is captured process-wide,
  worker threads and all).  It parses the captured trace (the
  ``*.pt.trace.json`` that ``export_chrome_trace`` writes) into
  per-engine **fused-op / DMA / collective** buckets and merges them
  into the :class:`~ceph_tpu_torch.ops.profiler.KernelProfiler` entries
  under the same engine names.
- :class:`FlightRecorder` — a bounded ring of the last N device
  launches (lane, batch key, QoS class, queue-wait vs device wall,
  trace id of the slowest member op), fed by the EC dispatcher and
  consulted by the SLOW_OPS dump path so a slow op's record names the
  launch that carried it.
- the parse/classify helpers — pure functions over trace-event dicts,
  pinned by tests on a hand-written Kineto-shaped fixture.

**Buckets.**  ``cat: "kernel"`` is ``fused_op``, except NCCL kernels
(``ncclDevKernel_*`` / ``ncclKernel_*``), which are ``collective``;
``gpu_memcpy`` and ``gpu_memset`` are ``dma``, except the mesh's gather
copies: a device-to-device or peer copy (``Memcpy DtoD`` / ``Memcpy
PtoP``) whose launch call lies, by correlation, in a ``mesh_gather`` or
``mesh_reconstruct`` tap interval is ``collective`` (the reference's
all-gather over ICI).  Every other copy, host<->device included, stays
``dma``.  Everything else —
``cuda_runtime`` / ``cuda_driver`` launch calls, ``cpu_op``,
``python_function``, ``user_annotation``, ``gpu_user_annotation``,
flow events (``ph`` other than ``"X"``, ``ac2g``) — is host-side or
wraps the device work beneath it, and would count it twice.

**Attribution.**  While a window is open, every profiler-tapped kernel
call reports its (engine, key, host interval) through
:meth:`DeviceTracer.note_kernel`, at call time (a CUDA call's device
time is read later, when the card has passed it, but its host interval
is the call's own).  A kernel runs after its host call returns, so
device time alone cannot say which call issued it.  Each ``kernel`` /
``gpu_memcpy`` / ``gpu_memset`` event is instead tied through its
``args.correlation`` to the ``cuda_runtime`` / ``cuda_driver`` event
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernelEx``, ...)
that issued it, and that host event lies inside the tap's interval.
The trace's timeline (microseconds from ``baseTimeNanoseconds``) is
anchored to ``time.perf_counter`` by a ``record_function`` marker
emitted as the window opens.  An event with no launch event falls back
to the reference's rule: the interval its own time overlaps most, or the
nearest one within 2 ms.

**Completeness.**  A card window's session starts with one profiler
warm-up step (``WARM_UP_S`` of tiny probes on the card, not kept) and
only then records, because the card's activity collection comes up
some time after the session starts; and it waits for the card before
it stops, so every launch of the window has finished when the activity
buffers are flushed.  The dump's ``capture`` key (:func:`capture_check`)
holds each hand kernel's captured ``kernel`` events against the
launches its wrapper counted while the window was open
(``gf_cuda.launch_counts`` when the session came up and again before it
stops), lists the kernels whose capture is ``short``, and counts the
tap intervals with no captured device event.  A launch counted at a
window's edge, while another caller opens or closes it, may count on
one side only.

**Threads.**  Kineto's session state belongs to the thread that opened
it, so a window is one session owned by one thread of its own: ``start``
and ``stop`` (and the expiry timer) only signal that thread.  Its
client initializes on the first thread that opens any session, which
must be the thread torch was imported on: :meth:`DeviceTracer.prepare`
does that once, from the daemon's own thread.

**Devices.**  A window on a CUDA device captures the card's activity,
and one that captures no CUDA event is an error reply, not an empty
success; a ``"cpu"`` window captures the host alone (its device
buckets stay empty: no CUDA event is device work).

Degradation contract: no ``torch.profiler``, no CUDA for a card window,
a session that fails to open, a parse failure, or a second concurrent
``start`` all return a structured ``{"unavailable": reason}`` (or
``{"error": ...}``) — never an exception into the admin socket or the
data path.  Windows are bounded (``max_duration`` clamps the requested
duration and an expiry timer closes an abandoned window), and the
feature is off-cost when no window is open: the profiler's per-call tap
is one attribute read.  Import-light: torch is imported only when a
window opens.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import shutil
import tempfile
import threading
import time
from collections import deque
from typing import Any, Hashable, Iterable

BUCKETS = ("fused_op", "dma", "collective")

# Kineto event categories that are device work
_KERNEL_CAT = "kernel"
_DMA_CATS = ("gpu_memcpy", "gpu_memset")
# the host-side calls that issue device work, tied to it by correlation
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# NCCL collective kernels (ncclDevKernel_AllGather_RING_LL,
# ncclKernel_AllReduce_...): cross-device traffic, not compute
_COLLECTIVE_MARKS = ("nccldevkernel", "ncclkernel")
# the mesh engine's gather (parallel/distributed.gather_rebuild): its
# copies between lanes, tied by correlation to these engines' calls
_GATHER_ENGINES = ("mesh_gather", "mesh_reconstruct")
_LANE_COPY_MARKS = ("DtoD", "PtoP")

# the record_function marker that anchors a window's timeline
ANCHOR_NAME = "ceph_tpu_torch::ktrace_anchor"
# how long start/stop wait for the session thread (the first CUDA
# session initializes CUPTI)
_SESSION_WAIT_S = 120.0
# a card window's warm-up before it opens, and the gap between its probes
WARM_UP_S = 1.0
WARM_UP_PROBE_S = 0.01


def classify_trace_event(name: str, args: dict | None = None,
                         thread_name: str = "", cat: str = "",
                         ph: str = "X") -> str | None:
    """Bucket one Kineto trace event: ``"collective"`` / ``"dma"`` /
    ``"fused_op"`` for device work, None for everything that is host
    side or wraps the device work (see the module docstring)."""
    if ph != "X":
        return None
    if cat == _KERNEL_CAT:
        low = (name or "").lower()
        if any(m in low for m in _COLLECTIVE_MARKS):
            return "collective"
        return "fused_op"
    if cat in _DMA_CATS:
        return "dma"
    return None


def parse_trace_dir(log_dir: str) -> tuple[list[dict], dict]:
    """Load every ``*.trace.json[.gz]`` under a log dir (this includes
    the ``*.pt.trace.json[.gz]`` that torch.profiler writes); returns
    ``(events, thread_names)`` where ``thread_names`` maps
    ``(pid, tid) -> name`` from the metadata events.  Raises on an
    unreadable/unparsable capture (the caller degrades it to
    ``unavailable``)."""
    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*.trace.json"),
                    recursive=True)
    )
    if not paths:
        raise FileNotFoundError(
            f"no *.trace.json[.gz] under {log_dir!r} (profiler wrote "
            "nothing)"
        )
    events: list[dict] = []
    threads: dict[tuple, str] = {}
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            obj = json.loads(f.read())
        for ev in obj.get("traceEvents", []):
            if ev.get("ph") == "M":
                if ev.get("name") == "thread_name":
                    threads[(ev.get("pid"), ev.get("tid"))] = (
                        (ev.get("args") or {}).get("name", "")
                    )
                continue
            if ev.get("ph") == "X" and "ts" in ev:
                events.append(ev)
    return events, threads


def _event_bucket(ev: dict, threads: dict) -> str | None:
    return classify_trace_event(
        ev.get("name", ""), ev.get("args"),
        threads.get((ev.get("pid"), ev.get("tid")), ""),
        cat=ev.get("cat", ""), ph=ev.get("ph", "X"),
    )


def device_spans(events: Iterable[dict],
                 threads: dict | None = None) -> list[tuple[float, float]]:
    """``(start_us, end_us)`` of every device event (the ones a bucket
    counts), on the trace timeline."""
    threads = threads or {}
    return [
        (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
        for ev in events if _event_bucket(ev, threads) is not None
    ]


def busy_seconds(spans: Iterable[tuple[float, float]]) -> float:
    """The union of ``(start_us, end_us)`` spans, in seconds: the time
    the device had any event running, overlaps counted once."""
    total = 0.0
    end = None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total / 1e6


def _launch_calls(events: list[dict]) -> dict[Any, tuple[float, float]]:
    """Correlation id -> the host launch call's (ts, dur), in us."""
    calls = {}
    for ev in events:
        if ev.get("cat") in _LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                calls[corr] = (float(ev["ts"]), float(ev.get("dur", 0.0)))
    return calls


def summarize_events(
    events: Iterable[dict], threads: dict | None = None, *,
    intervals: Iterable[tuple] = (), anchor_offset: float | None = None,
    wall_s: float | None = None, top_ops: int = 10,
) -> dict:
    """Classify + aggregate parsed trace events into the per-engine
    breakdown.  ``intervals`` is ``[(t0, t1, engine, key), ...]`` on
    the ``time.perf_counter`` timeline; ``anchor_offset`` maps an event
    timestamp (microseconds on the trace timeline) onto that timeline
    (``pc = anchor_offset + ts/1e6``) — None disables attribution and
    everything lands in ``unattributed``.  A device event is placed by
    the launch event its ``args.correlation`` names, else by its own
    time (module docstring); a lane-to-lane copy issued by the mesh's
    gather is ``collective``."""
    threads = threads or {}
    events = list(events)
    ivs = sorted(intervals)
    buckets = {b: 0.0 for b in BUCKETS}
    engines: dict[str, dict] = {}
    unattributed = {b: 0.0 for b in BUCKETS}
    ops: dict[tuple, list] = {}
    n_op_events = 0
    launches = _launch_calls(events)

    def _attr(ev_t0: float, ev_t1: float):
        """Engine/key of the launch interval overlapping this span most
        (linear scan is fine: intervals are bounded and windows are
        short); residual skew between the trace timeline and the
        perf_counter anchor is absorbed by a nearest-interval fallback
        within 2 ms."""
        best, best_ov = None, 0.0
        near, near_d = None, 2e-3
        for t0, t1, engine, key in ivs:
            ov = min(t1, ev_t1) - max(t0, ev_t0)
            if ov > best_ov:
                best, best_ov = (engine, key), ov
            elif best is None:
                d = max(t0 - ev_t1, ev_t0 - t1)
                if d < near_d:
                    near, near_d = (engine, key), d
        return best if best is not None else near

    for ev in events:
        bucket = _event_bucket(ev, threads)
        if bucket is None:
            continue
        name = ev.get("name", "")
        n_op_events += 1
        dur_s = float(ev.get("dur", 0.0)) / 1e6
        owner = None
        if anchor_offset is not None and ivs:
            launch = launches.get((ev.get("args") or {}).get("correlation"))
            if launch is not None:
                # a zero-length host event still has to overlap: give
                # it a microsecond
                t0 = anchor_offset + launch[0] / 1e6
                owner = _attr(t0, t0 + max(launch[1], 1.0) / 1e6)
                if (bucket == "dma" and owner is not None
                        and owner[0] in _GATHER_ENGINES
                        and any(m in name for m in _LANE_COPY_MARKS)):
                    bucket = "collective"
            else:
                t0 = anchor_offset + float(ev["ts"]) / 1e6
                owner = _attr(t0, t0 + dur_s)
        buckets[bucket] += dur_s
        o = ops.setdefault((name, bucket), [0, 0.0])
        o[0] += 1
        o[1] += dur_s
        if owner is None:
            unattributed[bucket] += dur_s
            continue
        engine, key = owner
        e = engines.setdefault(engine, {
            **{b: 0.0 for b in BUCKETS}, "seconds": 0.0, "events": 0,
            "keys": {},
        })
        e[bucket] += dur_s
        e["seconds"] += dur_s
        e["events"] += 1
        ks = str(key)
        e["keys"][ks] = e["keys"].get(ks, 0.0) + dur_s
    device_s = sum(buckets.values())
    out = {
        "op_events": n_op_events,
        "buckets": {b: round(v, 6) for b, v in buckets.items()},
        "device_seconds": round(device_s, 6),
        "engines": {
            name: {
                **{b: round(e[b], 6) for b in BUCKETS},
                "seconds": round(e["seconds"], 6),
                "events": e["events"],
                # a handful of the heaviest call signatures, so a busy
                # engine's dump names WHICH call burned the time
                "top_keys": {
                    k: round(v, 6) for k, v in sorted(
                        e["keys"].items(), key=lambda kv: -kv[1]
                    )[:5]
                },
            }
            for name, e in sorted(engines.items())
        },
        "unattributed": {b: round(v, 6)
                         for b, v in unattributed.items()},
        "top_ops": [
            {"name": n, "bucket": b, "count": c,
             "seconds": round(s, 6)}
            for (n, b), (c, s) in sorted(
                ops.items(), key=lambda kv: -kv[1][1]
            )[:top_ops]
        ],
    }
    if wall_s and wall_s > 0:
        # device-busy share of the window; >1.0 means overlapping
        # streams (two dispatcher workers) — an occupancy, not a
        # utilization percentage (busy_seconds gives the union)
        out["occupancy"] = round(device_s / wall_s, 4)
    return out


def capture_check(events: Iterable[dict], launched: dict[str, int],
                  threads: dict | None = None, *,
                  intervals: Iterable[tuple] = (),
                  anchor_offset: float | None = None) -> dict:
    """Whether a capture holds every launch the window counted.

    ``launched`` maps a hand kernel's name (``gf_cuda.launches``' keys)
    to the launches its wrapper counted while the window was open; a
    captured ``kernel`` event belongs to it when its name carries
    ``<name>_kernel``.  ``short`` lists the kernels with fewer captured
    events than counted launches.  ``intervals_without_device_events``
    counts the tap intervals (``summarize_events``' ``intervals``) that
    no captured device event's launch call, or where it has none its own
    time, overlaps: a tapped call whose device work is missing from the
    capture.  Without an anchor no interval can be placed, and every one
    counts as without events."""
    threads = threads or {}
    events = list(events)
    captured = {name: 0 for name in launched}
    launch_at = _launch_calls(events)
    spans = []
    for ev in events:
        if _event_bucket(ev, threads) is None:
            continue
        if ev.get("cat") == _KERNEL_CAT:
            for name in captured:
                if f"{name}_kernel" in ev.get("name", ""):
                    captured[name] += 1
        if anchor_offset is not None:
            t, d = launch_at.get((ev.get("args") or {}).get("correlation"),
                                 (float(ev["ts"]), float(ev.get("dur", 0.0))))
            t0 = anchor_offset + t / 1e6
            spans.append((t0, t0 + max(d, 1.0) / 1e6))
    spans.sort()
    starts = [a for a, _ in spans]
    # the latest end among the spans that start before each point: an
    # interval is covered when a span starting before its end ends
    # after its start
    reach, latest = [], float("-inf")
    for _, b in spans:
        latest = max(latest, b)
        reach.append(latest)
    empty = 0
    for t0, t1, *_ in intervals:
        hi = bisect.bisect_right(starts, t1)
        if hi == 0 or reach[hi - 1] < t0:
            empty += 1
    kernels = {name: {"launched": int(launched[name]), "captured": captured[name]}
               for name in sorted(launched)}
    return {
        "kernels": kernels,
        "short": [n for n, k in kernels.items() if k["captured"] < k["launched"]],
        "intervals_without_device_events": empty,
    }


def _wants_cuda(device) -> bool | None:
    """True for a CUDA device, False for the host, None to take the
    card when there is one."""
    if device is None:
        return None
    return str(device).split(":", 1)[0] == "cuda"


class _Session:
    """One torch.profiler session, opened, stopped and exported by a
    thread of its own (Kineto's session state is that thread's)."""

    def __init__(self, cuda: bool, path: str):
        self.cuda = cuda
        self.path = path
        self.error: Exception | None = None
        self.anchor_pc: float | None = None
        self._opened = threading.Event()
        self._close = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="ktrace-session", daemon=True
        )

    def open(self) -> None:
        self._thread.start()
        if not self._opened.wait(_SESSION_WAIT_S):
            self._close.set()
            raise TimeoutError("the profiler session did not open")
        if self.error is not None:
            raise self.error

    def close(self) -> None:
        self._close.set()
        self._thread.join(_SESSION_WAIT_S)
        if self._thread.is_alive():
            raise TimeoutError("the profiler session did not stop")
        if self.error is not None:
            raise self.error

    def _run(self) -> None:
        on_card = self.cuda
        try:
            import torch
            from torch.profiler import (
                ProfilerActivity,
                profile,
                record_function,
                schedule,
            )

            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            # one warm-up step, then one recorded until stop: the card's
            # activity is collected from start(), and kept only from step()
            prof = profile(activities=acts,
                           schedule=schedule(wait=0, warmup=1, active=1))
            prof.start()
            if on_card:
                _warm_up(torch)
            prof.step()
            with record_function(ANCHOR_NAME):
                self.anchor_pc = time.perf_counter()
        except Exception as e:  # swallow-ok: handed to open()'s caller, which replies unavailable
            self.error = e
            self._opened.set()
            return
        self._opened.set()
        self._close.wait()
        try:
            if on_card:
                # every launch of the window has finished on the card
                # before the activity buffers are flushed
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(self.path)
        except Exception as e:  # swallow-ok: handed to close()'s caller, which replies unavailable
            self.error = e


def _warm_up(torch) -> None:
    """Keep the card busy with tiny probes for ``WARM_UP_S`` while the
    session's CUDA activity collection comes up.  Without it, a window
    on an H100 sometimes lost its first launches: their runtime calls
    were in the capture, their kernels and copies were not.  The
    warm-up step's activity is not kept, so the window starts after
    it."""
    x = torch.zeros(1, device="cuda")
    end = time.perf_counter() + WARM_UP_S
    while time.perf_counter() < end:
        x.add_(1)
        torch.cuda.synchronize()
        time.sleep(WARM_UP_PROBE_S)


def _launch_counts() -> dict[str, int]:
    from . import gf_cuda

    return gf_cuda.launch_counts()


_prepared = False
_prepare_lock = threading.Lock()


class DeviceTracer:
    """Process-global trace-window service (one window at a time).

    Lifecycle: ``start(duration)`` opens a torch.profiler session on a
    thread of its own and arms a daemon-thread expiry timer; kernel
    calls report their (engine, key, interval) via :meth:`note_kernel`
    (the KernelProfiler calls it on every call while a window is open);
    ``stop()`` closes the session, parses the capture, attributes
    events to engines, and merges the per-engine buckets into the
    KernelProfiler.  ``status``/``dump`` serve the admin commands.

    Locking discipline: the heavy work — the torch import, opening and
    closing the session, and the capture parse — happens OUTSIDE
    ``self._lock``, so the lock-only readers (``status()``,
    ``totals()``, which run on daemon event loops) never block behind
    it.  An abandoned window is closed by the expiry timer's own thread
    (plus a lazy check in ``start``/``dump``, which run in executors),
    so the operator who started a window and walked away cannot leave
    profiler overhead armed — and no event loop pays for the close."""

    MAX_INTERVALS = 8192
    DEFAULT_DURATION = 2.0

    def __init__(self):
        self._lock = threading.Lock()
        self._active = False
        self._label = ""
        self._dir: str | None = None
        self._session: _Session | None = None
        self._opened_at = 0.0
        self._deadline = 0.0
        self._timer: threading.Timer | None = None
        self._intervals: list[tuple] = []
        self._intervals_dropped = 0
        # the hand kernels' launch counts when the open window's session
        # came up (gf_cuda.launch_counts), for the capture check
        self._launches_at_open: dict[str, int] = {}
        # clear while a close is between marking the window inactive and
        # storing its result
        self._not_closing = threading.Event()
        self._not_closing.set()
        self.last: dict | None = None
        # the last closed window's device spans ((start_us, end_us) on
        # its trace timeline), for an idle share over its wall time
        self.last_device_spans: list[tuple[float, float]] = []
        self._totals = {b: 0.0 for b in BUCKETS}
        self._consumed: dict[str, float] = {}  # consume_totals cursor
        self._windows = 0
        self._failed_windows = 0
        self._last_occupancy = 0.0

    # the KernelProfiler's fast-path gate: one attribute read per
    # kernel call when no window is open
    @property
    def active(self) -> bool:
        return self._active

    @staticmethod
    def prepare() -> None:
        """Initialize the profiler's client on the calling thread, once
        per process: call it from the thread torch was imported on
        (module docstring).  Best effort: a failure here shows as an
        ``unavailable`` reply when a window opens."""
        global _prepared
        with _prepare_lock:
            if _prepared:
                return
            _prepared = True
            try:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU]):
                    pass
            except Exception:  # swallow-ok: start() reports a profiler that cannot open
                pass

    # -- window lifecycle ----------------------------------------------------

    def start(self, duration: float | None = None, label: str = "",
              max_duration: float = 30.0, device=None) -> dict:
        """``device``: a CUDA device captures the card (and is refused
        without CUDA), ``"cpu"`` the host alone, None the card when
        there is one."""
        try:
            import torch
            import torch.profiler  # noqa: F401 — deferred, heavy
        except Exception as e:  # swallow-ok: no torch.profiler in this process — a structured unavailable, nothing device-side was touched
            return {"unavailable": f"torch.profiler not importable: {e!r}"}
        cuda = _wants_cuda(device)
        if cuda is None:
            cuda = torch.cuda.is_available()
        elif cuda and not torch.cuda.is_available():
            return {"unavailable": "a CUDA trace window needs CUDA, and "
                                   "torch.cuda.is_available() is false"}
        if self._expired():
            self._close(expired=True)
        want = float(duration) if duration else self.DEFAULT_DURATION
        want = max(0.05, min(want, float(max_duration)))
        with self._lock:
            if self._active:
                return {
                    "error": "a trace window is already open "
                             f"(label={self._label!r}, "
                             f"{max(0.0, self._deadline - time.time()):.1f}s"
                             " left) — one window at a time; `kernel "
                             "trace stop` it first",
                    "busy": True,
                }
            # reserve the window NOW: one at a time holds even while
            # the session opens outside the lock below (a _close in the
            # meantime sees no session and leaves the reservation)
            self._active = True
            self._label = label or ""
            self._dir = None
            self._session = None
            self._opened_at = time.time()
            self._deadline = self._opened_at + want
            self._intervals = []
            self._intervals_dropped = 0
        log_dir = tempfile.mkdtemp(prefix="ceph-tpu-torch-ktrace-")
        session = _Session(cuda, os.path.join(log_dir, "window.pt.trace.json"))
        try:
            session.open()
        except Exception as e:  # swallow-ok: profiler refused (no CUPTI / session conflict) — structured unavailable, no window opened
            shutil.rmtree(log_dir, ignore_errors=True)
            with self._lock:
                self._active = False
                self._failed_windows += 1
            return {"unavailable": f"profiler session failed: {e!r}"}
        # the expiry bound runs on its own daemon thread: no event
        # loop (report tick, sync admin handler) ever pays for the
        # close of an abandoned window
        timer = threading.Timer(want + 0.05, self._expire)
        timer.daemon = True
        with self._lock:
            # a stop() or dump() that came while the session opened
            # found no session to close and left the reservation alone,
            # so the window is still this call's
            self._dir = log_dir
            self._session = session
            self._timer = timer
            self._launches_at_open = _launch_counts()
            # restart the expiry clock now the session is actually
            # open: the first CUDA session pays CUPTI's init, and a
            # short window must not expire during its own open
            self._opened_at = time.time()
            self._deadline = self._opened_at + want
        timer.start()
        # the profiler tap starts feeding note_kernel from here
        from .profiler import profiler

        profiler().trace_sink = self
        return {
            "success": "trace window open",
            "label": label or "",
            "duration_s": round(want, 3),
            "expires_in_s": round(want, 3),
        }

    def note_kernel(self, engine: str, key: Hashable, seconds: float,
                    nbytes: int = 0,
                    t_end_pc: float | None = None) -> None:
        """One profiler-tapped kernel call's host interval (called by
        the KernelProfiler while a window is open; bounded, so a storm
        cannot grow without limit)."""
        if not self._active:
            return
        t1 = t_end_pc if t_end_pc is not None else time.perf_counter()
        with self._lock:
            if not self._active:
                return
            if len(self._intervals) >= self.MAX_INTERVALS:
                self._intervals_dropped += 1
                return
            self._intervals.append((t1 - seconds, t1, engine, key))

    def stop(self) -> dict:
        return self._close()

    def _expired(self) -> bool:
        with self._lock:
            return self._active and time.time() > self._deadline

    def _expire(self) -> None:
        """Timer-thread body: close the window the operator abandoned
        (best effort — a racing explicit stop() wins idempotently)."""
        try:
            if self._expired():
                self._close(expired=True)
        except Exception:  # swallow-ok: expiry is best-effort observability; an explicit stop/dump still closes and reports the failure
            pass

    def _close(self, expired: bool = False) -> dict:
        """Close the open window: mark it inactive under the lock, then
        do the heavy work (session stop + parse) OUTSIDE it, then store
        the result.  Idempotent — a second caller sees no open
        window."""
        with self._lock:
            if not self._active or self._session is None:
                # no_window is the structured signal (callers racing
                # the expiry timer key on it to serve dump() instead —
                # never on the message text)
                return {"unavailable": "no trace window open",
                        "no_window": True}
            log_dir = self._dir
            session = self._session
            label = self._label
            wall_s = time.time() - self._opened_at
            intervals = self._intervals
            dropped = self._intervals_dropped
            at_open = self._launches_at_open
            self._active = False
            self._not_closing.clear()
            self._dir = None
            self._session = None
            self._intervals = []
            timer, self._timer = self._timer, None
        try:
            if timer is not None:
                timer.cancel()  # no-op when this IS the timer thread
            try:
                launched = {n: c - at_open.get(n, 0)
                            for n, c in _launch_counts().items()}
                session.close()
                events, threads = parse_trace_dir(log_dir)
                anchor_ts = min(
                    (float(e["ts"]) for e in events
                     if e.get("name") == ANCHOR_NAME),
                    default=None,
                )
                offset = (session.anchor_pc - anchor_ts / 1e6
                          if anchor_ts is not None else None)
                summary = summarize_events(
                    events, threads, intervals=intervals,
                    anchor_offset=offset, wall_s=wall_s,
                )
                spans = device_spans(events, threads)
                capture = capture_check(events, launched, threads,
                                        intervals=intervals, anchor_offset=offset)
                failure = None
                if session.cuda and not spans:
                    failure = ("the CUDA trace window captured no CUDA "
                               "kernel, copy or memset")
            except Exception as e:  # swallow-ok: capture/parse failure is an observability miss, not an op error — the window closes and reports a structured unavailable
                failure = f"trace capture failed: {e!r}"
                summary = None
            finally:
                if log_dir:
                    shutil.rmtree(log_dir, ignore_errors=True)
            if failure is not None:
                with self._lock:
                    self._failed_windows += 1
                    self.last = {
                        ("error" if summary is not None else "unavailable"):
                            failure,
                        "label": label, "wall_s": round(wall_s, 3),
                    }
                    self.last_device_spans = []
                    return dict(self.last)
            result = {
                "label": label,
                "wall_s": round(wall_s, 3),
                **({"expired": True} if expired else {}),
                **({"intervals_dropped": dropped} if dropped else {}),
                "launch_intervals": len(intervals),
                **summary,
                "capture": capture,
            }
            with self._lock:
                self._windows += 1
                for b in BUCKETS:
                    self._totals[b] += summary["buckets"][b]
                self._last_occupancy = summary.get("occupancy", 0.0)
                self.last = result
                self.last_device_spans = spans
            # fold the per-engine buckets into the KernelProfiler entries
            # (same engine names as the call stats): dump_kernel_profile
            # then says where each engine's device time went
            from .profiler import profiler

            profiler().merge_device_time({
                name: {b: e[b] for b in BUCKETS}
                for name, e in summary["engines"].items()
            })
            return dict(result)
        finally:
            # a dump() that raced this close waits for it here
            self._not_closing.set()

    # -- admin/service views -------------------------------------------------

    def status(self) -> dict:
        """Lock-only state read — safe straight on an event loop (the
        sync admin handler, a report tick): an expired-but-not-yet-
        closed window (the timer fires within ~50 ms) reports active
        with expires_in_s 0."""
        with self._lock:
            return {
                "active": self._active,
                **({"label": self._label,
                    "expires_in_s": round(
                        max(0.0, self._deadline - time.time()), 3),
                    "launch_intervals": len(self._intervals)}
                   if self._active else {}),
                "windows": self._windows,
                "failed_windows": self._failed_windows,
                "device_seconds_total": {
                    b: round(v, 6) for b, v in self._totals.items()
                },
                "last_occupancy": self._last_occupancy,
            }

    def dump(self) -> dict:
        """The last closed window's breakdown (closing an expired one
        first, so `trace start` + launch + `trace dump` round-trips
        without an explicit stop once the duration passed).  Runs the
        close itself when it races the expiry timer, and waits for a
        close already under way on another thread — callers arrive via
        executors (admin handler) or sync tools, never bare on a daemon
        event loop."""
        if self._expired():
            self._close(expired=True)
        self._not_closing.wait(_SESSION_WAIT_S)
        with self._lock:
            if self._active:
                return {
                    "unavailable": "trace window still open "
                                   f"({self._deadline - time.time():.1f}s"
                                   " left) — `kernel trace stop` it "
                                   "first or wait for expiry",
                }
            if self.last is None:
                return {"unavailable": "no trace window captured yet"}
            return dict(self.last)

    def totals(self) -> dict:
        """Monotonic per-bucket device-seconds across every window this
        process captured.  Lock-only read: safe on an event loop."""
        with self._lock:
            return {
                **{b: self._totals[b] for b in BUCKETS},
                "windows": self._windows,
                "last_occupancy": self._last_occupancy,
            }

    def consume_totals(self) -> dict:
        """The not-yet-consumed slice of :meth:`totals` — advances a
        single process-global cursor, so the per-bucket seconds are
        handed out exactly ONCE across however many daemons share this
        process (every daemon pulling :meth:`totals` independently
        would report N copies of the same window).  Lock-only; safe on
        an event loop."""
        with self._lock:
            out = {}
            for b in BUCKETS:
                out[b] = self._totals[b] - self._consumed.get(b, 0.0)
                self._consumed[b] = self._totals[b]
            out["windows"] = self._windows
            out["last_occupancy"] = self._last_occupancy
            return out


class FlightRecorder:
    """Ring buffer of the last N device launches (the black box the
    reference keeps for ops via OpHistory, applied to LAUNCHES): lane,
    batch key, QoS class, queue-wait vs device wall, and the trace id
    of the slowest member op.  ``lookup(trace_id)`` answers "which
    launch carried this op?" — the SLOW_OPS dump path consults it so a
    slow op's record names its launch instead of leaving the operator
    to correlate timestamps by hand."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._inflight: dict[int, dict] = {}
        self._seq = 0

    def begin(self, *, traces: Iterable[str | None] = (),
              **info: Any) -> int:
        """Open a launch record (visible to lookup/dump while the
        device call is in flight — a wedged launch must be findable
        BEFORE it completes).  Returns the token for :meth:`end`."""
        with self._lock:
            self._seq += 1
            token = self._seq
            self._inflight[token] = {
                "seq": token,
                "t": time.time(),
                "_traces": {t for t in traces if t},
                **info,
            }
            return token

    def end(self, token: int, *, device_wall_s: float | None = None,
            served: str | None = None, error: str | None = None,
            origin: str | None = None,
            remote_served: str | None = None,
            remote_queue_wait_s: float | None = None) -> None:
        """``origin`` names the lane whose FAULT caused a
        fallback-served batch ("remote" = accelerator/network trip,
        "device" = local device trip) — without it an operator reading
        ``dump_launch_history`` cannot tell which fault domain the
        replay answered for.  ``remote_served`` names the engine the
        ACCELERATOR served a remote-lane batch from (device /
        native_direct / fallback — the reply piggybacks it), so the
        client-side record shows whether the shared device, or its host
        fallback, actually produced the bytes."""
        with self._lock:
            rec = self._inflight.pop(token, None)
            if rec is None:
                return
            if device_wall_s is not None:
                rec["device_wall_s"] = round(device_wall_s, 6)
            if served is not None:
                rec["served"] = served
            if error is not None:
                rec["error"] = error
            if origin is not None:
                rec["origin"] = origin
            if remote_served is not None:
                rec["remote_served"] = remote_served
            if remote_queue_wait_s is not None:
                # accel-side coalesce wait (reply piggyback): keeps
                # the queue-wait-vs-device split honest for remote
                # launches
                rec["remote_queue_wait_s"] = round(remote_queue_wait_s, 6)
            self._ring.append(rec)

    @staticmethod
    def _public(rec: dict, in_flight: bool = False) -> dict:
        out = {k: v for k, v in rec.items() if not k.startswith("_")}
        if in_flight:
            out["in_flight"] = True
            out["age_s"] = round(time.time() - rec["t"], 3)
        return out

    def lookup(self, trace: str | None) -> dict | None:
        """The newest launch (in-flight first) that carried this trace
        id, or None."""
        if not trace:
            return None
        with self._lock:
            for rec in self._inflight.values():
                if trace in rec["_traces"]:
                    return self._public(rec, in_flight=True)
            for rec in reversed(self._ring):
                if trace in rec["_traces"]:
                    return self._public(rec)
        return None

    def dump(self) -> dict:
        """``dump_launch_history`` admin-socket body (newest last)."""
        with self._lock:
            return {
                "capacity": self._ring.maxlen,
                "in_flight": [
                    self._public(r, in_flight=True)
                    for r in self._inflight.values()
                ],
                "launches": [self._public(r) for r in self._ring],
            }


_tracer: DeviceTracer | None = None
_tracer_lock = threading.Lock()


def tracer() -> DeviceTracer:
    """The process-global window service (same singleton pattern as
    ops.profiler — every in-process daemon shares the one profiler
    session the singleton guards)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = DeviceTracer()
    return _tracer
