"""Cross-op EC microbatch dispatcher: one padded device launch for many
in-flight ops.

Counterpart of ``ceph_tpu/osd/ec_dispatch.py``, with its device lane,
native-direct lane, fallback lanes, mesh lane and remote lane.

The OSD's per-object batching (``ec_util.encode`` runs all stripes of
ONE op in one device call) stops at the op boundary: N concurrent 64 KiB
writes still cost N serial launches on the asyncio event loop, each
with its own host<->device copies and its own launch latency.  This is
the dynamic-batching lesson from accelerator serving stacks — and the
same amortization ISA-L's table cache buys the reference
(reference:src/erasure-code/isa/ErasureCodeIsaTableCache.cc): pay the
per-launch overhead once per *batch*, not once per *request*.

Three mechanisms, composed:

- **cross-op coalescing** — requests queue per (codec, stripe geometry
  [, survivor set]) key; a flusher fires on a stripe-count threshold
  (``max_stripes``) or a sub-millisecond window (``window``), stacking
  the queued ops into one ``[ΣS, k, C4]`` launch.  The GF matmul is
  columnwise, so the batch's per-shard rows are exactly the per-op rows
  concatenated: each waiter gets its row range sliced back, byte
  identical to a per-op ``ec_util.encode``/``decode_concat`` (pinned
  against the numpy oracle by tests/test_torch_ec_dispatch.py).
- **shape bucketing** — the batched stripe count is zero-padded up to
  the next power of two before the device call (pad rows sliced off on
  the way out), so the set of launch shapes (the profiler's signatures)
  holds O(log max_S) entries per codec instead of one per distinct size.
  Pad waste is tracked (``ec.dispatch_pad_stripes``/``_bytes``).  The
  native C engine takes the direct lane, unpadded.
- **event-loop liberation** — the batched device call runs in a
  ``ThreadPoolExecutor`` via ``run_in_executor``, so heartbeat,
  messenger, and op-tracker tasks keep ticking during a long encode
  instead of freezing behind a synchronous device call.

The native C engine (a codec on the CPU) opts out of coalescing
entirely (requests still run in the worker pool): it has no launch
overhead to amortize, and per-op buffers are cache-resident while a
stacked multi-op pass goes DRAM-bound.  The gates are ec_util's shared
``native_encode_path``/``native_decode_path`` predicates, the same
conditions the encode/decode stacks route on, so the lanes cannot
drift.

A fourth mechanism is the **mesh lane** (the multi-device engine as a
first-class dispatcher lane, not a bypass):

- given a :class:`~ceph_tpu_torch.parallel.engine.MeshEcEngine` as
  ``mesh_engine`` (the OSD's ``osd_ec_mesh``) and a matrix codec,
  coalesced batches route to the mesh: stripes split over its lanes,
  and reconstructs enter survivor-split and gather onto the lane that
  rebuilds each byte slice.  Batch keys grow a mesh-slice dimension
  ``(pg, shard)``, and the stripe bucketing aligns to
  ``mesh_size x bucket`` (:func:`bucket_stripes_aligned`), so lanes
  stay balanced and the program cache stays O(#buckets x
  #mesh-slices).  The lane inherits ALL the machinery below: QoS
  classes never share a mesh batch, ``launch_deadline`` bounds mesh
  launches, and a fatal mesh failure (a card in the slice dying
  included) replays bit-identically on the host fallback via the same
  classifier and supervisor.

A fifth mechanism rides on top (the accelerator fault domain,
osd/ec_failover):

- **engine failover** — a batched device launch that fails with a
  FATAL error (CUDA error / OOM / kernel build or launch — see
  ``classify_engine_error``) is replayed on the host fallback engine
  (``ec_util.encode_fallback``/``decode_concat_fallback``, pinned
  bit-identical), so no waiter ever observes a device error; data-shape
  errors still surface to their caller.  Each failure advances the
  :class:`~ceph_tpu_torch.osd.ec_failover.EngineSupervisor` breaker;
  while TRIPPED, requests route straight to the fallback lane and a
  canary probe re-promotes the device.  Every launch is bounded by
  ``launch_deadline``: past it the waiters fail over and the wedged
  worker thread stays pinned on the daemon's HeartbeatMap handle
  (grace -> health warn, suicide_grace -> daemon policy), so a hung
  device call can never silently freeze the OSD.  Fault hooks
  ``inject_engine_failure`` / ``inject_launch_hang`` prove all of it.

A sixth mechanism is the **remote lane** (the shared accelerator
service, ``accel``):

- given an :class:`~ceph_tpu_torch.accel.client.AccelClient` as
  ``remote`` (mode prefer|require), coalesced batches ship to the
  accelerator daemon over the messenger — payloads as borrowed frame
  views, QoS class + geometry in the fields, trace id on the frame
  header — unpadded: the accelerator re-coalesces across CLIENT OSDs
  through its own dispatcher, which owns the bucketing.  The remote is
  its own fault domain: beacons gate routing (a TRIPPED or saturated
  remote sheds with no timeout chain), its faults never advance the
  local breaker, and a remote fatal replays on the LOCAL host fallback
  bit-identically with ``origin=remote`` in the flight record.

Observability: batch/op/flush-reason/pad counters plus a
``dispatch_batch_size_histogram`` on the ``ec`` subsystem
(``osd.ec_perf.create_ec_perf``), the ``engine_state`` gauge and
``engine_failovers``/``replayed_ops``/``launch_deadline_timeouts``
counters for the fault domain, the kernel profiler sees the bucketed
shapes at the codec boundary, :meth:`ECDispatcher.dump` serves the
``dump_ec_dispatch`` body, and every launch (batched, native-direct,
fallback-direct) lands in the
:class:`~ceph_tpu_torch.ops.device_trace.FlightRecorder` ring — lane,
batch key, QoS class, queue-wait vs device wall, slowest member trace
id.

Threads: launches run in the worker pool, so the kernels launch from
threads other than the event loop's.  A worker thread's current CUDA
stream is its own default stream, and every device result is copied
back to host memory before the worker returns (``like_input``), so no
work of one launch is left on a stream another thread reads.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping

import numpy as np

from ..common.tracing import current_client, current_trace
from ..models.matrix_codec import EngineFault
from ..ops.device_trace import FlightRecorder
from ..utils.buffers import as_u8, note_copy
from . import ec_util

logger = logging.getLogger("ceph_tpu_torch.ec_dispatch")


class LaunchDeadlineExceeded(RuntimeError):
    """A batched device launch outlived osd_ec_launch_deadline: the
    device call is considered wedged (classified fatal by lineage —
    RuntimeError — so the replay path treats it like a device loss)."""


def bucket_stripes(s: int) -> int:
    """Smallest power of two >= ``s`` — the launch shape bucket."""
    return 1 << max(0, (int(s) - 1).bit_length())


def bucket_stripes_aligned(s: int, quantum: int = 1,
                           bucket: bool = True) -> int:
    """Mesh-lane bucketing: round ``s`` up to ``quantum * 2^j`` (the
    mesh size times a power-of-two bucket), so every lane gets the same
    stripe count AND the program cache stays O(log max_S) per mesh
    slice.  With ``bucket=False`` only the mesh alignment is applied
    (lanes must stay balanced even when the operator disables
    bucketing)."""
    units = max(1, -(-int(s) // int(quantum)))
    if bucket:
        units = bucket_stripes(units)
    return int(quantum) * units


class _Op:
    """One queued waiter: its payload and the future its op awaits.
    ``trace``/``t_submit`` feed the launch flight recorder — the
    queue-wait split and the slow-op -> launch correlation.
    ``client`` names the requesting entity; when no explicit client is
    passed it captures ``current_client`` — the tenant id the op path
    set at dispatch — so flight records attribute device time per
    tenant with no signature threading through the EC call chain.
    ``locality`` holds the surviving shards' OSD locality labels
    (decode only): the fleet router prefers the accelerator matching
    the batch's majority label."""

    __slots__ = ("fut", "stripes", "payload", "trace", "t_submit",
                 "client", "locality")

    def __init__(self, fut: asyncio.Future, stripes: int, payload: Any,
                 client=None, locality: "list[str] | None" = None):
        self.fut = fut
        self.stripes = stripes
        self.payload = payload
        self.trace = current_trace.get()
        self.t_submit = time.monotonic()
        self.client = client if client is not None \
            else current_client.get()
        self.locality = locality


class _Batch:
    """One still-collecting batch for a queue key."""

    __slots__ = ("kind", "codec", "sinfo", "ops", "stripes", "timer",
                 "lane", "quantum", "klass")

    def __init__(self, kind: str, codec, sinfo: ec_util.StripeInfo,
                 lane: str = "device", quantum: int = 1,
                 klass: str = "client"):
        self.kind = kind  # "enc" | "dec"
        self.codec = codec
        self.sinfo = sinfo
        self.ops: list[_Op] = []
        self.stripes = 0
        self.timer: asyncio.TimerHandle | None = None
        self.lane = lane  # "device" | "mesh" | "remote"
        self.quantum = int(quantum)  # stripe alignment (mesh size)
        self.klass = klass  # QoS traffic class (classes never mix)


class ECDispatcher:
    """Coalesces concurrent EC encode/decode requests into padded,
    executor-offloaded device launches (see module docstring).

    ``perf`` is the owning daemon's ``ec`` PerfCounters (None for a
    standalone dispatcher — dump() still carries its own totals).
    """

    def __init__(self, perf=None, *, window: float = 5e-4,
                 max_stripes: int = 512, bucket: bool = True,
                 max_workers: int = 2, scheduler=None,
                 supervisor=None, launch_deadline: float = 0.0,
                 hb_handle=None, mesh_engine=None,
                 launch_history: int = 64, remote=None):
        if mesh_engine is not None and not all(
                callable(getattr(mesh_engine, a, None))
                for a in ("routes", "mesh_key", "encode_batch",
                          "decode_batch", "encode", "decode_concat")):
            raise ValueError("mesh_engine must be a mesh engine "
                             "(parallel.engine.MeshEcEngine)")
        if remote is not None and not all(
                callable(getattr(remote, a, None))
                for a in ("routes", "run_batch", "note_failure", "dump")):
            raise ValueError("remote must be a remote-lane client "
                             "(accel.client.AccelClient)")
        self._perf = perf
        # the remote accelerator lane (accel/client.AccelClient; None =
        # local lanes only): coalesced batches ship to a shared
        # accelerator daemon over the messenger instead of launching on
        # this process's device.  The remote has ITS OWN fault domain —
        # its faults never touch the local supervisor's breaker (a
        # network trip must not bench the local device), and a failed
        # remote batch replays on the LOCAL fallback engine
        self._remote = remote
        # the multi-device mesh lane (parallel/engine.MeshEcEngine; None
        # = single-device only).  supports()/routes() never touch a
        # device; the first mesh-lane submit resolves the lanes lazily
        # via mesh_key
        self._mesh = mesh_engine
        # the OSD's QoS scheduler (duck-typed: an async
        # ``pace(klass, cost)``; None standalone): BACKGROUND stripes
        # (klass != "client") pace through it before entering a batch
        # window, so client stripes preempt recovery stripes exactly
        # when the device is the bottleneck.  Pacing is tag-only (no
        # slot held) — the caller may already hold a recovery/scrub
        # grant, and nesting slot acquisitions at this depth could
        # deadlock the pool.
        self._scheduler = scheduler
        self.window = float(window)
        self.max_stripes = int(max_stripes)
        self.bucket = bool(bucket)
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="ec-dispatch"
        )
        self._open: dict[tuple, _Batch] = {}
        self._tasks: set[asyncio.Task] = set()
        self._stopping = False
        # adaptive window (the serving-stack trick): when the LAST
        # launch carried a single op, traffic is serial and the next
        # batch flushes on the next loop tick (delay 0) instead of
        # idling a full window per op — ops submitted in the same tick
        # (an asyncio.gather burst) still coalesce, because the timer
        # callback runs after the already-ready task steps.  Starts
        # optimistic (assume concurrency) so the first burst gets the
        # full window.
        self._last_ops = 2
        self._max_workers = max_workers
        # accelerator fault domain (osd/ec_failover): the supervisor
        # gates/records engine health, the deadline bounds every device
        # launch, the HeartbeatMap handle keeps the daemon-policy clock
        # on a wedged worker thread, the inject_* hooks fabricate
        # device faults (config: ec_inject_engine_failure /
        # ec_inject_launch_hang, live via observers)
        self._supervisor = supervisor
        self.launch_deadline = float(launch_deadline)
        self._hb_handle = hb_handle
        self.inject_engine_failure = 0
        self.inject_launch_hang = 0.0
        self._inject_n = 0
        self._inflight_launches: dict[int, float] = {}  # id -> start
        # the (kind, sinfo, codec, lane) of the launch that last tripped the
        # breaker — what the canary probe re-verifies
        self._last_trip: tuple | None = None
        if supervisor is not None and supervisor.probe is None:
            supervisor.probe = self._canary_probe
        # dump()-side totals, independent of the perf wiring
        self._totals = {
            "batches": 0, "ops": 0, "stripes": 0, "cancelled": 0,
            "pad_stripes": 0, "pad_bytes": 0, "native_direct": 0,
            "failovers": 0, "replayed_ops": 0, "fallback_direct": 0,
            "deadline_timeouts": 0,
            "flush": {"size": 0, "window": 0, "stop": 0},
            # per-route slice of the above (pad waste and batch sizes
            # attributable per lane)
            "lanes": {
                lane: {"batches": 0, "ops": 0, "stripes": 0,
                       "pad_stripes": 0, "pad_bytes": 0}
                for lane in ("device", "mesh", "remote")
            },
            # launches whose member ops came from >1 client entity
            "cross_client_batches": 0,
        }
        # padded S -> launches, per lane (O(log max_S) rows per lane
        # by construction; the mesh lane's rows are mesh_size-aligned;
        # the remote lane ships unpadded — the accelerator owns the
        # bucketing for its own launches — so it has no table)
        self._buckets_seen: dict[str, dict[int, int]] = {
            "device": {}, "mesh": {},
        }
        # device-launch flight recorder (ops.device_trace): the last N
        # launches with lane / batch key / QoS class / queue-wait vs
        # device wall / slowest member trace id, served by
        # dump_launch_history and consulted by the SLOW_OPS dump path
        # (OpTracker.launch_lookup = this flight.lookup)
        self.flight = FlightRecorder(capacity=launch_history)

    # -- public API ----------------------------------------------------------

    async def encode(
        self, sinfo: ec_util.StripeInfo, codec, data, *,
        klass: str = "client", client: str | None = None,
    ) -> dict[int, np.ndarray]:
        """Batched analog of :func:`ec_util.encode` — same contract,
        same bytes; may share its device launch with other in-flight
        ops.  ``klass`` is the QoS traffic class: background stripes
        pace through the scheduler before entering a batch window, and
        batches never mix classes (the key includes it), so a client
        batch is never held open for — or padded by — recovery math.
        ``client`` names the requesting entity in the flight records."""
        if client is None:
            # tenant attribution: the direct lanes bypass _Op, so
            # capture the contextvar here too
            client = current_client.get()
        buf = as_u8(data)
        if buf.size % sinfo.stripe_width != 0:
            raise ValueError(
                f"data size {buf.size} not a multiple of stripe_width "
                f"{sinfo.stripe_width}"
            )
        stripes = buf.size // sinfo.stripe_width
        if stripes == 0 or self._stopping:
            # empty payloads and shutdown drain skip the queue (nothing
            # to amortize / no flusher guaranteed to run again)
            return self._inline_encode_fn()(sinfo, codec, buf)
        await self._qos_pace(klass, stripes)
        if self._stopping:
            # stop() may have drained the batches and shut the worker
            # pool down while we slept in pace() — a late submit would
            # open a batch nobody will ever flush (and the executor
            # would refuse the launch)
            return self._inline_encode_fn()(sinfo, codec, buf)
        # lane selection: the remote accelerator (an explicit operator
        # opt-in via osd_ec_accel_mode) outranks every local lane — its
        # whole point is taking the device math off this host; its OWN
        # breaker beacon gates it, not the local supervisor.  Below it,
        # the mesh (osd_ec_mesh, an explicit operator opt-in) outranks
        # the native C engine; the native lane outranks the device lane
        # on a CPU codec
        if self._remote is not None and self._remote.routes(codec):
            key = ("enc", "remote", None, klass, id(codec),
                   sinfo.stripe_width, sinfo.chunk_size)
            return await self._submit(key, "enc", codec, sinfo, buf,
                                      stripes, lane="remote",
                                      klass=klass, client=client)
        lane = "mesh" if (
            self._mesh is not None and self._mesh.routes(sinfo, codec)
        ) else "device"
        if lane != "mesh" and ec_util.native_encode_path(sinfo, codec):
            # no launch overhead to amortize on the C engine — keep
            # per-op (cache-resident) calls, just off the loop
            return await self._run_native_direct(
                ec_util.encode, sinfo, codec, buf, "encode", buf.size,
                klass=klass, client=client,
            )
        if self._supervisor is not None and not self._supervisor.device_ok():
            # breaker TRIPPED/PROBING: the device engine — mesh slice
            # included, it is the same accelerator fault domain — is out
            # of the data path; serve from the host fallback (still off
            # the loop; the canary is the only device traffic until the
            # supervisor re-promotes)
            return await self._run_fallback_direct(
                ec_util.encode_fallback, sinfo, codec, buf,
                "encode", buf.size, klass=klass, client=client,
            )
        mesh_slice = (
            self._mesh.mesh_key(codec.get_data_chunk_count())
            if lane == "mesh" else None
        )
        key = ("enc", lane, mesh_slice, klass, id(codec),
               sinfo.stripe_width, sinfo.chunk_size)
        return await self._submit(key, "enc", codec, sinfo, buf, stripes,
                                  lane=lane, mesh_slice=mesh_slice,
                                  klass=klass, client=client)

    async def decode_concat(
        self, sinfo: ec_util.StripeInfo, codec,
        chunks: Mapping[int, np.ndarray], *, klass: str = "client",
        client: str | None = None,
        locality: "list[str] | None" = None,
    ) -> bytes:
        """Batched analog of :func:`ec_util.decode_concat`.  Requests
        coalesce only with peers reading through the SAME survivor set
        (the recovery matrix depends on it) and the same QoS class (see
        :meth:`encode`).  ``locality`` names the surviving shards' OSD
        locality labels; the remote lane's router prefers the
        accelerator matching the batch's majority label."""
        if client is None:
            client = current_client.get()  # see encode()
        arrs = {int(s): as_u8(v) for s, v in chunks.items()}
        sizes = {a.size for a in arrs.values()}
        if len(sizes) != 1:
            raise ValueError(f"shard buffers differ in size: {sizes}")
        shard_len = next(iter(sizes))
        if shard_len % sinfo.chunk_size != 0:
            raise ValueError(
                f"shard buffer size {shard_len} not a multiple of "
                f"chunk_size {sinfo.chunk_size}"
            )
        stripes = shard_len // sinfo.chunk_size
        if stripes == 0 or self._stopping:
            return self._inline_decode_fn()(sinfo, codec, arrs)
        await self._qos_pace(klass, stripes)
        if self._stopping:
            # see encode(): stop() may have won the race while pacing
            return self._inline_decode_fn()(sinfo, codec, arrs)
        k = codec.get_data_chunk_count()
        missing = any(r not in arrs for r in range(k))
        # remote lane first (see encode()) — but only when rows are
        # MISSING: an all-rows-present concat does no device math, and
        # shipping its payload across the wire to do a host transform
        # there would be pure network waste
        if (missing and self._remote is not None
                and self._remote.routes(codec)):
            present = tuple(sorted(arrs))
            key = ("dec", "remote", None, klass, id(codec),
                   sinfo.stripe_width, sinfo.chunk_size, present)
            return await self._submit(key, "dec", codec, sinfo, arrs,
                                      stripes, lane="remote",
                                      klass=klass, client=client,
                                      locality=locality)
        # the mesh lane only earns its keep when rows are MISSING (the
        # gathered reconstruct); a plain concat read stays on the
        # device/native lanes
        lane = "mesh" if (
            self._mesh is not None
            and self._mesh.routes(sinfo, codec)
            and missing
        ) else "device"
        if lane != "mesh" and ec_util.native_decode_path(codec, shard_len):
            return await self._run_native_direct(
                ec_util.decode_concat, sinfo, codec, arrs, "decode",
                shard_len * len(arrs), klass=klass, client=client,
            )
        if self._supervisor is not None and not self._supervisor.device_ok():
            return await self._run_fallback_direct(
                ec_util.decode_concat_fallback, sinfo, codec, arrs,
                "decode", shard_len * len(arrs), klass=klass,
                client=client,
            )
        present = tuple(sorted(arrs))
        mesh_slice = self._mesh.mesh_key(k) if lane == "mesh" else None
        key = ("dec", lane, mesh_slice, klass, id(codec),
               sinfo.stripe_width, sinfo.chunk_size, present)
        return await self._submit(key, "dec", codec, sinfo, arrs, stripes,
                                  lane=lane, mesh_slice=mesh_slice,
                                  klass=klass, client=client)

    def mesh_route(self, sinfo, codec, *, missing: bool = True) -> bool:
        """Would a request for this (geometry, codec) take the mesh
        lane?  The OSD router tags its trace spans with this — ONE
        gate, so the span's engine label cannot drift from the actual
        route.  ``missing=False`` marks a decode whose wanted rows are
        all present (no reconstruct — the mesh does not apply).  A
        TRIPPED/PROBING breaker answers False too: those requests are
        served by the host fallback, and the span must say so."""
        return (
            self._mesh is not None
            and missing
            and self._mesh.routes(sinfo, codec)
            and (self._supervisor is None
                 or self._supervisor.device_ok())
        )

    def _inline_encode_fn(self):
        """Engine for the inline per-op lanes (empty payload, shutdown
        drain): a TRIPPED breaker must route these to the host fallback
        too — an inline call runs ON the event loop, where a wedged
        device call would have no deadline, no watchdog pin, and would
        stall the very heartbeat tasks that enforce daemon policy."""
        if self._supervisor is not None and not self._supervisor.device_ok():
            return ec_util.encode_fallback
        return ec_util.encode

    def _inline_decode_fn(self):
        """Decode twin of :meth:`_inline_encode_fn`."""
        if self._supervisor is not None and not self._supervisor.device_ok():
            return ec_util.decode_concat_fallback
        return ec_util.decode_concat

    async def _qos_pace(self, klass: str, stripes: int) -> None:
        """Background stripes wait out the scheduler's pacing tags
        before joining a batch window; client stripes pass — their op
        was already admitted (and is holding a grant) at the OSD op
        intake, so gating them again would double-charge the class."""
        if self._scheduler is None or klass == "client":
            return
        await self._scheduler.pace(klass, cost=float(stripes))

    async def stop(self) -> None:
        """Flush every open batch (reason ``stop``), wait for in-flight
        launches, stop the engine supervisor's probe loop, shut the
        worker pool down.  Requests arriving after stop() fall back to
        inline per-op calls."""
        self._stopping = True
        for key in list(self._open):
            self._flush(key, "stop")
        if self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
        if self._supervisor is not None:
            await self._supervisor.stop()
        self._executor.shutdown(wait=False)

    def engine_health(self) -> dict:
        """``dump_engine_health`` admin-socket body: the supervisor's
        state machine plus this dispatcher's failover slice — the ONE
        accessor (dump() embeds it too), so the admin surfaces cannot
        drift from the dispatcher's actual totals."""
        t = self._totals
        return {
            **(self._supervisor.dump()
               if self._supervisor is not None else {}),
            "dispatcher": {
                "inflight_launches": len(self._inflight_launches),
                "launch_deadline_s": self.launch_deadline,
                "failovers": t["failovers"],
                "replayed_ops": t["replayed_ops"],
                "fallback_direct": t["fallback_direct"],
                "deadline_timeouts": t["deadline_timeouts"],
            },
        }

    def dump(self) -> dict:
        """Admin-socket body (``dump_ec_dispatch``)."""
        return {
            "config": {
                "window_s": self.window,
                "max_stripes": self.max_stripes,
                "bucket": self.bucket,
                "launch_deadline_s": self.launch_deadline,
                "inject_engine_failure": self.inject_engine_failure,
                "inject_launch_hang_s": self.inject_launch_hang,
            },
            **({"engine_health": self._supervisor.dump()}
               if self._supervisor is not None else {}),
            "inflight_launches": len(self._inflight_launches),
            "open_batches": [
                {
                    "kind": b.kind, "ops": len(b.ops),
                    "stripes": b.stripes,
                    "chunk_size": b.sinfo.chunk_size,
                }
                for b in self._open.values()
            ],
            "mesh_lane": self._mesh is not None,
            **({"remote": self._remote.dump()}
               if self._remote is not None else {}),
            "totals": {
                **{k: v for k, v in self._totals.items() if k != "flush"},
                "flush_reasons": dict(self._totals["flush"]),
            },
            # the observed bucketing tables: padded stripe count ->
            # launches that used it, per lane (O(log max_S) rows each
            # by construction; the mesh table's rows are mesh-aligned)
            "buckets": {
                str(k): v
                for k, v in sorted(self._buckets_seen["device"].items())
            },
            "mesh_buckets": {
                str(k): v
                for k, v in sorted(self._buckets_seen["mesh"].items())
            },
        }

    # -- queueing ------------------------------------------------------------

    async def _run_direct(self, fn, sinfo, codec, payload, op: str,
                          nbytes: int, totals_key: str,
                          perf_key: str | None = None,
                          klass: str = "client",
                          client: str | None = None):
        """Per-op call in the worker pool (event-loop liberation
        without coalescing) — shared by the native C lane and the
        host-fallback lane (the serving path while the device engine
        is TRIPPED).  The call is timed in-worker: pool queue wait must
        not read as device time in the gauges/histograms under load —
        and whichever engine serves, its time feeds the same gauges
        (the daemon's op-level timer includes executor-hop wait, so it
        no longer feeds them on the dispatch route).  Direct calls are
        launches too: they ride the flight recorder (lane =
        native_direct/fallback_direct, one-op "batch"), so a slow op
        served off-device still names what carried it."""
        self._totals[totals_key] = self._totals.get(totals_key, 0) + 1
        if self._perf is not None and perf_key is not None:
            self._perf.inc(perf_key)
        loop = asyncio.get_running_loop()
        flight = self.flight.begin(
            lane=totals_key, kind="enc" if op == "encode" else "dec",
            klass=klass, ops=1, stripes=None,
            stripe_width=sinfo.stripe_width,
            chunk_size=sinfo.chunk_size, queue_wait_s=0.0,
            slowest_trace=current_trace.get(),
            traces=[current_trace.get()],
            **({"clients": [client]} if client else {}),
        )

        def _timed_call():
            t0 = time.perf_counter()
            res = fn(sinfo, codec, payload)
            return res, time.perf_counter() - t0

        try:
            out, dt = await loop.run_in_executor(self._executor,
                                                 _timed_call)
        except BaseException as e:
            # BaseException: a cancelled waiter (CancelledError) must
            # close its flight record too, or _inflight leaks phantom
            # launches forever
            self.flight.end(flight, served="error", error=repr(e))
            raise
        self.flight.end(flight, device_wall_s=dt, served=totals_key)
        if self._perf is not None:
            try:
                ec_util.account_ec_call(self._perf, op, nbytes, dt)
            except Exception:  # swallow-ok: observability is best-effort
                pass
        return out

    def _run_native_direct(self, fn, sinfo, codec, payload, op: str,
                           nbytes: int, klass: str = "client",
                           client: str | None = None):
        return self._run_direct(fn, sinfo, codec, payload, op, nbytes,
                                "native_direct",
                                perf_key="dispatch_native_direct",
                                klass=klass, client=client)

    def _run_fallback_direct(self, fn, sinfo, codec, payload, op: str,
                             nbytes: int, klass: str = "client",
                             client: str | None = None):
        return self._run_direct(fn, sinfo, codec, payload, op, nbytes,
                                "fallback_direct", klass=klass,
                                client=client)

    async def _submit(self, key: tuple, kind: str, codec, sinfo,
                      payload, stripes: int, *, lane: str = "device",
                      mesh_slice: tuple | None = None,
                      klass: str = "client",
                      client: str | None = None,
                      locality: "list[str] | None" = None):
        loop = asyncio.get_running_loop()
        b = self._open.get(key)
        if b is not None and b.ops and (
            b.stripes + stripes > self.max_stripes
        ):
            # admitting this op would overshoot the threshold, and the
            # overshoot would be PADDED up to the next power-of-two
            # bucket (2049 stripes -> a 4096 launch, ~50% waste): flush
            # what's queued at its snug bucket and open a fresh batch
            self._flush(key, "size")
            b = None
        if b is None:
            # the mesh lane's alignment quantum is the mesh size (the
            # k+m-independent pg x shard slice the batch splits over):
            # encode stripes split across every lane, decode bytes
            # split across the pg axis — both need ΣS % mesh_size == 0
            quantum = (
                mesh_slice[0] * mesh_slice[1] if mesh_slice else 1
            )
            b = self._open[key] = _Batch(kind, codec, sinfo, lane=lane,
                                         quantum=quantum, klass=klass)
            delay = self.window if self._last_ops > 1 else 0.0
            b.timer = loop.call_later(delay, self._flush, key, "window")
        fut = loop.create_future()
        b.ops.append(_Op(fut, stripes, payload, client=client,
                         locality=locality))
        b.stripes += stripes
        if b.stripes >= self.max_stripes:
            self._flush(key, "size")
        return await fut

    def _flush(self, key: tuple, reason: str) -> None:
        b = self._open.pop(key, None)
        if b is None:
            return  # the size threshold beat this window timer
        if b.timer is not None:
            b.timer.cancel()
        # an aborted op (cancelled waiter) must not wedge or pad the
        # batch: drop it here, before the launch is shaped
        live = [op for op in b.ops if not op.fut.done()]
        dropped = len(b.ops) - len(live)
        if dropped:
            self._totals["cancelled"] += dropped
            if self._perf is not None:
                self._perf.inc("dispatch_cancelled", dropped)
        if not live:
            return
        self._last_ops = len(live)  # feeds the adaptive window
        task = asyncio.ensure_future(self._run_batch(b, live, reason))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _flight_begin(self, b: _Batch, ops: list[_Op],
                      reason: str) -> int:
        """Open the launch's flight-recorder record BEFORE the device
        call: a wedged launch must be findable while it is in flight
        (the slow ops it is carrying are in flight too).  The slowest
        member is the op that queued earliest — its wait IS the
        batch's queue-wait number."""
        now = time.monotonic()
        oldest = min(ops, key=lambda op: op.t_submit)
        # key=str: tenant ids (ints) and peer names (strs) can share
        # one launch
        clients = sorted({op.client for op in ops if op.client},
                         key=str)
        return self.flight.begin(
            lane=b.lane, kind=b.kind, klass=b.klass, reason=reason,
            ops=len(ops), stripes=b.stripes,
            stripe_width=b.sinfo.stripe_width,
            chunk_size=b.sinfo.chunk_size,
            queue_wait_s=round(now - oldest.t_submit, 6),
            slowest_trace=oldest.trace,
            traces=[op.trace for op in ops],
            # which clients shared this launch
            **({"clients": clients} if clients else {}),
        )

    async def _run_batch(self, b: _Batch, ops: list[_Op],
                         reason: str) -> None:
        flight = self._flight_begin(b, ops, reason)
        try:
            await self._run_batch_inner(b, ops, reason, flight)
        finally:
            # safety net: every exit path above ends the record; a
            # CANCELLED task (loop teardown mid-launch) reaches only
            # this finally — end() is a no-op when already ended
            self.flight.end(flight, served="cancelled",
                            error="launch task cancelled")

    async def _run_batch_inner(self, b: _Batch, ops: list[_Op],
                               reason: str, flight: int) -> None:
        origin = None
        extra: dict = {}
        try:
            results, pad, seconds, extra = await self._launch(b, ops)
            if b.lane != "remote" and self._supervisor is not None:
                # a remote success says nothing about the LOCAL device
                # — only local launches close the local breaker
                self._supervisor.record_success()
        except Exception as e:
            # the fault fork (osd/ec_failover): FATAL errors — a CUDA
            # error, OOM, a kernel build or launch failure, a blown
            # launch deadline — replay the whole batch on the host
            # fallback engine (bit-identical), so no waiter ever sees a
            # device error; data-shape errors surface to every waiter.
            # REMOTE batches fork the same way, but against their own
            # fault domain: the accelerator's failure never advances
            # the local supervisor's breaker (a network trip must not
            # bench a healthy local device), and a remote fatal always
            # replays locally — accelerator death mid-batch is
            # classified like device death
            sup = self._supervisor
            if b.lane == "remote":
                from ..accel.client import AccelDataError

                replayable = not isinstance(e, AccelDataError)
                if replayable:
                    self._remote.note_failure(e)
            elif isinstance(e, LaunchDeadlineExceeded):
                # record_timeout already advanced the breaker (and
                # counted the timeout) inside _bounded_device_call —
                # re-recording here would double-count one wedge as a
                # timeout AND a fatal error
                replayable = sup is not None and sup.enabled
            else:
                kind = (sup.record_failure(e, lane=b.lane)
                        if sup is not None else "data")
                replayable = (kind == "fatal" and sup is not None
                              and sup.enabled)
            if not replayable:
                # data errors always surface; fatal errors surface too
                # when failover is off (no supervisor, or live-disabled)
                # — the pre-failover contract
                for op in ops:
                    if not op.fut.done():
                        op.fut.set_exception(e)
                self.flight.end(flight, served="error", error=repr(e))
                return
            if b.lane != "remote":
                self._last_trip = (b.kind, b.sinfo, b.codec, b.lane)
            try:
                results, pad, seconds = await self._replay(b, ops)
                extra = {}
            except Exception as e2:
                # the fallback failed too (a data error the device
                # masked, or a host fault): surface THAT error — it is
                # the one describing the actual state of the bytes
                for op in ops:
                    if not op.fut.done():
                        op.fut.set_exception(e2)
                self.flight.end(flight, served="error", error=repr(e2))
                return
            self._note_failover(b, ops, e)
            served = "fallback"
            flight_error = repr(e)
            # a fallback-served record says WHERE the fault was
            origin = b.lane
        else:
            served = b.lane
            flight_error = None
        # waiters resolve FIRST: accounting (a partially-registered
        # PerfCounters, say) must never wedge the data path
        for op, res in zip(ops, results):
            if not op.fut.done():
                op.fut.set_result(res)
        self.flight.end(flight, device_wall_s=seconds, served=served,
                        error=flight_error, origin=origin, **extra)
        try:
            self._note_batch(b, ops, reason, pad, seconds, served)
        except Exception:  # swallow-ok: observability is best-effort by contract
            pass

    async def _launch(self, b: _Batch, ops: list[_Op]):
        """Returns ``(results, pad, seconds, extra)`` — ``extra`` is
        flight-record enrichment (the remote lane reports which engine
        the ACCELERATOR served from; local lanes have nothing to
        add)."""
        if b.lane == "remote":
            # the remote lane is messenger I/O, not a worker-pool
            # device call: the AccelClient bounds it with its own RPC
            # deadline (osd_ec_accel_deadline) and raises
            # AccelUnavailable/AccelServiceError for the fork above —
            # no watchdog pin (nothing can wedge a thread here)
            return await self._run_remote(b, ops)
        results, pad, seconds = await self._bounded_device_call(
            f"{b.kind} launch ({b.stripes} stripes)",
            self._run_sync, b, ops,
        )
        return results, pad, seconds, {}

    async def _run_remote(self, b: _Batch, ops: list[_Op]):
        """One remote-lane batch: ``remote.run_batch`` ships it
        unpadded and answers with the accelerator's evidence, which
        enriches this launch's flight record."""
        results, pad, seconds, info = \
            await self._remote.run_batch(b, ops)
        extra = {}
        if info.get("served"):
            extra["remote_served"] = info["served"]
        if info.get("queue_wait_s"):
            # the accel-side coalesce wait (reply piggyback): the
            # honest queue-wait-vs-device split for a REMOTE launch
            extra["remote_queue_wait_s"] = float(info["queue_wait_s"])
        return results, pad, seconds, extra

    async def _bounded_device_call(self, label: str, fn, *args):
        """One device call in the worker pool, bounded by
        ``osd_ec_launch_deadline`` and pinned on the HeartbeatMap while
        in flight — shared by batch launches and the canary probe, so a
        wedged canary gets the exact same discipline as a wedged
        launch.  On deadline: the caller fails over NOW
        (LaunchDeadlineExceeded), the wedged thread is abandoned to a
        fresh executor (it would otherwise eat a pool slot — and with
        it, the fallback serving lane), and its HeartbeatMap pin keeps
        counting until the thread returns — grace marks the daemon
        unhealthy, suicide_grace invokes daemon policy (reference: a
        wedged thread must kill the daemon rather than wedge the
        cluster)."""
        loop = asyncio.get_running_loop()
        cf = self._executor.submit(fn, *args)
        token = id(cf)
        self._inflight_launches[token] = time.monotonic()
        self._pin_watchdog()

        def _done(_f, token=token):
            try:
                loop.call_soon_threadsafe(self._untrack_launch, token)
            # swallow-ok: loop already closed at teardown — nothing left to unpin
            except RuntimeError:
                pass

        cf.add_done_callback(_done)
        fut = asyncio.wrap_future(cf)
        deadline = self.launch_deadline
        if deadline <= 0:
            return await fut
        try:
            return await asyncio.wait_for(asyncio.shield(fut), deadline)
        except asyncio.TimeoutError:
            # the abandoned call may still complete (or raise) later:
            # mark its exception retrieved so asyncio never logs a
            # spurious "exception was never retrieved" for a call the
            # waiters already failed over from
            fut.add_done_callback(
                lambda f: f.cancelled() or f.exception()
            )
            self._totals["deadline_timeouts"] += 1
            if self._perf is not None:
                self._perf.inc("launch_deadline_timeouts")
            if self._supervisor is not None:
                self._supervisor.record_timeout(deadline)
            self._executor.shutdown(wait=False)
            self._executor = ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="ec-dispatch",
            )
            raise LaunchDeadlineExceeded(
                f"EC {label} exceeded the {deadline:g}s launch deadline"
            ) from None

    async def _replay(self, b: _Batch, ops: list[_Op]):
        """Replay a failed batch on the host fallback engine (worker
        pool; no injection, no deadline — the fallback cannot wedge on
        a device)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor, self._run_sync, b, ops, "fallback"
        )

    def _note_failover(self, b: _Batch, ops: list[_Op],
                       cause: Exception) -> None:
        logger.warning(
            "EC %s batch (%d ops, %d stripes) failed over to the host "
            "fallback engine: %r", b.kind, len(ops), b.stripes, cause,
        )
        self._totals["failovers"] += 1
        self._totals["replayed_ops"] += len(ops)
        if self._perf is not None:
            try:
                self._perf.inc("engine_failovers")
                self._perf.inc("replayed_ops", len(ops))
            except Exception:  # swallow-ok: observability is best-effort
                pass

    # -- launch watchdog (HeartbeatMap wiring) -------------------------------

    def set_watchdog_handle(self, handle) -> None:
        """Adopt the daemon's HeartbeatMap handle for in-flight device
        launches (the daemon creates its HeartbeatMap after the
        dispatcher; handles registered later attach here)."""
        self._hb_handle = handle
        self._pin_watchdog()

    def _pin_watchdog(self) -> None:
        """Pin the daemon's ec-launch handle to the OLDEST in-flight
        launch: fresh launches must never mask a wedged one (the same
        rule the OSD op handle follows)."""
        if self._hb_handle is not None:
            self._hb_handle.pin(
                min(self._inflight_launches.values(), default=None)
            )

    def _untrack_launch(self, token: int) -> None:
        self._inflight_launches.pop(token, None)
        self._pin_watchdog()

    # -- fault injection + canary --------------------------------------------

    def _maybe_inject(self) -> None:
        """Worker-thread hook on every DEVICE launch (batches and the
        canary; never the fallback): the accelerator analog of
        ms_inject_socket_failures."""
        if self.inject_launch_hang > 0:
            time.sleep(self.inject_launch_hang)
        n = self.inject_engine_failure
        if n > 0:
            self._inject_n += 1
            if self._inject_n % n == 0:
                raise EngineFault(
                    "INTERNAL: injected device loss "
                    "(ec_inject_engine_failure)"
                )

    async def _canary_probe(self) -> bool:
        """One-stripe launch of the KIND that tripped the breaker
        (encode, or a one-erasure decode), checked byte-for-byte
        against the host oracle — the supervisor's re-promotion
        evidence.  Probing the tripped kind matters: a device whose
        reconstruct program is broken but whose encode still works
        would otherwise re-promote on an encode canary and flap
        TRIPPED->HEALTHY->TRIPPED forever.  Runs in the worker pool
        like every launch."""
        key = self._last_trip
        if key is None:
            return True  # never tripped via a batch: nothing to disprove
        kind, sinfo, codec, lane = key
        # probe the LANE that tripped: a dead card in the mesh slice
        # fails mesh launches while the single-device engine may still
        # answer — an ec_util canary would then re-promote a mesh lane
        # that is still broken and flap
        if lane == "mesh":
            enc_dev = self._mesh.encode
            dec_dev = self._mesh.decode_concat
        else:
            enc_dev = ec_util.encode
            dec_dev = ec_util.decode_concat

        def _probe_sync() -> bool:
            self._maybe_inject()
            buf = np.arange(
                sinfo.stripe_width, dtype=np.uint32
            ).astype(np.uint8)  # deterministic, alignment-friendly
            shards = ec_util.encode_fallback(sinfo, codec, buf)
            if kind == "dec":
                # drop one data shard: the probe must drive the device
                # RECONSTRUCT program, the one that actually tripped
                survivors = {s: np.asarray(v)
                             for s, v in shards.items() if s != 0}
                got = dec_dev(sinfo, codec, survivors)
                want = ec_util.decode_concat_fallback(
                    sinfo, codec, survivors
                )
                # copy-ok: one-stripe canary, cold re-promotion path
                return bytes(got) == bytes(want)
            got = enc_dev(sinfo, codec, buf)
            want = shards
            return set(got) == set(want) and all(
                np.array_equal(np.asarray(got[s]), np.asarray(want[s]))
                for s in want
            )

        # rides the same bounding as a batch launch: a wedged canary
        # respawns the executor (it must not eat the fallback lane's
        # worker slots) and stays on the watchdog pin until it returns
        return await self._bounded_device_call("canary probe",
                                               _probe_sync)

    def _note_batch(self, b: _Batch, ops: list[_Op], reason: str,
                    pad: int, seconds: float,
                    served: str | None = None) -> None:
        """``served`` names the engine that actually produced the
        bytes: the batch's lane normally, ``"fallback"`` after a
        failover replay.  Per-route evidence (the lane split, the
        bucket tables, the mesh_* family, the per-engine GB/s gauges)
        follows SERVED, not routed: a device or mesh slice whose
        launches are all being replayed on the host must not keep
        painting healthy throughput — that is exactly the outage those
        counters exist to reveal (the failovers/replayed_ops counters
        carry the replay side)."""
        if served is None:
            served = b.lane
        stripes = sum(op.stripes for op in ops)
        t = self._totals
        t["batches"] += 1
        t["ops"] += len(ops)
        t["stripes"] += stripes
        t["pad_stripes"] += pad
        t["pad_bytes"] += pad * b.sinfo.stripe_width
        t["flush"][reason] = t["flush"].get(reason, 0) + 1
        if served != "fallback":
            lt = t["lanes"][served]
            lt["batches"] += 1
            lt["ops"] += len(ops)
            lt["stripes"] += stripes
            lt["pad_stripes"] += pad
            lt["pad_bytes"] += pad * b.sinfo.stripe_width
            if served in self._buckets_seen:
                # the remote lane ships unpadded (the accelerator owns
                # the bucketing), so only local lanes keep a table
                sp = stripes + pad
                lb = self._buckets_seen[served]
                lb[sp] = lb.get(sp, 0) + 1
        if len({op.client for op in ops if op.client}) > 1:
            # ops from more than one client shared this launch
            t["cross_client_batches"] += 1
        pec = self._perf
        if pec is None:
            return
        pec.inc("dispatch_batches")
        pec.inc("dispatch_ops", len(ops))
        pec.inc(f"dispatch_flush_{reason}")
        if pad:
            pec.inc("dispatch_pad_stripes", pad)
            pec.inc("dispatch_pad_bytes", pad * b.sinfo.stripe_width)
        occupancy = (
            min(1.0, stripes / self.max_stripes) if self.max_stripes
            else 1.0
        )
        pec.observe("dispatch_occupancy", occupancy)
        pec.hist("dispatch_batch_size_histogram", len(ops))
        # the per-lane occupancy/pad/batch-size split (a fallback
        # replay is counted by failovers/replayed_ops)
        if served == "mesh":
            pec.inc("dispatch_batches_mesh")
            pec.inc("dispatch_ops_mesh", len(ops))
            if pad:
                pec.inc("dispatch_pad_stripes_mesh", pad)
                pec.inc("dispatch_pad_bytes_mesh",
                        pad * b.sinfo.stripe_width)
            pec.observe("dispatch_occupancy_mesh", occupancy)
            pec.hist("dispatch_batch_size_mesh_histogram", len(ops))
            pec.inc("mesh_batches")
            pec.inc("mesh_encode_calls" if b.kind == "enc"
                    else "mesh_decode_calls", len(ops))
            pec.set("mesh_devices", b.quantum)
        elif served == "device":
            pec.inc("dispatch_batches_device")
            pec.inc("dispatch_ops_device", len(ops))
            if pad:
                pec.inc("dispatch_pad_stripes_device", pad)
                pec.inc("dispatch_pad_bytes_device",
                        pad * b.sinfo.stripe_width)
            pec.observe("dispatch_occupancy_device", occupancy)
            pec.hist("dispatch_batch_size_device_histogram", len(ops))
        elif served == "remote":
            pec.inc("dispatch_batches_remote")
            pec.inc("dispatch_ops_remote", len(ops))
            pec.observe("dispatch_occupancy_remote", occupancy)
            pec.hist("dispatch_batch_size_remote_histogram", len(ops))
            # device wall time belongs to the ACCELERATOR's ec family
            # (it reports its own); this OSD's client-side view —
            # batches/bytes/rtt — is accounted by the AccelClient.
            # Feeding the remote's seconds into the local encode/decode
            # gauges would paint phantom local device throughput.
            return
        # wall-time accounting from this LAUNCH's own time (logical
        # bytes, pad excluded), whichever engine served it: the
        # daemon's op-level timer includes queue wait and batch
        # sharing, so on the dispatch route the encode/decode time
        # avg + size x latency histogram + GB/s gauge are all fed
        # here, once per launch.  The mesh lane feeds the mesh_* GB/s
        # gauges only when the mesh actually served — a fallback
        # replay's wall time belongs to the host-path gauges.
        op = "encode" if b.kind == "enc" else "decode"
        if b.kind == "enc":
            nbytes = stripes * b.sinfo.stripe_width
        else:
            nbytes = stripes * b.sinfo.chunk_size * len(ops[0].payload)
        ec_util.account_ec_call(pec, op, nbytes, seconds,
                                mesh=served == "mesh")

    # -- the batched launch (executor thread) --------------------------------

    def _pad_for(self, b: _Batch, total_stripes: int) -> int:
        """Zero stripes to add (only device- and mesh-lane codecs reach
        a batch — the native engine took the direct lane in
        encode/decode).  The mesh lane always pads to its alignment
        quantum (lanes must stay balanced across the slice even with
        bucketing disabled); bucketing then rounds the per-lane stripe
        count to a power of two — ``mesh_size x bucket``."""
        if b.quantum > 1:
            return bucket_stripes_aligned(
                total_stripes, b.quantum, self.bucket
            ) - total_stripes
        if not self.bucket:
            return 0
        return bucket_stripes(total_stripes) - total_stripes

    def _run_sync(self, b: _Batch, ops: list[_Op],
                  engine: str = "device"):
        """Worker-thread body: concat -> pad -> one ec_util call ->
        per-op slices.  The device call is timed HERE (not around the
        executor hop) so the reported launch time never includes
        worker-pool queue wait; per-op encode slices are COPIES, so one
        stalled waiter pins only its own bytes, not the whole padded
        batch output.

        ``engine`` picks the math: "device" is the batch's lane —
        ec_util on the codec's device, or the mesh engine's lanes
        (fault-injection hooks apply to both: the mesh slice is the same
        accelerator fault domain); "fallback" is the host replay route
        (ec_util.*_fallback — no injection, no bucketing: the host
        engines have no launch shapes to bound)."""
        fallback = engine == "fallback"
        if fallback:
            encode_fn, decode_fn = (ec_util.encode_fallback,
                                    ec_util.decode_fallback)
        elif b.lane == "mesh":
            encode_fn, decode_fn = (self._mesh.encode_batch,
                                    self._mesh.decode_batch)
        else:
            encode_fn, decode_fn = ec_util.encode, ec_util.decode
        sinfo, codec = b.sinfo, b.codec
        cs = sinfo.chunk_size
        total = sum(op.stripes for op in ops)
        pad = 0 if fallback else self._pad_for(b, total)
        if b.kind == "enc":
            if len(ops) == 1 and not pad:
                cat = ops[0].payload  # single op, snug bucket: no gather
            else:
                # EXACTLY ONE gather into one preallocated host buffer
                # (np.zeros: pad rows arrive already zero) — the batch's
                # single accounted copy before the device upload
                cat = np.zeros(
                    (total + pad) * sinfo.stripe_width, dtype=np.uint8
                )
                off = 0
                for op in ops:
                    n = op.stripes * sinfo.stripe_width
                    cat[off : off + n] = op.payload
                    off += n
                note_copy("ec_gather", off)
            t0 = time.perf_counter()
            if not fallback:
                # inside the timed window: the hang variant SIMULATES a
                # wedged device call, and a wedged call is slow DEVICE
                # WALL — timing it out of the window made the injected
                # slow launch invisible to the flight recorder, exactly
                # the record dump_launch_history exists to show
                self._maybe_inject()
            out = encode_fn(sinfo, codec, cat)
            seconds = time.perf_counter() - t0
            results = []
            off = 0
            for op in ops:
                end = off + op.stripes * cs
                results.append(
                    {s: a[off:end].copy() for s, a in out.items()}
                )
                off = end
            return results, pad, seconds
        # decode: stack per-shard buffers; the recovery matrix is
        # columnwise, so row ranges slice back exactly per op.  Same
        # one-gather-per-shard assembly as the encode side.
        present = sorted(ops[0].payload)
        cat: dict[int, np.ndarray] = {}
        for s in present:
            if len(ops) == 1 and not pad:
                cat[s] = ops[0].payload[s]
                continue
            buf = np.zeros((total + pad) * cs, dtype=np.uint8)
            off = 0
            for op in ops:
                n = op.stripes * cs
                buf[off : off + n] = op.payload[s]
                off += n
            note_copy("ec_gather", off)
            cat[s] = buf
        k = codec.get_data_chunk_count()
        t0 = time.perf_counter()
        if not fallback:
            self._maybe_inject()  # see the encode side: device wall
        decoded = decode_fn(sinfo, codec, cat, want=list(range(k)))
        seconds = time.perf_counter() - t0
        rows = [np.asarray(decoded[i]) for i in range(k)]
        results = []
        off = 0
        for op in ops:
            end = off + op.stripes * cs
            results.append(ec_util.shards_to_logical(
                [r[off:end] for r in rows], cs
            ))
            off = end
        return results, pad, seconds
