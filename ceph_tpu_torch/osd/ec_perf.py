"""The ``ec`` perf-counter family, registered in one place.

Counterpart of ``create_ec_perf``, ``create_accel_client_perf`` and
``create_accel_service_perf`` in ``ceph_tpu/osd/ec_perf.py``: the same
keys, so that the dispatcher, the supervisor, the accelerator client and
the accelerator daemon find every key they mutate and a ``perf dump`` of
either package has the same shape.  The ``accel`` family has two halves:
the OSD's client-side view of its remote, and the accelerator daemon's
service-side totals (distinct key names, so the shared subsystem name
never collides).  The client half carries the fleet router's keys
(``remote_failover_next``, ``locality_hits``/``misses``, ``fleet_*``),
and ``create_accel_target_perf`` the per-target ``accel@<id>`` family.
"""

from __future__ import annotations

from ..common.perf_counters import PerfHistogramAxis


def create_ec_perf(perf):
    """Create and populate the ``ec`` subsystem on ``perf`` (a
    PerfCountersCollection) — shared by the OSD and the accelerator
    daemon."""
    pec = perf.create("ec")
    # the keys, types and descriptions are the reference's, word for
    # word: the two packages' perf schemas compare equal
    pec.add_counter("encode_calls", "batched device encodes")
    pec.add_counter("encode_bytes", "logical bytes encoded")
    pec.add_counter("decode_calls", "batched device decodes")
    pec.add_counter("decode_bytes", "shard bytes decoded")
    pec.add_counter("mesh_encode_calls",
                    "encodes dispatched to the device-mesh engine")
    pec.add_counter("mesh_decode_calls",
                    "reconstructs via the mesh all-gather path")
    # the mesh dispatcher lane: launch/geometry evidence
    # for the multi-chip route, distinct from the per-op calls
    pec.add_counter("mesh_batches",
                    "coalesced launches served by the mesh lane")
    pec.add_gauge("mesh_devices",
                  "devices in the EC mesh slice (pg x shard) as "
                  "seen by the last mesh-lane launch")
    # per-engine codec throughput: last-call GB/s gauges + wall-time
    # avgs
    pec.add_gauge("encode_gbps", "host-path encode GB/s (last call)")
    pec.add_gauge("decode_gbps", "host-path decode GB/s (last call)")
    pec.add_gauge("mesh_encode_gbps",
                  "mesh-engine encode GB/s (last call)")
    pec.add_gauge("mesh_decode_gbps",
                  "mesh-engine reconstruct GB/s (last call)")
    pec.add_time_avg("encode_time", "device encode wall time")
    pec.add_time_avg("decode_time", "device decode wall time")
    pec.add_histogram("encode_time_histogram",
                      "EC encode buffer size x device wall time")
    pec.add_histogram("decode_time_histogram",
                      "EC decode shard bytes x device wall time")
    # cross-op microbatch dispatcher (osd_ec_dispatch; see
    # osd/ec_dispatch.py): coalesced-launch + bucketing evidence
    pec.add_counter("dispatch_batches", "coalesced device launches")
    pec.add_counter("dispatch_ops",
                    "encode/decode requests served by coalesced launches")
    pec.add_counter("dispatch_cancelled",
                    "queued waiters dropped by op abort")
    pec.add_counter("dispatch_flush_size",
                    "batches flushed on the stripe threshold")
    pec.add_counter("dispatch_flush_window",
                    "batches flushed on the coalescing window")
    pec.add_counter("dispatch_flush_stop",
                    "batches flushed at daemon shutdown")
    pec.add_counter("dispatch_pad_stripes",
                    "zero stripes added by shape bucketing")
    pec.add_counter("dispatch_pad_bytes",
                    "bucket pad waste in bytes")
    pec.add_counter("dispatch_native_direct",
                    "per-op calls routed straight to the native C "
                    "engine in the worker pool (no coalescing win "
                    "there — see ec_dispatch)")
    pec.add_avg("dispatch_occupancy",
                "batch stripes / flush threshold at launch")
    pec.add_histogram(
        "dispatch_batch_size_histogram",
        "requests coalesced per device launch",
        axes=[PerfHistogramAxis("ops", min=1.0, buckets=12)],
    )
    # per-lane split of the dispatcher evidence: pad waste /
    # occupancy / batch sizes attributable per route (native-direct has its own counter above — no
    # batching there, so no occupancy/pad series)
    pec.add_counter("dispatch_batches_device",
                    "coalesced launches on the single-device lane")
    pec.add_counter("dispatch_batches_mesh",
                    "coalesced launches on the mesh lane")
    pec.add_counter("dispatch_ops_device",
                    "requests served by single-device launches")
    pec.add_counter("dispatch_ops_mesh",
                    "requests served by mesh-lane launches")
    pec.add_counter("dispatch_pad_stripes_device",
                    "bucket pad stripes on the single-device lane")
    pec.add_counter("dispatch_pad_stripes_mesh",
                    "mesh-alignment + bucket pad stripes on the "
                    "mesh lane")
    pec.add_counter("dispatch_pad_bytes_device",
                    "single-device-lane pad waste in bytes")
    pec.add_counter("dispatch_pad_bytes_mesh",
                    "mesh-lane pad waste in bytes")
    pec.add_avg("dispatch_occupancy_device",
                "single-device-lane batch stripes / flush threshold")
    pec.add_avg("dispatch_occupancy_mesh",
                "mesh-lane batch stripes / flush threshold")
    pec.add_histogram(
        "dispatch_batch_size_device_histogram",
        "requests coalesced per single-device launch",
        axes=[PerfHistogramAxis("ops", min=1.0, buckets=12)],
    )
    pec.add_histogram(
        "dispatch_batch_size_mesh_histogram",
        "requests coalesced per mesh-lane launch",
        axes=[PerfHistogramAxis("ops", min=1.0, buckets=12)],
    )
    # the remote dispatcher lane: batches shipped to the
    # shared accelerator daemon over the messenger — no padding there
    # (the accelerator buckets on its own jit cache), so no pad series
    pec.add_counter("dispatch_batches_remote",
                    "coalesced batches shipped to the accelerator")
    pec.add_counter("dispatch_ops_remote",
                    "requests served by accelerator-lane batches")
    pec.add_avg("dispatch_occupancy_remote",
                "remote-lane batch stripes / flush threshold")
    pec.add_histogram(
        "dispatch_batch_size_remote_histogram",
        "requests coalesced per remote-lane batch",
        axes=[PerfHistogramAxis("ops", min=1.0, buckets=12)],
    )
    # inside-the-kernel device tracing (trace windows, not ported
    # yet): per-bucket device-seconds accumulated across closed
    # `kernel trace` windows, pulled off the report tick; the
    # occupancy gauge reflects the LAST window (device-busy seconds
    # / window wall — parallel execution threads can push it >1)
    pec.add_counter("device_time_fused_op",
                    "traced device seconds in fused-op/compute "
                    "HLO events (kernel trace windows)")
    pec.add_counter("device_time_dma",
                    "traced device seconds in DMA/infeed/outfeed/"
                    "copy events")
    pec.add_counter("device_time_collective",
                    "traced device seconds in ICI collective "
                    "events (all-gather/all-reduce/...)")
    pec.add_gauge("device_occupancy",
                  "device-busy share of the last trace window "
                  "(>1 = parallel execution threads)")
    # accelerator fault domain (osd/ec_failover): the engine_state
    # gauge feeds the mgr's ACCEL_DEGRADED health check
    pec.add_gauge("engine_state",
                  "EC device engine health: 0 healthy / 1 suspect "
                  "/ 2 tripped / 3 probing")
    pec.add_counter("engine_failovers",
                    "batched launches replayed on the host fallback "
                    "engine after a fatal device error")
    pec.add_counter("replayed_ops",
                    "waiter ops served bit-identically by a "
                    "failover replay")
    pec.add_counter("launch_deadline_timeouts",
                    "device launches abandoned at "
                    "osd_ec_launch_deadline (wedged device call)")
    return pec


def create_accel_client_perf(perf):
    """The OSD-side half of the ``accel`` family: this daemon's view of
    its remote accelerator (the AccelClient mutates these)."""
    pacc = perf.create("accel")
    pacc.add_counter("remote_batches",
                     "coalesced EC batches shipped to the accelerator")
    pacc.add_counter("remote_ops",
                     "member ops served by remote batches")
    pacc.add_counter("remote_bytes",
                     "payload bytes shipped to the accelerator")
    pacc.add_counter("remote_failovers",
                     "remote batches replayed on the LOCAL fallback "
                     "engine after an accelerator fault (network trip "
                     "— see dump_launch_history origin=remote)")
    pacc.add_counter("remote_data_errors",
                     "remote batches answered with a data-shape error "
                     "(surfaced to the caller, not replayed)")
    pacc.add_counter("remote_routed_away",
                     "requests that skipped the remote lane because "
                     "the last beacon read TRIPPED or saturated")
    pacc.add_gauge("remote_unreachable",
                   "1 while the accelerator is marked unreachable "
                   "(connect/deadline faults; feeds the mgr's "
                   "ACCEL_UNREACHABLE health check)")
    pacc.add_gauge("remote_state",
                   "accelerator engine breaker state from the last "
                   "beacon/reply (0 healthy .. 3 probing)")
    pacc.add_gauge("remote_queue_depth",
                   "accelerator queue depth from the last "
                   "beacon/reply")
    pacc.add_time_avg("remote_rtt",
                      "remote batch round-trip wall time")
    # the accelerator FLEET (accel/router.py): inter-accel failover +
    # load/locality routing evidence, and the fleet gauges the mgr's
    # ACCEL_FLEET_DEGRADED check reads
    pacc.add_counter("remote_failover_next",
                     "remote batches failed over to the NEXT "
                     "accelerator in the fleet (no client op failed; "
                     "local fallback happens only when the whole "
                     "fleet is down)")
    pacc.add_counter("locality_hits",
                     "decode batches routed to the accelerator "
                     "matching their surviving shards' majority "
                     "locality label")
    pacc.add_counter("locality_misses",
                     "decode batches carrying locality labels that "
                     "no (preferred) accelerator matched")
    pacc.add_gauge("fleet_size", "accelerator targets this OSD routes "
                                 "over (map entries, or 1 for the "
                                 "static osd_ec_accel_addr shim)")
    pacc.add_gauge("fleet_up", "fleet targets currently reachable")
    pacc.add_gauge("fleet_down",
                   "fleet targets sticky-down (>=1 with fleet_up>=1 "
                   "raises ACCEL_FLEET_DEGRADED; all down raises "
                   "ACCEL_UNREACHABLE)")
    return pacc


def create_accel_target_perf(perf, target):
    """The per-accel split of the client half: one ``accel@<id>``
    subsystem per fleet target, mutated by that target's AccelClient
    alongside the aggregate family.  The mgr prometheus module
    recognises the ``@`` form and exports these as
    ``ceph_accel_*{accel="<id>"}`` labelled series, so a fleet's skew
    is visible per target in one query."""
    pacc = perf.create(f"accel@{target}")
    pacc.add_counter("remote_batches",
                     "coalesced EC batches shipped to this accelerator")
    pacc.add_counter("remote_ops",
                     "member ops served by this accelerator")
    pacc.add_counter("remote_bytes",
                     "payload bytes shipped to this accelerator")
    pacc.add_counter("remote_failover_next",
                     "batches this accelerator failed that the next "
                     "fleet member retried")
    pacc.add_counter("remote_data_errors",
                     "data-shape errors answered by this accelerator")
    pacc.add_counter("remote_routed_away",
                     "requests that skipped this accelerator "
                     "(TRIPPED/saturated beacon)")
    pacc.add_gauge("remote_unreachable",
                   "1 while this accelerator is sticky-down")
    pacc.add_gauge("remote_state",
                   "this accelerator's breaker state from its last "
                   "beacon/reply")
    pacc.add_gauge("remote_queue_depth",
                   "this accelerator's queue depth from its last "
                   "beacon/reply")
    pacc.add_time_avg("remote_rtt",
                      "batch round-trip wall time to this accelerator")
    return pacc


def create_accel_service_perf(perf):
    """The accelerator-daemon half of the ``accel`` family: the shared
    service's own request totals."""
    pacc = perf.create("accel")
    pacc.add_counter("rpc_encode", "encode batches received")
    pacc.add_counter("rpc_decode", "decode batches received")
    pacc.add_counter("rpc_errors",
                     "requests answered with an error reply")
    pacc.add_counter("rpc_bytes_in", "payload bytes received")
    pacc.add_counter("rpc_bytes_out", "result bytes sent")
    pacc.add_counter("beacons", "engine-state beacons broadcast")
    pacc.add_counter("cross_client_batches",
                     "launches that coalesced ops from more than one "
                     "client OSD (the shared-occupancy win)")
    pacc.add_gauge("queue_depth", "requests currently in service")
    pacc.add_gauge("clients", "client OSDs seen in the last 30s")
    pacc.add_time_avg("service_time",
                      "request service wall time (queue + launch)")
    return pacc
