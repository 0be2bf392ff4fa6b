"""The small-op cost ledger + per-hop latency family (``stack.*``).

Counterpart of ``ceph_tpu/common/stack_ledger.py``, whole.  It measures
the per-op cost of the frame header against the rest of an op:

- **ledger counters**, fed by the messenger boundary on every frame:
  ``header_encode_s`` / ``header_decode_s`` (seconds spent purely on
  the header: struct pack/unpack + field-tail codec + type routing,
  never the payload-proportional crc), ``frames_encoded`` /
  ``frames_decoded``, and ``frame_allocs`` — discrete frame-BUFFER
  allocation events on the frame path.  Re-baselined by the
  binary header: the JSON era counted header bytes + crc pack +
  control-frame join + the decode header copy (~3 per frame); all
  four are gone — headers now pack into slab-recycled scratch
  (common/slab.py) and decode as struct slices of the receive view —
  so the only remaining alloc events are slab-pool **misses**
  (cold pool / oversize tails).  Steady state is allocation-free:
  ``frame_allocs`` goes FLAT while ``slab_hits`` grows (pinned by
  the reference's tests/test_wire_protocol.py on a live cluster).
  ``header_share`` is ``(header_encode_s + header_decode_s) / Σ op
  wall``.

- **slab pool counters** (``slab_hits`` / ``slab_misses`` /
  ``slab_bytes_held``), fed by common/slab.py: recycling proof for
  the frame scratch pool — hits are allocation-free frame encodes,
  misses are real allocations (also counted in ``frame_allocs``),
  the gauge is bytes parked in the bounded free lists.

- **per-hop latency histograms** ``lat_<hop>``, fed by the OSD for
  1-in-``osd_op_trace_sample_every`` client ops (the sampled
  waterfall, common/tracing.py): log2 buckets from 1 µs, flattened by
  the mgr prometheus module into ``ceph_stack_lat_<hop>_bucket``
  series — per-hop p99 as a continuously exported series, not a debug
  session.

Process-global like the ``data_path`` family (utils/buffers.py): every
in-process daemon shares one messenger boundary, so they share one
ledger; daemons ``attach()`` it into their collections so it rides
``perf dump`` and the mgr report.  (With several OSDs in one process
each exports the same shared numbers — the documented data_path
caveat applies here too.)
"""

from __future__ import annotations

import threading

# the canonical small-op hops (the waterfall's vocabulary); feed_hop()
# lazily registers anything else, same policy as note_copy's hops.
# Every hop here — and every literal record_span/feed_hop hop anywhere
# — must also appear in common/hop_manifest.json: the manifest bounds
# the ceph_stack_lat_* prometheus series set by construction, and
# tools/check_counters.py fails CI on drift in either direction
STACK_HOPS = (
    "client_serialize",  # client: operate() submit -> frame queued
    "wire",              # frame queued -> peer receive (clock-aligned)
    "dispatch",          # peer receive -> op handler entry
    "qos_wait",          # OpTracker queued_for_qos -> dequeued
    "execute",           # op engine wall (EC/replication inside)
    "coalesce_wait",     # EC dispatcher batch queue wait (child)
    "device_wall",       # device launch wall (child)
    "accel_queue_wait",  # accel-side coalesce wait (remote lane child)
    "reply_wire",        # reply queued -> client receive
    "reply_dispatch",    # client receive -> op task resumed
    "total",             # client submit -> reply queued (OSD-visible
                         # extent; add lat_reply_* for the full wall)
)

_lock = threading.Lock()
_perf = None  # built lazily: common must import without perf_counters


def stack_perf():
    """The process-global ``stack`` PerfCounters."""
    global _perf
    if _perf is None:
        with _lock:
            if _perf is None:
                from .perf_counters import PerfCounters, latency_axis

                pc = PerfCounters("stack")
                (pc
                 .add_counter("header_encode_s",
                              "seconds spent encoding frame headers "
                              "(struct pack + field tail; crc "
                              "excluded)")
                 .add_counter("header_decode_s",
                              "seconds spent decoding frame headers "
                              "(struct unpack + field tail + type "
                              "routing; crc excluded)")
                 .add_counter("frames_encoded",
                              "frames whose header encode was timed")
                 .add_counter("frames_decoded",
                              "frames whose header decode was timed")
                 .add_counter("frame_allocs",
                              "frame-buffer allocation events on the "
                              "frame path — slab-pool misses and "
                              "oversize scratch; flat in steady "
                              "state (the JSON-era header/crc/join/"
                              "decode-copy allocs are retired)")
                 .add_counter("slab_hits",
                              "frame scratch served from the slab "
                              "free lists (allocation-free encodes)")
                 .add_counter("slab_misses",
                              "slab checkouts that had to allocate "
                              "(cold pool or oversize request)")
                 .add_gauge("slab_bytes_held",
                            "bytes parked in the slab pool's bounded "
                            "free lists")
                 .add_counter("recv_allocs",
                              "receive-buffer allocation events — "
                              "recv-pool misses (cold pool / oversize "
                              "frame); flat in steady state now that "
                              "inbound frames land in pooled blocks "
                              "(common/recv_pool.py), the last "
                              "allocating hop retired")
                 .add_counter("recv_slab_hits",
                              "inbound frames served from the recv "
                              "pool's free lists (allocation-free "
                              "receives)")
                 .add_gauge("recv_bytes_held",
                            "bytes parked in the recv pool's bounded "
                            "free lists (quarantined still-referenced "
                            "blocks excluded: their views own them)")
                 .add_counter("sampled_ops",
                              "client ops that got full waterfall "
                              "spans (1-in-osd_op_trace_sample_every)"))
                # one latency histogram per hop — literal keys so the
                # check_counters gate and the prometheus collision
                # check both cover the family.  1 us floor: small-op
                # hops sit well under the 100 us default floor.
                axes_kw = dict(lat_min=1e-6, buckets=22)
                pc.add_histogram("lat_client_serialize",
                                 "client submit -> frame queued",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_wire",
                                 "frame queued -> peer receive "
                                 "(clock-aligned)",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_dispatch",
                                 "peer receive -> op handler entry",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_qos_wait",
                                 "QoS admission queue wait",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_execute",
                                 "op engine wall time",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_coalesce_wait",
                                 "EC dispatcher batch queue wait",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_device_wall",
                                 "device launch wall time",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_accel_queue_wait",
                                 "accelerator-side coalesce wait",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_reply_wire",
                                 "reply queued -> client receive",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_reply_dispatch",
                                 "client receive -> op task resumed",
                                 axes=latency_axis(**axes_kw))
                pc.add_histogram("lat_total",
                                 "client submit -> reply queued (the "
                                 "OSD-visible extent, fed where the "
                                 "histograms are exported; reply "
                                 "wire/delivery ride lat_reply_*)",
                                 axes=latency_axis(**axes_kw))
                # the registrations above are LITERAL on purpose (the
                # check_counters gate and the prometheus collision
                # check both key on literal builder args); this pins
                # them to the canonical hop vocabulary so the two
                # cannot drift apart silently
                missing = [h for h in STACK_HOPS
                           if f"lat_{h}" not in pc._types]
                assert not missing, (
                    f"STACK_HOPS drifted from the literal lat_* "
                    f"registrations: {missing}"
                )
                _perf = pc
    return _perf


def note_header_encode(seconds: float, allocs: int = 0) -> None:
    """One frame header encoded (msg/message.py boundary)."""
    pc = stack_perf()
    pc.inc_pair("header_encode_s", seconds, "frames_encoded", 1)
    if allocs:
        pc.inc("frame_allocs", allocs)


def note_header_decode(seconds: float, allocs: int = 0) -> None:
    """One frame header decoded (msg/message.py boundary)."""
    pc = stack_perf()
    pc.inc_pair("header_decode_s", seconds, "frames_decoded", 1)
    if allocs:
        pc.inc("frame_allocs", allocs)


def note_frame_alloc(n: int = 1) -> None:
    """A frame-buffer allocation outside the slab accounting (rare:
    paths that bypass the pool entirely)."""
    stack_perf().inc("frame_allocs", n)


def note_slab_hit(n: int = 1) -> None:
    """Pooled slab checkouts (allocation-free frame encodes), flushed
    in batches from the pool's plain-int tally — the checkout hot path
    sits inside the timed header-encode window and pays no perf-
    counter lock; releases/misses/stats flush the delta."""
    stack_perf().inc("slab_hits", n)


def note_slab_miss(held_bytes: int) -> None:
    """One slab checkout that had to allocate — a real frame-path
    allocation, ALSO counted into ``frame_allocs`` (the
    flat-in-steady-state pin)."""
    pc = stack_perf()
    pc.inc("slab_misses")
    pc.inc("frame_allocs")
    pc.set("slab_bytes_held", held_bytes)


def note_slab_held(held_bytes: int) -> None:
    """Free-list byte gauge refresh on a slab release."""
    stack_perf().set("slab_bytes_held", held_bytes)


def note_recv_hit(n: int = 1) -> None:
    """Pooled receive-block checkouts (allocation-free frame reads),
    flushed in batches from the pool's plain-int tally like
    note_slab_hit."""
    stack_perf().inc("recv_slab_hits", n)


def note_recv_miss(held_bytes: int) -> None:
    """One receive checkout that had to allocate — a real frame-path
    allocation, ALSO counted into ``frame_allocs`` (the
    flat-in-steady-state pin now covers both directions)."""
    pc = stack_perf()
    pc.inc("recv_allocs")
    pc.inc("frame_allocs")
    pc.set("recv_bytes_held", held_bytes)


def note_recv_held(held_bytes: int) -> None:
    """Free-list byte gauge refresh on a recv-block release."""
    stack_perf().set("recv_bytes_held", held_bytes)


def feed_hop(hop: str, seconds: float) -> None:
    """Sample one hop duration into its ``lat_<hop>`` histogram
    (negative clock-alignment residue clamps to the floor bucket);
    unknown hops lazily register, like note_copy's dynamic hops."""
    pc = stack_perf()
    key = f"lat_{hop}"
    if key not in pc._types:
        with _lock:
            if key not in pc._types:
                from .perf_counters import latency_axis

                pc.add_histogram(key, f"waterfall hop {hop}",
                                 axes=latency_axis(lat_min=1e-6,
                                                   buckets=22))
    pc.hist(key, max(float(seconds), 1e-9))


def header_seconds() -> tuple[float, float]:
    """(encode_s, decode_s) accumulated so far — the bench ledger
    read."""
    pc = stack_perf()
    return float(pc.get("header_encode_s")), float(pc.get("header_decode_s"))


def reset_stack() -> None:
    """Zero the family (a bench window starts clean)."""
    stack_perf().reset()
