"""Typed cluster messages (reference:src/messages/ — the ~150 M*.h set,
narrowed to what the mini-RADOS data/control path uses).

Counterpart of ``ceph_tpu/msg/messages.py``, whole: every type with the
same ``TYPE``, ``TYPE_ID`` and ``FIELDS``, so this package reads any
frame the reference writes, not only the accelerator service's.

Bulk chunk payloads ride in frame blobs; metadata rides in the frame's
field tail (msg/message.py — marshal for the data path, JSON for the
``WIRE_TAIL = "json"`` admin/auth types).  Every class declares a
stable integer ``TYPE_ID`` — WIRE PROTOCOL, pinned against
msg/wire_manifest.json by tools/check_wire.py: never renumber or reuse
one (retire ids into the manifest's ``retired`` list instead), append
new ids to both this file and the manifest.  ``encode_txn``/
``decode_txn`` put a whole shard-local ObjectStore Transaction on the
wire — the exact role of ``ECSubWrite::transaction``
(reference:src/messages/MOSDECSubOpWrite.h, reference:src/osd/ECMsgTypes.h).
"""

from __future__ import annotations

from typing import Any

from ..store import CollectionId, ObjectId, Transaction
from .message import Message, register

# -- transaction wire form ---------------------------------------------------


def encode_txn(txn: Transaction) -> tuple[list, list[bytes]]:
    """Transaction -> (json-able op list, blobs). Bytes args (write data,
    xattr values, omap values) are hoisted into blobs, referenced by index."""
    ops_out: list[Any] = []
    blobs: list[bytes] = []

    def blob(b: bytes) -> int:
        # borrowed view, not bytes(b): shard write data is the fan-out
        # hot path, and the frame encoder sends views without joining
        blobs.append(b)
        return len(blobs) - 1

    for op in txn.ops:
        name = op[0]
        if name in ("create_collection", "remove_collection"):
            ops_out.append([name, op[1].pg])
        elif name in ("clone", "try_stash", "stash_restore"):
            (_, cid, src, dst) = op
            ops_out.append([name, cid.pg, [src.name, src.shard], [dst.name, dst.shard]])
        elif name in ("touch", "remove"):
            (_, cid, oid) = op
            ops_out.append([name, cid.pg, [oid.name, oid.shard]])
        elif name == "write":
            (_, cid, oid, offset, data) = op
            ops_out.append([name, cid.pg, [oid.name, oid.shard], offset, blob(data)])
        elif name in ("zero", "truncate"):
            ops_out.append([name, op[1].pg, [op[2].name, op[2].shard], *op[3:]])
        elif name == "setattr":
            (_, cid, oid, key, value) = op
            ops_out.append([name, cid.pg, [oid.name, oid.shard], key, blob(value)])
        elif name == "rmattr":
            (_, cid, oid, key) = op
            ops_out.append([name, cid.pg, [oid.name, oid.shard], key])
        elif name == "omap_setkeys":
            (_, cid, oid, kv) = op
            ops_out.append(
                [name, cid.pg, [oid.name, oid.shard],
                 {k: blob(v) for k, v in kv.items()}]
            )
        elif name == "omap_rmkeys":
            (_, cid, oid, keys) = op
            ops_out.append([name, cid.pg, [oid.name, oid.shard], list(keys)])
        elif name == "omap_clear":
            (_, cid, oid) = op
            ops_out.append([name, cid.pg, [oid.name, oid.shard]])
        else:
            raise ValueError(f"cannot encode transaction op {name!r}")
    return ops_out, blobs


def decode_txn(ops_in: list, blobs: list[bytes]) -> Transaction:
    txn = Transaction()

    def oid(o) -> ObjectId:
        return ObjectId(o[0], o[1])

    for op in ops_in:
        name = op[0]
        if name in ("create_collection", "remove_collection"):
            getattr(txn, name)(CollectionId(op[1]))
        elif name in ("clone", "try_stash", "stash_restore"):
            getattr(txn, name)(CollectionId(op[1]), oid(op[2]), oid(op[3]))
        elif name in ("touch", "remove", "omap_clear"):
            getattr(txn, name)(CollectionId(op[1]), oid(op[2]))
        elif name == "write":
            txn.write(CollectionId(op[1]), oid(op[2]), op[3], blobs[op[4]])
        elif name in ("zero", "truncate"):
            getattr(txn, name)(CollectionId(op[1]), oid(op[2]), *op[3:])
        elif name == "setattr":
            # xattr/omap values are SMALL metadata the store retains
            # indefinitely: materialize them here, or a 30-byte hinfo
            # view would pin its whole multi-MB receive frame for as
            # long as the object lives (write data stays a view — the
            # store copies it into its own extents on apply)
            txn.setattr(CollectionId(op[1]), oid(op[2]), op[3],
                        bytes(blobs[op[4]]))  # copy-ok: tiny metadata, must not pin the frame
        elif name == "rmattr":
            txn.rmattr(CollectionId(op[1]), oid(op[2]), op[3])
        elif name == "omap_setkeys":
            txn.omap_setkeys(
                CollectionId(op[1]), oid(op[2]),
                # copy-ok: tiny metadata, must not pin the frame
                {k: bytes(blobs[i]) for k, i in op[3].items()},
            )
        elif name == "omap_rmkeys":
            txn.omap_rmkeys(CollectionId(op[1]), oid(op[2]), op[3])
        else:
            raise ValueError(f"cannot decode transaction op {name!r}")
    return txn


# -- cluster log -------------------------------------------------------------


@register
class MLog(Message):
    """Daemon -> mon cluster-log entries (reference:src/messages/MLog.h,
    fed by common/LogClient's clog handle): severity-tagged cluster
    events — scrub corruption, crc mismatches, rollbacks — forwarded to
    the monitor and surfaced by ``ceph log last``.

    ``entries`` = [{"stamp": float, "name": str, "level": "error|warn|
    info", "msg": str}].
    """

    TYPE = "log"
    TYPE_ID = 10
    FIELDS = ("entries",)


@register
class MLogSub(Message):
    """Client -> mon: (un)subscribe this connection to cluster-log
    pushes (`ceph -w`, reference:src/mon/LogMonitor.cc log
    subscriptions via MMonSubscribe 'log-info').  Entries then arrive
    as MLog messages on the same connection."""

    TYPE = "log_sub"
    TYPE_ID = 11
    FIELDS = ("sub",)


# -- heartbeat / liveness ----------------------------------------------------


@register
class MPing(Message):
    """reference:src/messages/MOSDPing.h (PING)."""

    TYPE = "ping"
    TYPE_ID = 20
    FIELDS = ("stamp", "epoch")


@register
class MPingReply(Message):
    """reference:src/messages/MOSDPing.h (PING_REPLY)."""

    TYPE = "ping_reply"
    TYPE_ID = 21
    FIELDS = ("stamp", "epoch")


@register
class MClockSync(Message):
    """NTP-style clock probe (common/clocksync.py; the reference mon's
    ``timecheck`` exchange, applied per messenger connection so span
    timestamps from different processes merge into one timeline).
    Handled INSIDE the messenger — no dispatcher ever sees one.
    Request: ``t0`` = requester's monotonic at send, ``t_rx``/``t_tx``
    None.  Pong: ``t0`` echoed, ``t_rx`` = responder's monotonic at
    receive, ``t_tx`` at pong send."""

    TYPE = "clock_sync"
    TYPE_ID = 22
    FIELDS = ("t0", "t_rx", "t_tx")


# -- mon control plane -------------------------------------------------------


@register
class MMonCommand(Message):
    """Operator/admin command to the mon (reference:src/messages/MMonCommand.h);
    ``cmd`` is a dict like {"prefix": "osd pool create", ...}."""

    TYPE = "mon_command"
    TYPE_ID = 30
    WIRE_TAIL = "json"  # admin payloads stay pcap-greppable
    FIELDS = ("tid", "cmd")


@register
class MMonCommandReply(Message):
    TYPE = "mon_command_reply"
    TYPE_ID = 31
    WIRE_TAIL = "json"  # admin payloads stay pcap-greppable
    FIELDS = ("tid", "code", "status", "out")


@register
class MMonGetMap(Message):
    """Map subscription: send maps newer than ``have`` and keep me posted
    (reference:src/messages/MMonGetOSDMap.h + MMonSubscribe.h)."""

    TYPE = "mon_get_map"
    TYPE_ID = 32
    FIELDS = ("have",)


@register
class MOSDMapMsg(Message):
    """OSDMap epoch push (reference:src/messages/MOSDMap.h).

    Carries EITHER a contiguous list of epoch deltas in ``incrementals``
    (the common case — O(churn) bytes, the reference's
    MOSDMap::incremental_maps) or the full map dict in ``osdmap``
    (bootstrap / gap recovery).  Receivers that cannot bridge the chain
    re-request with MMonGetMap(have=None)."""

    TYPE = "osd_map"
    TYPE_ID = 33
    # committed_epoch: election epoch the map was committed in (set on
    # mon->mon catch-up pushes; recovery orders maps by (epoch, version))
    FIELDS = ("epoch", "osdmap", "committed_epoch", "incrementals")


@register
class MOSDBoot(Message):
    """OSD announces itself up (reference:src/messages/MOSDBoot.h)."""

    TYPE = "osd_boot"
    TYPE_ID = 34
    FIELDS = ("osd_id", "addr")


@register
class MOSDFailure(Message):
    """Failure report to the mon (reference:src/messages/MOSDFailure.h)."""

    TYPE = "osd_failure"
    TYPE_ID = 35
    FIELDS = ("target_osd", "reporter", "epoch")


# -- mon quorum (multi-mon election + replicated map log) --------------------


@register
class MMonElection(Message):
    """Elector exchange (reference:src/mon/Elector.cc): ``op`` is
    propose | ack | victory.  Acks carry the responder's committed map so
    the winner adopts the newest state before taking over (the Paxos
    recovery phase collapsed to full-map snapshots); victory carries the
    adopted map."""

    TYPE = "mon_election"
    TYPE_ID = 40
    # accepted: the responder's highest ACCEPTED-but-uncommitted proposal
    # {"epoch", "version", "value"} (the Paxos collect/last phase's
    # uncommitted-value carry — reference:src/mon/Paxos.cc handle_last);
    # committed_epoch: the election epoch the committed map was chosen in,
    # so recovery can order committed vs accepted by (epoch, version).
    FIELDS = ("op", "epoch", "rank", "map_epoch", "osdmap",
              "accepted", "committed_epoch")


@register
class MMonPaxos(Message):
    """Replicated map commit (reference:src/mon/Paxos.cc): ``op`` is
    propose | ack | need_full | commit; ``version`` is the map epoch
    being committed.  ``value`` is {"full": map_dict} or — the common
    case, O(churn) bytes like the reference's versioned transaction
    log — {"inc": incremental_dict}; a peon that cannot derive the full
    map from its own state answers need_full and the leader re-proposes
    with the snapshot.  (A bare map dict is the pre-delta wire form,
    still accepted.)"""

    TYPE = "mon_paxos"
    TYPE_ID = 41
    FIELDS = ("op", "epoch", "rank", "version", "value")


@register
class MMonLease(Message):
    """Leader liveness + read lease to peons (reference:src/mon/Paxos.cc
    lease extension); silence past mon_election_timeout triggers a new
    election."""

    TYPE = "mon_lease"
    TYPE_ID = 42
    FIELDS = ("epoch", "rank", "map_epoch")


# -- client <-> OSD ----------------------------------------------------------


@register
class MOSDOp(Message):
    """Client object op (reference:src/messages/MOSDOp.h).

    ``ops`` = list of {"op": name, ...args}; write-class payloads ride in
    blobs in op order (blob index in the op's "data" key).

    ``snapc`` ({"seq", "snaps"}) rides with writes, ``snapid`` with reads
    — the reference's MOSDOp snap_seq/snaps/snapid header fields.

    ``stamps`` ({"submit": <client monotonic>}) feeds the op waterfall
    (common/tracing.py): together with the frame header's send stamp
    the OSD computes the client_serialize hop without shipping any
    span, and aligns it through the clock table.

    ``client`` is the originator's stable session id — a
    63-bit blake2b of the entity name, one marshalled u64 riding the
    positional tail.  It keys the OSD's per-tenant ledger and flows
    through EC dispatch to the accelerator's flight records, so every
    layer attributes work to the same tenant.  None from peers that
    predate the field or from internal sub-ops.
    """

    TYPE = "osd_op"
    TYPE_ID = 50
    # client ops may ride multi-op batch frames (ms_op_batch_max): the
    # writer loop packs consecutive ready MOSDOps to one OSD into a
    # single frame with per-member blob tables (FLAG_BATCH_BLOBS) —
    # the Objecter's op-per-target aggregation at the wire layer
    BATCH_OPS = True
    FIELDS = ("tid", "epoch", "pool", "oid", "ops", "snapc", "snapid",
              "stamps", "client")


@register
class MOSDOpReply(Message):
    """reference:src/messages/MOSDOpReply.h. Per-op outputs in ``out``
    (json-able); read payloads in blobs (blob index in out entry).

    ``spans`` piggybacks the OSD's waterfall hops for a SAMPLED op
    (1-in-osd_op_trace_sample_every; None otherwise): each entry is
    {"hop", "t0", "dur", "entity", "parent"?, "uncertainty"?} with
    ``t0`` in the OSD's monotonic clock — the client aligns them
    through its clock table and records them locally, so the full
    cross-daemon waterfall is readable at the client without any
    collector."""

    TYPE = "osd_op_reply"
    TYPE_ID = 51
    COALESCE = True  # blob-free acks may ride coalesced batch frames
    FIELDS = ("tid", "result", "epoch", "out", "spans")


# -- EC shard sub-ops --------------------------------------------------------


@register
class MOSDECSubOpWrite(Message):
    """Primary -> shard: apply this shard-local transaction + log entries
    (reference:src/messages/MOSDECSubOpWrite.h, ECSubWrite in
    reference:src/osd/ECMsgTypes.h). ``txn`` per encode_txn (blobs shared
    with the frame); ``log`` = json-able pg_log entries; ``at_version`` /
    ``trim_to`` version pairs."""

    TYPE = "ec_sub_op_write"
    TYPE_ID = 60
    FIELDS = ("pgid", "tid", "from_osd", "shard", "txn", "log", "at_version",
              "trim_to", "epoch")


@register
class MOSDECSubOpWriteReply(Message):
    TYPE = "ec_sub_op_write_reply"
    TYPE_ID = 61
    COALESCE = True  # blob-free acks may ride coalesced batch frames
    FIELDS = ("pgid", "tid", "shard", "result")


@register
class MOSDECSubOpRead(Message):
    """Primary -> shard chunk read (reference:src/messages/MOSDECSubOpRead.h);
    ``reads`` = [{"oid": [name, shard], "offset": o, "length": l}],
    ``attrs``: also return xattrs."""

    TYPE = "ec_sub_op_read"
    TYPE_ID = 62
    FIELDS = ("pgid", "tid", "shard", "reads", "attrs")


@register
class MOSDECSubOpReadReply(Message):
    """Chunk data in blobs (index in each reads entry's "data"); per-read
    errors inline (reference:src/messages/MOSDECSubOpReadReply.h)."""

    TYPE = "ec_sub_op_read_reply"
    TYPE_ID = 63
    FIELDS = ("pgid", "tid", "shard", "reads", "attrs", "errors")


# -- replicated sub-ops ------------------------------------------------------


@register
class MOSDRepOp(Message):
    """Primary -> replica whole-op transaction
    (reference:src/messages/MOSDRepOp.h)."""

    TYPE = "rep_op"
    TYPE_ID = 70
    FIELDS = ("pgid", "tid", "from_osd", "txn", "log", "at_version", "epoch")


@register
class MOSDRepOpReply(Message):
    TYPE = "rep_op_reply"
    TYPE_ID = 71
    COALESCE = True  # blob-free acks may ride coalesced batch frames
    FIELDS = ("pgid", "tid", "from_osd", "result")


# -- scrub -------------------------------------------------------------------


@register
class MOSDScrub(Message):
    """Operator -> PG primary: deep-scrub (and optionally repair) one PG
    (the `ceph pg deep-scrub` command path, reference:src/messages/
    MOSDScrub.h; engine analog reference:src/osd/ECBackend.cc:2313)."""

    TYPE = "osd_scrub"
    TYPE_ID = 80
    FIELDS = ("tid", "pgid", "repair")


@register
class MOSDScrubReply(Message):
    """``report`` = {"pg", "objects", "errors": [...], "repaired", "clean"}."""

    TYPE = "osd_scrub_reply"
    TYPE_ID = 81
    FIELDS = ("tid", "result", "report")


@register
class MPGLs(Message):
    """Client -> PG primary: list this PG's objects (the pgls op behind
    `rados ls`, reference:src/osd/PrimaryLogPG.cc do_pg_op PGLS)."""

    TYPE = "pg_ls"
    TYPE_ID = 82
    FIELDS = ("tid", "pgid")


@register
class MPGLsReply(Message):
    TYPE = "pg_ls_reply"
    TYPE_ID = 83
    FIELDS = ("tid", "result", "names")


@register
class MPGStats(Message):
    """OSD -> mgr: periodic stats report (reference:src/messages/
    MPGStats.h).  ``pgs`` = {pgid: {"objects", "bytes", "primary"}},
    ``perf`` = the daemon's counter dump, ``store`` = usage totals.

    ``ledger`` is the OSD's per-tenant heavy-hitter dump
    (client_ledger.series(): bounded top-K list of {"client", "pool",
    "class", rates...} rows plus the evicted-other bucket) — shipped
    as its own field rather than folded into ``perf`` so the mgr's
    prometheus module keeps full label control and the cardinality
    bound is enforced at the source.

    ``traces`` is the tail-sampling drain: the keep-policy
    survivors since the last report, each a merged op waterfall dict
    (hops, client, pool, keep reason, wall time, launch linkage) bound
    for the mgr trace store.  Bounded at the source — the OSD's
    pending ring holds at most 256 kept traces per interval."""

    TYPE = "pg_stats"
    TYPE_ID = 84
    FIELDS = ("osd", "epoch", "pgs", "perf", "store", "ledger", "traces")


@register
class MDaemonStats(Message):
    """Any non-OSD daemon -> mgr: periodic perf-counter report (the
    reference's MMgrReport from mons/rgw/mds).  ``name`` is the entity
    ("mon.0", "rgw.zone"), ``perf`` a PerfCountersCollection dump
    ({subsystem: {counter: value}}) — the prometheus module exports
    every series with a daemon label."""

    TYPE = "daemon_stats"
    TYPE_ID = 85
    FIELDS = ("name", "perf")


@register
class MAuth(Message):
    """Client -> mon CephX bootstrap (reference:src/messages/MAuth.h).
    op = "get_nonce" | "authenticate" (with entity + proof)."""

    TYPE = "auth"
    TYPE_ID = 90
    WIRE_TAIL = "json"  # admin payloads stay pcap-greppable
    FIELDS = ("tid", "op", "entity", "proof")


@register
class MAuthReply(Message):
    """reference:src/messages/MAuthReply.h; carries the service ticket
    on success plus the ticket's session key sealed under the entity
    secret (CephxServiceTicket secret analog — see auth.seal_skey)."""

    TYPE = "auth_reply"
    TYPE_ID = 91
    WIRE_TAIL = "json"  # admin payloads stay pcap-greppable
    FIELDS = ("tid", "result", "nonce", "ticket", "skey")


@register
class MClientRequest(Message):
    """CephFS client -> MDS metadata op (reference:src/messages/
    MClientRequest.h).  ``op`` names the call, ``args`` its parameters."""

    TYPE = "client_request"
    TYPE_ID = 100
    FIELDS = ("tid", "op", "args")


@register
class MClientReply(Message):
    """reference:src/messages/MClientReply.h."""

    TYPE = "client_reply"
    TYPE_ID = 101
    FIELDS = ("tid", "result", "out")


@register
class MWatchNotify(Message):
    """OSD -> watching client: a notify fired on an object you watch
    (reference:src/messages/MWatchNotify.h).  Payload in blobs[0]."""

    TYPE = "watch_notify"
    TYPE_ID = 110
    FIELDS = ("notify_id", "cookie", "oid", "notifier")


@register
class MWatchNotifyAck(Message):
    """Watching client -> OSD: notify handled; reply payload (if any)
    in blobs[0] (reference ack path via CEPH_OSD_OP_NOTIFY_ACK)."""

    TYPE = "watch_notify_ack"
    TYPE_ID = 111
    COALESCE = True  # blob-free acks may ride coalesced batch frames
    FIELDS = ("notify_id", "cookie")


# -- shared EC accelerator service (accel) ----------------------------------


@register
class MAccelEncode(Message):
    """OSD -> accelerator daemon: one coalesced EC encode batch (the
    remote dispatcher lane).  ``profile`` is the erasure-code
    profile dict the accelerator rebuilds the codec from (plugin, k, m,
    technique, ...); ``stripe_width``/``chunk_size`` the stripe
    geometry; ``stripes`` the per-member stripe counts (one entry per
    coalesced op — the accelerator's flight recorder attributes
    occupancy per client batch); ``klass`` the QoS traffic class the
    accelerator's own dmClock instance paces by.  Payloads ride in
    blobs, ONE BORROWED VIEW PER MEMBER OP (no gather on the OSD side
    — the frame encoder sends views vectored); the trace id rides the
    frame header like every message.

    ``tenants`` is the per-member originating-client id
    list (one entry per coalesced op, 0 for unattributed) — the
    accelerator's dmClock and flight records attribute device time to
    the SAME tenant ids the OSD ledger uses, not just to the sending
    OSD."""

    TYPE = "accel_encode"
    TYPE_ID = 120
    FIELDS = ("tid", "profile", "stripe_width", "chunk_size", "stripes",
              "klass", "tenants")


@register
class MAccelDecode(Message):
    """OSD -> accelerator daemon: one coalesced EC decode batch.
    ``present`` is the shared survivor set (batch keys include it, so
    every member reads through the same recovery matrix); blobs are
    per-member per-shard views in ``present`` order, member-major
    (op0's shards, then op1's, ...).  ``tenants`` as in MAccelEncode:
    per-member originating-client ids."""

    TYPE = "accel_decode"
    TYPE_ID = 121
    FIELDS = ("tid", "profile", "stripe_width", "chunk_size", "stripes",
              "present", "klass", "tenants")


@register
class MAccelReply(Message):
    """Accelerator -> OSD: the batch result, member-major.  Encode
    replies carry ``len(members) x len(shards)`` blobs — each member's
    per-shard result buffers in ``shards`` order (the accelerator's
    dispatcher already sliced them per member; sending them as views
    avoids any re-join); decode replies carry one reassembled logical
    blob PER member.
    ``engine_state``/``queue_depth``/``capacity`` piggyback the
    accelerator's health on EVERY reply (the beacon's fields), so a
    busy OSD learns about a TRIPPED or saturating remote from its own
    traffic, without waiting for the next beacon.  ``served`` names the
    engine that produced the bytes (device/mesh/fallback),
    ``device_wall_s`` its launch time and ``queue_wait_s`` the
    accelerator-side coalesce wait — accelerator-side evidence for the
    OSD's flight recorder and the op waterfall's accel hops."""

    TYPE = "accel_reply"
    TYPE_ID = 122
    FIELDS = ("tid", "result", "error", "shards", "engine_state",
              "queue_depth", "capacity", "served", "device_wall_s",
              "queue_wait_s")


@register
class MAccelBeacon(Message):
    """Accelerator -> every connected OSD, periodic: engine breaker
    state + queue depth + stripe capacity.  OSDs route around a TRIPPED
    or saturated remote on the NEXT request — no timeout chain — and
    route back when a healthy beacon arrives."""

    TYPE = "accel_beacon"
    TYPE_ID = 123
    FIELDS = ("name", "engine_state", "queue_depth", "capacity")


@register
class MAccelBoot(Message):
    """Accelerator -> mon: register into the mon-published AccelMap
    (the MOSDBoot analog).  Re-sent periodically as the
    registration beacon — the mon marks the accelerator down on beacon
    loss or connection reset and publishes the epoch bump, so every
    subscribed OSD's router learns within one map push.  ``down=True``
    is the graceful-deregistration form (clean daemon stop); a peon
    forwards either form to the leader like every map mutation."""

    TYPE = "accel_boot"
    TYPE_ID = 124
    FIELDS = ("name", "addr", "locality", "capacity", "down")


# -- recovery ----------------------------------------------------------------


@register
class MOSDPGScan(Message):
    """Primary -> shard: report your objects + log for this PG shard
    (reference:src/messages/MOSDPGScan.h + the GetInfo/GetLog peering
    exchanges, reference:src/osd/PG.h:1654 RecoveryMachine).

    ``shard`` is the reply routing key; ``store_shard`` names the shard
    collection to scan (-1 = replicated whole-PG collection)."""

    TYPE = "pg_scan"
    TYPE_ID = 130
    FIELDS = ("pgid", "tid", "shard", "store_shard", "from_osd")


@register
class MOSDPGScanReply(Message):
    """``objects`` = {name: {"version": [e,v], "size": n}};
    ``log`` = json-able pg_log entries in version order;
    ``info`` = PGShardInfo dict (les/last_update/log_len — the GetInfo
    payload, reference pg_info_t); ``intervals`` = this member's
    recorded past acting-set intervals (PastIntervals.to_json lists)."""

    TYPE = "pg_scan_reply"
    TYPE_ID = 131
    FIELDS = ("pgid", "tid", "shard", "objects", "log", "info", "intervals")


@register
class MOSDPGPush(Message):
    """Recovery push of a rebuilt shard/object (reference:src/messages/
    MOSDPGPush.h); ``pushes`` = [{"oid": [n,s], "data": blobidx, "attrs":
    {k: blobidx}, "version": v}]."""

    TYPE = "pg_push"
    TYPE_ID = 132
    FIELDS = ("pgid", "tid", "from_osd", "pushes")


@register
class MOSDPGPushReply(Message):
    TYPE = "pg_push_reply"
    TYPE_ID = 133
    FIELDS = ("pgid", "tid", "from_osd", "results")


@register
class MRecoveryReserve(Message):
    """Recovery/backfill remote-reservation protocol
    (reference:src/messages/MRecoveryReserve.h + MBackfillReserve.h):
    ``op`` is request | grant | release.  A grant may arrive long after
    the request — the target queues it behind its ``osd_max_backfills``
    remote slots (reference:src/osd/OSD.h remote_reserver)."""

    TYPE = "recovery_reserve"
    TYPE_ID = 134
    FIELDS = ("pgid", "tid", "from_osd", "op", "prio")
