"""Message envelope + binary wire framing.

Counterpart of ``ceph_tpu/msg/message.py``, whole: the same frame, byte
for byte (a frame either package writes, the other reads), the same
``TYPE_ID`` registry pinned by this package's own copy of
``msg/wire_manifest.json``, and the same borrowed-view contract.

The reference gives every message a **fixed-layout** typed header whose
decode is a pointer cast, not a parse (``ceph_msg_header``,
reference:src/include/msgr.h), a midsection and raw data segments, each
crc32c-protected (reference:src/msg/Message.h).  The frame here (all
integers little-endian; the writer prepends a 4-byte big-endian length
like before):

    offset  size  field
    0       4     magic  b"CTPB"
    4       2     type_id   (stable integer id, msg/wire_manifest.json)
    6       2     flags     (1 TRACED | 2 TAIL_BIN | 4 TAIL_JSON | 8 BATCH)
    8       8     seq       (per-connection send sequence)
    16      8     sent      (sender monotonic clock, f64; 0.0 untraced)
    24      2     blob_count  (sub-message count for BATCH frames)
    26      2     trace_len
    28      4     tail_len
    32      ...   blob lengths   (blob_count x u32)
    ...           trace id bytes (utf-8, trace_len)
    ...           field tail     (tail_len; see below)
    ...           blobs          (borrowed views, never joined)
    last 4        crc32c         (chained over everything above)

``fields`` ride the **tail**: ``marshal`` (C-speed, version-2 format —
frozen since CPython 2.4; both ends of every connection run the same
interpreter, and frames are crc-checked + cephx-authenticated like the
reference's peer-encoded structs) for data-path types, or JSON for the
few admin/auth types that opt in via ``WIRE_TAIL = "json"`` (operator
payloads stay greppable in a pcap; cold path — the check_wire gate
bans JSON from everything else).  ``None`` fields are omitted; a
message with no non-None fields has no tail at all.

Header + blob-length array + trace + tail + crc all pack into ONE
slab-recycled scratch block (common/slab.py) with ``pack_into``/slice
assignment — steady-state frame encode allocates nothing
(``stack.frame_allocs`` flat, ``stack.slab_hits`` growing).  Frames
<= :data:`SMALL_FRAME_MAX` additionally gather their blobs into the
same block (the old messenger control-frame join, now pool-backed):
heartbeats/acks cost one segment, one write, zero allocations.

**Batch frames** (flags BATCH) carry N sub-messages under one
header+crc; ``blob_count`` holds the sub-message count.  Two sub-entry
layouts, selected by the frame-level BATCH_BLOBS flag and pinned in
msg/wire_manifest.json:

- blob-free (the coalesced-ack path, byte-frozen): the OSD
  writer loop packs consecutive ready ``MOSDOpReply``-class acks
  (``COALESCE`` subclasses) into one frame, one syscall.  Each
  sub-entry is ``[u16 type_id][u16 flags][u16 trace_len][u32 tail_len]
  [trace][tail]``.
- blob-carrying (flags BATCH|BATCH_BLOBS — the multi-op REQUEST path,
  the Objecter's op-per-target aggregation on the wire): each
  sub-entry grows a blob table, ``[u16 type_id][u16 flags]
  [u16 trace_len][u32 tail_len][u16 blob_count][u32 blob_len x count]
  [trace][tail]``, and every member's blobs ride AFTER the entry
  table, concatenated in member order — so the metadata region still
  packs into one slab block and the payload views still ship vectored,
  exactly like a single-message frame.

Zero-copy contract (the bufferlist discipline, reference:src/include/
buffer.h): blobs are **borrowed views**, never copied —

- outbound, :func:`encode_frame_segments` returns the frame as a
  segment list (slab header block + the caller's blob views + the crc
  tail of the same slab block) for a vectored send; the crc chains
  across segments, so nothing is joined.  The caller must not mutate a
  blob between ``send()`` and the socket drain (a violation surfaces
  as a crc drop on the peer — a reconnect, never silent corruption).
- inbound, :func:`decode_frame` hands out ``memoryview`` slices of the
  one receive buffer (the views keep it alive) and parses the header
  as struct slices of that view — no byte of the frame is copied
  anywhere on the decode path (the JSON era's header copy is retired;
  tools/check_copies.py enforces it).
"""

from __future__ import annotations

import json
import marshal
import struct
import time
from typing import Any, Type

import numpy as np

from ..common.slab import frame_slab
from ..common.stack_ledger import note_header_decode, note_header_encode
from ..utils import native
from ..utils.buffers import BufferList, note_copy

MAGIC = b"CTPB"
CRC_SEED = 0xFFFFFFFF

# frames at or under this total gather into one slab block and ship as
# a single segment: acks/heartbeats are the message COUNT, and for
# them vectored bookkeeping costs more than one bounded sub-KiB copy
# into pooled memory (payload frames stay on the view path)
SMALL_FRAME_MAX = 1024

FLAG_TRACED = 0x1
FLAG_TAIL_BIN = 0x2
FLAG_TAIL_JSON = 0x4
FLAG_BATCH = 0x8
# batch members carry blobs: extended sub-entries with a per-member
# blob table (the multi-op request frame; see the module docstring)
FLAG_BATCH_BLOBS = 0x10

# magic, type_id, flags, seq, sent, blob_count, trace_len, tail_len
_FIXED = struct.Struct("<4sHHQdHHI")
# batch sub-entry: type_id, flags, trace_len, tail_len
_SUB = struct.Struct("<HHHI")
# extended batch sub-entry (BATCH_BLOBS): + blob_count (u32 blob
# lengths follow the fixed part, before the trace/tail bytes)
_SUBX = struct.Struct("<HHHIH")
_CRC = struct.Struct("<I")
# the marshal wire format version (2 = the portable, frozen layout)
_MARSHAL_VER = 2

# the reserved pseudo-type of coalesced multi-message frames; never a
# Message subclass id (check_wire refuses it in the manifest)
TYPE_ID_BATCH = 1

_REGISTRY: dict[int, Type["Message"]] = {}
_BY_NAME: dict[str, Type["Message"]] = {}

# per-blob-count length-array structs, built once (an f-string format
# per frame would re-parse in struct's cache path)
_LENS: dict[int, struct.Struct] = {}


def _lens_struct(n: int) -> struct.Struct:
    s = _LENS.get(n)
    if s is None:
        s = _LENS[n] = struct.Struct(f"<{n}I")
    return s


def register(cls: Type["Message"]) -> Type["Message"]:
    """Class decorator: route frames of ``cls.TYPE_ID`` to ``cls`` on
    decode (the role of the reference's decode_message type switch,
    reference:src/msg/Message.cc).  Ids are STABLE wire protocol —
    tools/check_wire.py pins them against msg/wire_manifest.json."""
    if not cls.TYPE:
        raise ValueError(f"{cls.__name__} has no TYPE")
    tid = cls.TYPE_ID
    if not isinstance(tid, int) or not (0 < tid < 0x10000):
        raise ValueError(f"{cls.__name__} has no valid TYPE_ID ({tid!r})")
    if tid == TYPE_ID_BATCH:
        raise ValueError(f"{cls.__name__}: TYPE_ID {tid} is reserved "
                         f"for batch frames")
    if tid in _REGISTRY:
        raise ValueError(
            f"duplicate TYPE_ID {tid} ({cls.__name__} vs "
            f"{_REGISTRY[tid].__name__})"
        )
    if cls.TYPE in _BY_NAME:
        raise ValueError(f"duplicate message type {cls.TYPE!r}")
    if cls.WIRE_TAIL not in ("bin", "json"):
        raise ValueError(f"{cls.__name__}: bad WIRE_TAIL {cls.WIRE_TAIL!r}")
    _REGISTRY[tid] = cls
    _BY_NAME[cls.TYPE] = cls
    return cls


def _blob_len(b) -> int:
    if isinstance(b, np.ndarray):
        return int(b.nbytes)  # raw byte count, whatever the dtype
    if isinstance(b, memoryview):
        return b.nbytes  # len() counts first-dim items, not bytes
    return len(b)


class Message:
    """Base message: subclasses set TYPE (readable name), TYPE_ID (the
    stable wire id) and FIELDS (attribute names; values must be
    marshal/json-able); bulk bytes go in ``blobs`` (bytes-like VIEWS —
    bytes, bytearray, memoryview, uint8 ndarray, or BufferList — held
    borrowed, not copied; see the module zero-copy contract).

    ``trace`` is the envelope-level trace id (the reference header's
    blkin trace context): not a subclass field — it rides the frame
    header on every message type, stamped by the sending connection
    when unset and restored on decode, so one client op's id follows
    its sub-ops and replies across daemons (common/tracing.py).

    ``COALESCE = True`` marks blob-free ack types the messenger writer
    loop may pack into one batch frame (ms_reply_coalesce_max).
    ``BATCH_OPS = True`` marks REQUEST types the writer loop may pack
    the same way blobs and all (ms_op_batch_max) — the frame grows
    per-member blob tables (FLAG_BATCH_BLOBS) and the payload views
    still ship vectored, never joined.
    """

    TYPE = ""
    TYPE_ID = 0
    FIELDS: tuple[str, ...] = ()
    # field-tail encoding: "bin" (marshal, the data path) or "json"
    # (admin/auth types only — the check_wire gate allowlists them)
    WIRE_TAIL = "bin"
    _TAIL_JSON = False  # derived below; hot-path flag
    _FIELDS_GET = None  # compiled positional-field accessor
    _FIELDS_SINGLE = False
    _PLAIN_BUILD = True
    COALESCE = False
    BATCH_OPS = False
    # decode metadata: True on members that arrived in a batch frame
    # (the OSD's QoS intake surfaces batch-member admission from it)
    from_batch = False

    def __init_subclass__(cls, **kw: Any):
        super().__init_subclass__(**kw)
        cls._TAIL_JSON = cls.WIRE_TAIL == "json"  # flag, not str cmp
        # compiled field access: one C attrgetter call pulls the whole
        # positional tail (the bin tail is the FIELDS tuple in
        # declaration order — no key strings on the wire, no per-field
        # getattr)
        if cls.FIELDS:
            import operator

            cls._FIELDS_GET = operator.attrgetter(*cls.FIELDS)
            cls._FIELDS_SINGLE = len(cls.FIELDS) == 1
        else:
            cls._FIELDS_GET = None
            cls._FIELDS_SINGLE = False
        # decode fast path allowed only for classes that keep the
        # stock construction hooks (overridden __init__/from_fields
        # get the validated slow path)
        cls._PLAIN_BUILD = (
            cls.__init__ is Message.__init__
            and cls.from_fields.__func__ is Message.from_fields.__func__
        )

    def __init__(self, **kw: Any):
        # borrowed views, NOT bytes(b) copies — the pre-zero-copy frame
        # path paid one full payload memcpy here per hop
        self.blobs: list = list(kw.pop("blobs", []))
        self.trace: str | None = kw.pop("trace", None)
        # transport stamps (op waterfall, common/tracing.py): ``sent``
        # is the SENDER's monotonic clock at frame encode (rides the
        # header next to the trace id, only on traced messages);
        # ``recv_ts`` is the receiver's monotonic clock at frame read
        # (set by the messenger reader loop, never on the wire) — the
        # wire hop is recv_ts - align(sent)
        self.sent: float | None = None
        self.recv_ts: float | None = None
        for f in self.FIELDS:
            setattr(self, f, kw.pop(f, None))
        if kw:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(kw)}")

    def fields(self) -> dict[str, Any]:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_fields(cls, fields: dict[str, Any], blobs: list) -> "Message":
        return cls(blobs=blobs, **fields)

    def __repr__(self) -> str:
        fs = ", ".join(f"{f}={getattr(self, f)!r}" for f in self.FIELDS)
        return (f"{type(self).__name__}({fs}, "
                f"blobs={[_blob_len(b) for b in self.blobs]})")


class BadFrame(ValueError):
    """Corrupt or malformed frame (bad magic / crc / header)."""


def _segments_of(b) -> list:
    """Wire segments for one blob (BufferList expands; scalars pass).
    Every segment comes back as bytes or a FLAT 1-byte view — a
    multi-dimensional memoryview would make ``len()`` count first-dim
    items instead of bytes and corrupt the frame length prefix."""
    if isinstance(b, BufferList):
        segs = b.segments()
    elif isinstance(b, np.ndarray):
        # REINTERPRET to raw bytes (cast), never value-cast: a u32
        # array blob must carry its 4N little-endian bytes, exactly
        # what the old bytes(b) copy serialized — astype(uint8) here
        # would silently truncate every lane to its low byte
        segs = [memoryview(np.ascontiguousarray(b)).cast("B")]
    else:
        segs = [b]
    return [
        s.cast("B") if isinstance(s, memoryview)
        and (s.ndim != 1 or s.itemsize != 1) else s
        for s in segs
    ]


def _pack_tail(msg: Message) -> tuple[bytes, int]:
    """(tail bytes, tail flag) for one message's fields.

    Bin tail = ``marshal`` of the FIELDS VALUES as a positional tuple
    (declaration order — no key strings on the wire; both ends share
    the class schema, and a length mismatch decodes as BadFrame).
    JSON tail (``WIRE_TAIL="json"`` admin/auth types) keeps the named
    non-None dict, greppable in a pcap.  No fields -> no tail."""
    if msg._TAIL_JSON:
        fields = {f: v for f in msg.FIELDS
                  if (v := getattr(msg, f)) is not None}
        if not fields:
            return b"", 0
        # admin/auth tail only — the data path rides marshal;
        # tools/check_wire.py enforces the split
        # wire-ok: JSON tail is the admin/auth opt-in, never the data path
        return json.dumps(fields, separators=(",", ":")).encode(), \
            FLAG_TAIL_JSON
    get = msg._FIELDS_GET
    if get is None:
        return b"", 0
    vals = get(msg)
    if msg._FIELDS_SINGLE:
        vals = (vals,)
    return marshal.dumps(vals, _MARSHAL_VER), FLAG_TAIL_BIN


def _build(cls: Type[Message], view: memoryview, flags: int,
           blobs: list) -> Message:
    """Construct one message from its tail bytes — every failure mode
    (undecodable tail, schema mismatch, hostile content) is a
    :class:`BadFrame`, never a reader-loop crash."""
    if not view.nbytes:
        fields: dict = {}
        vals: tuple = ()
        if cls.FIELDS:
            vals = (None,) * len(cls.FIELDS)
    elif flags & FLAG_TAIL_JSON:
        try:
            # wire-ok: admin-tail decode, cold path
            fields = json.loads(bytes(view))  # copy-ok: admin json tail
        except ValueError as e:
            raise BadFrame(f"bad json tail: {e!r}") from e
        if not isinstance(fields, dict):
            raise BadFrame(f"json tail is {type(fields).__name__}")
        try:
            return cls.from_fields(fields, blobs)
        except Exception as e:
            raise BadFrame(f"{cls.__name__}: field mismatch: {e!r}") from e
    else:
        try:
            vals = marshal.loads(view)
        except (ValueError, EOFError, TypeError) as e:
            raise BadFrame(f"bad field tail: {e!r}") from e
        if type(vals) is not tuple or len(vals) != len(cls.FIELDS):
            raise BadFrame(
                f"{cls.__name__}: tail arity "
                f"{len(vals) if type(vals) is tuple else type(vals).__name__}"
                f" != {len(cls.FIELDS)}"
            )
    if cls._PLAIN_BUILD:
        # stock construction hooks: set the positional fields straight
        # onto a bare instance (the __init__ kw loop re-validates what
        # the schema already guarantees)
        m = cls.__new__(cls)
        m.blobs = blobs
        m.trace = None
        m.sent = None
        m.recv_ts = None
        d = m.__dict__
        for f, v in zip(cls.FIELDS, vals):
            d[f] = v
        return m
    fields = {f: v for f, v in zip(cls.FIELDS, vals) if v is not None}
    try:
        return cls.from_fields(fields, blobs)
    except Exception as e:
        raise BadFrame(f"{cls.__name__}: field mismatch: {e!r}") from e


def encode_frame_segments(msg: Message, seq: int = 0) -> tuple[list, int,
                                                               Any]:
    """Frame as a segment list for a vectored send: ``(segments,
    total_bytes, release)``.  Segment 0 is the slab-packed binary
    header (fixed struct + blob lens + trace + field tail), the middle
    segments are the caller's blob views (ZERO copies), the trailer is
    the crc — a 4-byte view of the SAME slab block, chained across
    segments (ceph_crc32c composes), so the frame is never joined on
    the send side.  Frames <= SMALL_FRAME_MAX come back as ONE slab
    segment instead (blobs gathered into the block).

    ``release`` returns the scratch block to the pool — call it once
    the transport has drained the segments (the messenger writer loop
    does); dropping it instead just costs the pool a later miss."""
    # the header cost ledger (common/stack_ledger): time the HEADER
    # work only — tail codec + struct packing — never the
    # payload-proportional crc below (the stack.header_* ledger)
    _t0 = time.perf_counter()
    flags = 0
    trace_b = b""
    sent = 0.0
    if msg.trace is not None:
        flags |= FLAG_TRACED
        trace_b = msg.trace.encode()
        # send stamp for the waterfall's wire hop (sender's monotonic
        # clock; the receiver aligns it via clocksync).  It rides
        # wherever the trace id rides; untraced frames keep sent=0.0
        # and stay byte-deterministic across encodes
        msg.sent = time.monotonic()
        sent = msg.sent
    tail, tflag = _pack_tail(msg)
    flags |= tflag
    lens: list[int] = []
    blob_segs: list = []
    blob_total = 0
    for b in msg.blobs:
        if type(b) is bytes:  # the dominant blob shape: no cast walk
            n = len(b)
            lens.append(n)
            blob_total += n
            if n:
                blob_segs.append((b,))
            else:
                blob_segs.append(())
            continue
        segs_b = [s for s in _segments_of(b) if len(s)]
        n = sum(len(s) for s in segs_b)
        lens.append(n)
        blob_total += n
        blob_segs.append(segs_b)
    nblob = len(lens)
    n_trace = len(trace_b)
    n_tail = len(tail)
    head_len = _FIXED.size + 4 * nblob + n_trace + n_tail
    total = head_len + blob_total + 4
    small = total <= SMALL_FRAME_MAX
    slab = frame_slab().checkout(total if small else head_len + 4)
    buf = slab.data
    _FIXED.pack_into(buf, 0, MAGIC, msg.TYPE_ID, flags, seq, sent,
                     nblob, n_trace, n_tail)
    off = _FIXED.size
    if nblob:
        _lens_struct(nblob).pack_into(buf, off, *lens)
        off += 4 * nblob
    if n_trace:
        buf[off:off + n_trace] = trace_b
        off += n_trace
    if n_tail:
        buf[off:off + n_tail] = tail
        off += n_tail
    note_header_encode(time.perf_counter() - _t0)
    if small:
        # control-frame fast path: gather the (bounded, sub-KiB) blobs
        # into the same pooled block — one segment, one crc pass, no
        # allocation (the old messenger-side b"".join, slab-backed)
        for segs_b in blob_segs:
            for s in segs_b:
                n = len(s)
                buf[off:off + n] = s
                off += n
        crc = native.crc32c_view(CRC_SEED, memoryview(buf), off)
        _CRC.pack_into(buf, off, crc)
        return [slab.view(total)], total, slab.release
    crc = native.crc32c_view(CRC_SEED, memoryview(buf), head_len)
    head_view = slab.view(head_len)
    segs: list = [head_view]
    for segs_b in blob_segs:
        for s in segs_b:
            segs.append(s)
            crc = native.crc32c_view(crc, s)
    _CRC.pack_into(buf, head_len, crc)
    segs.append(slab.view(4, start=head_len))
    return segs, total, slab.release


def encode_batch_frame(msgs: list[Message], seq: int = 0) -> tuple[
        list, int, Any]:
    """N messages under ONE header+crc: ``(segments, total, release)``.
    ``seq`` is the first member's sequence number; members occupy
    seq..seq+N-1 in order.

    Blob-free members (the coalesced-ack path) keep the
    byte-frozen compact sub-entries and come back as a single slab
    segment.  Any member with blobs switches the WHOLE frame to the
    extended layout (FLAG_BATCH_BLOBS: per-member blob tables, blobs
    concatenated after the entry table in member order) — the multi-op
    request frame.  Payload views ship vectored like
    :func:`encode_frame_segments` (small frames still gather into the
    slab block); the zero-copy contract is identical."""
    _t0 = time.perf_counter()
    sent = 0.0
    parts: list[tuple[int, int, bytes, bytes, list[int], list]] = []
    any_traced = False
    any_blobs = False
    blob_total = 0
    for m in msgs:
        sflags = 0
        trace_b = b""
        if m.trace is not None:
            sflags |= FLAG_TRACED
            trace_b = m.trace.encode()
            any_traced = True
        tail, tflag = _pack_tail(m)
        sflags |= tflag
        lens: list[int] = []
        blob_segs: list = []
        for b in m.blobs:
            if type(b) is bytes:  # dominant blob shape: no cast walk
                n = len(b)
                lens.append(n)
                blob_total += n
                blob_segs.append((b,) if n else ())
                continue
            segs_b = [s for s in _segments_of(b) if len(s)]
            n = sum(len(s) for s in segs_b)
            lens.append(n)
            blob_total += n
            blob_segs.append(segs_b)
        if lens:
            any_blobs = True
        parts.append((m.TYPE_ID, sflags, trace_b, tail, lens, blob_segs))
    flags = FLAG_BATCH | (FLAG_BATCH_BLOBS if any_blobs else 0)
    if any_traced:
        flags |= FLAG_TRACED
        # one shared send stamp: the members leave the socket together
        sent = time.monotonic()
        for m in msgs:
            if m.trace is not None:
                m.sent = sent
    sub_size = _SUBX.size if any_blobs else _SUB.size
    entries_len = sum(
        sub_size + 4 * len(lens) + len(trace_b) + len(tail)
        for _tid, _sf, trace_b, tail, lens, _bs in parts
    ) if any_blobs else sum(
        sub_size + len(trace_b) + len(tail)
        for _tid, _sf, trace_b, tail, _l, _bs in parts
    )
    head_len = _FIXED.size + entries_len
    total = head_len + blob_total + 4
    small = total <= SMALL_FRAME_MAX or not blob_total
    slab = frame_slab().checkout(total if small else head_len + 4)
    buf = slab.data
    _FIXED.pack_into(buf, 0, MAGIC, TYPE_ID_BATCH, flags, seq, sent,
                     len(msgs), 0, entries_len)
    off = _FIXED.size
    for tid, sflags, trace_b, tail, lens, _bs in parts:
        if any_blobs:
            _SUBX.pack_into(buf, off, tid, sflags, len(trace_b),
                            len(tail), len(lens))
            off += _SUBX.size
            if lens:
                _lens_struct(len(lens)).pack_into(buf, off, *lens)
                off += 4 * len(lens)
        else:
            _SUB.pack_into(buf, off, tid, sflags, len(trace_b),
                           len(tail))
            off += _SUB.size
        buf[off:off + len(trace_b)] = trace_b
        off += len(trace_b)
        buf[off:off + len(tail)] = tail
        off += len(tail)
    note_header_encode(time.perf_counter() - _t0)
    if small:
        # acks and sub-KiB op runs gather into the one pooled block:
        # one segment, one crc pass, no allocation
        for _tid, _sf, _tr, _tl, _lens, blob_segs in parts:
            for segs_b in blob_segs:
                for s in segs_b:
                    n = len(s)
                    buf[off:off + n] = s
                    off += n
        crc = native.crc32c_view(CRC_SEED, memoryview(buf), off)
        _CRC.pack_into(buf, off, crc)
        return [slab.view(total)], total, slab.release
    crc = native.crc32c_view(CRC_SEED, memoryview(buf), head_len)
    segs: list = [slab.view(head_len)]
    for _tid, _sf, _tr, _tl, _lens, blob_segs in parts:
        for segs_b in blob_segs:
            for s in segs_b:
                segs.append(s)
                crc = native.crc32c_view(crc, s)
    _CRC.pack_into(buf, head_len, crc)
    segs.append(slab.view(4, start=head_len))
    return segs, total, slab.release


def encode_frame(msg: Message, seq: int = 0) -> bytes:
    """Flat-bytes frame (compat/tests; the messenger sends the segment
    list from :func:`encode_frame_segments` without joining)."""
    segs, total, release = encode_frame_segments(msg, seq)
    note_copy("msgr_encode", total)
    buf = bytearray(total)
    off = 0
    for s in segs:
        n = len(s)
        buf[off:off + n] = s
        off += n
    release()
    return bytes(buf)  # copy-ok: compat flat-frame wrapper


def decode_frame_msgs(frame: bytes | bytearray | memoryview) -> tuple[
        list, int]:
    """Decode one wire frame into its messages: ``([messages], seq)``
    — one element for a plain frame, N for a coalesced batch frame
    (``seq`` is the first member's).

    Blobs come back as ``memoryview`` slices of ``frame`` — zero
    copies; the views hold the receive buffer alive, and the header
    itself parses as struct slices of the same view (no header copy).
    Receive frames are never mutated, so aliasing is safe by
    construction here.  EVERY malformed input — bad magic, bad crc,
    truncation, unknown type id, lying lengths, undecodable tail —
    raises :class:`BadFrame`; nothing in here blocks."""
    if type(frame) is bytes:
        # the receive path hands bytes: crc the body prefix without
        # slicing anything (pointer + length, msg/message zero-copy)
        nbytes = len(frame)
        if nbytes < _FIXED.size + 4 or frame[:4] != MAGIC:
            raise BadFrame("bad magic")
        view = memoryview(frame)
        want = native.crc32c_view(CRC_SEED, frame, nbytes - 4)
    else:
        view = frame if isinstance(frame, memoryview) else memoryview(frame)
        nbytes = view.nbytes
        if nbytes < _FIXED.size + 4 or view[:4] != MAGIC:
            raise BadFrame("bad magic")
        want = native.crc32c_view(CRC_SEED, view, nbytes - 4)
    body = view[:-4]
    (crc,) = _CRC.unpack_from(view, nbytes - 4)
    if crc != want:
        raise BadFrame(f"crc mismatch: got {crc:#x} want {want:#x}")
    # header ledger (see encode_frame_segments): struct unpack + tail
    # codec + type routing, crc and blob views excluded
    _t0 = time.perf_counter()
    try:
        (_magic, type_id, flags, seq, sent, nblob, trace_len,
         tail_len) = _FIXED.unpack_from(body, 0)
    except struct.error as e:
        raise BadFrame(f"truncated header: {e}") from e
    if flags & FLAG_BATCH:
        if type_id != TYPE_ID_BATCH:
            raise BadFrame(f"batch flag on type id {type_id}")
        ext = bool(flags & FLAG_BATCH_BLOBS)
        # blob-free batches fill the body exactly with entries; the
        # extended layout appends the members' blobs after the table
        entries_end = _FIXED.size + tail_len
        if trace_len or (entries_end != body.nbytes if not ext
                         else entries_end > body.nbytes):
            raise BadFrame("batch frame length mismatch")
        msgs: list[Message] = []
        off = _FIXED.size
        blob_off = entries_end
        for _i in range(nblob):  # blob_count = sub-message count
            slens: tuple[int, ...] = ()
            if ext:
                try:
                    (stid, sflags, strace_len, stail_len,
                     snblob) = _SUBX.unpack_from(body, off)
                except struct.error as e:
                    raise BadFrame(f"truncated batch entry: {e}") from e
                off += _SUBX.size
                if snblob:
                    if off + 4 * snblob > entries_end:
                        raise BadFrame("batch entry overruns frame")
                    slens = struct.unpack_from(f"<{snblob}I", body, off)
                    off += 4 * snblob
            else:
                try:
                    stid, sflags, strace_len, stail_len = \
                        _SUB.unpack_from(body, off)
                except struct.error as e:
                    raise BadFrame(f"truncated batch entry: {e}") from e
                off += _SUB.size
            if off + strace_len + stail_len > entries_end:
                raise BadFrame("batch entry overruns frame")
            cls = _REGISTRY.get(stid)
            if cls is None:
                raise BadFrame(f"unknown message type id {stid}")
            trace = None
            if sflags & FLAG_TRACED:
                try:
                    trace = str(body[off:off + strace_len], "utf-8")
                except UnicodeDecodeError as e:
                    raise BadFrame(f"bad trace id: {e}") from e
            off += strace_len
            blobs = []
            for n in slens:
                if blob_off + n > body.nbytes:
                    raise BadFrame("batch blob length mismatch")
                blobs.append(body[blob_off:blob_off + n])
                blob_off += n
            m = _build(cls, body[off:off + stail_len], sflags, blobs)
            off += stail_len
            m.trace = trace
            m.sent = sent if (sflags & FLAG_TRACED) else None
            m.from_batch = True
            msgs.append(m)
        if off != entries_end or blob_off != body.nbytes:
            raise BadFrame("batch entries do not fill the frame")
        if not msgs:
            raise BadFrame("empty batch frame")
        note_header_decode(time.perf_counter() - _t0)
        return msgs, seq
    cls = _REGISTRY.get(type_id)
    if cls is None:
        raise BadFrame(f"unknown message type id {type_id}")
    off = _FIXED.size
    lens: tuple[int, ...] = ()
    if nblob:
        try:
            lens = struct.unpack_from(f"<{nblob}I", body, off)
        except struct.error as e:
            raise BadFrame(f"truncated blob lens: {e}") from e
        off += 4 * nblob
    if off + trace_len + tail_len > body.nbytes:
        raise BadFrame("truncated header")
    trace = None
    if flags & FLAG_TRACED:
        try:
            trace = str(body[off:off + trace_len], "utf-8")
        except UnicodeDecodeError as e:
            raise BadFrame(f"bad trace id: {e}") from e
    off += trace_len
    tail_view = body[off:off + tail_len]
    off += tail_len
    blobs = []
    for n in lens:
        if off + n > body.nbytes:
            raise BadFrame("blob length mismatch")
        blobs.append(body[off:off + n])
        off += n
    if off != body.nbytes:
        raise BadFrame("blob length mismatch")
    msg = _build(cls, tail_view, flags, blobs)
    note_header_decode(time.perf_counter() - _t0)
    msg.trace = trace
    msg.sent = sent if (flags & FLAG_TRACED) else None
    return [msg], seq


def decode_frame(frame: bytes | bytearray | memoryview) -> tuple[
        Message, int]:
    """Single-message inverse of :func:`encode_frame`: ``(message,
    seq)``.  Batch frames (N coalesced acks) must go through
    :func:`decode_frame_msgs` — the messenger reader does; this compat
    form rejects them rather than silently dropping N-1 messages."""
    msgs, seq = decode_frame_msgs(frame)
    if len(msgs) != 1:
        raise BadFrame(f"batch frame ({len(msgs)} messages): use "
                       f"decode_frame_msgs")
    return msgs[0], seq
