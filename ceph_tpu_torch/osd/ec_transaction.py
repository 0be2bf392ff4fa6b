"""EC partial-stripe write planning (the RMW pipeline's pure math).

Counterpart of ``ceph_tpu/osd/ec_transaction.py``, whole.
Re-expression of the reference EC overwrite planner
(reference:src/osd/ECTransaction.h:40-120 ``get_write_plan``): a client
mutation at an arbitrary (offset, length) is turned into

- ``to_read``: the stripe-aligned extents of the *old* object whose
  stripes are only partially covered by the write (at most two: the head
  and tail stripes), which the primary must fetch and decode before it
  can re-encode them, and
- ``will_write``: the stripe-aligned extent that will be re-encoded and
  written to every shard (one batched device call, per
  ``osd.ec_util.encode``).

Differences from the reference, by design:

- The reference pipelines plans through three wait-lists with an extent
  cache for in-flight overlap (reference:src/osd/ECBackend.h:549-551,
  reference:src/osd/ExtentCache.h:1); here a per-OBJECT asyncio lock
  (OSD.obj_lock — any same-object extents conflict in the collapsed
  model) serializes same-object mutations while different objects in
  one PG pipeline freely, so the plan executes synchronously under the
  object's lock and the cache collapses away.
- Zero-extension (append/truncate-up across never-written stripes) needs
  no device work at all: linear codes encode zero data to zero parity,
  so shard-side zero-fill of the hole *is* the correct encoding.
"""

from __future__ import annotations

import dataclasses

from .ec_util import StripeInfo


@dataclasses.dataclass(frozen=True)
class WritePlan:
    """Stripe-aligned plan for one EC object mutation.

    ``to_read``    — [(logical offset, length), ...] extents of the old
                     object to fetch+decode (stripe-aligned, ≤ 2 entries,
                     clipped to the old padded extent).
    ``will_write`` — (logical offset, length) extent to re-encode+write,
                     stripe-aligned; length 0 means no encode needed
                     (pure truncate/extend).
    ``new_size``   — logical object size after the op.
    ``old_size``   — logical object size before the op.
    ``shard_truncate`` — if not None, each shard truncates its chunk
                     buffer to this many bytes (chunk domain) *before*
                     the writes; used by truncate and writefull to drop
                     or zero-extend tail stripes.
    """

    to_read: tuple[tuple[int, int], ...]
    will_write: tuple[int, int]
    new_size: int
    old_size: int
    shard_truncate: int | None = None

    @property
    def first_stripe(self) -> int:
        return self.will_write[0]

    def stripes_written(self, sinfo: StripeInfo) -> tuple[int, int]:
        """(first stripe index, stripe count) of the will_write extent."""
        off, length = self.will_write
        return off // sinfo.stripe_width, length // sinfo.stripe_width


def _old_padded_end(sinfo: StripeInfo, old_size: int) -> int:
    return sinfo.logical_to_next_stripe_offset(old_size)


def plan_write(
    sinfo: StripeInfo, old_size: int, offset: int, length: int
) -> WritePlan:
    """Plan ``write(offset, length)`` over an object of ``old_size`` bytes.

    Mirrors reference:src/osd/ECTransaction.h:40-120: round the write out
    to stripe bounds; the head stripe must be read iff the write starts
    mid-stripe and that stripe holds old data; likewise the tail stripe.
    """
    if length == 0:
        ws = sinfo.logical_to_prev_stripe_offset(offset)
        return WritePlan((), (ws, 0), max(old_size, offset), old_size)
    sw = sinfo.stripe_width
    old_end = _old_padded_end(sinfo, old_size)
    ws = sinfo.logical_to_prev_stripe_offset(offset)
    we = sinfo.logical_to_next_stripe_offset(offset + length)
    reads: list[tuple[int, int]] = []
    # the head stripe [ws, ws+sw) must be read unless the write covers it
    # entirely; same for the tail stripe [we-sw, we) when distinct
    head_covered = offset == ws and (offset + length) >= min(we, ws + sw)
    if not head_covered and ws < old_end:
        reads.append((ws, min(sw, old_end - ws)))
    tail_start = we - sw
    if (
        tail_start != ws
        and (offset + length) < we
        and tail_start < old_end
    ):
        reads.append((tail_start, min(sw, old_end - tail_start)))
    return WritePlan(
        to_read=tuple(reads),
        will_write=(ws, we - ws),
        new_size=max(old_size, offset + length),
        old_size=old_size,
    )


def plan_write_full(sinfo: StripeInfo, old_size: int, length: int) -> WritePlan:
    """Full-object replacement: no reads; shards truncate to the new
    chunk length (dropping old tail stripes) then write everything."""
    we = sinfo.logical_to_next_stripe_offset(length)
    return WritePlan(
        to_read=(),
        will_write=(0, we),
        new_size=length,
        old_size=old_size,
        shard_truncate=sinfo.aligned_logical_offset_to_chunk_offset(we),
    )


def plan_append(sinfo: StripeInfo, old_size: int, length: int) -> WritePlan:
    return plan_write(sinfo, old_size, old_size, length)


def plan_truncate(sinfo: StripeInfo, old_size: int, size: int) -> WritePlan:
    """Truncate (shrink or zero-extend) to ``size``.

    Shrink to a mid-stripe boundary re-encodes the last kept stripe with
    zeros beyond ``size`` (the stored padding contract: bytes between
    ``size`` and the stripe edge are zeros). Extension is pure shard-side
    zero-fill — zero data encodes to zero parity.
    """
    sw = sinfo.stripe_width
    new_end = sinfo.logical_to_next_stripe_offset(size)
    shard_trunc = sinfo.aligned_logical_offset_to_chunk_offset(new_end)
    if size >= old_size or size % sw == 0:
        # pure extend or exact-stripe shrink: no re-encode
        return WritePlan(
            to_read=(),
            will_write=(sinfo.logical_to_prev_stripe_offset(size), 0),
            new_size=size,
            old_size=old_size,
            shard_truncate=shard_trunc,
        )
    last = sinfo.logical_to_prev_stripe_offset(size)
    old_end = _old_padded_end(sinfo, old_size)
    reads = ((last, min(sw, old_end - last)),) if last < old_end else ()
    return WritePlan(
        to_read=reads,
        will_write=(last, sw),
        new_size=size,
        old_size=old_size,
        shard_truncate=shard_trunc,
    )


def merge_extents(
    plan: WritePlan,
    sinfo: StripeInfo,
    old_data: dict[int, bytes],
    offset: int,
    data: bytes,
) -> bytearray:
    """Build the will_write buffer: old partial stripes + new bytes.

    ``old_data`` maps each to_read extent's logical offset to its decoded
    bytes (may be shorter than requested if the object ended early).
    Gaps — stripes past the old object or fully covered by the write —
    stay zero, which is both the padding contract and the correct
    content for holes.
    """
    ws, wlen = plan.will_write
    buf = bytearray(wlen)
    for ext_off, ext_bytes in old_data.items():
        rel = ext_off - ws
        buf[rel : rel + len(ext_bytes)] = ext_bytes
    if data:
        rel = offset - ws
        buf[rel : rel + len(data)] = data
    if plan.new_size < ws + wlen:
        # truncate path: zero everything past the new logical end
        rel = plan.new_size - ws
        if rel >= 0:
            buf[rel:] = b"\x00" * (len(buf) - rel)
    # the gather buffer itself: this merge IS the RMW path's one copy —
    # the old bytes(buf) materialized the whole will_write a second time
    return buf


# ---------------------------------------------------------------------------
# In-flight extent map (the ExtentCache role)


class _ExtentRec:
    __slots__ = ("token", "ranges", "event", "active")

    def __init__(self, token: int, ranges, event):
        self.token = token
        self.ranges = ranges
        self.event = event
        self.active = False


class ExtentLocks:
    """Per-object-family in-flight extent table: the pipelining half of
    the reference's ExtentCache + three wait-lists
    (reference:src/osd/ExtentCache.h:1, reference:src/osd/
    ECBackend.h:549-551).

    A same-object EC RMW registers the stripe-aligned extents it will
    read and write; a second RMW whose extents are DISJOINT proceeds
    concurrently (its shard reads and encode overlap the first op's
    round trips), while overlapping extents chain.  Exclusive
    acquisition (FULL, covering (0, inf)) is used by size-changing /
    snap-mutating / delete / repair ops, which conflict with everything.

    Fairness: requests live in one FIFO queue per key; a request
    activates only when NO EARLIER queued request (active or waiting)
    overlaps it.  A waiting exclusive request therefore blocks every
    later acquisition — a stream of disjoint fast writes cannot starve
    a delete/scrub (the reference's wait lists give the same FIFO
    property).

    asyncio-single-threaded discipline: ``enqueue`` and activation scans
    never await, so activation decisions are race-free.
    """

    FULL: tuple[tuple[float, float], ...] = ((0, float("inf")),)

    def __init__(self) -> None:
        self._queues: dict[object, list[_ExtentRec]] = {}
        self._next_token = 0

    @staticmethod
    def _overlap(a, b) -> bool:
        return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]

    @classmethod
    def _conflict(cls, ra, rb) -> bool:
        return any(
            cls._overlap(r, q)
            for r in ra if r[1] > 0
            for q in rb if q[1] > 0
        )

    def _scan(self, key) -> None:
        q = self._queues.get(key, ())
        for i, rec in enumerate(q):
            if rec.active:
                continue
            if any(self._conflict(prev.ranges, rec.ranges)
                   for prev in q[:i]):
                continue
            rec.active = True
            rec.event.set()

    def enqueue(self, key, ranges) -> _ExtentRec:
        """Join the key's FIFO; the returned record is ``active`` when
        the extents are held NOW, else await ``record.event`` (and then
        re-validate the plan — the object changed while waiting)."""
        import asyncio

        self._next_token += 1
        rec = _ExtentRec(
            self._next_token,
            tuple(tuple(r) for r in ranges),
            asyncio.Event(),
        )
        self._queues.setdefault(key, []).append(rec)
        self._scan(key)
        return rec

    def release(self, key, token: int) -> None:
        q = self._queues.get(key)
        if not q:
            return
        for i, rec in enumerate(q):
            if rec.token == token:
                del q[i]
                rec.event.set()  # unblock a cancelled waiter too
                break
        if q:
            self._scan(key)
        else:
            del self._queues[key]

    def busy(self, key) -> bool:
        return bool(self._queues.get(key))
