"""RBD image journal: crash-consistent op log over rados objects.

Re-expression of the reference journaling stack
(reference:src/journal/ — JournalMetadata / ObjectRecorder /
JournalPlayer — and reference:src/librbd/journal/ Journal<I>,
journal::Replay): with the ``journaling`` feature on, every mutating
image op is APPENDED to a per-image journal object before it touches
the data objects, and an opener replays any entries past the committed
position before serving I/O.  An acked client write therefore survives
the client dying at any point: either the journal holds it (replay
applies it) or it was never acked.  This is the first half of
rbd-mirror — a remote peer replaying the same journal produces a
crash-consistent copy.

Counterpart of ``ceph_tpu/rbd/journal.py``, whole: the frames are byte
for byte the reference's, so each package's :func:`decode_frames` reads
the other's journal.

Layout (one journal object per image, rotated by trim):

    rbd_journal.<image_id>     append-only frames
    header omap "journal_commit"  byte offset of the commit position

Frame: ``[4B BE total][4B BE crc32][4B BE hdr_len][hdr JSON][payload]``
where hdr carries {"tid", "op", ...} and payload is the write data.
A torn tail (client died mid-append) fails the length/crc check and is
discarded, exactly like the WAL store's torn-tail rule.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import TYPE_CHECKING

from ..rados.client import ENOENT, RadosError

if TYPE_CHECKING:  # pragma: no cover
    from .image import Image

JOURNAL_PREFIX = "rbd_journal."
COMMIT_KEY = "journal_commit"
_FRAME = struct.Struct(">III")  # total, crc32, hdr_len

# flush the commit position every N events (an opener replays at most
# N idempotent events unnecessarily), trim once fully committed past:
COMMIT_EVERY = 16
TRIM_BYTES = 1 << 20


def encode_frame(hdr: dict, payload: bytes = b"") -> bytes:
    h = json.dumps(hdr).encode()
    body = h + payload
    return _FRAME.pack(len(body), zlib.crc32(body), len(h)) + body


def decode_frames(buf: bytes, start: int = 0):
    """Yield (end_offset, hdr, payload) for every intact frame from
    ``start``; stops silently at a torn/corrupt tail."""
    pos = start
    n = len(buf)
    while pos + _FRAME.size <= n:
        total, crc, hlen = _FRAME.unpack_from(buf, pos)
        body_start = pos + _FRAME.size
        if hlen > total or body_start + total > n:
            return  # torn tail: the append died mid-frame
        body = buf[body_start : body_start + total]
        if zlib.crc32(body) != crc:
            return  # corrupt tail
        try:
            hdr = json.loads(body[:hlen])
        except ValueError:
            return
        pos = body_start + total
        yield pos, hdr, bytes(body[hlen:])


class ImageJournal:
    """The open image's recorder + replayer (single-writer images, the
    reference's exclusive-lock precondition for journaling)."""

    def __init__(self, image: "Image"):
        self.image = image
        self.oid = JOURNAL_PREFIX + image.image_id
        self.committed = 0   # durable commit position (header omap)
        self.applied = 0     # events applied locally since last flush
        self.end = 0         # append position (journal object size)
        self._tid = 0

    # -- recorder ------------------------------------------------------------

    async def append(self, op: str, fields: dict, payload: bytes = b"") -> None:
        """Durably journal one event BEFORE its data ops run
        (reference:librbd Journal<I>::append_write_event)."""
        self._tid += 1
        hdr = {"tid": self._tid, "op": op, **fields}
        frame = encode_frame(hdr, payload)
        await self.image.io.append(self.oid, frame)
        self.end += len(frame)

    async def _min_client_position(self) -> "int | None":
        """Smallest registered mirror-client position, or None when no
        clients are registered (reference:JournalMetadata minimum commit
        position over registered clients)."""
        from .mirror import CLIENT_PREFIX

        try:
            h = await self.image.io.omap_get(self.image.header)
        except RadosError:
            return None
        positions = [
            int(v) for k, v in h.items() if k.startswith(CLIENT_PREFIX)
        ]
        return min(positions) if positions else None

    async def commit(self, *, force: bool = False) -> None:
        """Advance the durable commit position (batched: an opener
        replays at most COMMIT_EVERY idempotent events)."""
        self.applied += 1
        if not force and self.applied < COMMIT_EVERY:
            return
        self.applied = 0
        # data ahead of the commit position may still sit in the
        # image's writeback cache: the position must never durably pass
        # an event whose data objects have not been written (an
        # unflushed cache + crash would skip replay of acked
        # writes).  The reference gates its commit position on the
        # object cacher flush the same way.
        await self.image._cache_flush()
        self.committed = self.end
        await self.image.io.omap_set(
            self.image.header, {COMMIT_KEY: str(self.end).encode()}
        )
        if self.committed >= TRIM_BYTES:
            await self._trim()

    async def _trim(self) -> None:
        """Everything is committed: drop the journal object and reset
        the positions (the reference prunes whole journal objects once
        the commit position passes them).  A registered mirror client
        that has NOT consumed the journal holds the trim — rbd-mirror
        must never lose events (reference minimum-commit-position
        rule).  ORDER MATTERS: the durable positions reset BEFORE the
        object is removed — a crash in between replays the (idempotent)
        committed events again, while the reverse order would leave a
        stale position that makes every later replay skip real events."""
        min_client = await self._min_client_position()
        if min_client is not None and min_client < self.end:
            return  # a mirror peer still needs these events
        from .mirror import CLIENT_PREFIX

        kv = {COMMIT_KEY: b"0"}
        if min_client is not None:
            h = await self.image.io.omap_get(self.image.header)
            for k in h:
                if k.startswith(CLIENT_PREFIX):
                    kv[k] = b"0"  # clients consumed everything: reset
        await self.image.io.omap_set(self.image.header, kv)
        try:
            await self.image.io.remove(self.oid)
        except RadosError as e:
            if e.code != -ENOENT:
                raise
        self.committed = self.end = 0

    # -- replayer ------------------------------------------------------------

    async def replay(self) -> int:
        """Apply every journaled event past the commit position
        (reference:src/librbd/journal/Replay.cc); returns the count.
        Runs at open, before the image serves I/O."""
        try:
            h = await self.image.io.omap_get(self.image.header)
            self.committed = int(h.get(COMMIT_KEY, b"0"))
        except RadosError:
            self.committed = 0
        try:
            buf = await self.image.io.read(self.oid)
        except RadosError as e:
            if e.code != -ENOENT:
                raise
            if self.committed:
                # no journal object but a nonzero stored position (e.g.
                # a crash inside an old trim): persist the reset so a
                # fresh journal's offsets line up
                await self.image.io.omap_set(
                    self.image.header, {COMMIT_KEY: b"0"}
                )
            self.end = self.committed = 0
            return 0
        replayed = 0
        pos = self.committed
        for end, hdr, payload in decode_frames(buf, self.committed):
            await self._apply(hdr, payload)
            self._tid = max(self._tid, int(hdr.get("tid", 0)))
            pos = end
            replayed += 1
        if pos < len(buf):
            # torn tail (writer died mid-append): DROP it now — a new
            # frame appended after the garbage would be unreachable to
            # every future replay (the WAL torn-tail discard rule)
            await self.image.io.truncate(self.oid, pos)
        self.end = pos
        if replayed:
            # replayed data may be parked in the writeback cache: flush
            # before the durable position passes those events
            await self.image._cache_flush()
            self.committed = pos
            await self.image.io.omap_set(
                self.image.header, {COMMIT_KEY: str(pos).encode()}
            )
            if self.committed >= TRIM_BYTES:
                await self._trim()
        return replayed

    async def _apply(self, hdr: dict, payload: bytes) -> None:
        img = self.image
        op = hdr.get("op")
        if op == "write":
            await img._apply_write_data(int(hdr["off"]), payload)
        elif op == "discard":
            await img._apply_discard_data(int(hdr["off"]), int(hdr["len"]))
        elif op == "resize":
            await img._apply_resize(int(hdr["size"]))
        # unknown ops are skipped (forward compatibility)
