"""rbd-mirror: one-way journal-based image replication.

The second half of the journaling feature (reference:src/tools/
rbd_mirror/ ImageReplayer + image_sync, over the journal client API in
reference:src/journal/JournalMetadata): a mirrorer BOOTSTRAPS the peer
image (initial deep copy of current data), registers itself as a
journal CLIENT on the source so trim cannot outrun it, and then
repeatedly REPLAYS source journal events past its own position into the
destination image.  Destination state is crash-consistent at every
replayed event boundary — the same guarantee a local crash-replay
gives.

Positions: the mirrorer's replay position lives in the SOURCE image's
header omap under ``journal_client/<mirror_id>``; ImageJournal._trim
only drops the journal once every registered client (and the local
committed position) has consumed it, then resets all client positions
to 0 — the reference's minimum-commit-position trim rule.

Counterpart of ``ceph_tpu/rbd/mirror.py``, whole.
"""

from __future__ import annotations

import json

from ..rados.client import ENOENT, IoCtx, RadosError
from .image import HEADER_PREFIX, RBD_DIRECTORY, Image, RbdError
from .journal import JOURNAL_PREFIX, decode_frames

CLIENT_PREFIX = "journal_client/"


class MirrorNotRegistered(RbdError):
    """sync() without a live registration (never bootstrapped, or
    deregistered): callers distinguish this from other -EINVAL-class
    failures by TYPE, not by message text."""


async def resolve_image_id(io: IoCtx, name: str) -> str:
    try:
        d = await io.omap_get(RBD_DIRECTORY)
    except RadosError as e:
        if e.code == -ENOENT:
            raise RbdError(-ENOENT, f"no image {name!r}") from e
        raise
    raw = d.get(f"name_{name}")
    if raw is None:
        raise RbdError(-ENOENT, f"no image {name!r}")
    return raw.decode()


class ImageMirrorer:
    """Replays one source image's journal into a destination image
    (possibly in another pool/cluster — any IoCtx works)."""

    def __init__(self, src_io: IoCtx, dst_io: IoCtx, name: str,
                 mirror_id: str = "peer"):
        self.src_io = src_io
        self.dst_io = dst_io
        self.name = name
        self.mirror_id = mirror_id
        self.image_id = ""      # source image id (resolved at bootstrap)
        self.position = 0       # journal offset replayed so far

    @property
    def _client_key(self) -> str:
        return CLIENT_PREFIX + self.mirror_id

    async def bootstrap(self) -> None:
        """Initial sync (reference:rbd_mirror image_sync): register as a
        journal client FIRST (freezing trim), deep-copy current data,
        and start replaying from the journal position captured at
        registration."""
        self.image_id = await resolve_image_id(self.src_io, self.name)
        src_header = HEADER_PREFIX + self.image_id
        h = await self.src_io.omap_get(src_header)
        src_features = json.loads(h.get("features", b"[]"))
        if "journaling" not in src_features:
            raise RbdError(-22, f"image {self.name!r} is not journaled")
        # register at position 0 BEFORE anything else — from this
        # instant the source cannot trim the journal out from under us —
        # and STAY at 0: the retained journal may hold events a crashed
        # writer durably appended but never applied to the data objects,
        # and the read-only deep copy below cannot see them.  The first
        # sync() replays the whole retained journal over the copy
        # (replay is idempotent: absolute offsets), which lands exactly
        # those events — the read-only-open equivalent of the rw open's
        # pre-copy ImageJournal.replay().
        await self.src_io.omap_set(
            src_header, {self._client_key: b"0"}
        )
        self.position = 0
        size = int(h["size"])
        order = int(h["order"])
        from .image import RBD

        rbd = RBD(self.dst_io)
        fresh = True
        try:
            # propagate the source's features (reference:rbd_mirror
            # creates the peer image with matching features): the copy
            # is itself journaled, so it can be promoted and mirrored
            # back symmetrically
            await rbd.create(
                self.name, size, order=order, features=src_features
            )
        except RbdError as e:
            if e.code != -17:  # EEXIST: resume into the existing copy
                raise
            fresh = False
        # the SOURCE is opened read-only (reference:rbd_mirror opens the
        # remote image read-only): no ImageJournal attach, so bootstrap
        # never replays/commits/trims the live writer's journal —
        # close()'s force-commit used to trim-and-reset positions under
        # a concurrent writer, leaving its in-memory counters pointing
        # past the recreated journal (stale-position hazard)
        src = await Image.open(self.src_io, self.name, read_only=True)
        dst = await Image.open(self.dst_io, self.name)
        try:
            if dst.size_bytes != src.size_bytes:
                await dst._apply_resize(src.size_bytes)
            step = dst.object_size
            for off in range(0, src.size_bytes, step):
                chunk = await src.read(off, min(step, src.size_bytes - off))
                if chunk.strip(b"\x00"):
                    await dst._apply_write_data(off, chunk)
                elif not fresh:
                    # resuming into an existing copy: a zero region must
                    # OVERWRITE whatever stale bytes the destination
                    # holds (skipping zeros is only safe on
                    # a freshly created, all-zero image)
                    await dst._apply_discard_data(off, len(chunk))
        finally:
            await src.close()
            await dst.close()

    async def sync(self) -> int:
        """Replay source journal events past our position into the
        destination (reference:rbd_mirror ImageReplayer::handle_replay);
        returns the number of events applied."""
        if not self.image_id:
            raise RbdError(-22, "bootstrap() first")
        src_header = HEADER_PREFIX + self.image_id
        h = await self.src_io.omap_get(src_header)
        stored = int(h.get(self._client_key, b"-1"))
        if stored < 0:
            raise MirrorNotRegistered(
                -22, "no journal-client registration (bootstrap first, "
                     "or the client was deregistered)"
            )
        # the REGISTRATION is authoritative (it is what holds trim and
        # what a trim resets); the in-memory position is just its cache,
        # so a fresh ImageMirrorer (e.g. the CLI's `rbd mirror sync`)
        # resumes exactly where the registered peer left off
        self.position = stored
        try:
            buf = await self.src_io.read(JOURNAL_PREFIX + self.image_id)
        except RadosError as e:
            if e.code != -ENOENT:
                raise
            return 0
        dst = await Image.open(self.dst_io, self.name)
        applied = 0
        pos = self.position
        try:
            for end, hdr, payload in decode_frames(buf, self.position):
                op = hdr.get("op")
                if op == "write":
                    await dst._apply_write_data(int(hdr["off"]), payload)
                elif op == "discard":
                    await dst._apply_discard_data(
                        int(hdr["off"]), int(hdr["len"])
                    )
                elif op == "resize":
                    await dst._apply_resize(int(hdr["size"]))
                pos = end
                applied += 1
        finally:
            await dst.close()
        if applied:
            self.position = pos
            await self.src_io.omap_set(
                src_header, {self._client_key: str(pos).encode()}
            )
        return applied

    async def deregister(self) -> None:
        """Stop mirroring: release the trim hold."""
        if self.image_id:
            await self.src_io.omap_rmkeys(
                HEADER_PREFIX + self.image_id, [self._client_key]
            )
