"""RBD image engine (reference:src/librbd/ — ImageCtx, internal.cc,
cls_rbd header ops; see package docstring for the on-disk layout).

Counterpart of ``ceph_tpu/rbd/image.py``, whole."""

from __future__ import annotations

import asyncio
import json
import secrets

from ..rados.client import ENOENT, EAGAIN, IoCtx, RadosError

EEXIST = 17
EINVAL = 22
EBUSY = 16

RBD_DIRECTORY = "rbd_directory"
RBD_CHILDREN = "rbd_children"  # parent@snap -> [child ids] (cls_rbd analog)
HEADER_PREFIX = "rbd_header."
DATA_PREFIX = "rbd_data."
DEFAULT_ORDER = 22  # 4 MiB objects, the rbd default


class RbdError(RadosError):
    pass


class RBD:
    """Pool-level image operations (reference:librbd::RBD)."""

    def __init__(self, io: IoCtx):
        self.io = io

    # -- directory (reference:src/cls/rbd cls_rbd dir_* methods) ----------
    async def _dir(self) -> dict[str, bytes]:
        try:
            return await self.io.omap_get(RBD_DIRECTORY)
        except RadosError as e:
            if e.code == -ENOENT:
                return {}
            raise

    async def list(self) -> list[str]:
        return sorted(
            k[len("name_"):] for k in await self._dir()
            if k.startswith("name_")
        )

    async def create(
        self, name: str, size: int, order: int = DEFAULT_ORDER,
        features: "list[str] | None" = None,
    ) -> None:
        """reference:librbd::create — claim the name atomically in the
        directory (cls rbd.dir_add, serialized under the PG lock), then
        write the header.  ``features=["journaling"]`` turns on the
        crash-consistent op journal (``rbd/journal.py``)."""
        if not (12 <= order <= 26):
            raise RbdError(-EINVAL, f"order {order} out of range")
        known = {"journaling"}
        bad = set(features or ()) - known
        if bad:
            raise RbdError(-EINVAL, f"unknown features {sorted(bad)}")
        image_id = secrets.token_hex(8)  # process-independent, 64-bit
        try:
            await self.io.exec(RBD_DIRECTORY, "rbd", "dir_add",
                               {"name": name, "id": image_id})
        except RadosError as e:
            raise RbdError(e.code, f"image {name!r} exists") from e
        header = HEADER_PREFIX + image_id
        await self.io.omap_set(header, {
            "size": str(int(size)).encode(),
            "order": str(order).encode(),
            "snap_seq": b"0",
            "snaps": b"{}",
            "features": json.dumps(sorted(features or [])).encode(),
        })

    async def remove(self, name: str) -> None:
        """reference:librbd::remove — refuse while snapshots exist."""
        img = await Image.open(self.io, name)
        try:
            if img.snaps:
                raise RbdError(-EBUSY, "image has snapshots")
            if img.parent is not None:
                await img._deregister_child()  # free the parent snap
            await img._remove_data_objects(img.size_bytes)
            if "journaling" in img.features:
                from .journal import JOURNAL_PREFIX

                await img._remove_quiet(JOURNAL_PREFIX + img.image_id)
            await self.io.remove(img.header)
        finally:
            await img.close()
        await self.io.exec(RBD_DIRECTORY, "rbd", "dir_remove",
                           {"name": name, "id": img.image_id})

    async def rename(self, src: str, dst: str) -> None:
        try:
            await self.io.exec(RBD_DIRECTORY, "rbd", "dir_rename",
                               {"src": src, "dst": dst})
        except RadosError as e:
            raise RbdError(e.code, f"rename {src!r} -> {dst!r}") from e

    async def clone(
        self, parent_name: str, parent_snap: str, clone_name: str
    ) -> None:
        """COW child of a PROTECTED parent snap (reference:librbd::clone,
        format-2 layering): the child starts as pure metadata; reads fall
        through holes to the parent, first writes copy objects up."""
        parent = await Image.open(self.io, parent_name)
        try:
            s = parent.snaps.get(parent_snap)
            if s is None:
                raise RbdError(-ENOENT, f"no snap {parent_snap!r}")
            if not s.get("protected"):
                raise RbdError(
                    -EINVAL, f"snap {parent_snap!r} is not protected"
                )
            snap_size = int(s["size"])
            await self.create(clone_name, snap_size, order=parent.order)
            child = await Image.open(self.io, clone_name)
            try:
                await self.io.omap_set(child.header, {
                    "parent": json.dumps({
                        "image_id": parent.image_id,
                        "snap_name": parent_snap,
                        "snap_id": int(s["id"]),
                        "overlap": snap_size,
                    }).encode(),
                })
                await self.io.exec(RBD_CHILDREN, "rbd", "child_add", {
                    "key": f"{parent.image_id}@{int(s['id'])}",
                    "child": child.image_id,
                })
            finally:
                await child.close()
        finally:
            await parent.close()


class Image:
    """One open image (reference:librbd::ImageCtx + Image API).

    The image holds its own IoCtx so its write snap-context and read
    snap never leak into the caller's; the header watch keeps the
    cached metadata fresh across clients.
    """

    def __init__(self, io: IoCtx, name: str, image_id: str):
        # private IoCtx: snap state is per-open-image
        self.io = IoCtx(io.client, io.pool_name)
        self.name = name
        self.image_id = image_id
        self.header = HEADER_PREFIX + image_id
        self.size_bytes = 0
        self.order = DEFAULT_ORDER
        self.snaps: dict[str, dict] = {}   # name -> {"id","size","protected"?}
        self.snap_name: str | None = None  # opened-at-snap (read-only)
        self._watch_cookie: str | None = None
        self._closed = False
        self._cache = None  # librbd-style writeback cache (opt-in)
        # layering (format-2 cloning): {"image_id","snap_name","snap_id",
        # "size"} of the parent, or None
        self.parent: dict | None = None
        self._parent_img: "Image | None" = None  # opened lazily at the snap
        self._copyup_locks: dict[int, asyncio.Lock] = {}
        self.features: list[str] = []
        self.read_only = False
        self._journal = None  # ImageJournal when 'journaling' is on

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    async def open(
        cls, io: IoCtx, name: str, snap_name: str | None = None,
        cache_bytes: int = 0, read_only: bool = False,
    ) -> "Image":
        """``read_only=True`` mirrors librbd's OPEN_FLAG_READ_ONLY
        (reference:rbd_mirror opens the remote image read-only): no
        ImageJournal is attached, so no replay/commit/trim ever runs
        against the source's journal — a concurrent writer's positions
        stay untouched.  Write entry points raise -EROFS."""
        d = {}
        try:
            d = await io.omap_get(RBD_DIRECTORY)
        except RadosError as e:
            if e.code != -ENOENT:
                raise
        raw = d.get(f"name_{name}")
        if raw is None:
            raise RbdError(-ENOENT, f"no image {name!r}")
        img = cls(io, name, raw.decode())
        img.read_only = read_only
        await img._refresh()
        if cache_bytes > 0 and snap_name is None:
            # the librbd object cache (reference:librbd cache over
            # ObjectCacher); snapshots read uncached (set_read routing
            # happens below the cache)
            from ..rados.object_cacher import ObjectCacher

            img._cache = ObjectCacher(img.io, max_bytes=cache_bytes)
        if snap_name is not None:
            img.set_snap(snap_name)
        if "journaling" in img.features and snap_name is None \
                and not read_only:
            # crash-replay BEFORE serving I/O (reference:librbd
            # Journal<I>::open -> journal::Replay): a previous writer's
            # acked-but-unapplied ops land now
            from .journal import ImageJournal

            img._journal = ImageJournal(img)
            await img._journal.replay()
        # watch the header: other clients' resizes/snap ops invalidate us
        # (reference:ImageCtx::register_watch)
        img._watch_cookie = await img.io.watch(
            img.header, img._header_notify
        )
        return img

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        await self._cache_flush()
        if self._journal is not None:
            try:
                await self._journal.commit(force=True)
            except (RadosError, ConnectionError, OSError):
                pass  # replay at the next open covers the tail
        if self._parent_img is not None:
            await self._parent_img.close()
            self._parent_img = None
        if self._watch_cookie is not None:
            try:
                await self.io.unwatch(self._watch_cookie)
            except (RadosError, ConnectionError, OSError):
                pass

    async def _refresh(self) -> None:
        try:
            h = await self.io.omap_get(self.header)
        except RadosError as e:
            if e.code == -ENOENT:
                raise RbdError(-ENOENT, f"image {self.name!r} vanished")
            raise
        self.size_bytes = int(h["size"])
        self.order = int(h["order"])
        self.snaps = json.loads(h.get("snaps", b"{}"))
        self.features = json.loads(h.get("features", b"[]"))
        raw_parent = h.get("parent")
        self.parent = json.loads(raw_parent) if raw_parent else None
        self._apply_snapc()

    async def _parent(self) -> "Image | None":
        """The parent image opened read-only at the clone snap
        (reference:ImageCtx::parent), opened lazily and cached."""
        if self.parent is None:
            return None
        if self._parent_img is None:
            d = await self.io.omap_get(RBD_DIRECTORY)
            pname = d.get(f"id_{self.parent['image_id']}")
            if pname is None:
                raise RbdError(-ENOENT, "parent image vanished")
            self._parent_img = await Image.open(
                self.io, pname.decode(),
                snap_name=self.parent["snap_name"],
            )
        return self._parent_img

    def _header_notify(self, notifier: str, payload: bytes):
        # run the refresh asynchronously; the ack must not wait on I/O
        async def refresh_and_drop():
            await self._refresh()
            # another client changed the image (rollback/resize/...):
            # cached data may be stale now.  discard, don't flush — a
            # flush would overwrite the other client's change with our
            # stale whole-object buffers (the lock is advisory)
            await self._cache_drop(discard=True)

        return refresh_and_drop()

    async def _object_at(
        self, snap_name: str | None, objectno: int
    ) -> bytes | None:
        """One data object's bytes at a snap (None = head), or None if
        the object does not exist there.  A clone's parent-backed hole
        reads THROUGH to the parent (like Image.read) — an absent local
        object on a clone is inherited data, not a discard.

        Flips the shared IoCtx read-snap around the await (restored in
        finally): callers must not interleave other reads on this
        Image handle mid-call — export_diff documents itself as an
        exclusive whole-image operation for this reason."""
        sid = (int(self.snaps[snap_name]["id"])
               if snap_name is not None else None)
        restore = (int(self.snaps[self.snap_name]["id"])
                   if self.snap_name is not None else None)
        self.io.set_read(sid)
        try:
            return await self.io.read(
                self._data_name(objectno), 0, self.object_size
            )
        except RadosError as e:
            if e.code != -ENOENT:
                raise
        finally:
            self.io.set_read(restore)
        if self.parent is not None:
            got = await self._parent_read(objectno, 0, self.object_size)
            if got.rstrip(b"\x00"):
                return got
        return None

    async def export_diff(self, from_snap: str | None,
                          to_snap: str | None):
        """Yield (objectno, data|None) for every data object that
        differs between ``from_snap`` (None = the empty image, i.e. a
        full export) and ``to_snap`` (None = head) —
        reference:src/tools/rbd/action/ExportDiff.cc.  Object-granular
        where the reference is extent-granular via clone-overlap
        metadata: same incremental-backup contract, coarser grain.
        data None = the object is ABSENT at the target (a discard).

        An EXCLUSIVE whole-image operation: it flips the handle's read
        snap per object (see _object_at), so interleave no other I/O
        on this Image while iterating — open a dedicated handle (the
        CLI does).  Reads are sequential for the same reason."""
        for name, label in ((from_snap, "from"), (to_snap, "to")):
            if name is not None and name not in self.snaps:
                raise RbdError(-ENOENT, f"no {label} snap {name!r}")
        await self._cache_flush()
        from_size = (int(self.snaps[from_snap]["size"])
                     if from_snap is not None else 0)
        to_size = (int(self.snaps[to_snap]["size"])
                   if to_snap is not None else self.size_bytes)
        span = max(from_size, to_size)
        nobjs = (span + self.object_size - 1) // self.object_size
        for objectno in range(nobjs):
            new = await self._object_at(to_snap, objectno)
            if new is not None:
                # clip to the image boundary: a shrunk image's tail
                # object may physically extend past the logical size
                # (io.zero keeps the object length), and an oversized
                # record would fail the importer's bounds check
                limit = to_size - objectno * self.object_size
                if limit <= 0:
                    new = None
                elif len(new) > limit:
                    new = new[:limit]
            if from_snap is None:
                old = None
            else:
                old = await self._object_at(from_snap, objectno)
            if old == new:
                continue
            yield objectno, new

    async def apply_diff_record(
        self, objectno: int, data: bytes | None
    ) -> None:
        """Apply one export_diff record (import-diff side).  The whole
        object span is discarded first: a shorter record over a longer
        existing object must not leave stale tail bytes (the
        source reads zeros there)."""
        off = objectno * self.object_size
        span = min(self.object_size, max(0, self.size_bytes - off))
        if data is not None and off + len(data) > self.size_bytes:
            raise RbdError(-EINVAL, "diff record past image size")
        if span > 0 and (data is None or len(data) < span):
            # only when the record does NOT cover the whole span: a
            # shorter record over a longer existing object must not
            # leave stale tail bytes
            await self.discard(off, span)
        if data is not None:
            await self.write(off, data)

    async def du(self) -> dict:
        """Allocated bytes for the image HEAD: lists the pool once and
        stats each existing rbd_data object — sparse extents never
        written cost nothing (reference:src/tools/rbd/action/
        DiskUsage.cc; head only: snap-level accounting would need
        per-snap clone walks)."""
        await self._cache_flush()  # dirty cached writes must be counted
        prefix = f"{DATA_PREFIX}{self.image_id}."
        used = 0
        objects = 0
        for name in await self.io.client.list_objects(self.io.pool_name):
            if not name.startswith(prefix):
                continue
            try:
                used += await self.io.stat(name)
                objects += 1
            except RadosError as e:
                if e.code != -ENOENT:
                    raise  # a real I/O failure must not under-report
                # raced a discard/delete: the object is legitimately gone
        return {
            "name": self.name,
            "provisioned": self.size_bytes,
            "used": used,
            "objects": objects,
        }

    # -- layout ------------------------------------------------------------
    @property
    def object_size(self) -> int:
        return 1 << self.order

    def _data_name(self, objectno: int) -> str:
        return f"{DATA_PREFIX}{self.image_id}.{objectno:016x}"

    def _extents(
        self, offset: int, length: int
    ) -> list[tuple[int, int, int]]:
        """(objectno, obj_off, len) runs covering the range."""
        out = []
        pos, end = offset, offset + length
        while pos < end:
            objectno = pos // self.object_size
            obj_off = pos % self.object_size
            run = min(self.object_size - obj_off, end - pos)
            out.append((objectno, obj_off, run))
            pos += run
        return out

    def _apply_snapc(self) -> None:
        """Writes carry the image's live-snap context
        (reference:ImageCtx::get_snap_context)."""
        ids = sorted(
            (int(s["id"]) for s in self.snaps.values()), reverse=True
        )
        if ids:
            self.io.set_snapc(ids[0], ids)
        else:
            self.io.set_snapc(0, [])

    # -- data path ---------------------------------------------------------
    def _check_open_rw(self) -> None:
        if self._closed:
            raise RbdError(-EINVAL, "image is closed")
        if self.snap_name is not None:
            raise RbdError(-EINVAL, "image opened at a snapshot: read-only")
        if self.read_only:
            raise RbdError(-30, "image opened read-only")  # -EROFS

    async def write(self, offset: int, data: bytes) -> int:
        self._check_open_rw()
        if offset + len(data) > self.size_bytes:
            raise RbdError(-EINVAL, "write past end of image")
        if self._journal is not None:
            # journal-first (reference:librbd journaling write path):
            # the event is durable before any data object changes, so a
            # client dying anywhere after this point leaves a replayable
            # record instead of a torn multi-object write
            await self._journal.append("write", {"off": offset}, data)
        await self._apply_write_data(offset, data)
        if self._journal is not None:
            await self._journal.commit()
        return len(data)

    async def _apply_write_data(self, offset: int, data: bytes) -> None:
        """The data-object half of a write — used by the normal path
        and by journal replay (idempotent: absolute offsets)."""
        if self.parent is not None:
            await asyncio.gather(*(
                self._ensure_copyup(objectno)
                for objectno in {o for o, _off, _r in
                                 self._extents(offset, len(data))}
            ))
        pos = 0
        ops = []
        for objectno, obj_off, run in self._extents(offset, len(data)):
            chunk = data[pos : pos + run]
            pos += run
            name = self._data_name(objectno)
            if self._cache is not None:
                ops.append(self._cache.write(name, chunk, offset=obj_off))
            else:
                ops.append(self.io.write(name, chunk, offset=obj_off))
        await asyncio.gather(*ops)

    async def read(self, offset: int, length: int) -> bytes:
        if self._closed:
            raise RbdError(-EINVAL, "image is closed")
        size = (
            int(self.snaps[self.snap_name]["size"])
            if self.snap_name is not None else self.size_bytes
        )
        end = min(offset + length, size)
        if offset >= end:
            return b""

        async def fetch(objectno: int, obj_off: int, run: int) -> bytes:
            name = self._data_name(objectno)
            try:
                if self._cache is not None and self.snap_name is None:
                    got = await self._cache.read(name, obj_off, run)
                else:
                    got = await self.io.read(name, obj_off, run)
            except RadosError as e:
                if e.code != -ENOENT:
                    raise
                # absent object: a clone shows the parent through the
                # hole (reference:librbd read-from-parent); plain images
                # read zeros
                got = await self._parent_read(objectno, obj_off, run)
            return got + b"\x00" * (run - len(got))

        parts = await asyncio.gather(
            *(fetch(o, oo, r) for o, oo, r in self._extents(offset, end - offset))
        )
        return b"".join(parts)

    # -- layering internals --------------------------------------------------
    async def _parent_read(self, objectno: int, obj_off: int,
                           run: int) -> bytes:
        """Bytes the parent contributes to a hole in this object, clipped
        to the parent overlap (shrunk by resize, never regrown)."""
        if self.parent is None:
            return b""
        logical = objectno * self.object_size + obj_off
        overlap = int(self.parent["overlap"])
        if logical >= overlap:
            return b""
        parent = await self._parent()
        return await parent.read(logical, min(run, overlap - logical))

    async def _object_exists(self, name: str) -> bool:
        try:
            if self._cache is not None:
                await self._cache.read(name, 0, 0)
            else:
                await self.io.stat(name)
            return True
        except RadosError as e:
            if e.code == -ENOENT:
                return False
            raise

    async def _ensure_copyup(self, objectno: int) -> None:
        """First write to a clone's absent object copies the parent's
        whole object range up first (reference:librbd copy-up), so
        later reads of the object's untouched regions stay correct.
        Serialized per object: a racing copy-up landing after another
        task's data write would revert acknowledged bytes (librbd's
        per-object copyup state machine)."""
        if self.parent is None:
            return
        lock = self._copyup_locks.setdefault(objectno, asyncio.Lock())
        async with lock:
            name = self._data_name(objectno)
            if await self._object_exists(name):
                return
            base = await self._parent_read(objectno, 0, self.object_size)
            if not base:
                return  # beyond the overlap: plain create-on-write
            if self._cache is not None:
                await self._cache.write(name, base, offset=0)
            else:
                await self.io.write(name, base, offset=0)

    async def discard(self, offset: int, length: int) -> None:
        """Punch a hole (reference:librbd discard -> zero/truncate/remove
        per object)."""
        self._check_open_rw()
        if self._journal is not None:
            await self._journal.append(
                "discard", {"off": offset, "len": length}
            )
        await self._apply_discard_data(offset, length)
        if self._journal is not None:
            await self._journal.commit()

    async def _apply_discard_data(self, offset: int, length: int) -> None:
        ops = []
        for objectno, obj_off, run in self._extents(offset, length):
            name = self._data_name(objectno)
            parent_covers = (
                self.parent is not None
                and objectno * self.object_size < int(self.parent["overlap"])
            )
            if obj_off == 0 and run == self.object_size:
                if parent_covers:
                    # removing the object would re-expose the parent:
                    # an EXISTING empty object reads as zeros instead
                    ops.append(self._truncate_zero(name))
                else:
                    ops.append(self._remove_quiet(name))
            else:
                if parent_covers:
                    await self._ensure_copyup(objectno)
                ops.append(self._zero_quiet(name, obj_off, run))
        await asyncio.gather(*ops)

    async def _truncate_zero(self, name: str) -> None:
        if self._cache is not None:
            await self._cache.write_full(name, b"")
        else:
            await self.io.truncate(name, 0)

    async def _remove_quiet(self, name: str) -> None:
        try:
            if self._cache is not None:
                await self._cache.remove(name)
            else:
                await self.io.remove(name)
        except RadosError as e:
            if e.code != -ENOENT:
                raise

    async def _zero_quiet(self, name: str, off: int, ln: int) -> None:
        # both paths materialize a zero-filled object if absent — the
        # OSD zero op creates-on-write, and the cached path must match
        try:
            if self._cache is not None:
                await self._cache.write(name, b"\x00" * ln, offset=off)
            else:
                await self.io.zero(name, off, ln)
        except RadosError as e:
            if e.code != -ENOENT:
                raise

    async def _cache_flush(self) -> None:
        if self._cache is not None:
            await self._cache.flush()

    async def _cache_drop(self, *, discard: bool = False) -> None:
        if self._cache is not None:
            await self._cache.invalidate(discard=discard)

    # -- metadata ----------------------------------------------------------
    async def resize(self, new_size: int) -> None:
        """Grow or shrink (reference:librbd::resize; shrink removes the
        now-out-of-range data objects)."""
        self._check_open_rw()
        if self._journal is not None:
            await self._journal.append("resize", {"size": int(new_size)})
        await self._apply_resize(new_size)
        if self._journal is not None:
            await self._journal.commit()

    async def _apply_resize(self, new_size: int) -> None:
        old = self.size_bytes
        if new_size < old:
            first_dead = -(-new_size // self.object_size)
            last = (old - 1) // self.object_size if old else -1
            await asyncio.gather(*(
                self._remove_quiet(self._data_name(n))
                for n in range(first_dead, last + 1)
            ))
            if new_size % self.object_size:
                # partial tail object: drop bytes past the new end.  On
                # a clone the boundary object may still be a parent
                # hole — zeroing would materialize it and shadow the
                # RETAINED head with zeros, so copy up first
                boundary = new_size // self.object_size
                if (self.parent is not None
                        and boundary * self.object_size
                        < int(self.parent["overlap"])):
                    await self._ensure_copyup(boundary)
                await self._zero_quiet(
                    self._data_name(boundary),
                    new_size % self.object_size,
                    self.object_size - new_size % self.object_size,
                )
        kv = {"size": str(int(new_size)).encode()}
        if self.parent is not None and new_size < int(
            self.parent["overlap"]
        ):
            # the parent overlap shrinks with the image and never
            # regrows (reference:librbd parent_overlap semantics) — a
            # later grow reads zeros there, not stale parent bytes
            self.parent["overlap"] = int(new_size)
            kv["parent"] = json.dumps(self.parent).encode()
        await self._set_header(kv)
        self.size_bytes = int(new_size)

    async def _set_header(self, kv: dict[str, bytes]) -> None:
        await self.io.omap_set(self.header, kv)
        try:
            await self.io.notify(self.header, b"header-update", timeout=2.0)
        except RadosError:
            pass  # watchers refresh lazily on the next notify

    async def stat(self) -> dict:
        return {
            "name": self.name, "id": self.image_id,
            "size": self.size_bytes, "order": self.order,
            "object_size": self.object_size,
            "num_objs": -(-self.size_bytes // self.object_size),
            "snaps": sorted(self.snaps),
        }

    async def _remove_data_objects(self, up_to_size: int) -> None:
        count = -(-up_to_size // self.object_size)
        await asyncio.gather(*(
            self._remove_quiet(self._data_name(n)) for n in range(count)
        ))

    # -- snapshots (reference:librbd snap_create/remove/rollback) ----------
    def set_snap(self, snap_name: str | None) -> None:
        """Route reads to a snapshot (None = head); writes are refused
        while a snap is set."""
        if snap_name is not None and snap_name not in self.snaps:
            raise RbdError(-ENOENT, f"no snap {snap_name!r}")
        self.snap_name = snap_name
        self.io.set_read(
            int(self.snaps[snap_name]["id"]) if snap_name else None
        )

    async def snap_create(self, snap_name: str) -> None:
        self._check_open_rw()
        if snap_name in self.snaps:
            raise RbdError(-EEXIST, f"snap {snap_name!r} exists")
        # dirty cached writes must be IN the snapshot
        await self._cache_flush()
        snapid = await self.io.selfmanaged_snap_create()
        self.snaps[snap_name] = {"id": snapid, "size": self.size_bytes}
        self._apply_snapc()
        await self._set_header({"snaps": json.dumps(self.snaps).encode()})

    async def snap_remove(self, snap_name: str) -> None:
        self._check_open_rw()
        s = self.snaps.get(snap_name)
        if s is None:
            raise RbdError(-ENOENT, f"no snap {snap_name!r}")
        if s.get("protected"):
            raise RbdError(-EBUSY,
                           f"snap {snap_name!r} is protected (clones?)")
        self.snaps.pop(snap_name)
        await self.io.selfmanaged_snap_remove(int(s["id"]))
        self._apply_snapc()
        await self._set_header({"snaps": json.dumps(self.snaps).encode()})

    async def snap_rollback(self, snap_name: str) -> None:
        """Roll every data object back to the snap (reference:librbd
        snap_rollback -> per-object selfmanaged rollback)."""
        self._check_open_rw()
        s = self.snaps.get(snap_name)
        if s is None:
            raise RbdError(-ENOENT, f"no snap {snap_name!r}")
        # rollback rewrites objects server-side: cached state is stale
        # (our own pending writes are flushed first by design; the drop
        # itself must not re-flush)
        await self._cache_flush()
        await self._cache_drop(discard=True)
        snapid, snap_size = int(s["id"]), int(s["size"])
        max_size = max(self.size_bytes, snap_size)
        count = -(-max_size // self.object_size)

        async def roll(objectno: int) -> None:
            name = self._data_name(objectno)
            try:
                await self.io.rollback(name, snapid)
            except RadosError as e:
                if e.code != -ENOENT:
                    raise  # absent everywhere: object was a hole then too

        await asyncio.gather(*(roll(n) for n in range(count)))
        if snap_size != self.size_bytes:
            await self._set_header({"size": str(snap_size).encode()})
            self.size_bytes = snap_size

    # -- layering: protect / flatten (reference:librbd snap_protect,
    # flatten; children registry reference:src/cls/rbd children ops) -------

    async def snap_protect(self, snap_name: str) -> None:
        """Cloning requires a protected snap: protection blocks rmsnap
        until every child is flattened or removed."""
        self._check_open_rw()
        s = self.snaps.get(snap_name)
        if s is None:
            raise RbdError(-ENOENT, f"no snap {snap_name!r}")
        s["protected"] = True
        await self._set_header({"snaps": json.dumps(self.snaps).encode()})

    async def snap_unprotect(self, snap_name: str) -> None:
        self._check_open_rw()
        s = self.snaps.get(snap_name)
        if s is None:
            raise RbdError(-ENOENT, f"no snap {snap_name!r}")
        children = await self._children_of(int(s["id"]))
        if children:
            raise RbdError(
                -EBUSY, f"snap {snap_name!r} has {len(children)} children"
            )
        s["protected"] = False
        await self._set_header({"snaps": json.dumps(self.snaps).encode()})

    async def _children_of(self, snapid: int) -> list[str]:
        try:
            out = await self.io.exec(
                RBD_CHILDREN, "rbd", "children_get",
                {"key": f"{self.image_id}@{snapid}"},
            )
        except RadosError as e:
            if e.code == -ENOENT:
                return []
            raise
        return out["children"]

    async def list_children(self, snap_name: str) -> list[str]:
        """Child image NAMES cloned from the snap."""
        s = self.snaps.get(snap_name)
        if s is None:
            raise RbdError(-ENOENT, f"no snap {snap_name!r}")
        ids = await self._children_of(int(s["id"]))
        d = await self.io.omap_get(RBD_DIRECTORY)
        return sorted(
            d[f"id_{cid}"].decode() for cid in ids if f"id_{cid}" in d
        )

    async def _deregister_child(self) -> None:
        """Drop this image from its parent snap's children table
        (atomic via the cls method, like registration)."""
        try:
            await self.io.exec(RBD_CHILDREN, "rbd", "child_remove", {
                "key": f"{self.parent['image_id']}@{self.parent['snap_id']}",
                "child": self.image_id,
            })
        except RadosError as e:
            if e.code != -ENOENT:
                raise

    async def flatten(self) -> None:
        """Copy every parent-backed object up and detach from the parent
        (reference:librbd::flatten)."""
        self._check_open_rw()
        if self.parent is None:
            return
        overlap = int(self.parent["overlap"])
        sem = asyncio.Semaphore(8)  # bounded parallel copy-ups

        async def up(objectno: int) -> None:
            async with sem:
                await self._ensure_copyup(objectno)

        await asyncio.gather(*(
            up(n) for n in range(-(-overlap // self.object_size))
        ))
        await self._deregister_child()
        await self.io.omap_rmkeys(self.header, ["parent"])
        self.parent = None
        if self._parent_img is not None:
            await self._parent_img.close()
            self._parent_img = None
        await self._set_header({})  # notify watchers

    # -- exclusive lock (reference:librbd/ExclusiveLock -> cls lock) -------
    LOCK_NAME = "rbd_lock"
    LOCK_TAG = "internal"

    async def lock_acquire(self, cookie: str = "auto") -> None:
        try:
            await self.io.exec(self.header, "lock", "lock", {
                "name": self.LOCK_NAME, "type": 1,
                "entity": self.io.client.name, "cookie": cookie,
                "tag": self.LOCK_TAG,
            })
        except RadosError as e:
            raise RbdError(e.code, "image is locked") from e

    async def lock_release(self, cookie: str = "auto") -> None:
        await self.io.exec(self.header, "lock", "unlock", {
            "name": self.LOCK_NAME,
            "entity": self.io.client.name, "cookie": cookie,
        })

    async def lock_owners(self) -> list[dict]:
        info = await self.io.exec(
            self.header, "lock", "get_info", {"name": self.LOCK_NAME}
        )
        return info["lockers"]

    async def break_lock(self, entity: str, cookie: str = "auto") -> None:
        await self.io.exec(self.header, "lock", "break_lock", {
            "name": self.LOCK_NAME, "entity": entity, "cookie": cookie,
        })
