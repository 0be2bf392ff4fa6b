"""Client-side object cache (reference:src/osdc/ObjectCacher.{h,cc}).

The reference caches object extents in the client (librbd's cache, the
ceph-fuse data cache): reads hit cached extents, writes are buffered
dirty and flushed back asynchronously (write-back) or immediately
(write-through), with an LRU bounding memory and watch/notify-driven
invalidation available to callers whose objects can change underneath
them.

Simplifications that keep the contract: caching is whole-object (the
framework's hot objects — rbd chunks, fs stripe units — are bounded by
object_size anyway), and flushing is per-object ordered through the
IoCtx write path so crash consistency equals the uncached path's.

Counterpart of ``ceph_tpu/rados/object_cacher.py``, over the port's
``IoCtx``.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict

from .client import ENOENT, IoCtx, RadosError


class CachedObject:
    __slots__ = ("data", "dirty", "exists")

    def __init__(self, data: bytearray, exists: bool):
        self.data = data
        self.dirty = False
        self.exists = exists


class ObjectCacher:
    """LRU write-back/write-through cache over one IoCtx."""

    def __init__(self, io: IoCtx, max_bytes: int = 64 << 20,
                 write_back: bool = True):
        self.io = io
        self.max_bytes = max_bytes
        self.write_back = write_back
        self._objs: "OrderedDict[str, CachedObject]" = OrderedDict()
        self._bytes = 0
        self._lock = asyncio.Lock()
        # stats (perf-counter shape, reference l_objectcacher_*)
        self.hits = 0
        self.misses = 0
        self.flushes = 0

    # -- internals -----------------------------------------------------------
    async def _load(self, oid: str) -> CachedObject:
        obj = self._objs.get(oid)
        if obj is not None:
            self._objs.move_to_end(oid)
            self.hits += 1
            return obj
        self.misses += 1
        try:
            data = bytearray(await self.io.read(oid))
            exists = True
        except RadosError as e:
            if e.code != -ENOENT:
                raise
            data, exists = bytearray(), False
        obj = CachedObject(data, exists)
        self._objs[oid] = obj
        self._bytes += len(data)
        await self._evict(keep=oid)
        return obj

    async def _evict(self, keep: str | None = None) -> None:
        """LRU eviction; dirty victims flush first (reference
        ObjectCacher::trim).  ``keep`` is the object the caller is
        actively mutating: evicting it mid-operation would orphan the
        CachedObject and silently lose the dirty write."""
        while self._bytes > self.max_bytes:
            victim = next((k for k in self._objs if k != keep), None)
            if victim is None:
                return  # only the in-use object remains: keep it cached
            obj = self._objs.pop(victim)
            if obj.dirty:
                await self._flush_one(victim, obj)
            self._bytes -= len(obj.data)

    async def _flush_one(self, oid: str, obj: CachedObject) -> None:
        if not obj.dirty:
            return
        await self.io.write_full(oid, bytes(obj.data))
        obj.dirty = False
        self.flushes += 1

    # -- I/O surface ---------------------------------------------------------
    async def read(self, oid: str, offset: int = 0, length: int = -1) -> bytes:
        async with self._lock:
            obj = await self._load(oid)
            if not obj.exists:
                raise RadosError(-ENOENT, f"read {oid}")
            end = len(obj.data) if length < 0 else min(
                offset + length, len(obj.data)
            )
            return bytes(obj.data[offset:end])

    async def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        async with self._lock:
            obj = await self._load(oid)
            end = offset + len(data)
            if len(obj.data) < end:
                self._bytes += end - len(obj.data)
                obj.data.extend(b"\x00" * (end - len(obj.data)))
            obj.data[offset:end] = data
            obj.exists = True
            obj.dirty = True
            if not self.write_back:
                await self._flush_one(oid, obj)
            await self._evict(keep=oid)

    async def write_full(self, oid: str, data: bytes) -> None:
        async with self._lock:
            obj = self._objs.get(oid)
            if obj is None:
                obj = CachedObject(bytearray(), False)
                self._objs[oid] = obj
            else:
                self._objs.move_to_end(oid)  # hot: refresh LRU position
            self._bytes += len(data) - len(obj.data)
            obj.data = bytearray(data)
            obj.exists = True
            obj.dirty = True
            if not self.write_back:
                await self._flush_one(oid, obj)
            await self._evict(keep=oid)

    async def remove(self, oid: str) -> None:
        async with self._lock:
            obj = self._objs.pop(oid, None)
            if obj is not None:
                self._bytes -= len(obj.data)
            try:
                await self.io.remove(oid)
            except RadosError as e:
                if e.code != -ENOENT or (obj is None or not obj.exists):
                    raise

    # -- coherence -----------------------------------------------------------
    async def flush(self, oid: str | None = None) -> None:
        """Write back dirty state (reference flush_set); None = all."""
        async with self._lock:
            targets = (
                [(oid, self._objs[oid])] if oid is not None
                and oid in self._objs else
                list(self._objs.items()) if oid is None else []
            )
            for o, obj in targets:
                await self._flush_one(o, obj)

    async def invalidate(
        self, oid: str | None = None, *, discard: bool = False
    ) -> None:
        """Drop cached state.  Two modes:

        - ``discard=False`` (default, self-initiated release): dirty data
          is flushed first, like the reference's release_set-after-flush.
        - ``discard=True`` (remote-change notification — another client
          resized/rolled back/overwrote): dirty buffers are dropped
          WITHOUT flushing.  Flushing here would push stale whole-object
          writes over the other client's change (e.g. resurrect
          pre-rollback data), since the exclusive lock is advisory."""
        async with self._lock:
            names = [oid] if oid is not None else list(self._objs)
            for o in names:
                obj = self._objs.pop(o, None)
                if obj is not None:
                    if not discard:
                        await self._flush_one(o, obj)
                    self._bytes -= len(obj.data)

    def stats(self) -> dict:
        return {
            "objects": len(self._objs),
            "bytes": self._bytes,
            "dirty": sum(1 for o in self._objs.values() if o.dirty),
            "hits": self.hits,
            "misses": self.misses,
            "flushes": self.flushes,
        }
