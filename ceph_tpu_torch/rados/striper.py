"""Client-side striping: large logical objects over many RADOS objects.

Re-expression of the reference Striper (reference:src/osdc/Striper.cc:1
file_to_extents) + libradosstriper (reference:src/libradosstriper/): a
logical byte stream is cut into stripe units of ``stripe_unit`` bytes,
distributed round-robin over ``stripe_count`` objects per object set,
with each backing object capped at ``object_size`` bytes.  Backing
objects are named ``<soid>.<objectno:016x>`` (the striper's naming
convention), and the logical size rides as a "size" attribute on the
first object (the striper's locking/metadata collapsed to the size key
— the mini-RADOS has a single writer per op).

Layout math (file_to_extents): for logical offset ``off``:
  blockno   = off // stripe_unit        (which stripe unit)
  stripeno  = blockno // stripe_count   (which stripe row)
  stripepos = blockno % stripe_count    (column -> object in the set)
  objectsetno = stripeno // stripes_per_object
  objectno  = objectsetno * stripe_count + stripepos
  obj_off   = (stripeno % stripes_per_object) * stripe_unit + off % stripe_unit

Zero-copy data path: the extent table is computed VECTORIZED (one numpy
pass over all touched stripe units, merged to contiguous runs — the old
per-unit python loop was O(bytes/stripe_unit) interpreter work per op),
writes slice borrowed ``memoryview``s of the caller's buffer per extent
(no per-stripe ``data[a:b]`` bytes copies — the messenger sends views),
and reads gather every extent directly into ONE preallocated buffer
(the single accounted copy on the read path,
``data_path.copied_bytes_striper``).

Counterpart of ``ceph_tpu/rados/striper.py``, whole: the same layout
math and backing-object names, over this package's ``IoCtx``.
"""

from __future__ import annotations

import asyncio

import numpy as np

from ..utils.buffers import note_copy
from .client import ENOENT, IoCtx, RadosError

SIZE_XATTR = "striper.size"  # logical size key on the first backing object


class StripedLayout:
    """The file_to_extents algebra (reference:src/osdc/Striper.cc:59)."""

    def __init__(self, stripe_unit: int = 4096, stripe_count: int = 4,
                 object_size: int = 1 << 22):
        if stripe_unit <= 0 or stripe_count <= 0 or object_size <= 0:
            raise ValueError("layout parameters must be positive")
        if object_size % stripe_unit:
            raise ValueError("object_size must be a multiple of stripe_unit")
        self.stripe_unit = stripe_unit
        self.stripe_count = stripe_count
        self.object_size = object_size
        self.stripes_per_object = object_size // stripe_unit

    def extent_table(
        self, offset: int, length: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized file_to_extents: ``(objectno, obj_off, run,
        buf_off)`` arrays covering [offset, offset+length), contiguous
        runs within each object merged.  ``buf_off`` is each extent's
        offset into the caller's buffer — the slice table writes and
        reads index by, with no per-stripe arithmetic loop in python."""
        if length <= 0:
            z = np.empty(0, dtype=np.int64)
            return z, z, z.copy(), z.copy()
        su = self.stripe_unit
        first = offset // su
        last = (offset + length - 1) // su
        blockno = np.arange(first, last + 1, dtype=np.int64)
        stripeno = blockno // self.stripe_count
        stripepos = blockno % self.stripe_count
        objectsetno = stripeno // self.stripes_per_object
        objectno = objectsetno * self.stripe_count + stripepos
        obj_off = (stripeno % self.stripes_per_object) * su
        # per-unit start/len in LOGICAL space (first/last units partial)
        unit_start = np.maximum(blockno * su, offset)
        unit_end = np.minimum((blockno + 1) * su, offset + length)
        unit_off = obj_off + (unit_start - blockno * su)
        unit_len = unit_end - unit_start
        # merge contiguous runs: same object AND object offset continues
        if blockno.size > 1:
            brk = np.flatnonzero(
                (objectno[1:] != objectno[:-1])
                | (unit_off[1:] != unit_off[:-1] + unit_len[:-1])
            )
            starts = np.concatenate(([0], brk + 1))
            ends = np.concatenate((brk, [blockno.size - 1]))
        else:
            starts = np.array([0])
            ends = np.array([0])
        run_obj = objectno[starts]
        run_off = unit_off[starts]
        run_len = (unit_start[ends] + unit_len[ends]) - unit_start[starts]
        buf_off = unit_start[starts] - offset
        return run_obj, run_off, run_len, buf_off

    def extents(self, offset: int, length: int) -> list[tuple[int, int, int]]:
        """(objectno, obj_offset, len) covering [offset, offset+length),
        merged per contiguous run within each object (list form of
        :meth:`extent_table`, kept for the existing callers)."""
        obj, ooff, run, _ = self.extent_table(offset, length)
        return [
            (int(o), int(f), int(r))
            for o, f, r in zip(obj.tolist(), ooff.tolist(), run.tolist())
        ]

    def object_count(self, size: int) -> int:
        """Backing objects a logical size may touch."""
        if size == 0:
            return 0
        blocks = -(-size // self.stripe_unit)
        stripes = -(-blocks // self.stripe_count)
        objectsets = -(-stripes // self.stripes_per_object)
        return objectsets * self.stripe_count


class StripedObject:
    """One striped logical object (rados_striper_* surface)."""

    def __init__(self, io: IoCtx, soid: str, layout: StripedLayout | None = None):
        self.io = io
        self.soid = soid
        self.layout = layout or StripedLayout()

    def _oname(self, objectno: int) -> str:
        return f"{self.soid}.{objectno:016x}"

    async def _read_size_attr(self) -> int:
        try:
            raw = await self.io.getxattr(self._oname(0), SIZE_XATTR)
        except RadosError as e:
            if e.code == -ENOENT:
                return -1
            raise
        return int(raw.decode() or 0)

    async def _write_size_attr(self, size: int) -> None:
        oname = self._oname(0)
        try:
            await self.io.setxattr(oname, SIZE_XATTR, str(size).encode())
        except RadosError as e:
            if e.code != -ENOENT:
                raise
            # a write that never touched object 0 (high offset): create it
            # empty so the size attr has a home (the reference striper
            # likewise keeps its metadata on the first object)
            await self.io.write(oname, b"", offset=0)
            await self.io.setxattr(oname, SIZE_XATTR, str(size).encode())

    async def size(self) -> int:
        s = await self._read_size_attr()
        if s < 0:
            raise RadosError(-ENOENT, f"no striped object {self.soid!r}")
        return s

    async def write(self, data: bytes, offset: int = 0) -> None:
        """Write across backing objects; extents land concurrently.

        Per-extent chunks are borrowed VIEWS of ``data`` (no slicing
        copies — the frame encoder sends them vectored); the buffer must
        stay unmutated until the write completes."""
        view = memoryview(data)
        if view.ndim != 1 or view.itemsize != 1:
            view = view.cast("B")
        obj, ooff, run, boff = self.layout.extent_table(offset, len(view))
        ops = []
        for i in range(obj.size):
            chunk = view[int(boff[i]) : int(boff[i]) + int(run[i])]
            ops.append(
                self.io.write(
                    self._oname(int(obj[i])), chunk, offset=int(ooff[i])
                )
            )
        if ops:
            await asyncio.gather(*ops)
        old = await self._read_size_attr()
        new_end = offset + len(view)
        if new_end > max(old, 0):
            await self._write_size_attr(new_end)

    async def read(self, offset: int = 0, length: int = 0) -> bytearray:
        """Read [offset, offset+length) (to EOF when length<=0).

        Every extent gathers straight from its reply frame's view into
        ONE preallocated output buffer — the single copy on the read
        path (accounted as ``data_path.copied_bytes_striper``); holes
        and short reads stay zero-filled.  Returns the gather buffer
        itself (a ``bytearray`` — bytes-compatible, no extra copy)."""
        size = await self.size()
        end = size if length <= 0 else min(offset + length, size)
        if offset >= end:
            return bytearray()
        total = end - offset
        out = bytearray(total)  # zero-filled: holes need no writes
        mv = memoryview(out)
        obj, ooff, run, boff = self.layout.extent_table(offset, total)

        async def fetch(i: int) -> None:
            try:
                got = await self.io.read(
                    self._oname(int(obj[i])), int(ooff[i]), int(run[i]),
                    copy=False,
                )
            except RadosError as e:
                if e.code == -ENOENT:
                    return  # hole: object never written
                raise
            b0 = int(boff[i])
            mv[b0 : b0 + len(got)] = got  # the ONE gather copy

        await asyncio.gather(*(fetch(i) for i in range(obj.size)))
        note_copy("striper", total)
        return out

    async def remove(self) -> None:
        size = await self._read_size_attr()
        count = self.layout.object_count(max(size, 0))
        ops = []
        for objectno in range(max(count, 1)):  # object 0 always exists
            ops.append(self._remove_quiet(self._oname(objectno)))
        await asyncio.gather(*ops)

    async def _remove_quiet(self, oname: str) -> None:
        try:
            await self.io.remove(oname)
        except RadosError as e:
            if e.code != -ENOENT:
                raise
