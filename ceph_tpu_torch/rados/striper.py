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

The extent table is computed VECTORIZED (one numpy pass over all
touched stripe units, merged to contiguous runs).  Reads gather every
extent directly into ONE preallocated buffer (the single accounted copy
on the read path, ``data_path.copied_bytes_striper``).

Counterpart of ``ceph_tpu/rados/striper.py``: the same layout math,
backing-object names and size attribute, over this package's ``IoCtx``,
so a striped object written by either package reads back through the
other.  One difference, in the op count only: a write or read issues ONE
RADOS op per backing object and contiguous object range
(:meth:`StripedLayout.object_runs`), as Ceph's ``Striper::file_to_extents``
gives one object extent with its buffer extents, where the reference
issues one op per stripe unit (1024 ops for a 4 MiB object at the
default layout).  A write whose range covers one stripe unit of an object
sends a view of the caller's buffer; one that covers more gathers that
object's units into one buffer (the copy is accounted as
``data_path.copied_bytes_striper``).  The bytes that land are the same.
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

    def object_runs(self, offset: int, length: int) -> list[tuple[int, int, int, list]]:
        """The extents of [offset, offset+length) grouped into one run a
        backing object and contiguous object range: ``(objectno,
        obj_off, length, pieces)``, each piece ``(buf_off, run_off,
        len)`` placing a slice of the caller's buffer at ``run_off``
        into the run (Ceph's ObjectExtent with its buffer extents)."""
        obj, ooff, run, boff = self.extent_table(offset, length)
        if obj.size == 0:
            return []
        order = np.lexsort((ooff, obj))
        obj, ooff, run, boff = obj[order], ooff[order], run[order], boff[order]
        brk = np.flatnonzero((obj[1:] != obj[:-1]) | (ooff[1:] != ooff[:-1] + run[:-1]))
        starts = np.concatenate(([0], brk + 1)).tolist()
        ends = np.concatenate((brk + 1, [obj.size])).tolist()
        out = []
        for a, b in zip(starts, ends):
            base = int(ooff[a])
            pieces = [(int(boff[i]), int(ooff[i]) - base, int(run[i])) for i in range(a, b)]
            out.append((int(obj[a]), base, int(ooff[b - 1] + run[b - 1]) - base, pieces))
        return out

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
        """Write across backing objects: one write a backing object and
        contiguous range, all landing concurrently.

        A run of one piece is a borrowed VIEW of ``data`` (the frame
        encoder sends it vectored; the buffer must stay unmutated until
        the write completes); a run of several pieces is gathered into
        one buffer, the write path's one accounted copy."""
        view = memoryview(data)
        if view.ndim != 1 or view.itemsize != 1:
            view = view.cast("B")
        ops = []
        copied = 0
        for objectno, obj_off, length, pieces in self.layout.object_runs(offset, len(view)):
            if len(pieces) == 1:
                b0, _r0, n = pieces[0]
                chunk = view[b0 : b0 + n]
            else:
                chunk = bytearray(length)
                for b0, r0, n in pieces:
                    chunk[r0 : r0 + n] = view[b0 : b0 + n]
                copied += length
            ops.append(self.io.write(self._oname(objectno), chunk, offset=obj_off))
        if copied:
            note_copy("striper", copied)
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

        async def fetch(objectno: int, obj_off: int, length: int, pieces: list) -> None:
            try:
                got = await self.io.read(self._oname(objectno), obj_off, length, copy=False)
            except RadosError as e:
                if e.code == -ENOENT:
                    return  # hole: object never written
                raise
            got = memoryview(got)
            for b0, r0, n in pieces:  # the ONE gather copy
                n = min(n, len(got) - r0)  # a short read leaves zeros
                if n <= 0:
                    break
                mv[b0 : b0 + n] = got[r0 : r0 + n]

        await asyncio.gather(*(fetch(*run) for run in self.layout.object_runs(offset, total)))
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
