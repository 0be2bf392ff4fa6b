"""Slab-recycled frame buffer pools (the ``buffer::raw`` pool analog,
reference:src/common/buffer.cc raw_combined / mempool buffers).

Counterpart of ``ceph_tpu/common/slab.py``, whole.

The binary wire protocol (msg/message.py) packs every frame header —
fixed struct, blob-length array, trace id, field tail — and the crc
trailer into ONE scratch block with ``struct.pack_into`` / slice
assignment.  This module owns those blocks: bounded per-size-class
free lists, so steady-state frame memory is **allocation-free** — a
frame encode checks a block out, the messenger writer releases it once
the transport has drained it, and the next frame reuses the same
bytearray.  ``stack.slab_hits`` / ``slab_misses`` /
``slab_bytes_held`` (common/stack_ledger.py) prove the recycling; a
pool **miss** is a real frame-path allocation and feeds
``stack.frame_allocs`` — the baseline counter this pool drives flat.

Scope: the pool covers every buffer the frame layer itself creates
on the SEND side — header+crc scratch, sub-KiB control-frame
assembly, batch-frame assembly.  **Receive** buffers have their own
mirror-image pool (common/recv_pool.py): inbound frames
land directly in pooled ``RecvBlock`` slots via the messenger's
``BufferedProtocol``, and the unbounded-lifetime problem this
paragraph once punted to Python's GC (a read reply's blob lives as
long as the caller keeps it) is solved the way buffer::raw solves it
in the reference — a refcount on the block (view export probing + a
bounded quarantine), so downstream views pin the block and the last
one to die recycles it.

Thread-safe: one process-global pool (:func:`frame_slab`) is shared by
every in-process messenger plus the EC dispatcher's worker threads,
like the ``stack.*`` ledger it reports through.
"""

from __future__ import annotations

import threading

from . import stack_ledger

# power-of-4-ish classes sized for frame headers and small frames: the
# 256B class carries almost every binary header (32B fixed + lens +
# trace + tail), 1KiB the control-frame fast path, the larger classes
# coalesced ack batches and oversized field tails (map pushes, the
# periodic stats reports whose perf-dump tails run to hundreds of KiB
# — without the top class every stats tick would be a steady-state
# allocation, exactly what frame_allocs must NOT show)
SIZE_CLASSES = (256, 1024, 4096, 16384, 65536, 262144)
# free-list bounds: per-class count cap AND a per-class byte cap (the
# count cap alone would let the 256KiB class park 16MiB) — past
# either, a released block is dropped to the GC instead of held; the
# pool bounds memory, it never grows it
DEFAULT_PER_CLASS = 64
DEFAULT_CLASS_BYTES = 1 << 20


class SlabBuf:
    """One checked-out slab block.  ``data`` is the backing bytearray
    (>= the requested size); write with ``pack_into``/slice assignment
    and send ``view(n)`` slices.  ``release()`` returns the block to
    its pool — the caller must guarantee no live view of ``data`` can
    still reach the transport (the messenger releases only after the
    socket drained the frame)."""

    __slots__ = ("data", "_pool", "_klass", "_out")

    def __init__(self, data: bytearray, pool: "SlabPool | None",
                 klass: int | None):
        self.data = data
        self._pool = pool
        self._klass = klass
        self._out = True

    def view(self, n: int, start: int = 0) -> memoryview:
        return memoryview(self.data)[start:start + n]

    def release(self) -> None:
        """Return to the pool (idempotent; oversize blocks just drop)."""
        if not self._out:
            return
        self._out = False
        if self._pool is not None:
            self._pool._put(self)


class SlabPool:
    """Bounded per-size-class free lists of bytearray blocks."""

    def __init__(self, size_classes: tuple[int, ...] = SIZE_CLASSES,
                 per_class: int = DEFAULT_PER_CLASS,
                 class_bytes: int = DEFAULT_CLASS_BYTES):
        self.size_classes = tuple(sorted(size_classes))
        self.per_class = int(per_class)
        # effective per-class block cap: min(count cap, byte cap)
        self._cap = {
            c: max(1, min(int(per_class), int(class_bytes) // c))
            for c in self.size_classes
        }
        self._free: dict[int, list[SlabBuf]] = {
            c: [] for c in self.size_classes
        }
        self._lock = threading.Lock()
        self._bytes_held = 0
        self.hits = 0
        self.misses = 0
        # ledger flush watermark: hits reported to stack.slab_hits so
        # far — the hit path tallies under the pool lock only; the
        # perf-counter lock is paid on release/miss/stats, outside
        # the timed header-encode window
        self._hits_reported = 0

    def _class_for(self, n: int) -> int | None:
        for c in self.size_classes:
            if n <= c:
                return c
        return None  # oversize: exact alloc, never pooled

    def checkout(self, n: int) -> SlabBuf:
        """A block of at least ``n`` bytes.  A pooled block is a hit
        (no allocation); an empty free list or an oversize request is
        a miss — a real frame-path allocation, counted into
        ``stack.frame_allocs`` next to ``stack.slab_misses``.

        The hit path pays ONE plain pool lock (this sits inside the
        timed header-encode window) and NO perf-counter lock: hits
        tally in a plain int and flush into ``stack.slab_hits`` in
        batches from release/miss/stats, where a lock round trip is
        already being paid."""
        klass = self._class_for(n)
        if klass is not None:
            with self._lock:
                free = self._free[klass]
                buf = free.pop() if free else None
                if buf is not None:
                    self.hits += 1
                    self._bytes_held -= klass
            if buf is not None:
                buf._out = True
                return buf
        with self._lock:
            self.misses += 1
            held = self._bytes_held
        self._flush_hits()
        stack_ledger.note_slab_miss(held)
        return SlabBuf(bytearray(klass if klass is not None else n),
                       self if klass is not None else None, klass)

    def _flush_hits(self) -> None:
        """Push un-reported hits into ``stack.slab_hits`` (called on
        release/miss/stats — never on the checkout hot path)."""
        with self._lock:
            delta = self.hits - self._hits_reported
            self._hits_reported += delta
        if delta:
            stack_ledger.note_slab_hit(delta)

    def _put(self, buf: SlabBuf) -> None:
        with self._lock:
            free = self._free[buf._klass]
            if len(free) < self._cap[buf._klass]:
                free.append(buf)
                self._bytes_held += buf._klass
            held = self._bytes_held
        self._flush_hits()
        stack_ledger.note_slab_held(held)

    def stats(self) -> dict:
        self._flush_hits()
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "bytes_held": self._bytes_held,
                "free": {c: len(f) for c, f in self._free.items()},
                "caps": dict(self._cap),
            }


_lock = threading.Lock()
_frame_slab: SlabPool | None = None


def frame_slab() -> SlabPool:
    """The process-global frame-scratch pool (one messenger boundary
    per process -> one pool, like the ``stack.*`` ledger)."""
    global _frame_slab
    if _frame_slab is None:
        with _lock:
            if _frame_slab is None:
                _frame_slab = SlabPool()
    return _frame_slab
