"""Pooled receive buffers for the messenger's frame reader.

Counterpart of ``ceph_tpu/common/recv_pool.py``, whole.

The SEND side is allocation-free (common/slab.py scratch +
borrowed blob views); receive stayed the last allocating hop — every
``readexactly(n)`` built a fresh ``bytes`` per frame.  This pool closes
that: the reader checks out a :class:`RecvBlock`, the transport fills
it in place (asyncio BufferedProtocol ``recv_into``), and decode hands
out ``memoryview`` slices of the SAME block — zero copies, zero
steady-state allocations (``stack.recv_allocs`` flat,
``stack.recv_slab_hits`` growing; pinned live by
tests/test_torch_msg.py).

**Lifetime discipline (the refcount problem, solved by CPython's own
buffer-export tracking).**  Inbound blob views outlive the reader loop:
the OSD dispatches ops as tasks and the client can hand
``read(copy=False)`` views to the caller.  A recycled-while-referenced
block would be silent data corruption, so release is two-phase:

- the reader calls :meth:`RecvBlock.release` once the frame's dispatch
  returns (its OWN views dropped first);
- ``release`` probes whether any downstream ``memoryview`` still
  exports the block's ``bytearray`` (resizing a bytearray with live
  exports raises ``BufferError`` — the probe appends+trims one byte,
  observable by nobody).  Export-free blocks recycle immediately;
  exported blocks park in a bounded **quarantine** swept on later pool
  traffic, so a view held across an op keeps its block alive (the view
  itself pins the bytearray via refcount) and the block returns to the
  free lists the moment the last view dies.

Blocks the quarantine bound evicts are simply dropped to the GC: any
surviving view still owns the bytearray, so eviction can never corrupt
— it only costs a later pool miss.  That asymmetry (drop is always
safe, recycle needs proof) is the same discipline the writer loop
applies to slab blocks under backpressure.

Size classes run larger than the send slab's (frames aggregate ops
now: a 16-op batch of 4 KiB writes is a ~68 KiB frame); oversize
checkouts allocate exactly and never pool.  Process-global like
``frame_slab()``: every in-process daemon shares one pool, so the
``stack.recv_*`` counters are one ledger per process.
"""

from __future__ import annotations

import threading

from .stack_ledger import note_recv_held, note_recv_hit, note_recv_miss

# free-list classes (bytes).  Receive frames skew larger than send
# scratch: an op frame carries its payload inline and batch frames
# multiply it, so the ladder tops out at 1 MiB (vs the slab's 256 KiB).
SIZE_CLASSES = (4096, 16384, 65536, 262144, 1048576)
# bounds: per-class free-list count cap and a whole-pool byte cap —
# whichever trips first, the released block is dropped to the GC
PER_CLASS = 32
MAX_HELD_BYTES = 8 << 20
# quarantined (still-exported) blocks kept for later sweeps; beyond
# this the oldest is dropped to the GC (safe: live views pin the bytes)
QUARANTINE_MAX = 256

# hit-tally flush batch (mirrors slab.py: the checkout hot path pays a
# plain int increment, not a perf-counter lock)
_HIT_FLUSH = 64


def _has_exports(buf: bytearray) -> bool:
    """True iff any memoryview still exports ``buf``.  CPython refuses
    to resize a bytearray with live buffer exports — append+trim one
    byte is an export probe no reader of the buffer can observe."""
    try:
        buf.append(0)
    except BufferError:
        return True
    del buf[-1:]
    return False


class RecvBlock:
    """One pooled receive buffer: the transport fills ``buf`` in place,
    decode slices views out of it, :meth:`release` recycles it once the
    reader is done (downstream views defer recycling, never block it).
    """

    __slots__ = ("buf", "cap", "_pool", "_out")

    def __init__(self, pool: "RecvPool | None", cap: int):
        self.buf = bytearray(cap)
        self.cap = cap
        self._pool = pool  # None = oversize one-shot, never pooled
        self._out = True

    def view(self, n: int, start: int = 0) -> memoryview:
        """A writable window over the block (the transport's
        ``recv_into`` target / decode's frame body)."""
        return memoryview(self.buf)[start:start + n]

    def release(self) -> None:
        """Hand the block back (idempotent).  Recycles now if no view
        exports the buffer, else quarantines until the last view dies.
        """
        if not self._out:
            return
        self._out = False
        if self._pool is not None:
            self._pool._put(self)


class RecvPool:
    """Bounded size-class free lists + export-quarantine (see module
    docstring).  Thread-safe like SlabPool: daemons share one loop, but
    tests exercise the pool from executors."""

    def __init__(self, classes=SIZE_CLASSES, per_class: int = PER_CLASS,
                 max_held_bytes: int = MAX_HELD_BYTES,
                 quarantine_max: int = QUARANTINE_MAX):
        self.classes = tuple(sorted(classes))
        self.per_class = per_class
        self.max_held_bytes = max_held_bytes
        self.quarantine_max = quarantine_max
        self._free: dict[int, list[RecvBlock]] = {c: [] for c in self.classes}
        self._quarantine: list[RecvBlock] = []
        self._held = 0
        self._hits = 0  # unflushed hit tally (batched into the ledger)
        self._lock = threading.Lock()

    def _class_for(self, n: int) -> int | None:
        for c in self.classes:
            if n <= c:
                return c
        return None

    def checkout(self, n: int) -> RecvBlock:
        """A block with ``cap >= n``.  Free-list hit is allocation-free;
        a sweep of the quarantine runs before any fresh allocation, so
        blocks freed by dying views recycle ahead of new memory."""
        cls = self._class_for(n)
        with self._lock:
            if cls is not None:
                free = self._free[cls]
                if free:
                    blk = free.pop()
                    self._held -= blk.cap
                    blk._out = True
                    self._hits += 1
                    if self._hits >= _HIT_FLUSH:
                        hits, self._hits = self._hits, 0
                    else:
                        hits = 0
                else:
                    self._sweep_locked()
                    free = self._free[cls]
                    if free:
                        blk = free.pop()
                        self._held -= blk.cap
                        blk._out = True
                        self._hits += 1
                        hits = 0
                    else:
                        blk = None
                        hits = self._hits
                        self._hits = 0
            else:
                blk = None
                hits = self._hits
                self._hits = 0
            held = self._held
        if hits:
            note_recv_hit(hits)
        if blk is not None:
            return blk
        # miss: a real allocation on the receive path (also booked into
        # stack.frame_allocs — the flat-in-steady-state pin)
        note_recv_miss(held)
        return RecvBlock(self if cls is not None else None,
                         cls if cls is not None else n)

    def _put(self, blk: RecvBlock) -> None:
        with self._lock:
            if _has_exports(blk.buf):
                self._quarantine.append(blk)
                if len(self._quarantine) > self.quarantine_max:
                    # oldest out, dropped to the GC: its views keep the
                    # bytearray alive, the pool just forgets it
                    self._quarantine.pop(0)
                self._sweep_locked()
                held = self._held
                hits = 0
            else:
                self._recycle_locked(blk)
                self._sweep_locked()
                held = self._held
                hits, self._hits = self._hits, 0
        if hits:
            note_recv_hit(hits)
        note_recv_held(held)

    def _recycle_locked(self, blk: RecvBlock) -> None:
        free = self._free[blk.cap]
        if (len(free) < self.per_class
                and self._held + blk.cap <= self.max_held_bytes):
            free.append(blk)
            self._held += blk.cap
        # else: dropped to the GC (bounded memory beats a cheap miss)

    def _sweep_locked(self) -> None:
        """Move export-free quarantined blocks back to the free lists."""
        if not self._quarantine:
            return
        still = []
        for blk in self._quarantine:
            if _has_exports(blk.buf):
                still.append(blk)
            else:
                self._recycle_locked(blk)
        self._quarantine = still

    def stats(self) -> dict:
        with self._lock:
            return {
                "free": {c: len(v) for c, v in self._free.items()},
                "held_bytes": self._held,
                "quarantined": len(self._quarantine),
            }


_pool: RecvPool | None = None
_pool_lock = threading.Lock()


def recv_pool() -> RecvPool:
    """The process-global receive pool (one per process, like
    ``frame_slab()`` — every in-process daemon shares it)."""
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = RecvPool()
    return _pool
