"""Zero-copy byte-buffer plumbing for the data path.

Counterpart of ``ceph_tpu/utils/buffers.py``, whole: :func:`as_u8`,
:class:`BufferList` and the ``data_path`` copy accounting.

The reference never copies payload bytes between the messenger frame and
the backend: ``bufferlist`` (src/include/buffer.h) is a refcounted list
of ptr/len segments, and every hop — frame decode, striping, EC shard
assembly — appends/slices segments instead of memcpy'ing.  This module
is that idea expressed for a numpy/torch stack:

- :func:`as_u8` — coerce ANY bytes-like to a flat uint8 array without
  copying (``np.frombuffer`` speaks the buffer protocol directly; the
  old ``bytes(data)`` round trip copied every bytearray/memoryview).
- :class:`BufferList` — ref-held ``memoryview`` segments with O(1)
  append/substr; bytes flatten exactly once, at the device or API
  boundary, and the flatten is *accounted*.
- copy accounting — the ``data_path`` perf-counter family
  (``copied_bytes_<hop>`` / ``copies_<hop>``) that makes every copy the
  stack still performs visible in ``perf dump`` -> mgr prometheus
  (daemons attach :func:`data_path_perf` into their collections; tests
  assert the per-round-trip budget).

Aliasing caveat (the price of zero-copy, same as the reference): a
``BufferList``/``as_u8`` view ALIASES its source — mutating the source
after slicing mutates every view.  Hot paths only slice immutable
receive frames or freshly-encoded shard buffers; anything that must
outlive its source takes ``substr_copy``/``tobytes`` (and shows up in
the counters).
"""

from __future__ import annotations

import threading

import numpy as np

# -- copy accounting ----------------------------------------------------------

# The well-known hops, registered eagerly so `perf schema` shows the
# family even before traffic; note_copy() lazily registers any new hop
# (dynamic keys are exempt from the check_counters literal-key gate by
# design — same policy as the rgw per-verb family).
_HOPS = (
    "msgr_encode",   # outbound frame assembly (compat joins only)
    "msgr_decode",   # inbound blob extraction (zero on the view path)
    "client_read",   # rados client read() materializing bytes for its API
    "striper",       # striped read gather into the caller's one buffer
    "ec_gather",     # stripe->shard layout transform / batch concat
    "flatten",       # BufferList.tobytes()/as_u8 multi-segment flatten
    "cold",          # annotated cold paths (compat wrappers, admin)
)

_dp_lock = threading.Lock()
_dp_perf = None  # built lazily: utils must import without common/*


def data_path_perf():
    """The process-global ``data_path`` PerfCounters (one per process,
    shared by every daemon in it — attach() into each collection so the
    family rides ``perf dump`` and the mgr prometheus exposition)."""
    global _dp_perf
    if _dp_perf is None:
        with _dp_lock:
            if _dp_perf is None:
                from ..common.perf_counters import PerfCounters

                pc = PerfCounters("data_path")
                for h in _HOPS:
                    pc.add_counter(f"copied_bytes_{h}",
                                   f"payload bytes memcpy'd at hop {h}")
                    pc.add_counter(f"copies_{h}",
                                   f"copy operations at hop {h}")
                _dp_perf = pc
    return _dp_perf


def note_copy(hop: str, nbytes: int) -> None:
    """Record one payload copy of ``nbytes`` at ``hop``.  Every memcpy
    the hot path still performs calls this — the counters are the
    evidence for the copy-budget gate (<= 1x payload per round trip)."""
    if nbytes <= 0:
        return
    pc = data_path_perf()
    key = f"copied_bytes_{hop}"
    if key not in pc._types:
        with _dp_lock:
            if key not in pc._types:
                pc.add_counter(key, f"payload bytes memcpy'd at hop {hop}")
                pc.add_counter(f"copies_{hop}",
                               f"copy operations at hop {hop}")
    pc.inc(key, int(nbytes))
    pc.inc(f"copies_{hop}")


def copied_bytes(hop: str | None = None) -> int:
    """Total instrumented copy bytes (one hop, or all hops)."""
    pc = data_path_perf()
    if hop is not None:
        key = f"copied_bytes_{hop}"
        return int(pc.get(key)) if key in pc._types else 0
    return sum(
        int(pc.get(k)) for k in list(pc._types)
        if k.startswith("copied_bytes_")
    )


def reset_copies() -> None:
    """Zero the family (a bench phase / test window starts clean)."""
    data_path_perf().reset()


# -- coercion -----------------------------------------------------------------

def as_u8(data, *, writable: bool = False) -> np.ndarray:
    """Coerce bytes-like or array-like to a contiguous flat uint8 array
    WITHOUT copying when the input already owns suitable bytes.

    ``np.frombuffer`` accepts the buffer protocol directly, so bytes,
    bytearray, memoryview and mmap all wrap for free (the array aliases
    the source; see the module aliasing caveat).  The only copy left is
    the one that is semantically required: ``writable=True`` over a
    read-only source (``bytes``, read-only views).
    """
    if isinstance(data, BufferList):
        return data.as_u8(writable=writable)
    if isinstance(data, np.ndarray):
        out = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    elif isinstance(data, (bytes, bytearray, memoryview)):
        mv = memoryview(data)
        if mv.ndim != 1 or not mv.contiguous or mv.itemsize != 1:
            mv = memoryview(mv.tobytes())  # copy-ok: non-contiguous source
            note_copy("flatten", mv.nbytes)
        out = np.frombuffer(mv, dtype=np.uint8)
    else:
        return np.ascontiguousarray(
            np.asarray(data, dtype=np.uint8)
        ).reshape(-1)
    if writable and not out.flags.writeable:
        note_copy("flatten", out.size)
        out = out.copy()  # copy-ok: read-only source, writable required
    return out


# -- BufferList ---------------------------------------------------------------

class BufferList:
    """Refcounted segment list — the ``bufferlist`` analog.

    Holds ``memoryview`` segments over caller buffers; ``append`` /
    ``substr`` / iteration copy nothing (the views keep their sources
    alive).  Bytes materialize exactly once, at :meth:`tobytes` /
    :meth:`as_u8` / multi-segment flatten — and that flatten is
    recorded in the ``data_path`` counters.
    """

    __slots__ = ("_segs", "_len")

    def __init__(self, data=None):
        self._segs: list[memoryview] = []
        self._len = 0
        if data is not None:
            self.append(data)

    # -- building (O(1) per segment, zero copy)
    def append(self, data) -> "BufferList":
        if isinstance(data, BufferList):
            for s in data._segs:
                self._segs.append(s)
            self._len += data._len
            return self
        mv = data if isinstance(data, memoryview) else memoryview(
            np.ascontiguousarray(data, dtype=np.uint8) if isinstance(
                data, np.ndarray) else data
        )
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        if mv.nbytes:
            self._segs.append(mv)
            self._len += mv.nbytes
        return self

    def __len__(self) -> int:
        return self._len

    @property
    def nseg(self) -> int:
        return len(self._segs)

    def segments(self) -> list[memoryview]:
        """The raw views, for vectored I/O (writelines) — no copy."""
        return list(self._segs)

    # -- slicing (O(segments), zero copy)
    def substr(self, off: int, length: int) -> "BufferList":
        """View slice [off, off+length) — segments are shared, not
        copied (mutation of the source shows through; use
        :meth:`substr_copy` for an independent buffer)."""
        if off < 0 or length < 0 or off + length > self._len:
            raise ValueError(
                f"substr({off}, {length}) out of range for {self._len}"
            )
        out = BufferList()
        pos = 0
        need = length
        for seg in self._segs:
            if need == 0:
                break
            end = pos + seg.nbytes
            if end <= off:
                pos = end
                continue
            start = max(0, off - pos)
            take = min(seg.nbytes - start, need)
            out._segs.append(seg[start : start + take])
            out._len += take
            need -= take
            pos = end
        return out

    def substr_copy(self, off: int, length: int) -> bytes:
        """Independent copy of [off, off+length) — the escape hatch for
        data that must survive source mutation (accounted)."""
        return self.substr(off, length).tobytes()

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._len)
            if step != 1:
                raise ValueError("BufferList slices must be contiguous")
            return self.substr(start, max(0, stop - start))
        raise TypeError("BufferList indexing takes slices")

    # -- materialization (THE accounted copies)
    def tobytes(self) -> bytes:
        if not self._segs:
            return b""
        if len(self._segs) == 1:
            note_copy("flatten", self._len)
            return self._segs[0].tobytes()  # copy-ok: API boundary
        note_copy("flatten", self._len)
        out = bytearray(self._len)
        pos = 0
        for seg in self._segs:
            out[pos : pos + seg.nbytes] = seg
            pos += seg.nbytes
        return bytes(out)  # copy-ok: API boundary materialization

    def as_u8(self, *, writable: bool = False) -> np.ndarray:
        """Flat uint8 array: a FREE view when the list holds one
        segment (the common case after frame decode), one gather
        otherwise."""
        if not self._segs:
            return np.empty(0, dtype=np.uint8)
        if len(self._segs) == 1:
            return as_u8(self._segs[0], writable=writable)
        note_copy("flatten", self._len)
        out = np.empty(self._len, dtype=np.uint8)
        pos = 0
        for seg in self._segs:
            out[pos : pos + seg.nbytes] = np.frombuffer(seg, np.uint8)
            pos += seg.nbytes
        return out

    def to_memoryview(self) -> memoryview:
        """Single contiguous view: free for one segment, one gather
        otherwise (accounted via :meth:`as_u8`)."""
        if len(self._segs) == 1:
            return self._segs[0]
        return memoryview(self.as_u8())

    # -- wire helpers
    def crc32c(self, seed: int) -> int:
        """Chained crc32c over the segments — ceph_crc32c composes
        across appends, so no flatten is needed to checksum a frame."""
        from . import native

        crc = seed
        for seg in self._segs:
            crc = native.crc32c(crc, np.frombuffer(seg, np.uint8))
        return crc

    def __eq__(self, other) -> bool:
        if isinstance(other, BufferList):
            # dual segment-cursor walk: comparing two lists must not
            # flatten either side — a gather here would both cost a
            # full payload memcpy and record phantom flatten bytes in
            # the copy audit the budget gates read
            if self._len != other._len:
                return False
            a_i = b_i = a_off = b_off = 0
            while a_i < len(self._segs) and b_i < len(other._segs):
                a, b = self._segs[a_i], other._segs[b_i]
                take = min(a.nbytes - a_off, b.nbytes - b_off)
                if a[a_off : a_off + take] != b[b_off : b_off + take]:
                    return False
                a_off += take
                b_off += take
                if a_off == a.nbytes:
                    a_i += 1
                    a_off = 0
                if b_off == b.nbytes:
                    b_i += 1
                    b_off = 0
            return True
        try:
            mv = memoryview(other).cast("B")
        except TypeError:
            return NotImplemented
        if mv.nbytes != self._len:
            return False
        pos = 0
        for seg in self._segs:
            if seg != mv[pos : pos + seg.nbytes]:
                return False
            pos += seg.nbytes
        return True

    __hash__ = None  # mutable view container

    def __repr__(self) -> str:
        return f"BufferList(len={self._len}, segs={len(self._segs)})"
