"""Stripe/chunk algebra and batched EC math for the OSD data path.

Counterpart of ``ceph_tpu/osd/ec_util.py``, whole; the re-expression of
``ECUtil`` (reference:src/osd/ECUtil.{h,cc}):

- :class:`StripeInfo` — the logical↔chunk offset algebra of ``stripe_info_t``
  (reference:ECUtil.h:35-88).  An object is a sequence of stripes of
  ``stripe_width`` bytes; each stripe splits into k chunks of ``chunk_size``;
  shard i stores the concatenation of its chunk from every stripe.
- :func:`encode` / :func:`decode` — where the reference loops stripe-by-stripe
  calling the codec once per ``stripe_width`` slice (reference:ECUtil.cc:99,
  :113-120 and :45), we batch ALL stripes into a single ``[k, S*chunk]``
  device call: the per-shard output bytes are identical (the GF matmul is
  columnwise) but the card sees one large launch instead of S small ones.
- :class:`HashInfo` — cumulative per-shard crc32c, persisted as an object
  xattr and checked on every shard read (reference:ECUtil.h:109-167;
  check site reference:src/osd/ECBackend.cc:994-1008).
"""

from __future__ import annotations

import logging
from typing import Mapping, Sequence

import numpy as np

from ..models.interface import ErasureCodeInterface
from ..utils import native
from ..utils.buffers import as_u8, note_copy

logger = logging.getLogger("ceph_tpu_torch.ec_util")

CRC_SEED = 0xFFFFFFFF  # the reference seeds per-shard crcs with -1


class StripeInfo:
    """Logical↔chunk offset algebra (reference:ECUtil.h:35-88)."""

    def __init__(self, stripe_width: int, chunk_size: int):
        if stripe_width % chunk_size != 0:
            raise ValueError(
                f"stripe_width {stripe_width} not a multiple of chunk_size {chunk_size}"
            )
        self.stripe_width = stripe_width
        self.chunk_size = chunk_size
        self.k = stripe_width // chunk_size

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return offset // self.k

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return offset * self.k

    def aligned_offset_len_to_chunk(self, offset: int, length: int) -> tuple[int, int]:
        return (
            self.aligned_logical_offset_to_chunk_offset(offset),
            self.aligned_logical_offset_to_chunk_offset(length),
        )

    def offset_len_to_stripe_bounds(self, offset: int, length: int) -> tuple[int, int]:
        """Round (offset, length) out to full-stripe bounds."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def pad_to_stripe(self, data) -> bytes:
        """Zero-pad to a whole number of stripes (reference pads logically).
        Accepts any bytes-like (views included); unpadded input passes
        through untouched, a padded result is one accounted gather."""
        _, want = self.offset_len_to_stripe_bounds(0, len(data))
        if want == len(data):
            return data
        note_copy("ec_gather", len(data))
        out = bytearray(want)
        out[: len(data)] = data
        return out


# -- batched stripe math -----------------------------------------------------

def _native_matrix_engine(ec_impl) -> bool:
    """The native C GF engine applies: a plain w=8 matrix codec on the
    CPU device, a matrix the engine takes, and a loadable native library
    (one shared gate — native.host_engine_active)."""
    from ..models.matrix_codec import MatrixErasureCode

    return (
        type(ec_impl) is MatrixErasureCode
        and ec_impl.w == 8
        and native.fits(ec_impl.m, ec_impl.k)
        and native.host_engine_active(ec_impl.device)
    )


def native_encode_path(sinfo: StripeInfo, ec_impl) -> bool:
    """Will :func:`encode` actually take the native C branch for this
    geometry?  ONE predicate shared with the microbatch dispatcher's
    per-op direct lane, so the routing gates cannot drift (the branch
    below additionally needs ``cs % 8 == 0``)."""
    return sinfo.chunk_size % 8 == 0 and _native_matrix_engine(ec_impl)


def native_decode_path(ec_impl, shard_len: int) -> bool:
    """Will the codec's decode take the native C branch for shard
    buffers of ``shard_len`` bytes?  Mirrors the gate in
    MatrixErasureCode.decode_chunks (w=8, last dim % 8, native engine);
    shared with the dispatcher for the same no-drift reason."""
    return shard_len % 8 == 0 and _native_matrix_engine(ec_impl)


def account_ec_call(pec, op: str, nbytes: int, seconds: float) -> None:
    """THE definition of the ``ec.{encode,decode}`` device-wall-time
    feed — time avg + (size x latency) histogram + per-engine GB/s
    gauge — shared by the microbatch dispatcher's batch launches and its
    native direct lane, so the call sites cannot drift."""
    pec.observe(f"{op}_time", seconds)
    pec.hist(f"{op}_time_histogram", nbytes, seconds)
    if seconds > 0:
        pec.set(f"{op}_gbps", nbytes / seconds / 1e9)


def _check_batch_alignment(sinfo: StripeInfo, ec_impl) -> None:
    """Packetized (bitmatrix) codecs need chunk_size % (w*packetsize) == 0 or
    batched packets would span stripe boundaries and diverge from the
    reference per-stripe bytes; columnwise matrix codecs are exact at any
    chunk size (batch_alignment == 1)."""
    align = getattr(ec_impl, "batch_alignment", lambda: 1)()
    if sinfo.chunk_size % align != 0:
        raise ValueError(
            f"chunk_size {sinfo.chunk_size} not a multiple of codec "
            f"batch alignment {align}"
        )


def _encode_prologue(
    sinfo: StripeInfo, ec_impl: ErasureCodeInterface,
    data: bytes | np.ndarray,
) -> tuple[np.ndarray, int]:
    """Validate an encode batch; returns ``(buf, stripes)``.  ONE
    prologue shared by :func:`encode` and :func:`encode_fallback`: the
    device and fallback lanes must accept exactly the same batches, or
    a failover replay could reject — with a spurious ValueError
    delivered to the waiters as the "real" error — a batch the device
    lane already admitted."""
    buf = as_u8(data)
    if buf.size % sinfo.stripe_width != 0:
        raise ValueError(
            f"data size {buf.size} not a multiple of stripe_width {sinfo.stripe_width}"
        )
    if ec_impl.get_data_chunk_count() != sinfo.k:
        raise ValueError(
            f"codec k={ec_impl.get_data_chunk_count()} != stripe "
            f"k={sinfo.k}"
        )
    _check_batch_alignment(sinfo, ec_impl)
    return buf, buf.size // sinfo.stripe_width


def _decode_prologue(
    sinfo: StripeInfo, ec_impl: ErasureCodeInterface,
    chunks: Mapping[int, np.ndarray],
) -> tuple[list[int], int]:
    """Validate a decode shard set; returns ``(present, shard_len)`` —
    the decode-side twin of :func:`_encode_prologue`, shared by
    :func:`decode` and :func:`decode_fallback` for the same reason."""
    present = sorted(chunks)
    sizes = {np.asarray(v).size for v in chunks.values()}
    if len(sizes) != 1:
        raise ValueError(f"shard buffers differ in size: {sizes}")
    shard_len = next(iter(sizes))
    if shard_len % sinfo.chunk_size != 0:
        raise ValueError(
            f"shard buffer size {shard_len} not a multiple of "
            f"chunk_size {sinfo.chunk_size}"
        )
    _check_batch_alignment(sinfo, ec_impl)
    return present, shard_len


def encode(
    sinfo: StripeInfo, ec_impl: ErasureCodeInterface, data: bytes | np.ndarray
) -> dict[int, np.ndarray]:
    """Encode whole stripes: returns {shard: bytes for that shard}.

    ``data`` length must be a multiple of stripe_width.  Batches every
    stripe into one codec call (reference loops per stripe,
    reference:ECUtil.cc:113-120 — same bytes, one device launch).
    """
    buf, S = _encode_prologue(sinfo, ec_impl, data)
    k, m = ec_impl.get_data_chunk_count(), ec_impl.get_coding_chunk_count()
    cs = sinfo.chunk_size
    # [S, k, cs] -> [k, S*cs]: shard i's buffer is its chunk from each stripe
    # in order, exactly the reference's per-stripe append layout.
    #
    # Engine routing: a codec on the CPU runs the GF matmul in the
    # native C engine (the gf-complete/ISA-L class — no copies into
    # torch, no dispatch), exactly as the reference routes to ISA-L on
    # CPU; a codec on the card takes the shard entry, which keeps the
    # layout work on the card.  Parity bytes are identical on every path
    # (the GF algebra is exact; tests pin all engines to the numpy
    # oracle).
    if cs % 8 == 0 and _native_matrix_engine(ec_impl):
        # one C pass produces shard rows + parity (transpose and matmul
        # fused — no second read of the input)
        from ..ops.profiler import profiler

        m = ec_impl.get_coding_chunk_count()
        # the OSD's CPU-host hot path bypasses the codec entries, so it
        # must report into the kernel profiler here or the daemon's
        # dump_kernel_profile is empty exactly where the stack runs;
        # nothing to build on the C engine -> every call is
        # steady-state.  The matrix key is built once at codec
        # construction (_mkey).  The C pass performs the SAME
        # stripe->shard layout memcpy the other paths do on host — it
        # must hit the copy audit identically or the <=1x budget gate
        # would depend on engine routing.
        note_copy("ec_gather", buf.size)
        with profiler().timed(
            "native_stripes_encode",
            (ec_impl._mkey, S, cs),
            nbytes=buf.size, shape=(S, k, cs), compiled=False,
        ):
            out_arr = native.encode_stripes(ec_impl.matrix, buf, S, cs)
        return {i: out_arr[i] for i in range(k + m)}
    encs = getattr(ec_impl, "encode_shards_u32", None)
    if (
        encs is not None and cs % 4 == 0 and buf.ctypes.data % 4 == 0
        and not native.host_engine_active(getattr(ec_impl, "device", None))
    ):
        # the shard entry: the input is a FREE u32 view of the client
        # buffer; transpose + matmul + concat run on the codec's device
        # and ONE result comes back — its rows ARE the shard buffers
        d3 = buf.view(np.uint32).reshape(S, k, cs // 4)
        out = encs(d3)  # [k+m, S*cs4]
        return {i: out[i].view(np.uint8) for i in range(k + m)}
    enc32 = getattr(ec_impl, "encode_chunks_u32", None)
    if enc32 is not None and cs % 4 == 0 and buf.ctypes.data % 4 == 0:
        # u32-lane pipeline: the transpose moves 4-byte
        # units (≈2x the u8 transpose) and the codec skips every
        # uint8<->u32 relayout; shard rows come back as free u8 views.
        # The transpose is the ONE host gather on this path (the
        # stripe->shard layout transform) — accounted as ec_gather.
        note_copy("ec_gather", buf.size)
        arr32 = np.ascontiguousarray(
            buf.view(np.uint32).reshape(S, k, cs // 4).transpose(1, 0, 2)
        ).reshape(k, S * (cs // 4))
        parity32 = enc32(arr32)
        out = {i: arr32[i].view(np.uint8) for i in range(k)}
        for j in range(m):
            out[k + j] = np.ascontiguousarray(parity32[j]).view(np.uint8)
        return out
    note_copy("ec_gather", buf.size)
    arr = np.ascontiguousarray(
        buf.reshape(S, k, cs).transpose(1, 0, 2)
    ).reshape(k, S * cs)
    parity = np.asarray(ec_impl.encode_chunks(arr))
    out = {i: arr[i] for i in range(k)}
    for j in range(m):
        out[k + j] = parity[j]
    return out


def decode(
    sinfo: StripeInfo,
    ec_impl: ErasureCodeInterface,
    chunks: Mapping[int, np.ndarray],
    want: Sequence[int] | None = None,
) -> dict[int, np.ndarray]:
    """Rebuild shard buffers from surviving shard buffers.

    Each value in ``chunks`` is a whole shard buffer (S chunks back-to-back).
    The recovery matrix is columnwise, so one batched call rebuilds every
    stripe at once (reference:ECUtil.cc:45 loops per chunk_size slice).
    """
    present, _shard_len = _decode_prologue(sinfo, ec_impl, chunks)
    if want is None:
        want = list(range(ec_impl.get_data_chunk_count()))
    return ec_impl.decode(list(want), {i: np.asarray(chunks[i]) for i in present})


def shards_to_logical(rows: Sequence[np.ndarray], chunk_size: int) -> bytearray:
    """[k, S*cs] data-shard rows -> the logical stripe-interleaved
    bytes: the ONE inverse of :func:`encode`'s layout transform, shared
    by decode_concat and the microbatch dispatcher's per-op reassembly
    so the two decode paths cannot drift.

    Gathers the interleave directly into one ``bytearray`` (the old
    ``ascontiguousarray(...).tobytes()`` materialized the transpose and
    then copied it AGAIN); returns the gather buffer itself —
    bytes-compatible, sendable as a frame blob without conversion."""
    k = len(rows)
    row0 = np.asarray(rows[0])
    S = row0.size // chunk_size
    total = k * S * chunk_size
    note_copy("ec_gather", total)
    out = bytearray(total)
    dst = np.frombuffer(out, dtype=np.uint8).reshape(S, k, chunk_size)
    for i, r in enumerate(rows):
        dst[:, i, :] = np.asarray(r).reshape(S, chunk_size)
    return out


def decode_concat(
    sinfo: StripeInfo,
    ec_impl: ErasureCodeInterface,
    chunks: Mapping[int, np.ndarray],
) -> bytearray:
    """Rebuild the original logical bytes (stripe-interleaved data shards).

    Inverse of :func:`encode`'s layout transform
    (reference:ECUtil.cc:7 decode+concat).
    """
    k = ec_impl.get_data_chunk_count()
    decoded = decode(sinfo, ec_impl, chunks, want=list(range(k)))
    return shards_to_logical(
        [decoded[i] for i in range(k)], sinfo.chunk_size
    )


# -- host fallback engine (the failover replay path) --------------------------
#
# The engine supervisor (osd/ec_failover) replays a failed device batch
# here: same contract and BYTES as encode/decode_concat (every engine is
# pinned bit-identical to the host oracle), but the device is never
# touched — codecs route through their encode_chunks_host /
# decode_chunks_host oracle methods (models/matrix_codec), so a replay
# cannot re-raise the device fault it is recovering from.

_NO_HOST_ORACLE_WARNED: set[str] = set()


def _host_oracle(ec_impl, op: str):
    """``<op>_host`` on the codec, or (third-party plugins only —
    every in-repo codec ships host oracles) the device method with a
    once-per-class warning: a failover replay that silently re-enters
    the dead device would re-raise the fault it is recovering from,
    and the operator should know WHY failover is not protecting this
    pool."""
    host = getattr(ec_impl, f"{op}_host", None)
    if host is not None:
        return host
    cls = type(ec_impl).__name__
    if cls not in _NO_HOST_ORACLE_WARNED:
        _NO_HOST_ORACLE_WARNED.add(cls)
        logger.warning(
            "codec %s has no %s_host oracle: the EC failover replay "
            "falls back to its device method and cannot protect "
            "against device loss for this pool", cls, op,
        )
    return getattr(ec_impl, op)


def encode_fallback(
    sinfo: StripeInfo, ec_impl: ErasureCodeInterface,
    data: bytes | np.ndarray,
) -> dict[int, np.ndarray]:
    """Host-engine :func:`encode`: identical shard bytes, no device."""
    buf, S = _encode_prologue(sinfo, ec_impl, data)
    k, m = ec_impl.get_data_chunk_count(), ec_impl.get_coding_chunk_count()
    cs = sinfo.chunk_size
    note_copy("ec_gather", buf.size)
    arr = np.ascontiguousarray(
        buf.reshape(S, k, cs).transpose(1, 0, 2)
    ).reshape(k, S * cs)
    host = _host_oracle(ec_impl, "encode_chunks")
    parity = np.asarray(host(arr))
    out = {i: arr[i] for i in range(k)}
    for j in range(m):
        out[k + j] = parity[j]
    return out


def decode_fallback(
    sinfo: StripeInfo,
    ec_impl: ErasureCodeInterface,
    chunks: Mapping[int, np.ndarray],
    want: Sequence[int] | None = None,
) -> dict[int, np.ndarray]:
    """Host-engine :func:`decode`: identical shard bytes, no device."""
    present, _shard_len = _decode_prologue(sinfo, ec_impl, chunks)
    if want is None:
        want = list(range(ec_impl.get_data_chunk_count()))
    missing = sorted(set(want) - set(present))
    out = {
        i: np.asarray(chunks[i]) for i in want if i in chunks
    }
    if missing:
        host = _host_oracle(ec_impl, "decode_chunks")
        stacked = np.stack(
            [np.asarray(chunks[i], dtype=np.uint8) for i in present]
        )
        rebuilt = np.asarray(host(present, stacked, missing))
        for j, i in enumerate(missing):
            out[i] = rebuilt[j]
    return out


def decode_concat_fallback(
    sinfo: StripeInfo,
    ec_impl: ErasureCodeInterface,
    chunks: Mapping[int, np.ndarray],
) -> bytearray:
    """Host-engine :func:`decode_concat`: identical bytes, no device."""
    k = ec_impl.get_data_chunk_count()
    decoded = decode_fallback(sinfo, ec_impl, chunks, want=list(range(k)))
    return shards_to_logical(
        [decoded[i] for i in range(k)], sinfo.chunk_size
    )


# -- StripeHashes ------------------------------------------------------------


class StripeHashes:
    """Per-(shard, stripe) crc32c table — the overwrite-safe HashInfo.

    The reference's cumulative HashInfo only supports append
    (reference:src/osd/ECUtil.h:109-167); its overwrite pools lean on
    store-level block checksums instead. Here crc granularity is one
    chunk (= one shard's slice of one stripe), so an RMW overwrite
    updates exactly the affected stripes' entries and scrub/deep-scrub
    can verify any shard at rest chunk-by-chunk
    (check sites: read path and scrub, the analogs of
    reference:src/osd/ECBackend.cc:994-1008 and :2313).

    Persisted under the same xattr key the reference uses for HashInfo.
    """

    XATTR_KEY = "hinfo_key"

    def __init__(self, num_shards: int, chunk_size: int):
        self.chunk_size = chunk_size
        self.crcs: list[list[int]] = [[] for _ in range(num_shards)]

    @property
    def num_shards(self) -> int:
        return len(self.crcs)

    def num_stripes(self) -> int:
        return len(self.crcs[0]) if self.crcs else 0

    @staticmethod
    def _chunk_crcs(buf: np.ndarray, chunk_size: int) -> list[int]:
        buf = np.asarray(buf, dtype=np.uint8)
        if buf.size % chunk_size != 0:
            raise ValueError(
                f"shard buffer {buf.size} not a multiple of chunk {chunk_size}"
            )
        return [
            int(native.crc32c(CRC_SEED, buf[o : o + chunk_size]))
            for o in range(0, buf.size, chunk_size)
        ]

    def zero_crc(self) -> int:
        return int(
            native.crc32c(CRC_SEED, np.zeros(self.chunk_size, dtype=np.uint8))
        )

    def set_range(
        self, first_stripe: int, shard_bufs: Mapping[int, np.ndarray]
    ) -> None:
        """Install crcs for the stripes covered by ``shard_bufs`` (each a
        whole number of chunks starting at stripe ``first_stripe``).
        Holes below ``first_stripe`` (write past the old end) are chunks
        the store zero-fills, so they get the zero-chunk crc."""
        if sorted(shard_bufs) != list(range(self.num_shards)):
            raise ValueError(
                f"set_range covers shards {sorted(shard_bufs)}, "
                f"table tracks 0..{self.num_shards - 1}"
            )
        zc = self.zero_crc()
        for shard, buf in shard_bufs.items():
            row = self.crcs[shard]
            new = self._chunk_crcs(np.asarray(buf), self.chunk_size)
            if len(row) < first_stripe:
                row.extend([zc] * (first_stripe - len(row)))
            row[first_stripe : first_stripe + len(new)] = new

    def truncate_stripes(self, count: int) -> None:
        """Drop entries past ``count`` stripes; zero-extend up to it."""
        zc = self.zero_crc()
        for row in self.crcs:
            if len(row) > count:
                del row[count:]
            else:
                row.extend([zc] * (count - len(row)))

    def crc(self, shard: int, stripe: int) -> int:
        return self.crcs[shard][stripe]

    def verify(self, shard: int, first_stripe: int, buf: np.ndarray) -> bool:
        """Check a shard extent (whole chunks from ``first_stripe``)."""
        got = self._chunk_crcs(np.asarray(buf), self.chunk_size)
        row = self.crcs[shard]
        want = row[first_stripe : first_stripe + len(got)]
        if len(want) < len(got):
            # extent extends past the table: valid only if all-zero chunks
            want = want + [self.zero_crc()] * (len(got) - len(want))
        return got == want

    def to_dict(self) -> dict:
        return {"chunk_size": self.chunk_size, "crcs": [list(r) for r in self.crcs]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "StripeHashes":
        sh = cls(len(d["crcs"]), int(d["chunk_size"]))
        sh.crcs = [[int(c) for c in row] for row in d["crcs"]]
        return sh


# -- HashInfo ----------------------------------------------------------------


class HashInfo:
    """Cumulative per-shard crc32c over appended chunk data.

    Persisted as the ``hinfo_key`` xattr and verified on shard reads
    (reference:ECUtil.h:109-167; append at reference:ECUtil.cc:140).
    """

    XATTR_KEY = "hinfo_key"

    def __init__(self, num_chunks: int):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [CRC_SEED] * num_chunks

    def append(self, old_size: int, to_append: Mapping[int, np.ndarray]) -> None:
        if old_size != self.total_chunk_size:
            raise ValueError(
                f"append at {old_size} but total_chunk_size={self.total_chunk_size}"
            )
        if sorted(to_append) != list(range(len(self.cumulative_shard_hashes))):
            raise ValueError(
                f"append covers shards {sorted(to_append)} but HashInfo tracks "
                f"0..{len(self.cumulative_shard_hashes) - 1}"
            )
        sizes = {np.asarray(v).size for v in to_append.values()}
        if len(sizes) != 1:
            raise ValueError(f"unequal shard appends: {sizes}")
        for shard, data in to_append.items():
            self.cumulative_shard_hashes[shard] = native.crc32c(
                self.cumulative_shard_hashes[shard], np.asarray(data, dtype=np.uint8)
            )
        self.total_chunk_size += next(iter(sizes))

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def clear(self) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [
            CRC_SEED for _ in self.cumulative_shard_hashes
        ]

    # xattr (de)serialization — stable dict form, encoded by the ObjectStore
    def to_dict(self) -> dict:
        return {
            "total_chunk_size": self.total_chunk_size,
            "hashes": list(self.cumulative_shard_hashes),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "HashInfo":
        hi = cls(len(d["hashes"]))
        hi.total_chunk_size = int(d["total_chunk_size"])
        hi.cumulative_shard_hashes = [int(h) for h in d["hashes"]]
        return hi
