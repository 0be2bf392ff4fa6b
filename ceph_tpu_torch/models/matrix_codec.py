"""Matrix- and bitmatrix-based codecs over the GF region engines.

Counterpart of ``ceph_tpu/models/matrix_codec.py``.  Two concrete
engines shared by the jerasure/isa/lrc/shec plugins:

- :class:`MatrixErasureCode` — byte-wise GF(2^w) matmul codes
  (reed_sol_van / reed_sol_r6_op / ISA-L RS), the analog of
  jerasure_matrix_encode/decode (reference:src/erasure-code/jerasure/
  ErasureCodeJerasure.cc:175,183).
- :class:`BitmatrixErasureCode` — packet-XOR codes (cauchy_orig /
  cauchy_good / liberation family), the analog of
  jerasure_schedule_encode / jerasure_schedule_decode_lazy
  (reference:ErasureCodeJerasure.cc:279,288): each chunk is w packets of
  ``packetsize`` bytes (repeated in blocks); parity packets are XORs of
  data packets selected by the bit-matrix.

Every codec is bound to one device.  Its region engine (``ops.gf_torch``)
launches the Hopper kernel on CUDA and runs the plain torch version on
the CPU; encode and decode both stay on the codec's device.  The one
exception is the reference's native C lane: a w=8 matrix codec on the
CPU decodes host arrays through the port's native engine
(``utils.native``) when it loads.  Decode matrices are built on the host
by inverting the survivor submatrix and are cached, with their engines,
per erasure signature, mirroring the ISA-L table cache
(reference:src/erasure-code/isa/ErasureCodeIsaTableCache.cc:278-331).
The ``*_host`` methods compute the same bytes on the host (the native
engine, else the numpy oracle) and never touch a device: they are the
failover replay engine of ``osd.ec_failover``.

Every device entry reports into the kernel profiler (``ops.profiler``)
under the reference's engine names: ``gf_encode``, ``ec_shards``,
``gf_decode``, ``gf_decode_native``, ``bitmatrix_encode``,
``bitmatrix_decode``.
"""

from __future__ import annotations

import subprocess
from typing import Mapping, Sequence

import numpy as np
import torch

from ..ops import matrices as mx
from ..ops.gf import gf
from ..ops.gf_cuda import KernelBuildError, KernelLaunchError
from ..ops.gf_torch import BitmatrixXor, GFMatmul, bytes_to_u32, u32_to_bytes
from ..ops.profiler import profiler
from ..utils import native
from .base import ErasureCode, device_bytes, like_input
from .interface import ErasureCodeValidationError


def _apply(engine, x: torch.Tensor) -> torch.Tensor:
    """Run a lane engine over uint8 rows [n, C]: C is zero-padded to a
    whole lane (the columns are independent) and the pad cut off."""
    C = x.shape[-1]
    pad = -C % 4
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return u32_to_bytes(engine(bytes_to_u32(x)))[..., :C]


def _device_lanes(x, device: torch.device) -> tuple[torch.Tensor, bool]:
    """32-bit lanes (numpy uint32/int32, or an int32 tensor on
    ``device``) -> (int32 tensor on ``device``, whether host memory)."""
    if isinstance(x, torch.Tensor):
        return x, False
    arr = np.ascontiguousarray(x)
    if arr.dtype not in (np.uint32, np.int32):
        raise TypeError(f"lanes must be 32-bit, got {arr.dtype}")
    if not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy wants writable memory
    return torch.from_numpy(arr.view(np.int32)).to(device), True


def _mkey(matrix: np.ndarray) -> tuple:
    """A matrix as a hashable key (the profiler's call signature, and
    the reference's jit-cache key)."""
    return tuple(tuple(int(v) for v in row) for row in np.asarray(matrix))


def _check_survivors(present: tuple[int, ...], k: int) -> None:
    if len(present) < k:
        raise IOError(f"cannot decode: {len(present)} chunks available, need {k}")


# -- engine failure classification ---------------------------------------------
#
# A consumer that can replay a batch on the host engine must split "the
# DEVICE is broken" (replay, trip the breaker) from "the CALLER's data
# is broken" (surface the error: replaying garbage elsewhere only
# produces the same garbage slower).

# caller/data errors: shape mismatches, bad survivor sets ("cannot
# decode" IOErrors), bad profiles — deterministic on any engine
_DATA_ERRORS = (
    ValueError, TypeError, KeyError, IndexError, ZeroDivisionError,
    OSError, ErasureCodeValidationError, AssertionError,
)

class EngineFault(RuntimeError):
    """Fabricated device-lost error for the dispatcher's
    ``inject_engine_failure`` hook (classified fatal, like a real CUDA
    error)."""


# device-side faults whatever else they inherit from: a CUDA error
# surfaced by torch, a device allocation failure, this package's own
# kernel build and launch failures, and the injected fault
_FATAL_TYPES = tuple(
    t for t in (
        getattr(torch, "AcceleratorError", None),
        torch.OutOfMemoryError,
        KernelLaunchError,
        KernelBuildError,
        EngineFault,
    ) if t is not None
)


def classify_engine_error(exc: BaseException) -> str:
    """``"fatal"`` (device fault, CUDA error, OOM, kernel build or
    launch — the batch may replay on the host engine) or ``"data"``
    (caller error — surfaces to the waiter)."""
    if isinstance(exc, _FATAL_TYPES):
        return "fatal"
    if isinstance(exc, _DATA_ERRORS):
        return "data"
    # RuntimeError / MemoryError / SystemError and anything exotic: an
    # unknown error defaults to fatal, because the replay is safe
    # (bit-identical engines) while failing a client op on a transient
    # device fault is not
    return "fatal"


class MatrixErasureCode(ErasureCode):
    """Systematic code defined by an [m, k] GF(2^w) parity matrix."""

    def __init__(self, k: int, m: int, w: int, matrix: np.ndarray, device=None):
        super().__init__(device)
        self.k = k
        self.m = m
        self.w = w
        if w not in (8, 16):
            raise ErasureCodeValidationError(f"matrix codec supports w=8/16, got {w}")
        self.matrix = np.asarray(matrix, dtype=np.int64)
        if self.matrix.shape != (m, k):
            raise ErasureCodeValidationError(
                f"matrix shape {self.matrix.shape} != ({m}, {k})"
            )
        self._engine = GFMatmul(self.matrix, w, self.device)
        # profiler key, built ONCE: the encode hot path must not
        # re-serialize the matrix per op (it is immutable from here)
        self._mkey = _mkey(self.matrix)
        # (present, missing) -> (recovery matrix, its engine, its key)
        self._decode_cache: dict[tuple, tuple[np.ndarray, GFMatmul, tuple]] = {}

    def init(self, profile: Mapping[str, str]) -> None:
        self._profile = dict(profile)

    # -- encode -------------------------------------------------------------

    def encode_chunks(self, data_chunks):
        def run(data_chunks):
            x, host = device_bytes(data_chunks, self.device)
            return like_input(_apply(self._engine, x), host)

        shape = _shape(data_chunks)
        return profiler().call_jitted(
            "gf_encode", (self._mkey, shape), run, (data_chunks,),
            nbytes=_nbytes(data_chunks), shape=shape,
        )

    def encode_chunks_u32(self, d32):
        """Lane path ([k, N4] 32-bit lanes -> [m, N4]), for callers that
        keep the whole pipeline in lanes."""
        def run(d32):
            x, host = _device_lanes(d32, self.device)
            out = like_input(self._engine(x), host)
            return out.view(np.uint32) if host else out

        shape = _shape(d32)
        return profiler().call_jitted(
            "gf_encode", (self._mkey, shape), run, (d32,),
            nbytes=_nbytes(d32), shape=shape,
        )

    def encode_shards_u32(self, d3):
        """The OSD stack's entry: [S, k, C4] lanes in stripe order ->
        [k+m, S*C4] shard rows (data rows, then parity): a permute, the
        region engine and a concatenation."""
        def run(d3):
            x, host = _device_lanes(d3, self.device)
            S, k, C4 = x.shape
            flat = x.permute(1, 0, 2).reshape(k, S * C4)
            out = like_input(torch.cat([flat, self._engine(flat)], dim=0), host)
            return out.view(np.uint32) if host else out

        shape = _shape(d3)
        return profiler().call_jitted(
            "ec_shards", (self._mkey, shape), run, (d3,),
            nbytes=_nbytes(d3), shape=shape,
        )

    # -- host engine ----------------------------------------------------------

    def _host_matmul(self, matrix: np.ndarray, arr: np.ndarray) -> np.ndarray:
        """GF matmul on the host, no device involved: the native engine
        when it loads and the shape suits it (bit-identical to the
        tables, pinned by tests), else the numpy oracle every engine is
        pinned against."""
        if self.w == 8 and arr.shape[-1] % 8 == 0 and native.fits(*matrix.shape):
            try:
                return native.encode(matrix, arr)
            except (OSError, subprocess.CalledProcessError):
                pass  # library unbuildable here: the numpy oracle below
        G = gf(self.w)
        if self.w == 16:
            # bytes are pairs of native-endian GF(2^16) elements on the
            # lanes; reinterpret (free), multiply, reinterpret back
            out16 = G.matmul_region(matrix, arr.view(np.uint16))
            return np.ascontiguousarray(out16).view(np.uint8)
        return G.matmul_region(matrix, arr).astype(np.uint8)

    def encode_chunks_host(self, data_chunks: np.ndarray) -> np.ndarray:
        """Host-engine parity ([k, N] uint8 -> [m, N] uint8): same
        bytes as :meth:`encode_chunks`, no device launch."""
        arr = np.ascontiguousarray(np.asarray(data_chunks, dtype=np.uint8))
        return self._host_matmul(self.matrix, arr)

    def decode_chunks_host(
        self, present: Sequence[int], chunks: np.ndarray,
        missing: Sequence[int],
    ) -> np.ndarray:
        """Host-engine reconstruct: same recovery matrix (and cache) as
        :meth:`decode_chunks`, applied without a device launch."""
        present, missing = tuple(present), tuple(missing)
        _check_survivors(present, self.k)
        RM, _, _ = self._recovery_matrix(present, missing)
        arr = np.ascontiguousarray(np.asarray(chunks, dtype=np.uint8))
        return self._host_matmul(RM, arr)

    # -- decode -------------------------------------------------------------

    def _recovery_matrix(
        self, present: tuple[int, ...], missing: tuple[int, ...]
    ) -> tuple[np.ndarray, GFMatmul, tuple]:
        """([len(missing), len(present)] GF matrix rebuilding the missing
        rows, its engine on this codec's device, its profiler key),
        cached per erasure signature."""
        key = (present, missing)
        cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        G = gf(self.w)
        use = list(present)[: self.k]
        R = mx.decode_matrix(self.matrix, self.k, self.w, use)  # data = R @ surv
        rows = []
        for r in missing:
            if r < self.k:
                rows.append(R[r])
            else:
                rows.append(G.matmul(self.matrix[r - self.k][None, :], R)[0])
        RM = np.stack(rows)
        # widen to all present columns (zeros for unused survivors)
        if len(present) > self.k:
            full = np.zeros((len(missing), len(present)), dtype=np.int64)
            for c, p in enumerate(use):
                full[:, list(present).index(p)] = RM[:, c]
            RM = full
        entry = (RM, GFMatmul(RM, self.w, self.device), _mkey(RM))
        self._decode_cache[key] = entry
        return entry

    def decode_chunks(self, present: Sequence[int], chunks, missing: Sequence[int]):
        present, missing = tuple(present), tuple(missing)
        _check_survivors(present, self.k)
        RM, engine, rm_key = self._recovery_matrix(present, missing)
        shape = _shape(chunks)
        if (
            not isinstance(chunks, torch.Tensor)
            and self.w == 8 and shape[-1] % 8 == 0
            and type(self) is MatrixErasureCode
            and native.fits(*RM.shape)
            and native.host_engine_active(self.device)
        ):
            # a CPU codec: the native engine reconstructs with no copies
            # into torch (the same routing as the encode stack; bytes
            # identical, the GF algebra is exact)
            arr = np.asarray(chunks, dtype=np.uint8)
            with profiler().timed("gf_decode_native", (rm_key, shape),
                                  nbytes=arr.size, shape=shape,
                                  compiled=False):
                return native.encode(RM, arr)

        def run(chunks):
            x, host = device_bytes(chunks, self.device)
            return like_input(_apply(engine, x), host)

        return profiler().call_jitted(
            "gf_decode", (rm_key, shape), run, (chunks,),
            nbytes=_nbytes(chunks), shape=shape,
        )


class BitmatrixErasureCode(ErasureCode):
    """Packet-XOR code from an [m*w, k*w] GF(2) bit-matrix.

    ``packetsize`` must be a multiple of 4 (32-bit lanes); chunks are
    blocks of w*packetsize bytes.
    """

    def __init__(
        self, k: int, m: int, w: int, matrix: np.ndarray | None, packetsize: int,
        bitmatrix: np.ndarray | None = None, device=None,
    ):
        super().__init__(device)
        self.k = k
        self.m = m
        self.w = w
        if packetsize <= 0 or packetsize % 4 != 0:
            raise ErasureCodeValidationError(
                f"packetsize must be a positive multiple of 4, got {packetsize}"
            )
        self.packetsize = packetsize
        self.matrix = None if matrix is None else np.asarray(matrix, dtype=np.int64)
        if bitmatrix is not None:
            self.bitmatrix = np.asarray(bitmatrix, dtype=np.uint8)
        else:
            self.bitmatrix = gf(w).matrix_to_bitmatrix(self.matrix)
        if self.bitmatrix.shape != (m * w, k * w):
            raise ErasureCodeValidationError(
                f"bitmatrix shape {self.bitmatrix.shape} != ({m * w}, {k * w})"
            )
        self._engine = BitmatrixXor(self.bitmatrix, self.device)
        # profiler key bytes, serialized once (immutable from here)
        self._bm_key = self.bitmatrix.tobytes()
        # (present, missing) -> (recovery bitmatrix, its engine, its key)
        self._decode_cache: dict[tuple, tuple[np.ndarray, BitmatrixXor, bytes]] = {}

    def init(self, profile: Mapping[str, str]) -> None:
        self._profile = dict(profile)

    def get_alignment(self) -> int:
        return self.w * self.packetsize

    def batch_alignment(self) -> int:
        return self.w * self.packetsize

    # -- packet layout: [n, C] -> [n*w, B*ps] (numpy or torch alike) ---------

    def _to_packets(self, chunks):
        n, C = chunks.shape
        wps = self.w * self.packetsize
        if C % wps != 0:
            raise ErasureCodeValidationError(
                f"chunk size {C} not a multiple of w*packetsize={wps}"
            )
        B = C // wps
        x = chunks.reshape(n, B, self.w, self.packetsize).swapaxes(1, 2)
        return x.reshape(n * self.w, B * self.packetsize)

    def _from_packets(self, packets, n: int):
        nw, BP = packets.shape
        if nw != n * self.w:
            raise ValueError(f"{nw} packet rows for {n} chunks of w={self.w}")
        B = BP // self.packetsize
        x = packets.reshape(n, self.w, B, self.packetsize).swapaxes(1, 2)
        return x.reshape(n, B * self.w * self.packetsize)

    # -- encode / decode ------------------------------------------------------

    def _packet_shape(self, chunks) -> tuple[int, int]:
        n, C = _shape(chunks)
        return n * self.w, C // self.w

    def encode_chunks(self, data_chunks):
        def run(data_chunks):
            x, host = device_bytes(data_chunks, self.device)
            out = _apply(self._engine, self._to_packets(x))
            return like_input(self._from_packets(out, self.m), host)

        shape = self._packet_shape(data_chunks)
        return profiler().call_jitted(
            "bitmatrix_encode", (self._bm_key, shape), run, (data_chunks,),
            nbytes=_nbytes(data_chunks), shape=shape,
        )

    # -- host engine ----------------------------------------------------------

    @staticmethod
    def _host_bitmatmul(bm: np.ndarray, pk: np.ndarray) -> np.ndarray:
        """Packet XOR selected by the bit-matrix, on the host."""
        out = np.zeros((bm.shape[0],) + pk.shape[1:], dtype=np.uint8)
        for r in range(bm.shape[0]):
            rows = np.nonzero(bm[r])[0]
            if rows.size:
                out[r] = np.bitwise_xor.reduce(pk[rows], axis=0)
        return out

    def encode_chunks_host(self, data_chunks: np.ndarray) -> np.ndarray:
        """Host-engine parity: same bytes as :meth:`encode_chunks`, no
        device launch."""
        pk = self._to_packets(np.asarray(data_chunks, dtype=np.uint8))
        return self._from_packets(self._host_bitmatmul(self.bitmatrix, pk), self.m)

    def decode_chunks_host(
        self, present: Sequence[int], chunks: np.ndarray,
        missing: Sequence[int],
    ) -> np.ndarray:
        """Host-engine reconstruct via the same cached recovery
        bitmatrix as :meth:`decode_chunks`."""
        present, missing = tuple(present), tuple(missing)
        _check_survivors(present, self.k)
        RM, _, _ = self._recovery_bitmatrix(present, missing)
        pk = self._to_packets(np.asarray(chunks, dtype=np.uint8))
        return self._from_packets(self._host_bitmatmul(RM, pk), len(missing))

    def _recovery_bitmatrix(
        self, present: tuple[int, ...], missing: tuple[int, ...]
    ) -> tuple[np.ndarray, BitmatrixXor, bytes]:
        key = (present, missing)
        cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        w = self.w
        # Build survivor generator bitmatrix [len(present)*w, k*w] and invert
        # the GF(2) system for the first k survivors, matching
        # jerasure_schedule_decode_lazy's bitmatrix inversion.
        use = list(present)[: self.k]
        rows = []
        eye = np.eye(self.k * w, dtype=np.uint8)
        for r in use:
            if r < self.k:
                rows.append(eye[r * w : (r + 1) * w])
            else:
                rows.append(self.bitmatrix[(r - self.k) * w : (r - self.k + 1) * w])
        Gb = np.concatenate(rows, axis=0)  # [k*w, k*w]
        Rb = _gf2_invert(Gb)  # data_bits = Rb @ survivor_bits
        out_rows = []
        for r in missing:
            if r < self.k:
                out_rows.append(Rb[r * w : (r + 1) * w])
            else:
                pr = self.bitmatrix[(r - self.k) * w : (r - self.k + 1) * w]
                out_rows.append((pr.astype(np.int64) @ Rb.astype(np.int64)) % 2)
        RM = np.concatenate(out_rows, axis=0).astype(np.uint8)  # [|miss|*w, k*w]
        # widen to all present packet-columns
        if len(present) > self.k:
            full = np.zeros((RM.shape[0], len(present) * w), dtype=np.uint8)
            for c, p in enumerate(use):
                idx = list(present).index(p)
                full[:, idx * w : (idx + 1) * w] = RM[:, c * w : (c + 1) * w]
            RM = full
        entry = (RM, BitmatrixXor(RM, self.device), RM.tobytes())
        self._decode_cache[key] = entry
        return entry

    def decode_chunks(self, present: Sequence[int], chunks, missing: Sequence[int]):
        present, missing = tuple(present), tuple(missing)
        _check_survivors(present, self.k)
        _, engine, rm_key = self._recovery_bitmatrix(present, missing)

        def run(chunks):
            x, host = device_bytes(chunks, self.device)
            out = _apply(engine, self._to_packets(x))
            return like_input(self._from_packets(out, len(missing)), host)

        shape = self._packet_shape(chunks)
        return profiler().call_jitted(
            "bitmatrix_decode", (rm_key, shape), run, (chunks,),
            nbytes=_nbytes(chunks), shape=shape,
        )


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _nbytes(x) -> int:
    """Bytes of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def _gf2_invert(M: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2) (uint8 0/1)."""
    M = M.astype(np.uint8).copy()
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError(f"not square: {M.shape}")
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if M[r, col]:
                piv = r
                break
        if piv is None:
            raise ValueError("singular bitmatrix over GF(2)")
        if piv != col:
            M[[col, piv]] = M[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        mask = M[:, col].copy()
        mask[col] = 0
        rows = np.nonzero(mask)[0]
        M[rows] ^= M[col]
        inv[rows] ^= inv[col]
    return inv
