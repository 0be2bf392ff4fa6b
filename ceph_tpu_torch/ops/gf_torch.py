"""GF(2^w) region engines in torch: the plain versions and the routed
engines.

Counterpart of ``ceph_tpu/ops/gf_jax.py``.  Same arithmetic, the
doubling method: in GF(2^w), ``2*x`` is a masked shift plus a
conditional XOR of the field polynomial, and ``c*x`` is the XOR of
``2^b*x`` over the set bits b of c.  Chunk bytes are viewed as packed
32-bit lanes, 4 symbols (w=8) or 2 (w=16) per lane, byte-order
identical to the uint8 layout.

Lanes are carried as **int32**, not uint32: torch has no ``>>`` or
``<<`` for uint32 on the CPU.  That is exact here, because
``(x >> (w-1)) & high_unit`` masks away the sign extension and
``high_unit * poly`` stays positive (0x1d1d1d1d for w=8, 0x100b100b for
w=16).  The CUDA kernels take the same int32 tensors and read them as
uint32.

Routing (:class:`GFMatmul`, :class:`BitmatrixXor`): a tensor on the CPU
takes the plain version below; a tensor on CUDA takes the Hopper kernel
in ``gf_cuda`` or raises.  There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve
from . import gf_cuda
from .gf import PRIM_POLY

# packed-lane constants per w: (low-bits mask, high-bit units, reduction poly)
_PACK = {
    8: (0x7F7F7F7F, 0x01010101, PRIM_POLY[8] & 0xFF),
    16: (0x7FFF7FFF, 0x00010001, PRIM_POLY[16] & 0xFFFF),
}

LANE = torch.int32


def bytes_to_u32(a):
    """Free reinterpret of uint8 [..., N] (N % 4 == 0) as 32-bit lanes
    [..., N//4], carried as int32; numpy in -> numpy out, tensor in ->
    tensor out (a view either way)."""
    if a.shape[-1] % 4:
        raise ValueError(f"chunk length {a.shape[-1]} not a multiple of 4")
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.uint8:
            raise TypeError(f"GF region engines take uint8 data, got {a.dtype}")
        return a.contiguous().view(LANE)
    return np.ascontiguousarray(a, dtype=np.uint8).view(np.int32)


def u32_to_bytes(a):
    """Inverse of :func:`bytes_to_u32`."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8)
    return np.ascontiguousarray(a).view(np.uint8)


def gf_double_packed(x: torch.Tensor, w: int = 8) -> torch.Tensor:
    """x -> 2*x elementwise in GF(2^w), on int32-packed lanes."""
    mask_low, high_unit, poly = _PACK[w]
    high = (x >> (w - 1)) & high_unit
    return ((x & mask_low) << 1) ^ (high * poly)


def _row_plans(matrix: np.ndarray, w: int):
    """For each output row: list of (data_row, power_bit) XOR terms."""
    m, k = matrix.shape
    plans = []
    for i in range(m):
        terms = []
        for j in range(k):
            c = int(matrix[i, j])
            b = 0
            while c:
                if c & 1:
                    terms.append((j, b))
                c >>= 1
                b += 1
        plans.append(terms)
    return plans


def gf_matmul_u32(matrix: np.ndarray, d32: torch.Tensor, w: int = 8) -> torch.Tensor:
    """Plain version of the ``gf_matmul`` kernel: data [k, N4] lanes ->
    parity [m, N4].  Each input row is walked through its doubling chain
    once, up to its highest needed bit, and each power is XORed into the
    outputs whose coefficient has that bit set."""
    matrix = np.asarray(matrix)
    m, k = matrix.shape
    if d32.shape[0] != k:
        raise ValueError(f"expected {k} input rows, got {d32.shape[0]}")
    users: dict[tuple[int, int], list[int]] = {}
    for i, terms in enumerate(_row_plans(matrix, w)):
        for j, b in terms:
            users.setdefault((j, b), []).append(i)
    out = torch.zeros((m,) + tuple(d32.shape[1:]), dtype=d32.dtype, device=d32.device)
    for j in range(k):
        bits = [b for (jj, b) in users if jj == j]
        if not bits:
            continue
        cur = d32[j]
        for b in range(max(bits) + 1):
            if b:
                cur = gf_double_packed(cur, w)
            for i in users.get((j, b), ()):
                out[i] ^= cur
    return out


def xor_parity_u32(d32: torch.Tensor) -> torch.Tensor:
    """m=1 all-ones matrix: parity = XOR of the data rows (RAID-5).  A
    plain torch program on every device, as the reference's
    ``make_xor_parity_u32`` is an XLA program and no Pallas kernel."""
    rows = d32.unbind(0)
    return functools.reduce(torch.bitwise_xor, rows[1:], rows[0].clone())[None]


def bitmatrix_matmul_u32(bitmatrix: np.ndarray, p32: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``bitmatrix_xor`` kernel: packets [K, N4]
    lanes -> [M, N4], out[i] = XOR of the rows j with B[i, j] = 1.  Each
    input row is read once."""
    bm = np.asarray(bitmatrix) != 0
    M, K = bm.shape
    if p32.shape[0] != K:
        raise ValueError(f"expected {K} input rows, got {p32.shape[0]}")
    out = torch.zeros((M,) + tuple(p32.shape[1:]), dtype=p32.dtype, device=p32.device)
    for j in range(K):
        for i in np.nonzero(bm[:, j])[0]:
            out[i] ^= p32[j]
    return out


def _check_device(x: torch.Tensor, device: torch.device) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != LANE:
        raise TypeError("region engines take int32 lane tensors (bytes_to_u32)")
    if x.device != device:
        raise ValueError(f"lanes on {x.device}, engine on {device}")


class GFMatmul:
    """One [m, k] GF(2^w) matrix bound to a device: data [k, N4] lanes
    -> [m, N4].  On CUDA the matrix is packed and uploaded once, here,
    and every call launches the ``gf_matmul`` kernel.  An m=1 all-ones
    matrix takes :func:`xor_parity_u32` on every device."""

    def __init__(self, matrix: np.ndarray, w: int = 8, device=None):
        self.matrix = np.asarray(matrix, dtype=np.int64)
        self.m, self.k = self.matrix.shape
        self.w = w
        self.device = resolve(device)
        self.xor_only = self.m == 1 and bool(np.all(self.matrix == 1))
        self.table = None
        if self.device.type == "cuda" and not self.xor_only:
            self.table = gf_cuda.gf_table(self.matrix, w, self.device)

    def __call__(self, d32: torch.Tensor) -> torch.Tensor:
        _check_device(d32, self.device)
        if self.xor_only:
            return xor_parity_u32(d32)
        if d32.device.type == "cpu":
            return gf_matmul_u32(self.matrix, d32, self.w)
        return gf_cuda.gf_matmul(self.table, d32)


class BitmatrixXor:
    """One [M, K] GF(2) bit-matrix bound to a device: packets [K, N4]
    lanes -> [M, N4].  On CUDA the launch plans are packed once, here,
    and every call launches the ``bitmatrix_xor`` kernel."""

    def __init__(self, bitmatrix: np.ndarray, device=None):
        self.bitmatrix = np.asarray(bitmatrix, dtype=np.uint8)
        self.M, self.K = self.bitmatrix.shape
        self.device = resolve(device)
        self.table = None
        if self.device.type == "cuda":
            self.table = gf_cuda.bitmatrix_table(self.bitmatrix, self.device)

    def __call__(self, p32: torch.Tensor) -> torch.Tensor:
        _check_device(p32, self.device)
        if p32.device.type == "cpu":
            return bitmatrix_matmul_u32(self.bitmatrix, p32)
        return gf_cuda.bitmatrix_xor(self.table, p32)
