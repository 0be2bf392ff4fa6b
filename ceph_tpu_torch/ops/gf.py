"""GF(2^w) arithmetic — numpy CPU reference implementation.

The port's own copy of ``ceph_tpu/ops/gf.py`` (the port imports nothing
of ``ceph_tpu``).  It is the bit-exact oracle for the region engines in
``gf_torch.py`` (plain torch) and ``gf_cuda.py`` (Hopper kernels), and
the host engine of the codecs' ``*_host`` methods.  It plays the role gf-complete plays for the reference
(reference:src/erasure-code/jerasure/ErasureCodeJerasure.cc:22-28 includes
``galois.h``): single-element multiply/divide, region ops, and small dense
matrix algebra over GF(2^w) used to build and invert coding matrices.

Field polynomials match gf-complete's defaults so coding matrices (and hence
parity bytes) agree with the reference's jerasure/ISA-L plugins:

- w=4  : x^4+x+1                    (0x13)
- w=8  : x^8+x^4+x^3+x^2+1          (0x11d)   — also ISA-L's field
- w=16 : x^16+x^12+x^3+x+1          (0x1100b)
- w=32 : x^32+x^22+x^2+x+1          (0x400007) [carryless; tables not built]

Everything here is host-side, tiny (matrices are k+m <= ~20 square), and
numpy-vectorized where it matters (region ops used by tests/corpus).
"""

from __future__ import annotations

import functools

import numpy as np

# gf-complete default primitive polynomials (low bits, implicit leading 1).
PRIM_POLY = {4: 0x13, 8: 0x11D, 16: 0x1100B, 32: 0x400007}

# dtypes able to hold one field element per lane
_DTYPE = {4: np.uint8, 8: np.uint8, 16: np.uint16, 32: np.uint32}


class GF:
    """Tables + scalar/matrix ops for GF(2^w), w in {4, 8, 16}.

    For w=32 use :func:`gf32_mul` (carryless, no tables).
    """

    def __init__(self, w: int):
        if w not in (4, 8, 16):
            raise ValueError(f"GF tables only for w in 4/8/16, got {w}")
        self.w = w
        self.size = 1 << w
        self.poly = PRIM_POLY[w]
        self.dtype = _DTYPE[w]
        # Build log/antilog tables with generator x (=2), primitive for all
        # the polynomials above.
        size = self.size
        self.exp = np.zeros(2 * size, dtype=np.int64)  # doubled to skip mod
        self.log = np.zeros(size, dtype=np.int64)
        v = 1
        for i in range(size - 1):
            self.exp[i] = v
            self.log[v] = i
            v <<= 1
            if v & size:
                v ^= self.poly | size  # reduce by full polynomial
        self.exp[size - 1 : 2 * size - 2] = self.exp[: size - 1]
        # poison: any exp[log[0] + log[b]] is out of range -> IndexError
        # (positive sentinel; a negative one would wrap via numpy indexing)
        self.log[0] = 4 * size

        # Full multiplication table for w<=8 (256*256 = 64KiB) — used by the
        # region oracle and to build per-matrix-cell lookup tables (mirrors
        # ISA-L ec_init_tables, reference:src/erasure-code/isa/ErasureCodeIsa.cc:427).
        if w <= 8:
            a = np.arange(size)
            la = self.log[a]
            self.mul_table = np.zeros((size, size), dtype=self.dtype)
            self.mul_table[1:, 1:] = self.exp[
                (la[1:, None] + la[None, 1:])
            ].astype(self.dtype)
        else:
            self.mul_table = None

    # -- scalar ops ---------------------------------------------------------

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def div(self, a: int, b: int) -> int:
        if b == 0:
            raise ZeroDivisionError("GF division by zero")
        if a == 0:
            return 0
        return int(self.exp[self.log[a] - self.log[b] + (self.size - 1)])

    def inv(self, a: int) -> int:
        return self.div(1, a)

    def pow(self, a: int, n: int) -> int:
        if n == 0:
            return 1
        if a == 0:
            return 0
        return int(self.exp[(self.log[a] * n) % (self.size - 1)])

    # -- region ops (numpy-vectorized; the CPU parity oracle) --------------

    def mul_region(self, region: np.ndarray, c: int) -> np.ndarray:
        """Multiply every element of `region` (dtype matching w) by scalar c."""
        region = np.asarray(region, dtype=self.dtype)
        if c == 0:
            return np.zeros_like(region)
        if c == 1:
            return region.copy()
        if self.mul_table is not None:
            return self.mul_table[c][region]
        lc = self.log[c]
        out = np.zeros_like(region)
        nz = region != 0
        out[nz] = self.exp[self.log[region[nz]] + lc].astype(self.dtype)
        return out

    def matmul_region(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        """[m,k] GF matrix  x  [k,n] element rows -> [m,n].

        The CPU reference for encode_chunks: data rows are chunks, output rows
        are parity chunks (reference:src/erasure-code/jerasure/
        ErasureCodeJerasure.cc:175 jerasure_matrix_encode semantics).
        """
        matrix = np.asarray(matrix)
        data = np.asarray(data, dtype=self.dtype)
        m, k = matrix.shape
        assert data.shape[0] == k
        out = np.zeros((m,) + data.shape[1:], dtype=self.dtype)
        for i in range(m):
            acc = np.zeros(data.shape[1:], dtype=self.dtype)
            for j in range(k):
                acc ^= self.mul_region(data[j], int(matrix[i, j]))
            out[i] = acc
        return out

    # -- matrix algebra (host-side, tiny) ----------------------------------

    def matmul(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        A = np.asarray(A)
        B = np.asarray(B)
        out = np.zeros((A.shape[0], B.shape[1]), dtype=np.int64)
        for i in range(A.shape[0]):
            for j in range(B.shape[1]):
                acc = 0
                for t in range(A.shape[1]):
                    acc ^= self.mul(int(A[i, t]), int(B[t, j]))
                out[i, j] = acc
        return out

    def invert_matrix(self, M: np.ndarray) -> np.ndarray:
        """Gauss-Jordan inversion over GF(2^w).

        Mirrors jerasure_invert_matrix (used by the reference decode path,
        reference:src/erasure-code/shec/ErasureCodeShec.cc:769).  Raises
        ValueError on singular input.
        """
        M = np.array(M, dtype=np.int64)
        n = M.shape[0]
        assert M.shape == (n, n)
        inv = np.eye(n, dtype=np.int64)
        for col in range(n):
            # find pivot
            piv = None
            for r in range(col, n):
                if M[r, col] != 0:
                    piv = r
                    break
            if piv is None:
                raise ValueError("singular matrix over GF(2^w)")
            if piv != col:
                M[[col, piv]] = M[[piv, col]]
                inv[[col, piv]] = inv[[piv, col]]
            # scale pivot row to 1
            pv = int(M[col, col])
            if pv != 1:
                pinv = self.inv(pv)
                for j in range(n):
                    M[col, j] = self.mul(int(M[col, j]), pinv)
                    inv[col, j] = self.mul(int(inv[col, j]), pinv)
            # eliminate other rows
            for r in range(n):
                if r == col or M[r, col] == 0:
                    continue
                f = int(M[r, col])
                for j in range(n):
                    M[r, j] ^= self.mul(f, int(M[col, j]))
                    inv[r, j] ^= self.mul(f, int(inv[col, j]))
        return inv

    def solve(self, A: np.ndarray, T: np.ndarray) -> np.ndarray | None:
        """Solve X @ A = T over GF(2^w); None if inconsistent.

        A: [a, k] (rows spanning), T: [t, k].  Returns X [t, a] with free
        variables set to 0 and pivots preferred in *earlier* rows of A (so
        callers can bias which rows get used by ordering A).  This is the
        engine behind non-MDS decode (SHEC's decoding-matrix search,
        reference:src/erasure-code/shec/ErasureCodeShec.cc:547).
        """
        A = np.asarray(A, dtype=np.int64)
        T = np.asarray(T, dtype=np.int64)
        a, k = A.shape
        t = T.shape[0]
        assert T.shape[1] == k
        # Gaussian elimination on [A^T | T^T]: k rows, a+t cols
        M = np.concatenate([A.T, T.T], axis=1).astype(np.int64)
        pivots: list[tuple[int, int]] = []  # (row_of_M, col<a)
        row = 0
        for col in range(a):
            if row >= k:
                break
            piv = None
            for r in range(row, k):
                if M[r, col] != 0:
                    piv = r
                    break
            if piv is None:
                continue
            if piv != row:
                M[[row, piv]] = M[[piv, row]]
            pv = int(M[row, col])
            if pv != 1:
                pinv = self.inv(pv)
                for j in range(col, a + t):
                    M[row, j] = self.mul(int(M[row, j]), pinv)
            for r in range(k):
                if r != row and M[r, col] != 0:
                    f = int(M[r, col])
                    for j in range(col, a + t):
                        M[r, j] ^= self.mul(f, int(M[row, j]))
            pivots.append((row, col))
            row += 1
        # consistency: rows of M beyond the pivot rows must have zero target
        for r in range(row, k):
            if np.any(M[r, a:] != 0):
                return None
        X = np.zeros((t, a), dtype=np.int64)
        for prow, pcol in pivots:
            for j in range(t):
                X[j, pcol] = M[prow, a + j]
        return X

    # -- bit-matrix support (cauchy/liberation family) ----------------------

    def bitmatrix_of(self, c: int) -> np.ndarray:
        """w x w GF(2) matrix of multiply-by-c; column j = bits of c*x^j.

        Matches jerasure_matrix_to_bitmatrix's per-cell expansion: the j-th
        column is the binary representation of c * 2^j.
        """
        w = self.w
        out = np.zeros((w, w), dtype=np.uint8)
        v = c
        for j in range(w):
            for i in range(w):
                out[i, j] = (v >> i) & 1
            v = self.mul(v, 2)
        return out

    def n_ones(self, c: int) -> int:
        """Number of ones in the bit-matrix of multiply-by-c (cauchy_n_ones)."""
        w = self.w
        total = 0
        v = c
        for _ in range(w):
            total += bin(v).count("1")
            v = self.mul(v, 2)
        return total

    def matrix_to_bitmatrix(self, matrix: np.ndarray) -> np.ndarray:
        """[m,k] GF matrix -> [m*w, k*w] GF(2) bit-matrix (jerasure layout)."""
        matrix = np.asarray(matrix)
        m, k = matrix.shape
        w = self.w
        out = np.zeros((m * w, k * w), dtype=np.uint8)
        for i in range(m):
            for j in range(k):
                out[i * w : (i + 1) * w, j * w : (j + 1) * w] = self.bitmatrix_of(
                    int(matrix[i, j])
                )
        return out


@functools.lru_cache(maxsize=None)
def gf(w: int) -> GF:
    """Cached field context."""
    return GF(w)


def gf32_mul(a: int, b: int) -> int:
    """Carryless multiply + reduce for GF(2^32) (no tables)."""
    r = 0
    a &= 0xFFFFFFFF
    b &= 0xFFFFFFFF
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & (1 << 32):
            a ^= PRIM_POLY[32] | (1 << 32)
    return r
