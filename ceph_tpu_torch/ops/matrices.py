"""Coding-matrix constructions over GF(2^w).

The port's own copy of ``ceph_tpu/ops/matrices.py``.

Host-side (numpy) re-implementations of the matrix generators the reference's
plugins get from the jerasure / ISA-L native libraries:

- Reed-Solomon Vandermonde (systematic, first parity row all-ones) —
  reference:src/erasure-code/jerasure/ErasureCodeJerasure.cc:216
  (``reed_sol_vandermonde_coding_matrix``), algorithm per Plank & Ding,
  "Note: Correction to the 1997 Tutorial on Reed-Solomon Coding": build an
  extended Vandermonde matrix, systematize with elementary *column*
  operations (which preserve the any-k-rows-invertible MDS property), then
  normalize the first parity row to all ones.
- RAID-6 optimized (P = XOR, Q = powers of 2) —
  reference:ErasureCodeJerasure.cc reed_sol_r6_op technique.
- Cauchy original / cauchy good —
  reference:ErasureCodeJerasure.cc:329,339; element (i,j) = 1/(i xor (m+j)),
  "good" variant rescales rows/columns to minimize bit-matrix ones
  (jerasure cauchy.c ``improve_coding_matrix``).
- ISA-L style matrices (gf_gen_rs_matrix / gf_gen_cauchy1_matrix) —
  reference:src/erasure-code/isa/ErasureCodeIsa.cc:409-412.

All return numpy int64 [m, k] arrays of field elements (the bottom, parity
part of the distribution matrix; data rows are implicitly the identity).
"""

from __future__ import annotations

import numpy as np

from .gf import gf


def extended_vandermonde(rows: int, cols: int, w: int) -> np.ndarray:
    """(rows x cols) extended Vandermonde: e0 / powers / e_{cols-1} rows."""
    G = gf(w)
    if rows > G.size or cols > G.size:
        raise ValueError("rows/cols exceed field size")
    V = np.zeros((rows, cols), dtype=np.int64)
    V[0, 0] = 1
    if rows == 1:
        return V
    V[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        v = 1
        for j in range(cols):
            V[i, j] = v
            v = G.mul(v, i)
    return V


def rs_vandermonde(k: int, m: int, w: int) -> np.ndarray:
    """Systematic RS-Vandermonde parity matrix [m, k]; row 0 is all ones.

    Column operations preserve invertibility of every k-row submatrix of the
    (k+m) x k distribution matrix; per-row scaling likewise, so the final
    [I ; P·diag(c)] is MDS with P[0] = ones (XOR-parity fast path for m=1).
    """
    G = gf(w)
    rows, cols = k + m, k
    D = extended_vandermonde(rows, cols, w)

    for i in range(1, cols):
        # pivot search among rows >= i, swap into place
        piv = None
        for r in range(i, rows):
            if D[r, i] != 0:
                piv = r
                break
        if piv is None:
            raise ValueError("cannot systematize vandermonde matrix")
        if piv != i:
            D[[i, piv]] = D[[piv, i]]
        # scale column i so (i, i) == 1
        if D[i, i] != 1:
            t = G.inv(int(D[i, i]))
            for r in range(rows):
                D[r, i] = G.mul(int(D[r, i]), t)
        # column j ^= (i, j) * column i, zeroing row i off-diagonal
        for j in range(cols):
            t = int(D[i, j])
            if j != i and t != 0:
                for r in range(rows):
                    D[r, j] ^= G.mul(t, int(D[r, i]))

    P = D[k:, :].copy()
    # normalize first parity row to all ones (entries of an MDS parity block
    # are never zero, so division is safe)
    for j in range(cols):
        c = int(P[0, j])
        if c == 0:
            raise ValueError("MDS violation: zero in parity block")
        if c != 1:
            t = G.inv(c)
            for r in range(m):
                P[r, j] = G.mul(int(P[r, j]), t)
    return P


def rs_r6(k: int, w: int) -> np.ndarray:
    """RAID-6 P/Q matrix: row0 = ones, row1 = powers of 2."""
    G = gf(w)
    M = np.zeros((2, k), dtype=np.int64)
    M[0, :] = 1
    v = 1
    for j in range(k):
        M[1, j] = v
        v = G.mul(v, 2)
    return M


def cauchy_original(k: int, m: int, w: int) -> np.ndarray:
    """matrix[i][j] = 1 / (i xor (m + j)) over GF(2^w)."""
    G = gf(w)
    if k + m > G.size:
        raise ValueError("k+m exceeds field size for cauchy matrix")
    M = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            M[i, j] = G.inv(i ^ (m + j))
    return M


def cauchy_good(k: int, m: int, w: int) -> np.ndarray:
    """Cauchy matrix rescaled to minimize ones in its bit-matrix.

    Mirrors jerasure cauchy.c ``improve_coding_matrix``: divide each column
    by its row-0 element (row 0 becomes all ones), then for each later row
    greedily try dividing the whole row by each of its elements, keeping the
    scaling that minimizes the total bit-matrix popcount.
    """
    G = gf(w)
    M = cauchy_original(k, m, w)
    # step 1: row 0 -> all ones via column scaling
    for j in range(k):
        c = int(M[0, j])
        if c != 1:
            t = G.inv(c)
            for i in range(m):
                M[i, j] = G.mul(int(M[i, j]), t)
    # step 2: per-row greedy rescale minimizing bitmatrix ones
    for i in range(1, m):
        best = sum(G.n_ones(int(M[i, j])) for j in range(k))
        for j in range(k):
            c = int(M[i, j])
            if c == 1:
                continue
            t = G.inv(c)
            cnt = sum(G.n_ones(G.mul(int(M[i, x]), t)) for x in range(k))
            if cnt < best:
                best = cnt
                for x in range(k):
                    M[i, x] = G.mul(int(M[i, x]), t)
    return M


def isa_rs_vandermonde(k: int, m: int, w: int = 8) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix parity block: row r, col j = (2^r)^j.

    This power-series construction is only MDS inside a safety envelope;
    the reference clamps parameters for the same reason
    (reference:src/erasure-code/isa/ErasureCodeIsa.cc technique selection).
    """
    G = gf(w)
    if m > 4 or (m == 4 and k > 21) or k > 32:
        raise ValueError(
            f"isa_rs_vandermonde is not MDS for k={k}, m={m}; "
            "use m<=3 (k<=32) or m=4 (k<=21), or the cauchy matrix"
        )
    M = np.zeros((m, k), dtype=np.int64)
    gen = 1
    for r in range(m):
        p = 1
        for j in range(k):
            M[r, j] = p
            p = G.mul(p, gen)
        gen = G.mul(gen, 2)
    return M


def isa_cauchy(k: int, m: int, w: int = 8) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix parity block: row r, col j = 1/((k+r)^j)."""
    G = gf(w)
    if k + m > G.size:
        raise ValueError("k+m exceeds field size for cauchy matrix")
    M = np.zeros((m, k), dtype=np.int64)
    for r in range(m):
        for j in range(k):
            M[r, j] = G.inv((k + r) ^ j)
    return M


def decode_matrix(
    parity: np.ndarray, k: int, w: int, present_rows: list[int]
) -> np.ndarray:
    """Inverse of the k x k generator submatrix for the given surviving rows.

    ``present_rows`` lists k row indices of the (k+m) distribution matrix
    (0..k-1 = data rows, k.. = parity rows).  The returned [k, k] matrix R
    satisfies: data = R @ survivors (GF matmul), mirroring
    jerasure_matrix_decode's submatrix inversion.
    """
    G = gf(w)
    if len(present_rows) != k:
        raise ValueError(
            f"need exactly k={k} surviving rows to decode, got {len(present_rows)}"
        )
    sub = np.zeros((k, k), dtype=np.int64)
    for r, row in enumerate(present_rows):
        if row < k:
            sub[r, row] = 1
        else:
            sub[r, :] = parity[row - k, :]
    return G.invert_matrix(sub)
