"""SHEC plugin: Shingled Erasure Code (k, m, c).

Counterpart of ``ceph_tpu/models/shec.py``.  Decode applies each solved
recovery matrix through a region engine cached with the solve, on the
codec's device.

Behavior mirror of reference:src/erasure-code/shec/ErasureCodeShec.{h,cc}:
the coding matrix is an RS-Vandermonde block with each parity row masked to
a "shingle" window (:477 shec_reedsolomon_coding_matrix) — the m rows are
split into two groups (m1,c1)/(m2,c2) chosen to minimize the recovery
-efficiency functional (:440 shec_calc_recovery_efficiency1), then entries
outside each row's wrap-around window are zeroed.

Because the code is not MDS, decode solves the survivors' row-span for the
wanted rows (GF.solve) instead of inverting a fixed k x k submatrix, and
``minimum_to_decode`` performs a real minimal-set computation (the analog
of shec_make_decoding_matrix's search, :547): survivors are ordered data
-first so the solver's pivot preference uses as few parity reads as the
span allows.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ..ops import matrices as mx
from ..ops.gf import gf
from ..ops.gf_torch import GFMatmul
from .base import ErasureCode, device_bytes, like_input
from .interface import ErasureCodeValidationError
from .matrix_codec import MatrixErasureCode, _apply
from .registry import ErasureCodePlugin, PLUGIN_VERSION

__erasure_code_version__ = PLUGIN_VERSION

DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8


def _recovery_efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """r_e1 functional from the reference (:440): average chunks read."""
    if m1 < c1 or m2 < c2:
        return float("inf")
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return float("inf")
    r_eff_k = [10**8] * k
    r_e1 = 0
    for m_i, c_i in ((m1, c1), (m2, c2)):
        for rr in range(m_i):
            start = (rr * k) // m_i % k
            end = ((rr + c_i) * k) // m_i % k
            width = ((rr + c_i) * k) // m_i - (rr * k) // m_i
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], width)
                cc = (cc + 1) % k
            r_e1 += width
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_matrix(k: int, m: int, c: int, w: int) -> np.ndarray:
    """Shingled coding matrix: RS-Vandermonde with windows zeroed."""
    # pick the best (m1, c1) split, as the reference's exhaustive search
    best = (float("inf"), None)
    for c1 in range(c // 2 + 1):
        for m1 in range(m + 1):
            c2, m2 = c - c1, m - m1
            if m1 < c1 or m2 < c2:
                continue
            if (m1 == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                continue
            r = _recovery_efficiency(k, m1, m2, c1, c2)
            if r < best[0]:
                best = (r, (m1, c1))
    if best[1] is None:
        raise ErasureCodeValidationError(
            f"no valid shingle split for k={k} m={m} c={c}"
        )
    m1, c1 = best[1]
    m2, c2 = m - m1, c - c1

    M = mx.rs_vandermonde(k, m, w)
    row = 0
    for m_i, c_i in ((m1, c1), (m2, c2)):
        for rr in range(m_i):
            end = (rr * k) // m_i % k
            start = ((rr + c_i) * k) // m_i % k
            cc = start
            while cc != end:
                M[row + rr, cc] = 0
                cc = (cc + 1) % k
        row += m_i
    return M


class ShecErasureCode(MatrixErasureCode):
    """Matrix codec with span-solve decode (non-MDS)."""

    def __init__(self, k: int, m: int, c: int, w: int, device=None):
        super().__init__(k, m, w, shec_matrix(k, m, c, w), device)
        self.c = c
        # (present, missing) -> (survivors in solve order, X or None, X's engine)
        self._solve_cache: dict[tuple, tuple] = {}

    # -- span solving --------------------------------------------------------

    def _generator_rows(self, rows: Sequence[int]) -> np.ndarray:
        out = np.zeros((len(rows), self.k), dtype=np.int64)
        for i, r in enumerate(rows):
            if r < self.k:
                out[i, r] = 1
            else:
                out[i] = self.matrix[r - self.k]
        return out

    def _solve(self, present: tuple[int, ...], missing: tuple[int, ...]):
        key = (present, missing)
        if key not in self._solve_cache:
            # data rows first: biases the solver toward identity pivots
            ordered = sorted(present, key=lambda r: (r >= self.k, r))
            X = gf(self.w).solve(
                self._generator_rows(ordered), self._generator_rows(missing)
            )
            engine = None if X is None else GFMatmul(X, self.w, self.device)
            self._solve_cache[key] = (tuple(ordered), X, engine)
        return self._solve_cache[key]

    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> list[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return sorted(want)
        missing = tuple(sorted(want - avail))
        ordered, X, _ = self._solve(tuple(sorted(avail)), missing)
        if X is None:
            raise IOError(
                f"cannot decode chunks {missing} from {sorted(avail)}"
            )
        used = {ordered[j] for j in range(len(ordered)) if np.any(X[:, j] != 0)}
        used |= want & avail
        return sorted(used)

    def decode_chunks(self, present: Sequence[int], chunks, missing: Sequence[int]):
        present = tuple(present)
        missing = tuple(missing)
        ordered, X, engine = self._solve(present, missing)
        if X is None:
            raise IOError(
                f"cannot decode chunks {missing} from {sorted(present)}"
            )
        order_idx = [list(present).index(r) for r in ordered]
        x, host = device_bytes(chunks, self.device)
        return like_input(_apply(engine, x[order_idx]), host)

    def decode_chunks_host(
        self, present: Sequence[int], chunks: np.ndarray, missing: Sequence[int]
    ) -> np.ndarray:
        """Host-engine reconstruct (osd/ec_failover): the SAME span
        solve as :meth:`decode_chunks`, applied without a device launch
        — the inherited MDS recovery-matrix oracle would be wrong for
        this non-MDS layout."""
        present = tuple(present)
        missing = tuple(missing)
        ordered, X, _ = self._solve(present, missing)
        if X is None:
            raise IOError(
                f"cannot decode chunks {missing} from {sorted(present)}"
            )
        order_idx = [list(present).index(r) for r in ordered]
        data = np.asarray(chunks, dtype=np.uint8)[order_idx]
        return self._host_matmul(X, data)


class ErasureCodePluginShec(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], device):
        k = ErasureCode.to_int("k", profile, DEFAULT_K, minimum=1)
        m = ErasureCode.to_int("m", profile, DEFAULT_M, minimum=1)
        c = ErasureCode.to_int("c", profile, DEFAULT_C, minimum=1)
        w = ErasureCode.to_int("w", profile, DEFAULT_W)
        if w not in (8, 16):
            raise ErasureCodeValidationError(f"shec supports w=8/16, got {w}")
        if c > m:
            raise ErasureCodeValidationError(f"shec requires c <= m (c={c}, m={m})")
        if k + m > (1 << w):
            raise ErasureCodeValidationError(f"k+m={k+m} exceeds 2^w")
        codec = ShecErasureCode(k, m, c, w, device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name: str, registry) -> None:
    registry.add(name, ErasureCodePluginShec())
