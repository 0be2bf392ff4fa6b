"""jerasure-equivalent plugin: the reference's 7 techniques.

Counterpart of ``ceph_tpu/models/jerasure.py``; codecs run on the device
the registry hands to the factory.

Mirrors reference:src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}:
profile parsing (k/m/w/packetsize, :75), per-technique construction:

- ``reed_sol_van``   (:91)  — systematic RS-Vandermonde, byte-wise GF matmul
- ``reed_sol_r6_op`` (:121) — RAID-6 P/Q (m forced to 2)
- ``cauchy_orig``    (:188) — Cauchy bit-matrix, packet XOR schedule
- ``cauchy_good``    (:197) — ones-minimized Cauchy bit-matrix
- ``liberation``     (:206) — minimal-density RAID-6 bit-matrix (w prime)
- ``blaum_roth``     (:243) — m=2 bit-matrix code (w+1 prime)
- ``liber8tion``     (:254) — m=2, w=8 bit-matrix code

``blaum_roth`` and ``liberation`` are the real published constructions
(ring multiplication matrices over F2[x]/M_p, Blaum & Roth 1999;
rotation + single-excess-bit matrices, Plank FAST'08) — both are
PAPER-PINNED: tests/test_paper_pins.py re-derives the bit-matrices with
independent plain-python ring arithmetic, checks encode end-to-end
through the packet layout, verifies the minimal-density bound, and
proves the MDS property for every 2-erasure (the jerasure C itself is
not available in this tree — submodule not checked out — so byte-level
pinning against it is impossible here; the math is pinned instead).
``liber8tion`` is a same-property reconstruction: the original's
bit-matrices exist only as a search-found table in Plank's paper /
jerasure C (w=8 admits no closed form — rotation-based minimal-density
sets provably fail for rotation pairs differing by 4, which is why
Plank needed a search), and neither is reachable from this tree
(submodule absent, zero egress).  So the table here is our OWN
deterministic exhaustive search result (tools/search_liber8tion.py)
with the paper's full defining property set: m=2, w=8, k<=8, MDS for
every double failure, and MINIMUM DENSITY — exactly kw + k - 1 ones in
the Q row (71 for k=8), the bound the Liber8tion paper exists to hit.
Same geometry, same XOR-schedule execution, same fault tolerance, same
XOR count per coding word; only the parity bytes differ from
jerasure's table (tests/test_paper_pins.py verifies density + MDS).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..ops import matrices as mx
from .base import ErasureCode
from .interface import ErasureCodeValidationError
from .matrix_codec import BitmatrixErasureCode, MatrixErasureCode
from .registry import ErasureCodePlugin, PLUGIN_VERSION

__erasure_code_version__ = PLUGIN_VERSION

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8
DEFAULT_PACKETSIZE = 2048


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n**0.5) + 1):
        if n % p == 0:
            return False
    return True


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Minimal-density liberation RAID-6 bit-matrix (Plank, FAST'08).

    P-blocks are identities; Q-block for data column j is the rotation-by-j
    permutation plus, for j > 0, one extra bit at row i = j(w-1)/2 mod w,
    column (i + j - 1) mod w (jerasure liberation.c layout).
    """
    if not _is_prime(w) or w <= 2:
        raise ErasureCodeValidationError(f"liberation requires prime w > 2, got w={w}")
    if k > w:
        raise ErasureCodeValidationError(f"liberation requires k <= w, got k={k} w={w}")
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        for i in range(w):
            bm[i, j * w + i] = 1  # P: identity blocks
            bm[w + i, j * w + (j + i) % w] = 1  # Q: rotation by j
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            bm[w + i, j * w + (i + j - 1) % w] = 1
    return bm


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth minimal-density RAID-6 bit-matrix (Blaum & Roth, "On
    Lowest Density MDS Codes", IEEE Trans. IT 1999; the construction
    behind jerasure's blaum_roth technique,
    reference:src/erasure-code/jerasure/ErasureCodeJerasure.cc:482).

    Arithmetic is in the ring R_p = F2[x] / M_p(x) with p = w + 1 prime
    and M_p(x) = 1 + x + ... + x^w.  Data device j's w bits are the
    coefficients of a polynomial D_j; P = sum_j D_j (identity blocks) and
    Q = sum_j x^j * D_j, so the Q block for device j is the
    multiplication-by-x^j matrix over the basis {1, x, .., x^{w-1}} with
    the reduction x^w = 1 + x + ... + x^{w-1}.  MDS for k <= w.
    """
    if not _is_prime(w + 1):
        raise ErasureCodeValidationError(
            f"blaum_roth requires w+1 prime, got w={w}"
        )
    if w > 32:
        # the bit-matrix is O(k*w^2): an absurd profile w must not turn
        # into a multi-GB allocation (jerasure's usable range is w <= 32)
        raise ErasureCodeValidationError(
            f"blaum_roth requires w <= 32, got w={w}"
        )
    if k > w:
        raise ErasureCodeValidationError(
            f"blaum_roth requires k <= w, got k={k} w={w}"
        )
    # powers of x mod M_p as coefficient vectors, up to x^(2w-2)
    pows = np.zeros((2 * w - 1, w), dtype=np.uint8)
    pows[0, 0] = 1
    for t in range(1, 2 * w - 1):
        prev = pows[t - 1]
        cur = np.zeros(w, dtype=np.uint8)
        cur[1:] = prev[:-1]
        if prev[w - 1]:  # overflow: x^w = 1 + x + ... + x^{w-1}
            cur ^= 1
        pows[t] = cur
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        for c in range(w):
            bm[0:w, j * w + c][c] = 1          # P: identity blocks
            bm[w : 2 * w, j * w + c] = pows[j + c]  # Q: coeffs of x^(j+c)
    return bm


# Minimum-density RAID-6 X-matrices for w=8 (see module docstring): row
# r of X_j is the byte LIBER8TION_X[j][r], bit c set <=> X_j[r, c] = 1.
# X_0 = I; X_1..X_7 are permutation + one excess bit, so any k <= 8
# prefix carries exactly kw + k - 1 ones — the Blaum-Roth lower bound.
# Found by tools/search_liber8tion.py (deterministic: first solution in
# conjugacy-representative order); MDS + density pinned in
# tests/test_paper_pins.py.
LIBER8TION_X = (
    (1, 2, 4, 8, 16, 32, 64, 128),
    (3, 4, 8, 16, 32, 64, 128, 1),
    (2, 8, 1, 34, 4, 128, 16, 64),
    (4, 128, 16, 1, 64, 136, 2, 32),
    (8, 192, 64, 4, 1, 2, 32, 16),
    (16, 32, 72, 128, 2, 8, 1, 4),
    (32, 64, 128, 2, 8, 16, 4, 5),
    (64, 16, 2, 32, 128, 1, 36, 8),
)


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """[2w, k*w] coding bit-matrix (P row = identity blocks, Q row =
    LIBER8TION_X blocks), the w=8 analog of jerasure's
    liber8tion_coding_bitmatrix
    (reference:src/erasure-code/jerasure/ErasureCodeJerasure.cc:513)."""
    w = 8
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        for r in range(w):
            bm[r, j * w + r] = 1  # P: identity block
            rowbits = LIBER8TION_X[j][r]
            for c in range(w):
                if (rowbits >> c) & 1:
                    bm[w + r, j * w + c] = 1
    return bm


class JerasureCodec:
    """Profile parser + codec builder for all techniques."""

    MATRIX_TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op")
    BITMATRIX_TECHNIQUES = (
        "cauchy_orig",
        "cauchy_good",
        "liberation",
        "blaum_roth",
        "liber8tion",
    )

    @classmethod
    def create(cls, profile: Mapping[str, str], device=None) -> ErasureCode:
        technique = profile.get("technique", "reed_sol_van")
        k = ErasureCode.to_int("k", profile, DEFAULT_K, minimum=1)
        m = ErasureCode.to_int("m", profile, DEFAULT_M, minimum=1)
        w = ErasureCode.to_int("w", profile, DEFAULT_W, minimum=1)
        ps = ErasureCode.to_int("packetsize", profile, DEFAULT_PACKETSIZE, minimum=4)

        if technique == "reed_sol_van":
            if w not in (8, 16):
                raise ErasureCodeValidationError(
                    f"reed_sol_van supports w=8 or 16 on this backend, got {w}"
                )
            if k + m > (1 << w):
                raise ErasureCodeValidationError(f"k+m={k+m} exceeds 2^w={1<<w}")
            codec = MatrixErasureCode(k, m, w, mx.rs_vandermonde(k, m, w), device)
        elif technique == "reed_sol_r6_op":
            if m != 2:
                raise ErasureCodeValidationError("reed_sol_r6_op requires m=2")
            if w not in (8, 16):
                raise ErasureCodeValidationError(
                    f"reed_sol_r6_op supports w=8 or 16, got {w}"
                )
            codec = MatrixErasureCode(k, 2, w, mx.rs_r6(k, w), device)
        elif technique in ("cauchy_orig", "cauchy_good"):
            if w not in (4, 8, 16):
                raise ErasureCodeValidationError(
                    f"cauchy techniques support w=4/8/16, got {w}"
                )
            if k + m > (1 << w):
                raise ErasureCodeValidationError(f"k+m={k+m} exceeds 2^w={1<<w}")
            make = mx.cauchy_original if technique == "cauchy_orig" else mx.cauchy_good
            codec = BitmatrixErasureCode(k, m, w, make(k, m, w), ps, device=device)
        elif technique == "liberation":
            if m != 2:
                raise ErasureCodeValidationError("liberation requires m=2")
            codec = BitmatrixErasureCode(
                k, 2, w, None, ps, bitmatrix=liberation_bitmatrix(k, w),
                device=device,
            )
        elif technique == "blaum_roth":
            if m != 2:
                raise ErasureCodeValidationError("blaum_roth requires m=2")
            codec = BitmatrixErasureCode(
                k, 2, w, None, ps, bitmatrix=blaum_roth_bitmatrix(k, w),
                device=device,
            )
        elif technique == "liber8tion":
            if m != 2:
                raise ErasureCodeValidationError("liber8tion requires m=2")
            if w != 8:
                raise ErasureCodeValidationError("liber8tion requires w=8")
            if k > 8:
                raise ErasureCodeValidationError("liber8tion requires k <= 8")
            codec = BitmatrixErasureCode(
                k, 2, 8, None, ps, bitmatrix=liber8tion_bitmatrix(k),
                device=device,
            )
        else:
            raise ErasureCodeValidationError(f"unknown technique {technique!r}")

        codec.init(profile)
        codec.parse_chunk_mapping(profile)
        return codec


class ErasureCodePluginJerasure(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], device):
        return JerasureCodec.create(profile, device)


def __erasure_code_init__(name: str, registry) -> None:
    registry.add(name, ErasureCodePluginJerasure())
