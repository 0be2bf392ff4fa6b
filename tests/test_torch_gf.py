"""Port GF region engines (ceph_tpu_torch.ops) against ceph_tpu's.

Inputs come from ``np.random.default_rng(seed)``; every comparison is
bit-exact (integer arithmetic, tolerance 0).  The plain torch versions
are held against the Pallas kernels in interpret mode, against the XLA
kernels and against the numpy oracle.  The CUDA kernels cannot run
here: the host side they depend on (the compiled GF plan, the packed
bit-matrix masks) is held against a numpy emulation of each kernel's
walk over it.  ``chip_smoke.py``
holds the kernels themselves against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import matrices as ref_mx
from ceph_tpu.ops.gf import gf as ref_gf
from ceph_tpu.ops.gf_jax import (
    bytes_to_u32 as ref_bytes_to_u32,
    make_bitmatrix_matmul_u32,
    make_gf_matmul_u32,
)
from ceph_tpu.ops.gf_pallas import (
    BLOCK,
    make_bitmatrix_matmul_pallas,
    make_gf_matmul_pallas,
)
from ceph_tpu.models.jerasure import (
    blaum_roth_bitmatrix,
    liber8tion_bitmatrix,
    liberation_bitmatrix,
)

from ceph_tpu_torch.ops import gf_cuda, gf_torch
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.tools.gf_matmul_sweep import cauchy_decode_bitmatrix


def _bytes(rows: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(rows, n), dtype=np.uint8)


def _port(engine, data: np.ndarray) -> np.ndarray:
    """Run a port engine on CPU lanes; bytes out."""
    out = engine(torch.from_numpy(gf_torch.bytes_to_u32(data)))
    return gf_torch.u32_to_bytes(out.numpy())


def _recovery_matrix() -> np.ndarray:
    P = ref_mx.rs_vandermonde(8, 3, 8)
    g = np.vstack([np.eye(8, dtype=np.int64), P])
    present = [0, 2, 3, 4, 6, 7, 8, 9]  # rows 1 and 5 lost
    return ref_gf(8).invert_matrix(g[present])


GF_CASES = {
    "rs_8_3": lambda: (ref_mx.rs_vandermonde(8, 3, 8), 8),
    "rs_2_1": lambda: (ref_mx.rs_vandermonde(2, 1, 8), 8),
    "rs_10_4": lambda: (ref_mx.rs_vandermonde(10, 4, 8), 8),
    "cauchy_good_6_3": lambda: (ref_mx.cauchy_good(6, 3, 8), 8),
    "recovery": lambda: (_recovery_matrix(), 8),
    "rs_4_2_w16": lambda: (ref_mx.rs_vandermonde(4, 2, 16), 16),
}


@pytest.mark.parametrize("case", sorted(GF_CASES))
def test_gf_matmul_matches_pallas_and_xla(case):
    """Plain torch gf_matmul == Pallas (interpret) == XLA, one grid step
    of BLOCK lanes; w=16 is a shape the JAX tests never cover."""
    matrix, w = GF_CASES[case]()
    data = _bytes(matrix.shape[1], BLOCK * 4, seed=len(case))
    d32 = ref_bytes_to_u32(data)
    pallas = np.asarray(make_gf_matmul_pallas(matrix, w, interpret=True)(d32))
    xla = np.asarray(make_gf_matmul_u32(matrix, w)(d32))
    got = _port(gf_torch.GFMatmul(matrix, w, device="cpu"), data)
    assert np.array_equal(got, pallas.view(np.uint8))
    assert np.array_equal(got, xla.view(np.uint8))


@pytest.mark.parametrize("n4", [1, 3, 1021])
def test_gf_matmul_ragged_matches_xla(n4):
    """Lane counts the Pallas kernel refuses (not a multiple of BLOCK)
    agree with the XLA kernel and the numpy oracle."""
    matrix = ref_mx.rs_vandermonde(8, 3, 8)
    data = _bytes(8, 4 * n4, seed=n4)
    xla = np.asarray(make_gf_matmul_u32(matrix, 8)(ref_bytes_to_u32(data)))
    got = _port(gf_torch.GFMatmul(matrix, 8, device="cpu"), data)
    assert np.array_equal(got, xla.view(np.uint8))
    assert np.array_equal(got, gf(8).matmul_region(matrix, data))


@pytest.mark.parametrize("technique", ["cauchy_good", "liberation"])
def test_bitmatrix_matches_pallas_and_xla(technique):
    if technique == "cauchy_good":
        bm = ref_gf(8).matrix_to_bitmatrix(ref_mx.cauchy_good(6, 3, 8))
    else:
        bm = liberation_bitmatrix(5, 7)
    packets = _bytes(bm.shape[1], BLOCK * 4, seed=7)
    p32 = ref_bytes_to_u32(packets)
    pallas = np.asarray(make_bitmatrix_matmul_pallas(bm, interpret=True)(p32))
    xla = np.asarray(make_bitmatrix_matmul_u32(bm)(p32))
    got = _port(gf_torch.BitmatrixXor(bm, device="cpu"), packets)
    assert np.array_equal(got, pallas.view(np.uint8))
    assert np.array_equal(got, xla.view(np.uint8))


def test_gf_double_packed_every_symbol():
    """2*x for every w=8 symbol in every byte position, and for w=16
    symbols, against the scalar field multiply (sign bits included)."""
    for w, count in ((8, 256), (16, 1 << 16)):
        G = gf(w)
        syms = np.arange(count, dtype=np.uint8 if w == 8 else np.uint16)
        if w == 8:
            lanes = np.repeat(syms, 4).view(np.int32)
        else:
            lanes = np.repeat(syms, 2).view(np.int32)
        got = gf_torch.gf_double_packed(torch.from_numpy(lanes), w).numpy()
        got = got.view(syms.dtype)
        want = np.repeat(np.array([G.mul(int(s), 2) for s in syms], syms.dtype),
                         4 if w == 8 else 2)
        assert np.array_equal(got, want)


def test_xor_parity_is_all_ones_matmul():
    data = _bytes(5, 4096, seed=3)
    ones = np.ones((1, 5), dtype=np.int64)
    engine = gf_torch.GFMatmul(ones, 8, device="cpu")
    assert engine.xor_only
    assert np.array_equal(_port(engine, data), gf(8).matmul_region(ones, data))


def test_byte_lane_views_round_trip():
    data = _bytes(3, 64, seed=5)
    lanes = gf_torch.bytes_to_u32(data)
    assert lanes.dtype == np.int32 and lanes.shape == (3, 16)
    assert np.array_equal(gf_torch.u32_to_bytes(lanes), data)
    t = torch.from_numpy(data)
    assert torch.equal(gf_torch.u32_to_bytes(gf_torch.bytes_to_u32(t)), t)
    with pytest.raises(ValueError):
        gf_torch.bytes_to_u32(data[:, :6])


# -- the CUDA kernels' host side -------------------------------------------------


def _emulate_gf_kernel(table: gf_cuda.GFTable, d32: np.ndarray) -> np.ndarray:
    """numpy emulation of gf_matmul.cu, launch by launch: each walks its
    input rows' chains up to their length nb (rows with nb = 0 skipped),
    XORs each power into the accumulators its mask names (a tile of
    exactly mt), and stores its m rows, or XORs them into the outputs
    when it accumulates a later chunk of input rows."""
    x_all = d32.view(np.uint32)
    out = np.zeros((table.m, d32.shape[1]), dtype=np.uint32)
    mask_low, high_unit, poly = gf_torch._PACK[table.w]
    for g in table.launches:
        acc = np.zeros((g.mt, d32.shape[1]), dtype=np.uint32)
        for j in range(g.k):
            nb = int(g.nb[j])
            if nb == 0:
                continue
            x = x_all[g.in_row + j].copy()
            for b in range(table.w):
                if b:
                    if b >= nb:
                        break
                    high = (x >> np.uint32(table.w - 1)) & np.uint32(high_unit)
                    x = ((x & np.uint32(mask_low)) << np.uint32(1)) ^ (high * np.uint32(poly))
                mask = int(g.masks[j * table.w + b])
                for i in range(g.mt):
                    if (mask >> i) & 1:
                        acc[i] ^= x
        assert not acc[g.m:].any()  # no mask names an output past the tile's rows
        rows = out[g.out_row:g.out_row + g.m]
        if g.accumulate:
            rows ^= acc[:g.m]
        else:
            rows[:] = acc[:g.m]
    return out


# output groups a tile's outputs split into, as GROUPS of csrc/bitmatrix_xor.cu
BM_GROUPS = 8


def _emulate_bitmatrix_kernel(table: gf_cuda.BitmatrixTable, p32: np.ndarray) -> np.ndarray:
    """numpy emulation of bitmatrix_xor.cu, launch by launch: each of its
    BM_GROUPS output groups (mt / BM_GROUPS outputs each) walks the used
    rows 32 at a time, and each output XORs in the rows its word of the
    plan names; the launch stores its m rows, or XORs them into the
    outputs when it accumulates a later chunk of used rows."""
    x_all = p32.view(np.uint32)
    out = np.zeros((table.M, p32.shape[1]), dtype=np.uint32)
    for g in table.launches:
        og = g.mt // BM_GROUPS
        acc = np.zeros((g.mt, p32.shape[1]), dtype=np.uint32)
        for b, words in enumerate(g.bits.tolist()):
            for grp in range(BM_GROUPS):
                for i in range(grp * og, grp * og + og):
                    for r in range(32):
                        if (words[i] >> r) & 1:
                            acc[i] ^= x_all[g.rows[32 * b + r]]
        assert not acc[g.m:].any()  # no word names an output past the tile's rows
        rows = out[g.out_row:g.out_row + g.m]
        if g.accumulate:
            rows ^= acc[:g.m]
        else:
            rows[:] = acc[:g.m]
    return out


def _check_bitmatrix_plans(table: gf_cuda.BitmatrixTable, bm: np.ndarray) -> None:
    """Every launch's plan names, in order and within its capacity, the
    input rows its tile uses and no other, and for each block of 32 of
    them each output's word of the rows it takes."""
    bits = np.asarray(bm) != 0
    top = gf_cuda.BITMATRIX_TILES[-1]
    for g in table.launches:
        n = len(g.rows)
        assert n <= gf_cuda.BM_PLAN_ROWS and g.plan.shape == (gf_cuda.BM_PLAN_WORDS,)
        assert np.array_equal(g.plan[:n], g.rows) and g.bits.shape == (-(-n // 32), 32)
        assert np.all(np.diff(g.rows.astype(np.int64)) > 0)
        tile = bits[g.out_row:g.out_row + g.m]
        for r, j in enumerate(g.rows.tolist()):
            took = [(int(g.bits[r // 32, i]) >> (r % 32)) & 1 for i in range(32)]
            assert took == [int(tile[i, j]) if i < g.m else 0 for i in range(32)]
        assert not g.plan[gf_cuda.BM_PLAN_ROWS + g.bits.size:].any()
    for r0 in range(0, bits.shape[0], top):
        tile_rows = [g.rows for g in table.launches if g.out_row == r0]
        used = np.flatnonzero(bits[r0:r0 + top].any(axis=0))
        assert np.array_equal(np.concatenate(tile_rows), used)


# m -> the output tiles gf_table must choose: tiles of 16 and the rest,
# rounded up to a built tile
TILES = {1: (1,), 2: (2,), 3: (3,), 4: (4,), 5: (6,), 16: (16,), 17: (16, 1), 20: (16, 4)}


@pytest.mark.parametrize("m,w,k", [
    (1, 8, 1), (3, 8, 4), (16, 8, 16), (20, 8, 16), (2, 16, 2),
    (3, 8, 8), (17, 8, 9), (1, 8, 255), (3, 16, 7),
    (5, 8, 6), (3, 8, 300), (4, 16, 200), (16, 8, 1000),
])
def test_gf_table_packing(m, w, k):
    """The compiled plans drive the kernel's arithmetic to the plain
    version's bytes: exact and rounded-up tiles, one tile and several,
    k = 255 (the largest the plugins accept at w=8) in one launch, w=16,
    and input rows past one plan split into chunks that accumulate."""
    rng = np.random.default_rng(m * w + k)
    matrix = rng.integers(0, 1 << w, size=(m, k))
    table = gf_cuda.gf_table(matrix, w, torch.device("cpu"))
    assert table.tiles == TILES[m]
    chunk = min(gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS // w)
    assert len(table.launches) == len(table.tiles) * -(-k // chunk)
    assert all(g.plan.shape == (gf_cuda.PLAN_BYTES,) and g.k <= chunk
               for g in table.launches)
    d32 = gf_torch.bytes_to_u32(_bytes(k, 256, seed=m + k))
    want = gf_torch.gf_matmul_u32(matrix, torch.from_numpy(d32), w).numpy()
    assert np.array_equal(_emulate_gf_kernel(table, d32), want.view(np.uint32))


def _zero_column_matrix() -> np.ndarray:
    matrix = ref_mx.rs_vandermonde(6, 3, 8).copy()
    matrix[:, 2] = 0  # no output takes input row 2
    return matrix


PLAN_CASES = {
    # matrix, w, doubling chain of each input row (the plan's nb - 1)
    "isa_rs_8_3": (lambda: ref_mx.isa_rs_vandermonde(8, 3), 8, [0, 2, 4, 6, 4, 6, 7, 7]),
    "jerasure_rs_8_3": (lambda: ref_mx.rs_vandermonde(8, 3, 8), 8, [7] * 8),
    "zero_column": (_zero_column_matrix, 8, None),
    "recovery": (_recovery_matrix, 8, None),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_gf_plan_of_coding_matrices(case):
    """The plugins' own matrices: chain lengths as the doubling method
    needs them, a skipped row for a zero column, bytes equal to the plain
    version."""
    make, w, chains = PLAN_CASES[case]
    matrix = make()
    m, k = matrix.shape
    table = gf_cuda.gf_table(matrix, w, torch.device("cpu"))
    assert table.tiles == (m,) and len(table.launches) == 1
    want_nb = [int(np.bitwise_or.reduce(col)).bit_length() for col in matrix.T]
    assert table.launches[0].nb.tolist() == want_nb
    if chains is not None:
        assert [nb - 1 for nb in want_nb] == chains
    if case == "zero_column":
        assert table.launches[0].nb[2] == 0
    d32 = gf_torch.bytes_to_u32(_bytes(k, 512, seed=k))
    want = gf_torch.gf_matmul_u32(matrix, torch.from_numpy(d32), w).numpy()
    assert np.array_equal(_emulate_gf_kernel(table, d32), want.view(np.uint32))


# M -> the output tiles bitmatrix_table must choose: tiles of 32 and the
# rest, rounded up to a built tile
BM_TILES = {3: (8,), 5: (8,), 8: (8,), 16: (16,), 32: (32,), 64: (32, 32),
            80: (32, 32, 16), 128: (32, 32, 32, 32)}


@pytest.mark.parametrize("M,K", [
    (5, 8), (16, 16), (32, 32), (64, 64), (80, 64),
    (3, 24), (128, 40), (8, 1200), (8, 6144),
])
def test_bitmatrix_table_packing(M, K):
    """The packed plans drive the kernel's walk to the plain version's
    bytes: exact and rounded-up tiles, one tile and several (M = 128:
    four tiles, the input read by each), used rows past one plan split
    into launches that accumulate (K = 1200), and K = 6144, the most
    an earlier kernel, which staged the masks in shared memory, took."""
    rng = np.random.default_rng(M * 7 + K)
    bm = (rng.random((M, K)) < 0.4).astype(np.uint8)
    table = gf_cuda.bitmatrix_table(bm, torch.device("cpu"))
    assert table.tiles == BM_TILES[M]
    _check_bitmatrix_plans(table, bm)
    used = [np.count_nonzero(bm[r0:r0 + 32].any(axis=0)) for r0 in range(0, M, 32)]
    assert len(table.launches) == sum(-(-u // gf_cuda.BM_PLAN_ROWS) for u in used)
    p32 = gf_torch.bytes_to_u32(_bytes(K, 64, seed=M + K))
    want = gf_torch.bitmatrix_matmul_u32(bm, torch.from_numpy(p32)).numpy()
    assert np.array_equal(_emulate_bitmatrix_kernel(table, p32), want.view(np.uint32))


@pytest.mark.parametrize("missing", [(3,), (0, 4, 11, 13)])
def test_bitmatrix_plan_of_recovery_matrices(missing):
    """A decode's recovery bit-matrix: one erasure widens to all 13
    survivors ([8, 104], 24 zero columns, none of them in the plan: those
    rows cost no bytes); four erasures use every column."""
    bm = cauchy_decode_bitmatrix(missing)
    table = gf_cuda.bitmatrix_table(bm, torch.device("cpu"))
    _check_bitmatrix_plans(table, bm)
    planned = np.concatenate([g.rows for g in table.launches])
    zero = np.flatnonzero(~bm.any(axis=0))
    assert bm.shape == (8 * len(missing), 8 * (14 - len(missing)))
    assert len(zero) == (24 if len(missing) == 1 else 0)
    assert planned.size == bm.shape[1] - len(zero) and not np.isin(zero, planned).any()
    p32 = gf_torch.bytes_to_u32(_bytes(bm.shape[1], 256, seed=len(missing)))
    want = gf_torch.bitmatrix_matmul_u32(bm, torch.from_numpy(p32)).numpy()
    assert np.array_equal(_emulate_bitmatrix_kernel(table, p32), want.view(np.uint32))


def _plugin_bitmatrix(technique: str) -> np.ndarray:
    if technique == "cauchy_good":
        return ref_gf(8).matrix_to_bitmatrix(ref_mx.cauchy_good(10, 4, 8))
    if technique == "liberation":
        return liberation_bitmatrix(7, 7)
    if technique == "blaum_roth":
        return blaum_roth_bitmatrix(6, 6)
    return liber8tion_bitmatrix(8)


@pytest.mark.parametrize("technique", ["cauchy_good", "liberation", "blaum_roth",
                                       "liber8tion"])
def test_plugin_bitmatrices_through_the_kernel_plan(technique):
    """Each jerasure bit-matrix technique's matrix: the plain version
    equals the Pallas kernel (interpret mode), and the kernel's walk over
    its packed plan equals the plain version."""
    bm = _plugin_bitmatrix(technique)
    packets = _bytes(bm.shape[1], BLOCK * 4, seed=11)
    p32 = ref_bytes_to_u32(packets)
    pallas = np.asarray(make_bitmatrix_matmul_pallas(bm, interpret=True)(p32))
    plain = gf_torch.bitmatrix_matmul_u32(bm, torch.from_numpy(np.asarray(p32))).numpy()
    assert np.array_equal(plain.view(np.uint32), pallas.view(np.uint32))
    table = gf_cuda.bitmatrix_table(bm, torch.device("cpu"))
    _check_bitmatrix_plans(table, bm)
    got = _emulate_bitmatrix_kernel(table, np.asarray(p32).view(np.int32))
    assert np.array_equal(got, plain.view(np.uint32))


def test_tables_reject_what_the_kernels_do_not_take():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError):
        gf_cuda.gf_table(np.array([[256]]), 8, cpu)  # not a GF(2^8) element
    with pytest.raises(ValueError):
        gf_cuda.gf_table(np.ones((2, 2)), 4, cpu)  # no w=4 build
    with pytest.raises(ValueError):
        gf_cuda.gf_table(np.array([[-1]]), 16, cpu)  # not a GF(2^16) element
