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
from ceph_tpu.models.jerasure import liberation_bitmatrix

from ceph_tpu_torch.ops import gf_cuda, gf_torch
from ceph_tpu_torch.ops.gf import gf


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


def _emulate_bitmatrix_kernel(table: gf_cuda.BitmatrixTable, p32: np.ndarray) -> np.ndarray:
    masks = table.masks.numpy().view(np.uint64)
    x_all = p32.view(np.uint32)
    out = np.zeros((table.M, p32.shape[1]), dtype=np.uint32)
    for tile in range(masks.shape[0]):
        for j in range(table.K):
            mask = int(masks[tile, j])
            for i in range(table.mt):
                row = tile * table.mt + i
                if (mask >> i) & 1 and row < table.M:
                    out[row] ^= x_all[j]
    return out


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


@pytest.mark.parametrize("M,mt", [(5, 8), (16, 16), (32, 32), (64, 64), (80, 64)])
def test_bitmatrix_table_packing(M, mt):
    rng = np.random.default_rng(M)
    bm = (rng.random((M, 24)) < 0.4).astype(np.uint8)
    table = gf_cuda.bitmatrix_table(bm, torch.device("cpu"))
    assert table.mt == mt and table.masks.shape == (-(-M // mt), 24)
    p32 = gf_torch.bytes_to_u32(_bytes(24, 128, seed=M))
    want = gf_torch.bitmatrix_matmul_u32(bm, torch.from_numpy(p32)).numpy()
    assert np.array_equal(_emulate_bitmatrix_kernel(table, p32), want.view(np.uint32))


def test_tables_reject_what_the_kernels_do_not_take():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError):
        gf_cuda.gf_table(np.array([[256]]), 8, cpu)  # not a GF(2^8) element
    with pytest.raises(ValueError):
        gf_cuda.gf_table(np.ones((2, 2)), 4, cpu)  # no w=4 build
    with pytest.raises(ValueError):
        gf_cuda.gf_table(np.array([[-1]]), 16, cpu)  # not a GF(2^16) element
