#!/usr/bin/env python3
"""GPU smoke run of ``ceph_tpu_torch``, the PyTorch + CUDA port of the
erasure-code engine, on one NVIDIA card.

Run from the root of the repository, on a machine with a CUDA card and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each fatal on any mismatch or exception:

1. the card: ``nvidia-smi`` name and power limit, and torch's name;
2. build the two Hopper kernels from ``ceph_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build seconds and the
   compiler's register counts;
3. hold each kernel bit-exact against its plain torch version on the
   card: at the main-path shapes, at ragged and misaligned lane counts,
   at w=16, on recovery matrices, on matrices wider than one output
   tile, on jerasure's RS(8,3) matrix, on a matrix with a zero column,
   on k = 255, and on inputs longer than one launch's plan (k = 1000 at
   w=8, k = 200 at w=16; K = 6144 bit-matrix rows); the bit-matrix
   kernel also on rows misaligned by one lane, on the one-erasure
   cauchy_good decode matrix (24 zero columns) and on M = 128 outputs;
   and against the numpy oracle on a column slice;
4. the main path, with the launch counts set to 0 just before it: the
   five BASELINE.json configurations through
   ``registry.instance().factory(...)``, 64 objects of 1 MiB per call
   (a 64 MiB data block), encode, erase, decode, bytes equal to the
   originals and parity equal to ``encode_chunks_host``, then encode and
   decode again from tensors on the card; then the port's
   ``tools/ec_benchmark`` once for encode and once for decode.  Each
   kernel must have launched in this phase;
5. time each kernel at its main-path shape (CUDA events, median of many
   launches, one launch between two events for the ``kernels`` line and
   also batches of 20 back-to-back launches) beside its plain version and
   its bound, ``gf_matmul`` also on jerasure's RS(8,3) matrix and on a
   three-erasure ISA recovery matrix, ``bitmatrix_xor`` also on the
   one- and four-erasure cauchy_good decode matrices, each beside its
   own bound; the end-to-end RS(8,3) encode and decode GB/s through the
   registry, with host numpy in and out and device-resident; and the
   device-resident cauchy_good k=10 m=4 encode and decode beside the two
   packet-layout copies they make.

Output: the card line, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

OBJECTS = 64
OBJECT_SIZE = 1 << 20
SEED = 20261017

# H100 SXM device memory rate (NVIDIA data sheet)
MEMORY_BYTES_PER_S = 3.35e12
# 32-bit integer add / logical / shift / multiply results per clock per
# SM on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table); times SMs and the maximum SM clock
INT32_OPS_PER_CLOCK_PER_SM = 64
# integer operations of one GF doubling on a packed lane, at the least:
# a PRMT that copies each symbol's high bit over the symbol, an AND and a
# shift for (x & low) << 1, and one three-input LOP3 that XORs in the
# high mask ANDed with the polynomial (ceph_tpu_torch/csrc/gf_matmul.cu
# gf_double)
OPS_PER_DOUBLING = 4

# plugin, profile, erasure sets to decode (chunk positions)
CONFIGS = [
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1"}, [[0], [2]]),
    ("isa", {"k": "8", "m": "3"}, [[0], [1, 5, 9]]),
    ("jerasure", {"technique": "cauchy_good", "k": "10", "m": "4",
                  "packetsize": "4096"}, [[3], [0, 4, 11, 13]]),
    # BASELINE.json names l=4, which the reference rejects (k and m must
    # be multiples of (k+m)/l); l=3 is the valid neighbour, checked below
    ("lrc", {"k": "8", "m": "4", "l": "3"}, [[0], [0, 1, 4]]),
    ("shec", {"k": "8", "m": "4", "c": "3"}, [[2], [0, 1, 2]]),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def check_equal(what: str, got, want) -> None:
    import torch

    if tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel differs from its plain version")


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item())


def time_cuda(fn, reps: int, warmup: int = 3, batch: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` samples, each ``batch``
    back-to-back calls between two CUDA events on the current stream,
    divided by ``batch``.  One call a sample (the ``kernels`` line) also
    counts the host's launch gap; a batch keeps the card from waiting on
    the host between calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def time_wall(fn, reps: int, warmup: int = 1) -> float:
    """Median seconds of ``fn`` (which ends synchronised) on the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def xor_ops(terms_per_output) -> int:
    """Least integer operations that XOR t terms into each output: the
    first term is a move into the zeroed accumulator, and one
    three-input LOP3 folds two more, so t // 2 for each output."""
    return sum(int(t) // 2 for t in terms_per_output)


def gf_ops(matrix: np.ndarray, n4: int) -> int:
    """Integer operations of the doubling method for ``matrix`` over n4
    lanes: each input row's chain up to its highest needed bit, plus the
    folded XORs of each output's set coefficient bits."""
    matrix = np.asarray(matrix, dtype=np.int64)
    doublings = sum(int(np.bitwise_or.reduce(col)).bit_length() - 1
                    for col in matrix.T if col.any())
    terms = [sum(bin(int(c)).count("1") for c in row) for row in matrix]
    return n4 * (OPS_PER_DOUBLING * doublings + xor_ops(terms))


def used_rows(matrix: np.ndarray) -> int:
    """Input rows the matrix reads: a zero column's row is never read."""
    return int(np.count_nonzero(np.asarray(matrix).any(axis=0)))


def check_kernels(dev, rng) -> dict:
    """Every kernel bit-exact against its plain version on the card;
    returns the main-path inputs and errors for the timing phase."""
    import torch

    from ceph_tpu_torch.ops import gf_cuda, gf_torch, matrices as mx
    from ceph_tpu_torch.ops.gf import gf
    from ceph_tpu_torch.models.matrix_codec import _gf2_invert
    from ceph_tpu_torch.tools.gf_matmul_sweep import cauchy_decode_bitmatrix

    def lanes(rows: int, n4: int):
        return torch.from_numpy(
            rng.integers(-(1 << 31), 1 << 31, size=(rows, n4), dtype=np.int64)
            .astype(np.int32)
        ).to(dev)

    def gf_case(what, matrix, w, d32):
        got = gf_cuda.gf_matmul(gf_cuda.gf_table(matrix, w, dev), d32)
        want = gf_torch.gf_matmul_u32(matrix, d32, w)
        torch.cuda.synchronize()
        check_equal(f"gf_matmul {what}", got, want)
        return got, want

    def bm_case(what, bm, p32):
        got = gf_cuda.bitmatrix_xor(gf_cuda.bitmatrix_table(bm, dev), p32)
        want = gf_torch.bitmatrix_matmul_u32(bm, p32)
        torch.cuda.synchronize()
        check_equal(f"bitmatrix_xor {what}", got, want)
        return got, want

    # GF kernel: main path is ISA RS(8,3) over 64 x 1 MiB objects
    k, m = 8, 3
    rs = mx.isa_rs_vandermonde(k, m)
    n4_main = OBJECTS * OBJECT_SIZE // k // 4
    d_main = lanes(k, n4_main)
    got, want = gf_case("RS(8,3) full shape", rs, 8, d_main)
    gf_err = max_abs_err(got, want)
    # the numpy oracle on a column slice
    cols = np.ascontiguousarray(d_main[:, :4096].cpu().numpy()).view(np.uint8)
    oracle = gf(8).matmul_region(rs, cols)
    if not np.array_equal(got[:, :4096].cpu().numpy().view(np.uint8), oracle):
        raise AssertionError("gf_matmul differs from the numpy oracle")
    for n4 in (1, 3, 5, 1021, 4 * 4096 * 16 + 3):  # ragged lane counts
        gf_case(f"RS(8,3) n4={n4}", rs, 8, lanes(k, n4))
    # 4 KiB objects: 128 lanes a chunk row, misaligned by one lane
    buf = lanes(1, k * 128 * OBJECTS + 1)
    gf_case("RS(8,3) misaligned", rs, 8, buf[0, 1:].view(k, 128 * OBJECTS))
    gf_case("RS(4,2) w=16", mx.rs_vandermonde(4, 2, 16), 16, lanes(4, n4_main // 2))
    gf_case("RS(4,2) w=16 ragged", mx.rs_vandermonde(4, 2, 16), 16, lanes(4, 777))
    present = [0, 2, 3, 4, 6, 7, 8, 9]  # rows 1 and 5 lost
    g = np.vstack([np.eye(k, dtype=np.int64), rs])
    recovery = gf(8).invert_matrix(g[present])
    gf_case("recovery matrix", recovery, 8, lanes(k, n4_main))
    wide = rng.integers(0, 256, size=(20, 10))  # two output tiles
    gf_case("20x10 two tiles", wide, 8, lanes(10, 12345))
    jerasure = mx.rs_vandermonde(k, m, 8)  # every chain 7 long
    gf_case("jerasure RS(8,3) full shape", jerasure, 8, d_main)
    gf_case("RS(8,3) m=3 ragged", rs, 8, lanes(k, 2 * 2048 * 132 + 1023))
    zero_col = rs.copy()
    zero_col[:, 5] = 0  # no output takes input row 5
    gf_case("zero column", zero_col, 8, lanes(k, 300000))
    k255 = rng.integers(0, 256, size=(1, 255))  # k + m = 256, many ring stages
    gf_case("k=255", k255, 8, lanes(255, 40000))
    gf_case("5x8 in a tile of 6", rng.integers(0, 256, size=(5, 8)), 8, lanes(8, 99999))
    # input rows past one plan: launches that accumulate, vector and scalar stores
    gf_case("16x1000 w=8", rng.integers(0, 256, size=(16, 1000)), 8, lanes(1000, 4096))
    gf_case("4x200 w=16 ragged", rng.integers(0, 1 << 16, size=(4, 200)), 16,
            lanes(200, 3001))

    # bit-matrix kernel: main path is cauchy_good k=10 m=4 w=8, ps=4096
    k, m, w = 10, 4, 8
    bm = gf(w).matrix_to_bitmatrix(mx.cauchy_good(k, m, w))
    chunk = 4 * w * 4096  # 1 MiB / k rounded up to w*packetsize
    n4_bm = OBJECTS * chunk // w // 4
    p_main = lanes(k * w, n4_bm)
    got_b, want_b = bm_case("cauchy_good(10,4) full shape", bm, p_main)
    bm_err = max_abs_err(got_b, want_b)
    for n4 in (1, 3, 1021):
        bm_case(f"cauchy_good n4={n4}", bm, lanes(k * w, n4))
    lost = [1, 12]  # one data chunk and one parity chunk
    use = [c for c in range(k + m) if c not in lost][:k]
    eye = np.eye(k * w, dtype=np.uint8)
    gen = np.vstack([eye, bm])
    rows = np.concatenate([gen[c * w:(c + 1) * w] for c in use])
    rb = _gf2_invert(rows)
    bm_case("recovery bit-matrix", rb[w:2 * w], lanes(k * w, n4_bm))
    bm16 = gf(16).matrix_to_bitmatrix(mx.cauchy_good(4, 4, 16))  # M = 64
    bm_case("cauchy_good(4,4) w=16", bm16, lanes(64, 4099))
    wide_bm = (rng.random((80, 40)) < 0.5).astype(np.uint8)  # two tiles
    bm_case("80x40 two tiles", wide_bm, lanes(40, 5000))
    for mt_rows in (5, 12, 30):  # the narrower tiles
        bm_case(f"{mt_rows} outputs", bm[:mt_rows], lanes(k * w, 999))
    # rows misaligned by one lane: the producer's plain loads, not bulk copies
    buf = lanes(1, k * w * 8192 + 1)
    bm_case("misaligned rows", bm, buf[0, 1:].view(k * w, 8192))
    decode1 = cauchy_decode_bitmatrix([3])  # [8, 104], 24 zero columns
    p_decode1 = lanes(decode1.shape[1], n4_bm)
    bm_case("one-erasure decode [8, 104]", decode1, p_decode1)
    decode4 = cauchy_decode_bitmatrix([0, 4, 11, 13])  # [32, 80]
    bm_case("four-erasure decode [32, 80]", decode4, p_main)
    k6144 = (rng.random((8, 6144)) < 0.4).astype(np.uint8)  # chunks of used rows
    bm_case("K=6144", k6144, lanes(6144, 1000))
    m128 = (rng.random((128, 80)) < 0.35).astype(np.uint8)  # four output tiles
    bm_case("M=128", m128, lanes(80, 4099))
    return {
        "gf": (rs, d_main, gf_err),
        "gf_more": {"jerasure RS(8,3)": jerasure,
                    "ISA RS(8,3) recovery of 3": recovery3(rs)},
        "bitmatrix": (bm, p_main, bm_err),
        "bitmatrix_more": {"cauchy_good decode of 1 erasure": (decode1, p_decode1),
                           "cauchy_good decode of 4 erasures": (decode4, p_main)},
    }


def recovery3(rs: np.ndarray) -> np.ndarray:
    """The [3, 8] matrix that a decode of ISA RS(8,3) launches to rebuild
    data chunks 1, 5 and 7 from the first 8 survivors, built as
    ``MatrixErasureCode`` builds it."""
    from ceph_tpu_torch.ops import matrices as mx

    k = rs.shape[1]
    lost = [1, 5, 7]
    present = [c for c in range(k + rs.shape[0]) if c not in lost][:k]
    return mx.decode_matrix(rs, k, 8, present)[lost]


# -- phase 4: the main path ----------------------------------------------------


def run_config(plugin: str, profile: dict, erasure_sets, dev, rng) -> None:
    from ceph_tpu_torch.models import registry

    codec = registry.instance().factory(plugin, dict(profile))
    if codec.device != dev:
        raise AssertionError(f"{plugin} codec on {codec.device}, expected {dev}")
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    C = codec.get_chunk_size(OBJECT_SIZE)
    data = rng.integers(0, 256, size=(k, OBJECTS * C), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = codec.encode_chunks(data)
    t_enc = time.perf_counter() - t0
    host = codec.encode_chunks_host(data)
    if not np.array_equal(parity, host):
        raise AssertionError(f"{plugin} {profile}: parity differs from encode_chunks_host")
    log(f"  {plugin} {profile}: [{k}, {OBJECTS * C}] encode ok, parity == host oracle "
        f"({t_enc:.3f} s host clock, first call)")
    mapping = codec.get_chunk_mapping() or list(range(k))
    coding = [i for i in range(n) if i not in mapping]
    full = {pos: data[r] for r, pos in enumerate(mapping)}
    full.update({pos: parity[r] for r, pos in enumerate(coding)})
    for erased in erasure_sets:
        avail = {i: c for i, c in full.items() if i not in erased}
        t0 = time.perf_counter()
        out = codec.decode(list(erased), avail)
        t_dec = time.perf_counter() - t0
        for e in erased:
            if not np.array_equal(out[e], full[e]):
                raise AssertionError(f"{plugin} {profile}: chunk {e} differs after decode of {erased}")
        log(f"  {plugin} {profile} erased {erased}: decode ok ({t_dec:.3f} s host clock)")
    # device-resident: tensors in, tensors out, on the card throughout
    import torch

    parity_t = codec.encode_chunks(torch.from_numpy(data).to(dev))
    if not (isinstance(parity_t, torch.Tensor) and parity_t.device == dev
            and np.array_equal(parity_t.cpu().numpy(), parity)):
        raise AssertionError(f"{plugin} {profile}: device-resident encode differs")
    for erased in erasure_sets:
        present = [i for i in range(n) if i not in erased]
        survivors = torch.from_numpy(np.stack([full[i] for i in present])).to(dev)
        out = codec.decode_chunks(present, survivors, list(erased))
        want = np.stack([full[e] for e in erased])
        if not (isinstance(out, torch.Tensor) and out.device == dev
                and np.array_equal(out.cpu().numpy(), want)):
            raise AssertionError(
                f"{plugin} {profile}: device-resident decode of {erased} differs")
    log(f"  {plugin} {profile}: device-resident encode and decode ok")


def run_main_path(dev, rng) -> None:
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.models.interface import ErasureCodeValidationError
    from ceph_tpu_torch.tools import ec_benchmark

    try:
        registry.instance().factory("lrc", {"k": "8", "m": "4", "l": "4"})
    except ErasureCodeValidationError as e:
        log(f"  lrc k=8 m=4 l=4 rejected as by the reference: {e}")
    else:
        raise AssertionError("lrc k=8 m=4 l=4 must be rejected")
    for plugin, profile, erasure_sets in CONFIGS:
        run_config(plugin, profile, erasure_sets, dev, rng)
    for workload in ("encode", "decode"):
        argv = ["--plugin", "isa", "-p", "k=8", "-p", "m=3", "--workload", workload,
                "--size", str(OBJECT_SIZE), "--iterations", "10"]
        if workload == "encode":
            argv += ["--batch", str(OBJECTS)]
        log(f"  ec_benchmark {' '.join(argv)}  (<seconds>\\t<KiB>):")
        if ec_benchmark.main(argv) != 0:
            raise AssertionError(f"ec_benchmark {workload} failed")


# -- phase 5: timing -------------------------------------------------------------


def time_kernels(dev, inputs: dict, launches: dict) -> list[dict]:
    import torch

    from ceph_tpu_torch.ops import gf_cuda, gf_torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    int_ops_per_s = sms * INT32_OPS_PER_CLOCK_PER_SM * max_clock_hz
    log(f"  int32 peak {int_ops_per_s:.4g} op/s ({sms} SMs x "
        f"{INT32_OPS_PER_CLOCK_PER_SM} x {max_clock_hz / 1e6:.0f} MHz); "
        f"memory {MEMORY_BYTES_PER_S:.4g} B/s")

    def bound(nbytes: int, ops: int):
        t_bytes = nbytes / MEMORY_BYTES_PER_S * 1e3
        t_ops = ops / int_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    rows = []
    rs, d_main, gf_err = inputs["gf"]
    table = gf_cuda.gf_table(rs, 8, dev)
    bt = gf_cuda.bitmatrix_table(inputs["bitmatrix"][0], dev)
    kernel_calls = [lambda: gf_cuda.gf_matmul(table, d_main),
                    lambda: gf_cuda.bitmatrix_xor(bt, inputs["bitmatrix"][1])]
    ms = time_cuda(kernel_calls[0], reps=50)
    plain_ms = time_cuda(lambda: gf_torch.gf_matmul_u32(rs, d_main, 8), reps=5)
    k, n4 = d_main.shape
    m = rs.shape[0]
    b_ms, b_by = bound((used_rows(rs) + m) * n4 * 4, gf_ops(rs, n4))
    rows.append({
        "name": "gf_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:95",
        "launches": launches["gf_matmul"], "max_abs_err": gf_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    bm, p_main, bm_err = inputs["bitmatrix"]
    ms = time_cuda(kernel_calls[1], reps=50)
    plain_ms = time_cuda(lambda: gf_torch.bitmatrix_matmul_u32(bm, p_main), reps=5)
    K, n4 = p_main.shape
    M = bm.shape[0]
    b_ms, b_by = bound((used_rows(bm) + M) * n4 * 4,
                       xor_ops(np.count_nonzero(bm, axis=1)) * n4)
    rows.append({
        "name": "bitmatrix_xor", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/bitmatrix_xor.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:151",
        "launches": launches["bitmatrix_xor"], "max_abs_err": bm_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    for r, fn in zip(rows, kernel_calls):
        log(f"  {r['name']}: {r['ms']} ms one launch a sample, "
            f"{time_cuda(fn, reps=50, batch=20)} ms in batches of 20 (bound "
            f"{r['bound_ms']} ms by {r['bound_by']}, plain {r['plain_ms']} ms; one "
            f"launch a sample is {r['bound_ms'] / r['ms']:.1%} of bound)")
    k, n4 = d_main.shape
    for what, matrix in inputs["gf_more"].items():
        t = gf_cuda.gf_table(matrix, 8, dev)
        ms = time_cuda(lambda: gf_cuda.gf_matmul(t, d_main), reps=50)
        batched = time_cuda(lambda: gf_cuda.gf_matmul(t, d_main), reps=50, batch=20)
        b_ms, b_by = bound((used_rows(matrix) + matrix.shape[0]) * n4 * 4,
                           gf_ops(matrix, n4))
        log(f"  gf_matmul {what} over [{k}, {n4}]: {ms} ms one launch a sample, "
            f"{batched} ms in batches of 20 (bound {b_ms} ms by {b_by}, "
            f"{b_ms / batched:.1%} of bound in batches)")
    for what, (matrix, p32) in inputs["bitmatrix_more"].items():
        t = gf_cuda.bitmatrix_table(matrix, dev)
        ms = time_cuda(lambda: gf_cuda.bitmatrix_xor(t, p32), reps=50)
        batched = time_cuda(lambda: gf_cuda.bitmatrix_xor(t, p32), reps=50, batch=20)
        b_ms, b_by = bound((used_rows(matrix) + matrix.shape[0]) * p32.shape[1] * 4,
                           xor_ops(np.count_nonzero(matrix, axis=1)) * p32.shape[1])
        log(f"  bitmatrix_xor {what} {list(matrix.shape)} over {list(p32.shape)}: {ms} ms "
            f"one launch a sample, {batched} ms in batches of 20 (bound {b_ms} ms by "
            f"{b_by}, {b_ms / batched:.1%} of bound in batches)")
    return rows


def time_end_to_end(dev, rng) -> dict:
    import torch

    from ceph_tpu_torch.models import registry

    codec = registry.instance().factory("isa", {"k": "8", "m": "3"})
    k = codec.get_data_chunk_count()
    C = codec.get_chunk_size(OBJECT_SIZE)
    data = rng.integers(0, 256, size=(k, OBJECTS * C), dtype=np.uint8)
    parity = codec.encode_chunks(data)
    chunks = np.concatenate([data, parity])
    present, missing = list(range(1, k + 1)), [0]
    survivors = chunks[present]
    data_t = torch.from_numpy(data).to(dev)
    survivors_t = torch.from_numpy(survivors).to(dev)
    nbytes = OBJECTS * OBJECT_SIZE

    def dev_encode():
        codec.encode_chunks(data_t)
        torch.cuda.synchronize()

    def dev_decode():
        codec.decode_chunks(present, survivors_t, missing)
        torch.cuda.synchronize()

    out = {
        "encode_host_numpy": time_wall(lambda: codec.encode_chunks(data), 10),
        "decode_host_numpy": time_wall(
            lambda: codec.decode_chunks(present, survivors, missing), 10),
        "encode_device_resident": time_wall(dev_encode, 20),
        "decode_device_resident": time_wall(dev_decode, 20),
    }
    gbps = {key: nbytes / s / 1e9 for key, s in out.items()}
    for key, s in out.items():
        log(f"  isa RS(8,3) {key}: {gbps[key]:.3f} GB/s ({s * 1e3:.3f} ms for "
            f"{OBJECTS} x 1 MiB objects, host clock)")
    return gbps


def time_packet_layout(dev, rng) -> None:
    """Device-resident jerasure cauchy_good k=10 m=4 encode and decode
    (one erasure) on the host clock, beside the two packet-layout copies
    of ``BitmatrixErasureCode`` ([n, C] chunks <-> [n*w, B*ps] packet
    rows) that they make around the kernel, timed alone."""
    import torch

    from ceph_tpu_torch.models import registry

    codec = registry.instance().factory(
        "jerasure", {"technique": "cauchy_good", "k": "10", "m": "4", "packetsize": "4096"})
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    C = codec.get_chunk_size(OBJECT_SIZE)
    data_t = torch.from_numpy(
        rng.integers(0, 256, size=(k, OBJECTS * C), dtype=np.uint8)).to(dev)
    parity_t = codec.encode_chunks(data_t)
    chunks_t = torch.cat([data_t, parity_t])
    present, missing = [c for c in range(n) if c != 3], [3]
    survivors_t = chunks_t[present].contiguous()
    packets_out = codec._to_packets(parity_t)  # [m*w, B*ps], as the kernel gives it

    def dev_encode():
        codec.encode_chunks(data_t)
        torch.cuda.synchronize()

    def dev_decode():
        codec.decode_chunks(present, survivors_t, missing)
        torch.cuda.synchronize()

    encode_s = time_wall(dev_encode, 20)
    decode_s = time_wall(dev_decode, 20)
    to_ms = time_cuda(lambda: codec._to_packets(data_t), reps=20, batch=20)
    from_ms = time_cuda(lambda: codec._from_packets(packets_out, codec.m), reps=20, batch=20)
    nbytes = OBJECTS * OBJECT_SIZE
    log(f"  cauchy_good(10,4) encode_device_resident: {encode_s * 1e3:.4f} ms host clock "
        f"({nbytes / encode_s / 1e9:.3f} GB/s of object data); decode of 1 erasure "
        f"{decode_s * 1e3:.4f} ms ({nbytes / decode_s / 1e9:.3f} GB/s)")
    log(f"  packet layout copies alone, batches of 20: _to_packets of the data "
        f"{list(data_t.shape)} {to_ms} ms, _from_packets of the parity "
        f"{list(packets_out.shape)} {from_ms} ms; together "
        f"{(to_ms + from_ms) / (encode_s * 1e3):.1%} of the device-resident encode")


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "ceph_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the ceph_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from ceph_tpu_torch.device import default_device
    from ceph_tpu_torch.ops import gf_cuda

    dev = default_device()
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()

    log("== 1. card")
    card = nvidia_smi("name,power.limit")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"capability {torch.cuda.get_device_capability(0)}")

    log("== 2. build")
    t0 = time.perf_counter()
    built = gf_cuda.build()
    log(f"  built {sorted(built) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {n: round(s, 1) for n, s in built.items()} })")
    for name in gf_cuda.SOURCES:
        for line in gf_cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("== 3. kernels against their plain versions")
    inputs = check_kernels(dev, rng)
    log("  all kernel checks bit-exact")

    log("== 4. main path through the registry")
    gf_cuda.reset_launches()
    run_main_path(dev, rng)
    torch.cuda.synchronize()
    launches = dict(gf_cuda.launches)
    log(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    log("== 5. timing")
    rows = time_kernels(dev, inputs, launches)
    time_end_to_end(dev, rng)
    time_packet_layout(dev, rng)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
