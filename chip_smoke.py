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
   registry, with host numpy in and out and device-resident, each with
   the kernel profiler's tap and with it bypassed, in turns; and the
   device-resident cauchy_good k=10 m=4 encode and decode beside the two
   packet-layout copies they make;
6. the OSD EC engine, with the launch counts set to 0 just before it: the
   cross-op microbatch dispatcher built as the OSD builds it (window
   0.0005 s, 512 stripes, bucketing on, launch deadline 30 s, failover on
   under an ``EngineSupervisor``, 2 worker threads, ``create_ec_perf``),
   driving pool A (ISA RS(8,3), stripe unit 4096: 64 concurrent 4 MiB
   writes, then ``decode_concat`` of all 64 with shard 0 lost and with
   shards 1, 5, 9 lost) and pool B (jerasure cauchy_good k=10 m=4,
   packetsize 4096: 64 concurrent 4 MiB objects padded to 13 stripes, then
   a four-erasure ``decode_concat``), every byte of every timed run
   checked against the host engine (pool A is also written a second time,
   and once more through a dispatcher with one worker thread); then one
   pool-A batch with ``inject_engine_failure`` on (its
   waiters must get the same bytes through the host replay) and the
   canary's re-promotion of the card.  Outside the injected batch no op
   may be served off the card (failovers, fallback-direct and
   native-direct all 0), ``gf_matmul`` must launch in pool A and
   ``bitmatrix_xor`` in pool B, and the supervisor must end HEALTHY.  It
   also times the parts of one dispatched 16 MiB ISA launch: the host
   gather, the copy to the card, the permute, the kernel, the
   concatenation, the copy back and the per-op slices.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

OBJECTS = 64
OBJECT_SIZE = 1 << 20
SEED = 20261017

# phase 6: the OSD's dispatcher defaults (ceph_tpu/common/config.py:261-300)
# and object size (RBD's default 4 MiB objects)
OSD_WINDOW_S = 0.0005
OSD_MAX_STRIPES = 512
OSD_LAUNCH_DEADLINE_S = 30.0
OSD_PROBE_INTERVAL_S = 1.0
OSD_WORKERS = 2
OSD_OBJECT_SIZE = 4 << 20
OSD_OPS = 64
# pool A: ISA RS(8,3) with Ceph's default stripe unit (chunk) of 4096
POOL_A = ("isa", {"k": "8", "m": "3"}, 4096)
# pool B: the BASELINE jerasure cauchy_good k=10 m=4, packetsize 4096
# (its chunk is w * packetsize = 32768)
POOL_B = ("jerasure", {"technique": "cauchy_good", "k": "10", "m": "4",
                       "packetsize": "4096"}, 32768)

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
    from ceph_tpu_torch.ops.profiler import KernelProfiler, profiler

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

    def dev_encode_x10():  # a caller that keeps the card fed
        for _ in range(10):
            codec.encode_chunks(data_t)
        torch.cuda.synchronize()

    cases = {
        "encode_host_numpy": (lambda: codec.encode_chunks(data), 10),
        "decode_host_numpy": (lambda: codec.decode_chunks(present, survivors, missing), 10),
        "encode_device_resident": (dev_encode, 20),
        "decode_device_resident": (dev_decode, 20),
        "encode_device_resident_10_back_to_back": (dev_encode_x10, 10),
    }
    # the codec entries pass through the kernel profiler's tap; time them
    # with the tap and with it bypassed, in turns (on, off, off, on)
    tap = KernelProfiler.call_jitted

    def bypass(self, engine, key, fn, args, *, nbytes=0, shape=None, wrap=None):
        out = fn(*args)
        return out if wrap is None else wrap(out)

    times = {key: {"on": [], "off": []} for key in cases}
    try:
        for mode in ("on", "off", "off", "on"):
            KernelProfiler.call_jitted = tap if mode == "on" else bypass
            for key, (fn, reps) in cases.items():
                times[key][mode].append(time_wall(fn, reps))
    finally:
        KernelProfiler.call_jitted = tap
    # the tap times a call on the card between CUDA events, read later
    profiler().reset()
    for _ in range(20):
        codec.encode_chunks(data_t)
    eng = profiler().dump()["engines"]["gf_encode"]
    tap_s = eng["exec_time"] + eng["first_exec_s"]
    if eng["calls"] != 20 or not tap_s > 0:
        raise AssertionError(f"profiler tap on the card: {eng}")
    log(f"  profiler gf_encode, 20 device-resident calls back to back: "
        f"{tap_s / 20 * 1e3:.4f} ms a call on the card (CUDA events)")
    gbps = {}
    for key, t in times.items():
        on, off = statistics.median(t["on"]), statistics.median(t["off"])
        n = 10 * nbytes if key.endswith("back_to_back") else nbytes
        gbps[key] = n / on / 1e9
        log(f"  isa RS(8,3) {key}: {gbps[key]:.3f} GB/s ({on * 1e3:.4f} ms for "
            f"{n // nbytes} x {OBJECTS} x 1 MiB objects, host clock); profiler tap bypassed "
            f"{n / off / 1e9:.3f} GB/s ({off * 1e3:.4f} ms); each pass, ms: "
            f"on {[round(x * 1e3, 4) for x in t['on']]}, "
            f"off {[round(x * 1e3, 4) for x in t['off']]}")
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


# -- phase 6: the OSD EC engine ----------------------------------------------------


def _delta(before: dict, after: dict) -> dict:
    """after - before over the numbers of two nested dispatcher dumps."""
    out = {}
    for key, value in after.items():
        if isinstance(value, dict):
            out[key] = _delta(before.get(key, {}), value)
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            out[key] = value - before.get(key, 0)
    return out


def _pool_line(name: str, before: dict, after: dict) -> str:
    d = _delta(before, after)
    t = d["totals"]
    buckets = {k: v for k, v in d["buckets"].items() if v}
    return (f"  {name}: ops {t['ops']}, stripes {t['stripes']}, batches {t['batches']}, "
            f"flush {t['flush_reasons']}, pad stripes {t['pad_stripes']}, buckets {buckets}")


def _check_shards(what: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want) or any(
            not np.array_equal(np.asarray(got[s]), np.asarray(want[s])) for s in want):
        raise AssertionError(f"{what}: shards differ from ec_util.encode_fallback")


def time_launch_breakdown(dev, codec, sinfo, objs) -> dict:
    """The parts of one dispatched ISA launch of OSD_MAX_STRIPES stripes,
    each timed alone: host gather of the ops' payloads into one buffer,
    copy to the card, the permute to shard rows, the kernel, the
    concatenation of data and parity rows, the copy back, and the per-op
    shard slices the waiters get; beside the whole ``ec_util.encode``
    call on the gathered buffer.  Host parts on the host clock (ending
    synchronised), device parts with CUDA events in batches of 20."""
    import torch

    from ceph_tpu_torch.osd import ec_util

    sw, cs = sinfo.stripe_width, sinfo.chunk_size
    k = codec.get_data_chunk_count()
    per_op = len(objs[0]) // sw

    def gather():
        cat = np.zeros(OSD_MAX_STRIPES * sw, dtype=np.uint8)
        for i, o in enumerate(objs):
            cat[i * per_op * sw:(i + 1) * per_op * sw] = o
        return cat

    cat = gather()
    d3 = cat.view(np.int32).reshape(OSD_MAX_STRIPES, k, cs // 4)

    def h2d():
        x = torch.from_numpy(d3).to(dev)
        torch.cuda.synchronize()
        return x

    x = h2d()
    flat = x.permute(1, 0, 2).reshape(k, -1)
    parity = codec._engine(flat)
    out = torch.cat([flat, parity])
    host_out = out.cpu().numpy()

    def slices():
        return [{s: host_out[s][i * per_op * cs // 4:(i + 1) * per_op * cs // 4].copy()
                 for s in range(host_out.shape[0])} for i in range(len(objs))]

    def d2h():
        out.cpu().numpy()

    def whole():
        ec_util.encode(sinfo, codec, cat)

    parts = {
        "host gather": time_wall(gather, 10) * 1e3,
        "copy to the card": time_wall(h2d, 10) * 1e3,
        "permute": time_cuda(lambda: x.permute(1, 0, 2).reshape(k, -1), reps=20, batch=20),
        "kernel": time_cuda(lambda: codec._engine(flat), reps=20, batch=20),
        "cat": time_cuda(lambda: torch.cat([flat, parity]), reps=20, batch=20),
        "copy back": time_wall(d2h, 10) * 1e3,
        "per-op slices": time_wall(slices, 10) * 1e3,
    }
    whole_ms = time_wall(whole, 10) * 1e3
    # the same call as the dispatcher makes it: on a freshly gathered
    # buffer each time, and from a worker thread
    fresh_ms = time_wall(lambda: ec_util.encode(sinfo, codec, gather()), 10) * 1e3
    n = per_op * cs

    def cycle():  # what one dispatcher worker does for one launch
        out = ec_util.encode(sinfo, codec, gather())
        return [{s: a[i * n:(i + 1) * n].copy() for s, a in out.items()}
                for i in range(len(objs))]

    with ThreadPoolExecutor(1) as pool:
        worker_ms = time_wall(lambda: pool.submit(whole).result(), 10) * 1e3
        cycle_ms = time_wall(lambda: pool.submit(cycle).result(), 10) * 1e3
        # the dispatcher's waiters hold their slices, so each launch
        # allocates fresh host memory instead of reusing the last one's
        kept = []
        kept_ms = time_wall(lambda: kept.append(pool.submit(cycle).result()), 10) * 1e3
        del kept
    total = sum(parts.values())
    log(f"  one dispatched ISA launch of {OSD_MAX_STRIPES} stripes "
        f"({OSD_MAX_STRIPES * sw >> 20} MiB in, {host_out.nbytes >> 20} MiB out), "
        f"parts timed alone (ms): " + ", ".join(
            f"{name} {ms} ({ms / total:.1%})" for name, ms in parts.items()))
    log(f"  sum of parts {total} ms; ec_util.encode on the gathered buffer {whole_ms} ms, "
        f"on a fresh gather each call {fresh_ms} ms with the gather, from a worker "
        f"thread {worker_ms} ms; gather, encode and slices in a worker thread "
        f"{cycle_ms} ms, keeping every launch's slices as the waiters do {kept_ms} ms")
    return {"parts_ms": parts, "whole_encode_ms": whole_ms}


def run_osd_engine(dev, rng) -> dict:
    """Phase 6 (see the module docstring).  Returns the kernels' launch
    counts over the whole drive, counted from one reset at its start:
    both pool-A gathers and its decodes, the one-worker run, pool B, the
    canary's probes and the batch after re-promotion (the injected batch
    launches nothing; the launch breakdown's timing launches come after
    and are not counted)."""
    import asyncio

    import torch

    from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.ops.profiler import profiler
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
    from ceph_tpu_torch.osd.ec_failover import HEALTHY, STATE_NAMES, EngineSupervisor
    from ceph_tpu_torch.osd.ec_perf import create_ec_perf

    def make_pool(spec):
        plugin, profile, chunk = spec
        codec = registry.instance().factory(plugin, dict(profile))
        if codec.device != dev:
            raise AssertionError(f"{plugin} codec on {codec.device}, expected {dev}")
        k = codec.get_data_chunk_count()
        return codec, ec_util.StripeInfo(k * chunk, chunk)

    codec_a, sinfo_a = make_pool(POOL_A)
    codec_b, sinfo_b = make_pool(POOL_B)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(OSD_OPS)]
    objs_b = [np.frombuffer(sinfo_b.pad_to_stripe(o.tobytes()), dtype=np.uint8)
              for o in objs]
    total_bytes = OSD_OPS * OSD_OBJECT_SIZE
    log(f"  pool A: isa k=8 m=3, chunk {sinfo_a.chunk_size}, stripe width "
        f"{sinfo_a.stripe_width}; pool B: cauchy_good k=10 m=4, chunk "
        f"{sinfo_b.chunk_size}, stripe width {sinfo_b.stripe_width}; "
        f"{OSD_OPS} objects of {OSD_OBJECT_SIZE >> 20} MiB "
        f"({len(objs_b[0]) // sinfo_b.stripe_width} stripes each in pool B)")

    perf = PerfCountersCollection()
    pec = create_ec_perf(perf)
    sup = EngineSupervisor(enabled=True, perf=pec, probe_interval=OSD_PROBE_INTERVAL_S)
    launches = {}

    async def main():
        disp = ECDispatcher(
            perf=pec, window=OSD_WINDOW_S, max_stripes=OSD_MAX_STRIPES, bucket=True,
            max_workers=OSD_WORKERS, supervisor=sup,
            launch_deadline=OSD_LAUNCH_DEADLINE_S,
        )

        async def timed(coros):
            t0 = time.perf_counter()
            out = await asyncio.gather(*coros)
            return out, time.perf_counter() - t0

        def gbps(seconds):
            return f"{total_bytes / seconds / 1e9:.3f} GB/s ({seconds * 1e3:.1f} ms)"

        def snapshot():
            torch.cuda.synchronize()
            return dict(gf_cuda.launches)

        def kernel_counts(name, since):
            got = {n: c - since[n] for n, c in snapshot().items()}
            log(f"  launches in {name}: {got}")
            return got

        def off_card(d, name):
            t = d["totals"]
            for key in ("failovers", "fallback_direct", "native_direct", "deadline_timeouts"):
                if t[key]:
                    raise AssertionError(f"{t[key]} {key} in {name}: an op was served off "
                                         "the card")

        # the phase's launches are counted from this one reset
        gf_cuda.reset_launches()
        start = snapshot()
        want_a = [ec_util.encode_fallback(sinfo_a, codec_a, o) for o in objs]

        # pool A
        profiler().reset()
        before = disp.dump()
        shards_a, enc_s = await timed(disp.encode(sinfo_a, codec_a, o) for o in objs)
        again, enc2_s = await timed(disp.encode(sinfo_a, codec_a, o) for o in objs)
        for run in (shards_a, again):
            for i, got in enumerate(run):
                _check_shards(f"pool A op {i}", got, want_a[i])
        del again
        log(f"  pool A encode, {OSD_OPS} x 4 MiB, bytes == encode_fallback in both: first "
            f"gather {gbps(enc_s)}, second {gbps(enc2_s)} (host clock)")
        for lost in ((0,), (1, 5, 9)):
            outs, dec_s = await timed(
                disp.decode_concat(sinfo_a, codec_a,
                                   {s: v for s, v in sh.items() if s not in lost})
                for sh in shards_a)
            for i, (o, got) in enumerate(zip(objs, outs)):
                if bytes(got) != o.tobytes():
                    raise AssertionError(f"pool A op {i}: decode_concat of {lost} differs")
            log(f"  pool A decode_concat with shards {list(lost)} lost, bytes == written: "
                f"{gbps(dec_s)} (host clock)")
        log(_pool_line("pool A", before, disp.dump()))
        launches["pool A"] = kernel_counts("pool A", start)
        shard_eng = profiler().dump()["engines"]["ec_shards"]
        hits = shard_eng["jit_cache"]["hits"]
        log(f"  profiler ec_shards: {shard_eng['calls']} calls, shapes {shard_eng['shapes']}, "
            f"first call {shard_eng['first_exec_s'] * 1e3:.3f} ms, steady state "
            f"{shard_eng['exec_time'] / max(hits, 1) * 1e3:.3f} ms a call over {hits} "
            f"calls ({shard_eng['exec_gbps']} GB/s of input lanes)")
        del shards_a
        # the same writes through a dispatcher with one worker thread:
        # what the second worker's overlap buys, and what it costs each call
        one = ECDispatcher(window=OSD_WINDOW_S, max_stripes=OSD_MAX_STRIPES, max_workers=1)
        profiler().reset()
        one_out, one_s = await timed(one.encode(sinfo_a, codec_a, o) for o in objs)
        await one.stop()
        for i, got in enumerate(one_out):
            _check_shards(f"pool A op {i} through one worker", got, want_a[i])
        off_card(one.dump(), "the one-worker run")
        del one_out, want_a
        one_eng = profiler().dump()["engines"]["ec_shards"]
        log(f"  pool A encode through one worker thread, bytes == encode_fallback: "
            f"{gbps(one_s)}; ec_shards "
            f"{one_eng['exec_time'] / max(one_eng['jit_cache']['hits'], 1) * 1e3:.3f} ms "
            f"a call (host clock)")

        # pool B
        since = snapshot()
        before = disp.dump()
        shards_b, enc_s = await timed(disp.encode(sinfo_b, codec_b, o) for o in objs_b)
        for i, (o, got) in enumerate(zip(objs_b, shards_b)):
            _check_shards(f"pool B op {i}", got, ec_util.encode_fallback(sinfo_b, codec_b, o))
        lost = (0, 4, 11, 13)
        outs, dec_s = await timed(
            disp.decode_concat(sinfo_b, codec_b, {s: v for s, v in sh.items() if s not in lost})
            for sh in shards_b)
        for i, (o, got) in enumerate(zip(objs_b, outs)):
            if bytes(got) != o.tobytes():
                raise AssertionError(f"pool B op {i}: decode_concat of {lost} differs")
        log(f"  pool B encode, {OSD_OPS} objects, bytes == encode_fallback: {gbps(enc_s)}; "
            f"decode_concat with shards {list(lost)} lost, bytes == written: "
            f"{gbps(dec_s)} (host clock, object bytes before padding)")
        log(_pool_line("pool B", before, disp.dump()))
        launches["pool B"] = kernel_counts("pool B", since)
        del shards_b, outs

        off_card(disp.dump(), "pools A and B")
        if launches["pool A"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched in pool A")
        if launches["pool B"]["bitmatrix_xor"] == 0:
            raise AssertionError("bitmatrix_xor was not launched in pool B")

        # failover: two pool-A launches with the injected fault, then the canary
        batch = objs[:2 * OSD_MAX_STRIPES // (OSD_OBJECT_SIZE // sinfo_a.stripe_width)]
        disp.inject_engine_failure = 1
        replayed, _ = await timed(disp.encode(sinfo_a, codec_a, o) for o in batch)
        disp.inject_engine_failure = 0
        for i, (o, got) in enumerate(zip(batch, replayed)):
            _check_shards(f"injected batch op {i}", got,
                          ec_util.encode_fallback(sinfo_a, codec_a, o))
        t = disp.dump()["totals"]
        log(f"  injected fault: {len(batch)} ops, failovers {t['failovers']}, replayed ops "
            f"{t['replayed_ops']}, supervisor {STATE_NAMES[sup.state]}; bytes == "
            f"encode_fallback")
        if t["failovers"] != 2 or t["replayed_ops"] != len(batch):
            raise AssertionError(f"injected fault: failovers {t['failovers']}, "
                                 f"replayed {t['replayed_ops']}")
        t0 = time.perf_counter()
        while sup.state != HEALTHY:
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"canary did not re-promote: {sup.dump()}")
            await asyncio.sleep(0.05)
        log(f"  canary re-promoted the card after {time.perf_counter() - t0:.2f} s "
            f"(probes {sup.totals['probes']}, promotions {sup.totals['promotions']})")
        since = snapshot()
        after, _ = await timed(disp.encode(sinfo_a, codec_a, o) for o in batch[:4])
        for i, (o, got) in enumerate(zip(batch, after)):
            _check_shards(f"post-promotion op {i}", got,
                          ec_util.encode_fallback(sinfo_a, codec_a, o))
        launches["after promotion"] = kernel_counts("the batch after re-promotion", since)
        t = disp.dump()["totals"]
        if (t["failovers"], t["fallback_direct"], t["native_direct"]) != (2, 0, 0):
            raise AssertionError(f"ops served off the card outside the injected batch: {t}")
        if launches["after promotion"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched after re-promotion")
        if sup.state != HEALTHY:
            raise AssertionError(f"supervisor {STATE_NAMES[sup.state]} at the end")
        log(f"  dispatcher totals: {t}")
        log(f"  ec perf: encode_time {pec.dump()['encode_time']}, "
            f"decode_time {pec.dump()['decode_time']}")
        await disp.stop()
        launches["phase"] = kernel_counts("the whole phase", start)

    asyncio.run(main())
    time_launch_breakdown(dev, codec_a, sinfo_a,
                          objs[:OSD_MAX_STRIPES // (OSD_OBJECT_SIZE // sinfo_a.stripe_width)])
    return launches["phase"]


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

    log("== 6. OSD EC engine")
    osd_launches = run_osd_engine(dev, rng)
    for row in rows:
        row["launches_osd_engine"] = osd_launches[row["name"]]
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
