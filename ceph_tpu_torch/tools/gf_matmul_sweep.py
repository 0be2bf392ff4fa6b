"""Time, tune and inspect the region kernels (and the CRUSH kernels) on
one CUDA card.

Run from the root of the repository on a machine with a card and
``nvcc``::

    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --time
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --compare TREE
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --sweep
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --sass OUT_DIR [--mt N]

``--kernel`` picks ``gf_matmul`` (the default) or ``bitmatrix_xor``;
``crush_straw2`` and ``crush_choose`` take ``--time``, ``--compare`` and
``--sass``, ``crush_choose`` also ``--sweep``.

``--time`` checks the kernel's public wrapper bit-exact against the
plain version and times it through that wrapper (CUDA events, median
over ``--reps`` samples of 20 back-to-back calls, per call, and of one
call, which also counts the host's launch latency), each case beside
its bytes bound (each input row a nonzero column of the matrix reads
once, each output once); then torch's device copy of 64 MiB as a yardstick of
the card's practical memory rate.  ``gf_matmul``: ISA's and jerasure's
RS(8,3) matrices and an all-ones 3x8 matrix (no doubling: the ring and
the stores alone) over [8, 2,097,152] lanes (64 MiB in), and ISA's over
[8, 4096] lanes, where the host's cost of a launch shows.
``bitmatrix_xor``: jerasure cauchy_good k=10 m=4 w=8 (the [32, 80]
encode bit-matrix), its one-erasure decode bit-matrix ([8, 104], 24
zero columns) and its four-erasure one ([32, 80]) over 262,144 lanes
a row (1 MiB), a [32, 80] bit-matrix that gives each input row to one
output (80 set bits against cauchy_good's 888: the ring and the stores
with little XOR work) over the same lanes, and the encode over 4096
lanes.  ``crush_straw2``: checked bit-exact against ``straw2_plain`` and
timed on the row of ``CrushMap.flat(64)`` (the package's own tables)
over 1,000,000 lanes with random r, 64M draws.  ``crush_choose``: the
six cases of ``chip_smoke.py`` phases 7 and 8 (:func:`choose_cases`:
flat_64 firstn and indep, chooseleaf_16x4 and the 8 x 16 x 12 racks map
over x = 0..999,999; the replicated and the ISA k=8 m=3 pool of
``synthetic_map(10_240, 16)`` over their 65,536 PGs), each checked
bit-exact against ``mapper_torch.crush_choose_plain`` (the step
engine's loops, their draw on ``crush_straw2``), its draws counted and
its time set beside the bound of those draws
(:data:`INSTRUCTIONS_PER_DRAW` SASS instructions a draw at
:data:`ISSUE_LANES_PER_CLOCK_PER_SM`); in a package whose wrapper picks
a tile (``crush_cuda.choose_tile``), also the tile it picks, the sizes
it reads (the take row, the widest row on the rule's path, their
greatest common divisor) and the time at each tile.

``--compare TREE`` runs ``--time`` in four processes, in turns: the
package in TREE (for example an earlier commit unpacked with
``git archive``), this one, this one, TREE.  Only the wrappers'
signatures ``gf_table(matrix, w, device)``, ``gf_matmul(table,
lanes)``, ``bitmatrix_table(bitmatrix, device)`` and
``bitmatrix_xor(table, lanes)`` are assumed of TREE; for ``crush_straw2``,
``mapper_torch_hier.tables_for(cmap, device).rows``,
``crush_cuda.crush_straw2(rows, x, rows_of_lanes, r)`` and
``crush_torch.straw2_plain`` (every tree since the CRUSH slice), so the
draw of an earlier design is timed beside this one; for
``crush_choose``, ``fused_rule``, ``reweight_lanes``,
``crush_cuda.crush_choose(T, rule, x, reweight, draws)``,
``crush_choose_plain`` and ``osd.churn``'s ``synthetic_map``,
``_pps_vec`` and ``_int32_bits`` (every tree since the first
``crush_choose``).

``--sweep`` builds the kernel's source once per variant of its tuning
constants (written into copies of the source, all ``nvcc`` processes
started together; a ``gf_matmul`` variant of the plan's capacity packs
its tables to match), and times each variant through the wrapper as
``--time`` does, the variants forward and then backward; a
``crush_choose`` variant (threads a block, the blocks an SM holds at
least) is checked and timed at each tile on the six cases.

``--sass`` writes ``cuobjdump -sass`` of the built library to
``OUT_DIR/<kernel>.sass`` and prints the opcode counts of one
instantiation: the w=8 kernel of an output tile of ``--mt`` (default 3,
ISA's RS(8,3)) for ``gf_matmul``, the output tile of ``--mt`` (default
32, cauchy_good k=10 m=4) for ``bitmatrix_xor``, the one kernel for
``crush_straw2`` (the dump's addresses locate a draw's path: the item
loop and its normalisation branch, which :data:`INSTRUCTIONS_PER_DRAW`
counts; ``CALL`` opcodes show a divide subroutine) and each
instantiation of ``crush_choose`` (a tile G and the take row staged or
not), with ``ptxas``'s registers and stack frame of each function and
the local-memory loads and stores (``LDL``, ``STL``) of each; a
``crush_choose`` dump also counts ``crush_straw2``'s draw loop from its
dump: the loop's instructions less its normalisation branch's, which
is :data:`INSTRUCTIONS_PER_DRAW` while the draw is unchanged.
With
``PYTHONPATH=TREE python3 ceph_tpu_torch/tools/gf_matmul_sweep.py``
every mode runs on TREE's package instead.

Each result is one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.ops import gf_cuda, gf_torch, matrices as mx
from ceph_tpu_torch.ops.gf import gf

SWEEP_DIR = gf_cuda.BUILD_DIR / "sweep"
MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SEED = 20261017


class Kernel(NamedTuple):
    """What the modes need of one kernel: its table, wrapper and plain
    version, its cases, its tuning constants and their variants, and the
    mangled-name prefix of an output tile's instantiation with the tile
    that --sass reads by default."""

    name: str
    table: Callable
    run: Callable
    plain: Callable
    cases: Callable
    tuning: tuple
    variants: list
    symbol: str
    mt: int


def _lanes(rng, rows: int, n4: int, dev) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(rows, n4),
                                         dtype=np.int64).astype(np.int32)).to(dev)


def _gf_cases(dev) -> dict:
    """name -> (matrix, lanes)."""
    d32 = _lanes(np.random.default_rng(SEED), 8, (64 << 20) // 8 // 4, dev)
    isa = mx.isa_rs_vandermonde(8, 3)
    return {"isa": (isa, d32), "jerasure": (mx.rs_vandermonde(8, 3, 8), d32),
            "ones": (np.ones((3, 8), dtype=np.int64), d32),
            "isa_4096_lanes": (isa, d32[:, :4096].contiguous())}


def cauchy_decode_bitmatrix(missing) -> np.ndarray:
    """The recovery bit-matrix that a decode of jerasure cauchy_good
    k=10 m=4 w=8 launches to rebuild ``missing`` from every other chunk,
    built as ``BitmatrixErasureCode`` builds it: [8 * len(missing),
    8 * (14 - len(missing))], zero columns for the survivors past the
    first 10."""
    from ceph_tpu_torch.models import registry

    codec = registry.instance().factory(
        "jerasure", {"technique": "cauchy_good", "k": "10", "m": "4", "packetsize": "4096"},
        device="cpu")
    present = tuple(c for c in range(14) if c not in missing)
    return codec._recovery_bitmatrix(present, tuple(missing))[0]


def _bitmatrix_cases(dev) -> dict:
    """name -> (bit-matrix, lanes)."""
    rng = np.random.default_rng(SEED)
    n4 = 4 * 8 * 4096 * 64 // 8 // 4  # 64 objects of 1 MiB, rows of 1 MiB
    encode = gf(8).matrix_to_bitmatrix(mx.cauchy_good(10, 4, 8))
    p80 = _lanes(rng, 80, n4, dev)
    light = np.zeros((32, 80), dtype=np.uint8)  # every input row taken by one output
    light[np.arange(80) % 32, np.arange(80)] = 1
    return {"cauchy_good_10_4": (encode, p80),
            "one_output_a_row": (light, p80),
            "decode_1_erasure": (cauchy_decode_bitmatrix([3]), _lanes(rng, 104, n4, dev)),
            "decode_4_erasures": (cauchy_decode_bitmatrix([0, 4, 11, 13]), p80),
            "cauchy_good_4096_lanes": (encode, p80[:, :4096].contiguous())}


KERNELS = {
    "gf_matmul": Kernel(
        "gf_matmul", lambda M, dev: gf_cuda.gf_table(M, 8, dev), gf_cuda.gf_matmul,
        lambda M, x: gf_torch.gf_matmul_u32(M, x, 8), _gf_cases,
        # (consumer threads a block, lanes a thread, input rows a stage,
        #  stages, input rows a launch's plan holds at w=8)
        ("CONSUMERS", "V_MAX", "KC", "S", "PLAN_ROWS"),
        [(256, 8, 1, 4, 256),  # the source's own
         (256, 8, 2, 2, 256), (256, 8, 2, 3, 256), (256, 8, 2, 4, 256), (256, 8, 2, 8, 256),
         (256, 8, 1, 2, 256), (256, 8, 3, 2, 256), (256, 8, 4, 4, 256), (128, 8, 2, 2, 256),
         (128, 8, 4, 2, 256), (256, 4, 2, 2, 256), (512, 4, 2, 2, 256), (256, 16, 1, 2, 256),
         (256, 8, 2, 2, 224), (256, 8, 2, 2, 128), (256, 8, 2, 2, 64)],
        "gf_matmul_kernelILi8ELi{mt}E", 3),
    "bitmatrix_xor": Kernel(
        "bitmatrix_xor", gf_cuda.bitmatrix_table, gf_cuda.bitmatrix_xor,
        gf_torch.bitmatrix_matmul_u32, _bitmatrix_cases,
        # (consumer threads a block, output groups, lanes a thread at
        #  most, input rows a stage, stages)
        ("CONSUMERS", "GROUPS", "V_MAX", "KC", "S"),
        [(512, 8, 8, 4, 4),  # the source's own
         (256, 8, 8, 8, 4), (256, 4, 8, 4, 4), (256, 8, 16, 4, 4), (512, 8, 8, 2, 8),
         (512, 8, 8, 4, 3)],
        "bitmatrix_xor_kernelILi{mt}E", 32),
}
# the CRUSH kernels, which --sass, --time and --compare take (name -> the
# kernel's symbol)
CRUSH_SYMBOLS = {"crush_straw2": "crush_straw2_kernel", "crush_choose": "crush_choose_kernel"}
# the CRUSH kernels' bound counts SASS instructions over the issue rate:
# each SM's four schedulers issue at most one warp instruction (32 lanes)
# a clock each, whatever the pipe
ISSUE_LANES_PER_CLOCK_PER_SM = 128
# SASS instructions of one draw on flat_64's row (w > 0) in nvcc's sm_90a
# build on the card's machine, read from the dump of `--kernel
# crush_straw2 --sass`: the item loop (0x0b30-0x1840) 210, less the
# normalisation (0x1470-0x14c0, 6; only u + 1 < 0x8000 takes it, about
# half the draws, so leaving it out keeps the count a floor).  The divide
# by reciprocal is inline (three IMAD.WIDE and an IMAD.WIDE.X for the
# high product, then the correction); the dump has no CALL.
# crush_choose's draws are counted at the same figure: they run the same
# straw2_q (csrc/crush_draw.cuh), so the bound reads the same work
# whatever implements it (`--kernel crush_choose --sass` recounts
# crush_straw2's loop as a guard).
INSTRUCTIONS_PER_DRAW = 210 - 6
# crush_choose's tuning constants for --sweep (threads a block, blocks an
# SM holds at least) and their variants, the source's own first
CHOOSE_TUNING = ("kThreads", "kMinBlocks")
CHOOSE_VARIANTS = [(1024, 1), (512, 2), (256, 4)]
# phase 7: x = 0..CRUSH_X - 1; phase 8: a 10k-OSD map of 640 hosts of 16,
# two pools of CHURN_PG_NUM PGs
CRUSH_X = 1_000_000
CHURN_OSDS, CHURN_OSDS_PER_HOST, CHURN_PG_NUM = 10_240, 16, 65536
CHURN_EC = {"plugin": "isa", "k": "8", "m": "3"}


def _time(fn, reps: int, batch: int = 20) -> float:
    """Median over ``reps`` of the milliseconds per call of ``batch``
    back-to-back calls between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _cases(kernel: Kernel) -> dict:
    """name -> (matrix, lanes, the plain version's output)."""
    cases = kernel.cases(torch.device("cuda"))
    return {name: (M, x, kernel.plain(M, x)) for name, (M, x) in cases.items()}


def _time_cases(kernel: Kernel, cases: dict, what: str, reps: int) -> dict:
    """Check each case bit-exact, then time it: name -> (ms in batches of
    20, ms with one call a sample)."""
    out = {}
    for name, (M, x, want) in cases.items():
        table = kernel.table(M, x.device)
        got = kernel.run(table, x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what} {name}: differs from the plain version")
        out[name] = (_time(lambda: kernel.run(table, x), reps),
                     _time(lambda: kernel.run(table, x), 5 * reps, batch=1))
    return out


def time_package(kernel: Kernel, reps: int) -> None:
    cases = _cases(kernel)
    package = str(Path(gf_cuda.__file__).parents[2])
    for name, (ms, one) in _time_cases(kernel, cases, kernel.name, reps).items():
        M, x, _ = cases[name]
        used = np.count_nonzero(np.asarray(M).any(axis=0))  # a zero column's row is not read
        bound = (used + M.shape[0]) * x.shape[1] * 4 / MEMORY_BYTES_PER_S * 1e3
        print(json.dumps({"package": package, "kernel": kernel.name, "matrix": name,
                          "lanes": list(x.shape), "ms": ms, "ms_one_launch": one,
                          "bytes_bound_ms": bound}), flush=True)
    src = _lanes(np.random.default_rng(SEED), 8, (64 << 20) // 8 // 4, torch.device("cuda"))
    dst = torch.empty_like(src)
    ms = _time(lambda: dst.copy_(src), reps)
    print(json.dumps({"copy_64MiB_ms": ms, "GB_per_s": 2 * src.numel() * 4 / ms / 1e6}),
          flush=True)


def time_straw2(reps: int) -> None:
    """``crush_straw2`` on flat_64's row over 1,000,000 lanes: checked
    against ``straw2_plain``, then timed in batches of 20 and one launch
    a sample."""
    from ceph_tpu_torch.crush.map import CrushMap
    from ceph_tpu_torch.crush.mapper_torch_hier import tables_for
    from ceph_tpu_torch.ops import crush_cuda, crush_torch

    dev, n = torch.device("cuda"), 1_000_000
    T = tables_for(CrushMap.flat(64), dev).rows
    x = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.zeros_like(x)
    r = _lanes(np.random.default_rng(SEED), 1, n, dev)[0] & 0x7FFFFFFF
    got = crush_cuda.crush_straw2(T, x, rows, r)
    want = crush_torch.straw2_plain(T, x, rows, r)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("crush_straw2 differs from straw2_plain")
    ms = _time(lambda: crush_cuda.crush_straw2(T, x, rows, r), reps)
    one = _time(lambda: crush_cuda.crush_straw2(T, x, rows, r), 5 * reps, batch=1)
    print(json.dumps({"package": str(Path(gf_cuda.__file__).parents[2]),
                      "kernel": "crush_straw2", "row": "CrushMap.flat(64)", "lanes": n,
                      "draws": 64 * n, "ms": ms, "ms_one_launch": one,
                      "G_draws_per_s": 64 * n / ms / 1e6}), flush=True)


def crush_choose_maps(rng) -> list:
    """``chip_smoke.py`` phase 7's single-step cases: (name, map, rule,
    numrep, weights or None).  ``CrushMap.flat(64)`` with one firstn and
    one indep rule; ``bench.py``'s chooseleaf_16x4 (16 hosts of 4
    devices, chooseleaf firstn over hosts); a production-sized map of 8
    racks x 16 hosts x 12 devices (1536 OSDs, device weights 0.5 to 4
    from ``rng``, 8 devices out and 4 at half), chooseleaf firstn over
    hosts."""
    from ceph_tpu_torch.crush.map import CRUSH_BUCKET_STRAW2, CrushMap

    cases = []
    flat = CrushMap.flat(64)
    cases.append(("flat_64 firstn", flat, flat.add_simple_rule(flat.root_id(), 0), 3, None))
    cases.append(("flat_64 indep", flat,
                  flat.add_simple_rule(flat.root_id(), 0, indep=True), 3, None))
    h = CrushMap.hierarchical([list(range(4 * i, 4 * i + 4)) for i in range(16)])
    cases.append(("chooseleaf_16x4", h, h.add_simple_rule(h.root_id("default"), 1), 3, None))
    big = CrushMap()
    big.type_names.update({1: "host", 2: "rack", 3: "root"})
    dev_id, racks = 0, []
    for rk in range(8):
        hosts = []
        for hs in range(16):
            devs = list(range(dev_id, dev_id + 12))
            dev_id += 12
            ws = [int(w) for w in rng.integers(0x8000, 0x40000, size=12)]  # 0.5 to 4
            hosts.append(big.make_bucket(CRUSH_BUCKET_STRAW2, 1, devs, ws,
                                         name=f"rack{rk}-host{hs}"))
        racks.append(big.make_bucket(CRUSH_BUCKET_STRAW2, 2, hosts,
                                     [big.buckets[b].weight for b in hosts], name=f"rack{rk}"))
    big.make_bucket(CRUSH_BUCKET_STRAW2, 3, racks, [big.buckets[b].weight for b in racks],
                    name="default")
    picked = rng.choice(dev_id, size=12, replace=False)
    weights = big.get_weights(out=[int(d) for d in picked[:8]],
                              reweight={int(d): 0.5 for d in picked[8:]})
    cases.append(("racks_8x16x12 chooseleaf", big, big.add_simple_rule(big.root_id(), 1),
                  3, weights))
    return cases


def pool_lanes(m, pool, dev):
    """What ``ChurnPlanner.map_pool`` hands the mapper for ``pool`` of
    OSDMap ``m``: (rule, int32 lanes of the PGs' pps on ``dev``, the
    in/out weights)."""
    from ceph_tpu_torch.osd import churn

    ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
    seeds = torch.arange(pool.pg_num, dtype=torch.int64, device=dev)
    return ruleno, churn._int32_bits(churn._pps_vec(pool, seeds)), list(m.osd_weight)


def choose_cases(dev, rng) -> dict:
    """``crush_choose``'s six cases: name -> (tables, rule, lanes,
    reweight) on ``dev``; phase 7's four over x = 0..CRUSH_X - 1 and
    phase 8's two pools over their PGs."""
    from ceph_tpu_torch.crush.mapper_torch_hier import fused_rule, reweight_lanes, tables_for
    from ceph_tpu_torch.osd.churn import synthetic_map

    x = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    cases = [(name, cmap, ruleno, numrep, x, weights)
             for name, cmap, ruleno, numrep, weights in crush_choose_maps(rng)]
    m = synthetic_map(CHURN_OSDS, CHURN_OSDS_PER_HOST, replicated=(3, CHURN_PG_NUM),
                      ec=(CHURN_EC, CHURN_PG_NUM))
    for pool in m.pools.values():
        ruleno, lanes, weights = pool_lanes(m, pool, dev)
        cases.append((f"pool {pool.name} ({pool.pg_num} PGs x {pool.size})", m.crush, ruleno,
                      pool.size, lanes, weights))
    return {name: (tables_for(cmap, dev), fused_rule(cmap, ruleno, numrep), lanes,
                   reweight_lanes(cmap, weights, dev))
            for name, cmap, ruleno, numrep, lanes, weights in cases}


def issue_rate(dev) -> float:
    """Thread instructions the card issues a second at most: SMs x
    ISSUE_LANES_PER_CLOCK_PER_SM x the maximum SM clock."""
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * ISSUE_LANES_PER_CLOCK_PER_SM * float(clock.split()[0]) * 1e6


def time_choose(reps: int) -> None:
    """``crush_choose`` on its six cases (:func:`choose_cases`): checked
    against ``crush_choose_plain``, its draws counted, timed in batches
    of 20 and one launch a sample beside its bound; with a wrapper that
    picks a tile, at each tile too."""
    from ceph_tpu_torch.crush import mapper_torch
    from ceph_tpu_torch.ops import crush_cuda

    dev = torch.device("cuda")
    package = str(Path(gf_cuda.__file__).parents[2])
    tiled = hasattr(crush_cuda, "choose_tile")
    rate = issue_rate(dev)
    for name, (T, rule, x, rw) in choose_cases(dev, np.random.default_rng(SEED)).items():
        counted = torch.zeros(1, dtype=torch.int64, device=dev)
        got = crush_cuda.crush_choose(T, rule, x, rw, counted)
        want = mapper_torch.crush_choose_plain(T, rule, x, rw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"crush_choose {name}: differs from crush_choose_plain")
        draws = int(counted.item())
        ms = _time(lambda: crush_cuda.crush_choose(T, rule, x, rw), reps)
        bound = draws * INSTRUCTIONS_PER_DRAW / rate * 1e3
        row = {"package": package, "kernel": "crush_choose", "case": name,
               "lanes": x.shape[0], "width": rule.width, "draws": draws, "ms": ms,
               "ms_one_launch": _time(lambda: crush_cuda.crush_choose(T, rule, x, rw),
                                      5 * reps, batch=1),
               "bound_ms": bound, "share_of_bound": bound / ms}
        if tiled:
            row.update(tile=crush_cuda.choose_tile(T, rule), take_row=T.sizes[rule.take_row],
                       widest_row=rule.widest, row_gcd=rule.row_gcd)
            row["ms_by_tile"] = {
                g: _time(lambda: crush_cuda.crush_choose(T, rule, x, rw, tile=g), reps)
                for g in gf_cuda.CHOOSE_TILES}
        print(json.dumps(row), flush=True)


def compare(name: str, tree: Path, reps: int) -> None:
    here = Path(gf_cuda.__file__).resolve().parents[2]
    for root in (tree.resolve(), here, here, tree.resolve()):
        path = os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))
        env = dict(os.environ, PYTHONPATH=path)
        subprocess.run([sys.executable, __file__, "--kernel", name, "--time",
                        "--reps", str(reps)], env=env, check=True)


def _variant_source(name: str, tuning: tuple, v, out_dir: Path) -> Path:
    source = gf_cuda.SOURCES[name]
    text = (gf_cuda.CSRC / source).read_text()
    for const, value in zip(tuning, v):
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"{source} has no single constant {const}")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / source).write_text(text)
    return out_dir / source


def _registers(kernel: Kernel, log: str) -> str:
    """ptxas's register count of the instantiation that --sass reads."""
    entry, sym = None, kernel.symbol.format(mt=kernel.mt)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "Used" in line and entry and sym in entry:
            return line.split("Used")[1].split(",")[0].strip()
    return "?"


class _Lib:
    """Stands in for kernel ``name``'s loaded library inside its wrapper."""

    def __init__(self, name: str, fn):
        setattr(self, f"{name}_launch", fn)


def _build_variants(name: str, tuning: tuple, variants: list) -> dict:
    """Build kernel ``name``'s source once per variant of its tuning
    constants, all ``nvcc`` processes started together: tag -> (variant,
    launch function, compiler log)."""
    nvcc = gf_cuda._nvcc()
    procs = {}
    for v in variants:
        tag = "_".join(f"{n}{x}" for n, x in zip(tuning, v))
        src = _variant_source(name, tuning, v, SWEEP_DIR / name / tag)
        lib = src.with_name(f"lib{name}.so")
        cmd = [nvcc, *gf_cuda.NVCC_FLAGS, "-I", str(gf_cuda.CSRC), "-o", str(lib), str(src)]
        procs[tag] = (v, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (v, proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise gf_cuda.KernelBuildError(f"{tag}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = gf_cuda._ARGTYPES[name]
        libs[tag] = (v, fn, log)
    return libs


def sweep(kernel: Kernel, reps: int) -> None:
    libs = _build_variants(kernel.name, kernel.tuning, kernel.variants)
    for tag, (_v, _fn, log) in libs.items():
        print(json.dumps({"built": tag, f"mt{kernel.mt}_registers": _registers(kernel, log)}),
              flush=True)
    cases = _cases(kernel)
    tags = list(libs)
    plan = (gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS, gf_cuda.PLAN_BYTES)
    times: dict[tuple[str, str], list] = {}
    try:
        for tag in tags + tags[::-1]:
            v, fn, _log = libs[tag]
            gf_cuda._LIBS[kernel.name] = _Lib(kernel.name, fn)
            if kernel.name == "gf_matmul":
                rows = v[-1]
                gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS = rows, 8 * rows
                gf_cuda.PLAN_BYTES = rows + 2 * 8 * rows
            for name, ms in _time_cases(kernel, cases, tag, reps).items():
                times.setdefault((tag, name), []).append(ms)
    finally:
        gf_cuda._LIBS.pop(kernel.name, None)
        gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS, gf_cuda.PLAN_BYTES = plan
    for (tag, name), ts in times.items():
        print(json.dumps({"variant": tag, "matrix": name, "ms": [t[0] for t in ts],
                          "ms_one_launch": [t[1] for t in ts]}), flush=True)


def sweep_choose(reps: int) -> None:
    """``crush_choose``'s variants of CHOOSE_TUNING, each checked against
    ``crush_choose_plain`` and timed at every tile on the six cases, the
    variants forward and then backward."""
    from ceph_tpu_torch.crush import mapper_torch
    from ceph_tpu_torch.ops import crush_cuda

    libs = _build_variants("crush_choose", CHOOSE_TUNING, CHOOSE_VARIANTS)
    for tag, (_v, _fn, log) in libs.items():
        print(json.dumps({"built": tag, "ptxas": {
            fn.split("crush_choose_kernel")[-1][:12]: stats
            for fn, stats in _ptxas(log).items() if "crush_choose_kernel" in fn}}), flush=True)
    dev = torch.device("cuda")
    cases = choose_cases(dev, np.random.default_rng(SEED))
    want = {name: mapper_torch.crush_choose_plain(T, rule, x, rw)
            for name, (T, rule, x, rw) in cases.items()}
    tags = list(libs)
    times: dict[tuple[str, str, int], list] = {}
    try:
        for tag in tags + tags[::-1]:
            gf_cuda._LIBS["crush_choose"] = _Lib("crush_choose", libs[tag][1])
            for name, (T, rule, x, rw) in cases.items():
                for g in gf_cuda.CHOOSE_TILES:
                    got = crush_cuda.crush_choose(T, rule, x, rw, tile=g)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want[name]):
                        raise AssertionError(f"{tag} {name} tile {g}: differs from "
                                             "crush_choose_plain")
                    times.setdefault((tag, name, g), []).append(_time(
                        lambda: crush_cuda.crush_choose(T, rule, x, rw, tile=g), reps))
    finally:
        gf_cuda._LIBS.pop("crush_choose", None)
    for tag in tags:
        for name in cases:
            print(json.dumps({"variant": tag, "case": name, "ms_by_tile": {
                g: times[tag, name, g] for g in gf_cuda.CHOOSE_TILES}}), flush=True)


def _dump(name: str) -> str:
    """``cuobjdump -sass`` of kernel ``name``'s library, built if need be."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(gf_cuda._nvcc()).parent / "cuobjdump")
    gf_cuda.build((name,))
    return subprocess.run([cuobjdump, "-sass", str(gf_cuda.library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def _functions(text: str) -> dict:
    """The dump's functions: mangled name -> [(address, opcode, line)]."""
    funcs, body = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            body = funcs.setdefault(head.group(1), [])
            continue
        op = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if op and body is not None:
            body.append((int(op.group(1), 16), op.group(3).split(".")[0], line))
    return funcs


def _ptxas(log: str) -> dict:
    """ptxas -v's figures per function: mangled name -> registers, stack
    frame, spill stores and loads (bytes)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = out.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn is not None:
            fn.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                      spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    return out


def draw_loop(body: list) -> dict:
    """crush_straw2's item loop in its dump: the longest backward branch's
    span (instructions from its target to the branch), the forward branch
    inside it over the normalisation (the one block with ``FLO``, the
    count of leading zeros; instructions strictly between branch and
    target) and the draw, the first less the second."""
    where = {addr: i for i, (addr, _op, _line) in enumerate(body)}
    loops = []
    for i, (addr, op, line) in enumerate(body):
        target = re.search(r"BRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", line)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            start = where.get(int(target.group(1), 16))
            if start is not None:
                loops.append((i - start + 1, start, i))
    if not loops:
        return {"loop": None}
    span, start, end = max(loops)
    skips = []
    for i in range(start, end + 1):
        addr, op, line = body[i]
        target = re.search(r"BRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", line)
        if op == "BRA" and target and addr < int(target.group(1), 16):
            stop = where.get(int(target.group(1), 16), end)
            if any(o == "FLO" for _a, o, _l in body[i + 1:stop]):
                skips.append(stop - i - 1)
    normalisation = min(skips) if skips else None
    return {"loop": span, "normalisation": normalisation,
            "draw": span - normalisation if normalisation is not None else None,
            "counted_in_bound": INSTRUCTIONS_PER_DRAW}


def sass(name: str, symbol: str, out_dir: Path, mt: int | None) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    text = _dump(name)
    (out_dir / f"{name}.sass").write_text(text)
    stats = _ptxas(gf_cuda.build_log(name))
    package = str(Path(gf_cuda.__file__).parents[2])
    for fn, body in _functions(text).items():
        if not re.search(symbol, fn):
            continue
        ops = Counter(op for _a, op, _l in body)
        print(json.dumps({"package": package, "kernel": name, "function": fn, "mt": mt,
                          "instructions": len(body), "ptxas": stats.get(fn, {}),
                          "local_memory": {"LDL": ops["LDL"], "STL": ops["STL"]},
                          "by_opcode": dict(ops.most_common())}), flush=True)
        if name == "crush_straw2":
            print(json.dumps({"crush_straw2_draw": draw_loop(body)}), flush=True)
    if name == "crush_choose":  # the shared draw, unchanged: crush_straw2's loop recounted
        for fn, body in _functions(_dump("crush_straw2")).items():
            if CRUSH_SYMBOLS["crush_straw2"] in fn:
                print(json.dumps({"crush_straw2_draw": draw_loop(body)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted([*KERNELS, *CRUSH_SYMBOLS]), default="gf_matmul")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--compare", type=Path, metavar="TREE")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sass", type=Path, metavar="OUT_DIR")
    ap.add_argument("--mt", type=int)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_matmul_sweep: CUDA is not available", file=sys.stderr)
        return 2
    if args.kernel in CRUSH_SYMBOLS:
        if (args.sweep and args.kernel != "crush_choose") or not (
                args.sass or args.time or args.compare or args.sweep):
            ap.error(f"--kernel {args.kernel} takes --time, --compare and --sass"
                     + (" and --sweep" if args.kernel == "crush_choose" else ""))
        print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
        if args.sass:
            sass(args.kernel, CRUSH_SYMBOLS[args.kernel], args.sass, None)
        if args.time:
            (time_straw2 if args.kernel == "crush_straw2" else time_choose)(args.reps)
        if args.compare:
            compare(args.kernel, args.compare, args.reps)
        if args.sweep:
            sweep_choose(args.reps)
        return 0
    kernel = KERNELS[args.kernel]
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    if args.sass:
        mt = args.mt or kernel.mt
        sass(kernel.name, kernel.symbol.format(mt=mt), args.sass, mt)
    if args.time:
        time_package(kernel, args.reps)
    if args.compare:
        compare(kernel.name, args.compare, args.reps)
    if args.sweep:
        sweep(kernel, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
