"""Time, tune and inspect the region kernels on one CUDA card.

Run from the root of the repository on a machine with a card and
``nvcc``::

    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --time
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --compare TREE
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --sweep
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep [--kernel K] --sass OUT_DIR [--mt N]

``--kernel`` picks ``gf_matmul`` (the default) or ``bitmatrix_xor``.

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
lanes.

``--compare TREE`` runs ``--time`` in four processes, in turns: the
package in TREE (for example an earlier commit unpacked with
``git archive``), this one, this one, TREE.  Only the wrappers'
signatures ``gf_table(matrix, w, device)``, ``gf_matmul(table,
lanes)``, ``bitmatrix_table(bitmatrix, device)`` and
``bitmatrix_xor(table, lanes)`` are assumed of TREE.

``--sweep`` builds the kernel's source once per variant of its tuning
constants (written into copies of the source, all ``nvcc`` processes
started together; a ``gf_matmul`` variant of the plan's capacity packs
its tables to match), and times each variant through the wrapper as
``--time`` does, the variants forward and then backward.

``--sass`` writes ``cuobjdump -sass`` of the built library to
``OUT_DIR/<kernel>.sass`` and prints the opcode counts of one
instantiation: the w=8 kernel of an output tile of ``--mt`` (default 3,
ISA's RS(8,3)) for ``gf_matmul``, the output tile of ``--mt`` (default
32, cauchy_good k=10 m=4) for ``bitmatrix_xor``.  With
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


def compare(kernel: Kernel, tree: Path, reps: int) -> None:
    here = Path(gf_cuda.__file__).resolve().parents[2]
    for root in (tree.resolve(), here, here, tree.resolve()):
        path = os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))
        env = dict(os.environ, PYTHONPATH=path)
        subprocess.run([sys.executable, __file__, "--kernel", kernel.name, "--time",
                        "--reps", str(reps)], env=env, check=True)


def _variant_source(kernel: Kernel, v, out_dir: Path) -> Path:
    source = gf_cuda.SOURCES[kernel.name]
    text = (gf_cuda.CSRC / source).read_text()
    for name, value in zip(kernel.tuning, v):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"{source} has no single constant {name}")
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


def sweep(kernel: Kernel, reps: int) -> None:
    nvcc = gf_cuda._nvcc()
    procs = {}
    for v in kernel.variants:
        tag = "_".join(f"{n}{x}" for n, x in zip(kernel.tuning, v))
        src = _variant_source(kernel, v, SWEEP_DIR / kernel.name / tag)
        lib = src.with_name(f"lib{kernel.name}.so")
        cmd = [nvcc, *gf_cuda.NVCC_FLAGS, "-I", str(gf_cuda.CSRC), "-o", str(lib), str(src)]
        procs[tag] = (v, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (v, proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise gf_cuda.KernelBuildError(f"{tag}:\n{log}")
        print(json.dumps({"built": tag, f"mt{kernel.mt}_registers": _registers(kernel, log)}),
              flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), f"{kernel.name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = gf_cuda._ARGTYPES[kernel.name]
        libs[tag] = (v, fn)

    class _Lib:  # stands in for the loaded library inside the wrapper
        def __init__(self, fn):
            setattr(self, f"{kernel.name}_launch", fn)

    cases = _cases(kernel)
    tags = list(libs)
    plan = (gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS, gf_cuda.PLAN_BYTES)
    times: dict[tuple[str, str], list] = {}
    try:
        for tag in tags + tags[::-1]:
            v, fn = libs[tag]
            gf_cuda._LIBS[kernel.name] = _Lib(fn)
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


def sass(kernel: Kernel, out_dir: Path, mt: int) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(gf_cuda._nvcc()).parent / "cuobjdump")
    gf_cuda.build((kernel.name,))
    text = subprocess.run([cuobjdump, "-sass", str(gf_cuda.library_path(kernel.name))],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / f"{kernel.name}.sass").write_text(text)
    sym = re.compile(r"Function : \S*" + kernel.symbol.format(mt=mt))
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = bool(sym.search(line))
        elif inside:
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
            if op:
                body.append(op.group(2).split(".")[0])
    print(json.dumps({"package": str(Path(gf_cuda.__file__).parents[2]),
                      "kernel": kernel.name, "mt": mt, "instructions": len(body),
                      "by_opcode": dict(Counter(body).most_common())}), flush=True)
    for line in gf_cuda.build_log(kernel.name).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(json.dumps({"ptxas": line.strip()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="gf_matmul")
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
    kernel = KERNELS[args.kernel]
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    if args.sass:
        sass(kernel, args.sass, args.mt or kernel.mt)
    if args.time:
        time_package(kernel, args.reps)
    if args.compare:
        compare(kernel, args.compare, args.reps)
    if args.sweep:
        sweep(kernel, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
