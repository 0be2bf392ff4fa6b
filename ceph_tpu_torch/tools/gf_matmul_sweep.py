"""Time, tune and inspect the ``gf_matmul`` kernel on one CUDA card.

Run from the root of the repository on a machine with a card and
``nvcc``::

    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep --time
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep --compare TREE
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep --sweep
    python3 -m ceph_tpu_torch.tools.gf_matmul_sweep --sass OUT_DIR [--mt 3]

``--time`` checks ``gf_cuda.gf_matmul`` bit-exact against the plain
version and times it through that public wrapper (CUDA events, median
over ``--reps`` samples of 20 back-to-back calls, per call, and of one
call, which also counts the host's launch latency) on ISA's and
jerasure's RS(8,3) matrices and an all-ones 3x8 matrix (no doubling:
the ring and the stores alone) over [8, 2,097,152] lanes (64 MiB in),
and on ISA's over [8, 4096] lanes, where the host's cost of a launch
shows; then torch's device copy of the same 64 MiB as a yardstick of
the card's practical memory rate.

``--compare TREE`` runs ``--time`` in four processes, in turns: the
package in TREE (for example an earlier commit unpacked with
``git archive``), this one, this one, TREE.  Only the wrapper's
signatures ``gf_table(matrix, w, device)`` and ``gf_matmul(table,
lanes)`` are assumed of TREE.

``--sweep`` builds ``csrc/gf_matmul.cu`` once per variant of its tuning
constants (written into copies of the source, all ``nvcc`` processes
started together; a variant of the plan's capacity packs its tables to
match), and times each variant through the wrapper as ``--time`` does,
the variants forward and then backward.

``--sass`` writes ``cuobjdump -sass`` of the built library to
``OUT_DIR/gf_matmul.sass`` and prints the opcode counts of its w=8
kernel for an output tile of ``--mt`` (3, ISA's RS(8,3)).  With
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

import numpy as np
import torch

from ceph_tpu_torch.ops import gf_cuda, gf_torch, matrices as mx

N4 = (64 << 20) // 8 // 4
SWEEP_DIR = gf_cuda.BUILD_DIR / "sweep"
TUNING = ("CONSUMERS", "V_MAX", "KC", "S", "PLAN_ROWS")
# (consumer threads a block, lanes a thread, input rows a stage, stages,
#  input rows a launch's plan holds at w=8)
VARIANTS = [
    (256, 8, 1, 4, 256),  # the source's own
    (256, 8, 2, 2, 256), (256, 8, 2, 3, 256), (256, 8, 2, 4, 256), (256, 8, 2, 8, 256),
    (256, 8, 1, 2, 256), (256, 8, 3, 2, 256), (256, 8, 4, 4, 256), (128, 8, 2, 2, 256),
    (128, 8, 4, 2, 256), (256, 4, 2, 2, 256), (512, 4, 2, 2, 256), (256, 16, 1, 2, 256),
    (256, 8, 2, 2, 224), (256, 8, 2, 2, 128), (256, 8, 2, 2, 64),
]


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


def _cases(dev) -> dict:
    """name -> (matrix, lanes, the plain version's output)."""
    rng = np.random.default_rng(20261017)
    d32 = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(8, N4), dtype=np.int64)
                           .astype(np.int32)).to(dev)
    isa = mx.isa_rs_vandermonde(8, 3)
    cases = {"isa": (isa, d32), "jerasure": (mx.rs_vandermonde(8, 3, 8), d32),
             "ones": (np.ones((3, 8), dtype=np.int64), d32),
             "isa_4096_lanes": (isa, d32[:, :4096].contiguous())}
    return {name: (M, x, gf_torch.gf_matmul_u32(M, x, 8)) for name, (M, x) in cases.items()}


def _time_cases(cases: dict, what: str, reps: int) -> dict:
    """Check each case bit-exact, then time it: name -> (ms in batches of
    20, ms with one call a sample)."""
    out = {}
    for name, (M, x, want) in cases.items():
        table = gf_cuda.gf_table(M, 8, x.device)
        got = gf_cuda.gf_matmul(table, x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what} {name}: differs from the plain version")
        out[name] = (_time(lambda: gf_cuda.gf_matmul(table, x), reps),
                     _time(lambda: gf_cuda.gf_matmul(table, x), 5 * reps, batch=1))
    return out


def time_package(reps: int) -> None:
    cases = _cases(torch.device("cuda"))
    package = str(Path(gf_cuda.__file__).parents[2])
    for name, (ms, one) in _time_cases(cases, "gf_matmul", reps).items():
        print(json.dumps({"package": package, "matrix": name, "ms": ms,
                          "ms_one_launch": one}), flush=True)
    src = cases["isa"][1]
    dst = torch.empty_like(src)
    ms = _time(lambda: dst.copy_(src), reps)
    print(json.dumps({"copy_64MiB_ms": ms, "GB_per_s": 2 * src.numel() * 4 / ms / 1e6}),
          flush=True)


def compare(tree: Path, reps: int) -> None:
    here = Path(gf_cuda.__file__).resolve().parents[2]
    for root in (tree.resolve(), here, here, tree.resolve()):
        path = os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))
        env = dict(os.environ, PYTHONPATH=path)
        subprocess.run([sys.executable, __file__, "--time", "--reps", str(reps)],
                       env=env, check=True)


def _variant_source(v, out_dir: Path) -> Path:
    text = (gf_cuda.CSRC / "gf_matmul.cu").read_text()
    for name, value in zip(TUNING, v):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"gf_matmul.cu has no single constant {name}")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "gf_matmul.cu").write_text(text)
    return out_dir / "gf_matmul.cu"


def _registers(log: str, w: int, mt: int) -> str:
    """ptxas's register count of the gf_matmul_kernel<w, mt> instantiation."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "Used" in line and entry and f"gf_matmul_kernelILi{w}ELi{mt}E" in entry:
            return line.split("Used")[1].split(",")[0].strip()
    return "?"


def sweep(reps: int) -> None:
    nvcc = gf_cuda._nvcc()
    procs = {}
    for v in VARIANTS:
        tag = "_".join(f"{n}{x}" for n, x in zip(TUNING, v))
        src = _variant_source(v, SWEEP_DIR / tag)
        lib = src.with_name("libgf_matmul.so")
        cmd = [nvcc, *gf_cuda.NVCC_FLAGS, "-I", str(gf_cuda.CSRC), "-o", str(lib), str(src)]
        procs[tag] = (v, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (v, proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise gf_cuda.KernelBuildError(f"{tag}:\n{log}")
        consumers, lanes, kc, stages, _ = v
        print(json.dumps({"built": tag, "w8_mt3_registers": _registers(log, 8, 3),
                          "ring_bytes_a_block": stages * kc * consumers * lanes * 4}),
              flush=True)
        fn = ctypes.CDLL(str(lib)).gf_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = gf_cuda._ARGTYPES["gf_matmul"]
        libs[tag] = (v[-1], fn)

    class _Lib:  # stands in for the loaded library inside gf_cuda.gf_matmul
        def __init__(self, fn):
            self.gf_matmul_launch = fn

    cases = _cases(torch.device("cuda"))
    tags = list(libs)
    plan = (gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS, gf_cuda.PLAN_BYTES)
    times: dict[tuple[str, str], list] = {}
    try:
        for tag in tags + tags[::-1]:
            rows, fn = libs[tag]
            gf_cuda._LIBS["gf_matmul"] = _Lib(fn)
            gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS = rows, 8 * rows
            gf_cuda.PLAN_BYTES = rows + 2 * 8 * rows
            for name, ms in _time_cases(cases, tag, reps).items():
                times.setdefault((tag, name), []).append(ms)
    finally:
        gf_cuda._LIBS.pop("gf_matmul", None)
        gf_cuda.PLAN_ROWS, gf_cuda.PLAN_MASKS, gf_cuda.PLAN_BYTES = plan
    for (tag, name), ts in times.items():
        print(json.dumps({"variant": tag, "matrix": name, "ms": [t[0] for t in ts],
                          "ms_one_launch": [t[1] for t in ts]}), flush=True)


def sass(out_dir: Path, mt: int) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(gf_cuda._nvcc()).parent / "cuobjdump")
    gf_cuda.build(("gf_matmul",))
    text = subprocess.run([cuobjdump, "-sass", str(gf_cuda.library_path("gf_matmul"))],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / "gf_matmul.sass").write_text(text)
    sym = re.compile(rf"Function : \S*gf_matmul_kernel\S*ILi8ELi{mt}E")
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = bool(sym.search(line))
        elif inside:
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
            if op:
                body.append(op.group(2).split(".")[0])
    print(json.dumps({"package": str(Path(gf_cuda.__file__).parents[2]),
                      "kernel": f"w=8 MT={mt}", "instructions": len(body),
                      "by_opcode": dict(Counter(body).most_common())}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--compare", type=Path, metavar="TREE")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sass", type=Path, metavar="OUT_DIR")
    ap.add_argument("--mt", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_matmul_sweep: CUDA is not available", file=sys.stderr)
        return 2
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    if args.sass:
        sass(args.sass, args.mt)
    if args.time:
        time_package(args.reps)
    if args.compare:
        compare(args.compare, args.reps)
    if args.sweep:
        sweep(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
