"""Benchmark sweep: plugins x techniques x (k, m), GB/s per cell.

Clone of ``qa/workunits/erasure-code/bench.sh``: same grid (plugins
{isa, jerasure} x techniques {vandermonde, cauchy} x k in {2,3,4,6,10} with
the k->ms table at reference:bench.sh:108-113), same packetsize formula
(:90-101: ~size/(k*w*16) rounded to 16, capped at 3100), same GB/s
derivation (:166).  Output is JSON lines (one per cell) instead of flot JS.

Usage: python -m ceph_tpu_torch.tools.bench_sweep [--size 4096] [--iterations N]
       [--quick] [--batch N] [--device cuda|cpu]

Counterpart of ``ceph_tpu/tools/bench_sweep.py`` over this package's
``ec_benchmark``, with its ``--device`` (default ``cuda``: the codecs run
on the card; ``cpu`` runs the plain torch engines).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import ec_benchmark

K2MS = {2: [1], 3: [2], 4: [2, 3], 6: [2, 3, 4], 10: [3, 4]}
PLUGINS = {
    "jerasure": {"vandermonde": "reed_sol_van", "cauchy": "cauchy_good"},
    "isa": {"vandermonde": "reed_sol_van", "cauchy": "cauchy"},
}


def packetsize(k: int, w: int, size: int) -> int:
    """reference:bench.sh:90-101."""
    p = size // (k * w * 16) * 16
    p = min(p, 3100)
    return max(p, 16)


def cell_args(plugin: str, tech_name: str, k: int, m: int, size: int,
              iterations: int, workload: str, erasures: int, batch: int,
              device: str = "cuda"):
    technique = PLUGINS[plugin][tech_name]
    params = [f"k={k}", f"m={m}", f"technique={technique}"]
    if plugin == "jerasure" and technique.startswith("cauchy"):
        params.append(f"packetsize={packetsize(k, 8, size)}")
    argv = [
        "--plugin", plugin, "--workload", workload, "--size", str(size),
        "--iterations", str(iterations), "--erasures", str(erasures),
        "--batch", str(batch), "--device", device,
    ]
    for p in params:
        argv += ["--parameter", p]
    return argv


def run_cell(argv) -> tuple[float, int]:
    args = ec_benchmark.parse_args(argv)
    profile = ec_benchmark.make_profile(args.parameter)
    from ..models import registry

    codec = registry.instance().factory(args.plugin, profile, device=args.device)
    if args.workload == "encode":
        return ec_benchmark.run_encode(codec, args)
    return ec_benchmark.run_decode(codec, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="EC benchmark sweep (bench.sh clone)")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--quick", action="store_true", help="k in {2,4} only, 10 iters")
    ap.add_argument("--workloads", default="encode,decode")
    ap.add_argument("--device", default="cuda",
                    help="torch device the codecs run on (cuda or cpu)")
    args = ap.parse_args(argv)
    grid = {2: [1], 4: [2]} if args.quick else K2MS
    iterations = 10 if args.quick else args.iterations
    for plugin, techs in PLUGINS.items():
        for tech_name in techs:
            for k, ms in grid.items():
                for m in ms:
                    for workload in args.workloads.split(","):
                        erasures = min(m, 2)
                        cell = cell_args(plugin, tech_name, k, m, args.size,
                                         iterations, workload, erasures,
                                         args.batch, args.device)
                        try:
                            seconds, total_bytes = run_cell(cell)
                        except Exception as e:  # a cell failing shouldn't kill the sweep
                            print(json.dumps({
                                "plugin": plugin, "technique": tech_name,
                                "k": k, "m": m, "workload": workload,
                                "error": str(e),
                            }))
                            continue
                        gbps = (total_bytes / (1 << 30)) / seconds if seconds else 0.0
                        print(json.dumps({
                            "plugin": plugin, "technique": tech_name, "k": k,
                            "m": m, "workload": workload, "size": args.size,
                            "iterations": iterations, "seconds": round(seconds, 6),
                            "total_kib": total_bytes // 1024,
                            "gbps": round(gbps, 6),
                        }))
                        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
