#!/usr/bin/env python3
"""Count, window by window, the launches a ``kernel trace`` capture holds.

Runs ``chip_smoke.py``'s phases 7 to 10 on the card (the history that
phase 11 follows in a whole run), then phase 11 again and again: each
time one ``kernel trace`` window over ``accel.a``'s admin socket around
pools A and B.  For each window it prints one JSON line with the
launches the EC kernels' wrappers counted (``gf_cuda.launches``, the
phase's only launches) beside the kernel events the window's dump holds
(its ``top_ops`` counts), and last a tally of whole and short windows.

    python3 trace_windows.py [--windows N] [--tree DIR]

``--tree DIR`` runs DIR's ``chip_smoke.py`` and ``ceph_tpu_torch``
instead of this checkout's, for example the parent commit unpacked with
``git archive``; phase 11's own check of the capture, where DIR has
one, reports here instead of failing the run.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

EC_KERNELS = ("gf_matmul", "bitmatrix_xor")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trace_windows: CUDA is not available", file=sys.stderr)
        return 2
    cs = importlib.import_module("chip_smoke")
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.ops.profiler import profiler

    print(json.dumps({"tree": args.tree, "card": cs.nvidia_smi("name,power.limit"),
                      "torch": torch.__version__}), flush=True)
    gf_cuda.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    t0 = time.perf_counter()
    cs.run_crush(dev, rng)
    cs.run_churn(dev, rng)
    figures: dict = {}
    cs.run_accel_service(dev, rng, {}, figures)
    cs.run_accel_fleet(dev, rng, figures)
    print(json.dumps({"history_s": round(time.perf_counter() - t0, 1)}), flush=True)

    dumps = []
    check = cs.check_trace_window

    def keep(result, *rest):
        dumps.append(result)
        try:
            return check(result, *rest)
        except AssertionError as e:
            print(json.dumps({"phase_11_check": str(e)[:300]}), flush=True)
            return 1.0

    cs.check_trace_window = keep
    short = 0
    for i in range(args.windows):
        profiler().reset()
        counted = cs.run_observability(dev, rng)
        ops = dumps[-1]["top_ops"]
        captured = {k: sum(op["count"] for op in ops if f"{k}_kernel" in op["name"])
                    for k in EC_KERNELS}
        whole = all(captured[k] == counted[k] for k in EC_KERNELS)
        short += not whole
        print(json.dumps({"window": i, "counted": {k: counted[k] for k in EC_KERNELS},
                          "captured": captured, "whole": whole,
                          "device_seconds": dumps[-1]["device_seconds"],
                          "wall_s": dumps[-1]["wall_s"]}), flush=True)
    print(json.dumps({"windows": args.windows, "short": short}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
