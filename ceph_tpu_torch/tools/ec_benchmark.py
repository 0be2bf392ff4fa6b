"""Erasure-code micro-benchmark CLI.

Counterpart of ``ceph_tpu/tools/ec_benchmark.py``, with one flag more:
``--device`` (default ``cuda``; ``cpu`` runs the plain torch engines).
Data goes in and comes out as host numpy, so each timed call includes
the copies to the device and back.

Clone of ``ceph_erasure_code_benchmark``
(reference:src/test/erasure-code/ceph_erasure_code_benchmark.cc): same
flags (:42-64), same workloads (encode loop :180-186, decode loop
:298-323 with random/exhaustive erasure generation and a correctness
check per iteration), same two-column output ``<seconds>\t<total_KiB>``
(:187,:325).  ``qa/workunits/erasure-code/bench.sh:166`` derives GB/s as
``(total/1024/1024)/seconds``.

``--batch N`` encodes N objects per device call (one ``[k, N*chunk]``
launch), the way to fill the device; the reported total scales
accordingly.  ``--batch 1`` reproduces the reference's strictly
per-object loop.

Usage:
  python -m ceph_tpu_torch.tools.ec_benchmark --plugin jerasure \
      --parameter k=2 --parameter m=1 --workload encode --size 1048576 \
      --iterations 100
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys
import time

import numpy as np

from ..models import registry
from ..models.interface import ErasureCodeInterface


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="erasure code benchmark (ceph_erasure_code_benchmark clone)"
    )
    ap.add_argument("--plugin", "-P", default="jerasure")
    ap.add_argument("--workload", "-w", choices=("encode", "decode"),
                    default="encode")
    ap.add_argument("--size", "-s", type=int, default=1 << 20,
                    help="object size in bytes (default 1MiB)")
    ap.add_argument("--iterations", "-i", type=int, default=1)
    ap.add_argument("--erasures", "-e", type=int, default=1,
                    help="number of erasures per decode iteration")
    ap.add_argument("--erased", type=int, action="append", default=None,
                    help="explicit chunk index to erase (repeatable)")
    ap.add_argument("--erasures-generation", "-E",
                    choices=("random", "exhaustive"), default="random")
    ap.add_argument("--parameter", "-p", action="append", default=[],
                    metavar="K=V", help="profile parameter, e.g. k=2")
    ap.add_argument("--batch", type=int, default=1,
                    help="objects per device call (1 = reference loop)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the codec runs on (cuda or cpu)")
    ap.add_argument("--verbose", "-v", action="store_true")
    return ap.parse_args(argv)


def make_profile(params: list[str]) -> dict[str, str]:
    profile: dict[str, str] = {}
    for p in params:
        if "=" not in p:
            raise SystemExit(f"--parameter {p!r} is not K=V")
        key, val = p.split("=", 1)
        profile[key] = val
    return profile


def _erasure_sets(codec: ErasureCodeInterface, args) -> "itertools.cycle":
    """Iterator of chunk-index tuples to erase, per --erasures-generation."""
    n = codec.get_chunk_count()
    if args.erased:
        return itertools.repeat(tuple(args.erased))
    if args.erasures_generation == "exhaustive":
        combos = list(itertools.combinations(range(n), args.erasures))
        return itertools.cycle(combos)
    rnd = random.Random(0)

    def gen():
        while True:
            yield tuple(rnd.sample(range(n), args.erasures))

    return gen()


def run_encode(codec: ErasureCodeInterface, args) -> tuple[float, int]:
    n = codec.get_chunk_count()
    want = list(range(n))
    rng = np.random.default_rng(0)
    k = codec.get_data_chunk_count()
    chunk = codec.get_chunk_size(args.size)
    if args.batch == 1:
        data = rng.integers(0, 256, size=args.size, dtype=np.uint8).tobytes()
        codec.encode(want, data)  # warm up (kernel build and load)
        begin = time.perf_counter()
        for _ in range(args.iterations):
            codec.encode(want, data)
        elapsed = time.perf_counter() - begin
        return elapsed, args.size * args.iterations
    # batched: one [k, batch*chunk] launch per iteration
    arr = rng.integers(0, 256, size=(k, args.batch * chunk), dtype=np.uint8)
    codec.encode_chunks(arr)
    begin = time.perf_counter()
    for _ in range(args.iterations):
        codec.encode_chunks(arr)
    elapsed = time.perf_counter() - begin
    return elapsed, args.size * args.iterations * args.batch


def run_decode(codec: ErasureCodeInterface, args) -> tuple[float, int]:
    n = codec.get_chunk_count()
    k = codec.get_data_chunk_count()
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=args.size, dtype=np.uint8).tobytes()
    encoded = codec.encode(list(range(n)), data)
    sets = _erasure_sets(codec, args)
    # warm-up each distinct erasure signature would be unfair for random;
    # warm the first one to absorb the kernel build, as the reference's
    # first iteration absorbs table setup.
    first = next(sets)
    avail = {i: v for i, v in encoded.items() if i not in first}
    codec.decode(list(range(k)), avail)
    elapsed = 0.0
    for _ in range(args.iterations):
        erased = next(sets)
        avail = {i: v for i, v in encoded.items() if i not in erased}
        begin = time.perf_counter()
        decoded = codec.decode(list(range(k)), avail)
        elapsed += time.perf_counter() - begin
        # per-iteration correctness check, as contents_equal at
        # reference:ceph_erasure_code_benchmark.cc:234
        for i in range(k):
            if not np.array_equal(decoded[i], encoded[i]):
                raise SystemExit(f"chunk {i} differs after decode of {erased}")
    return elapsed, args.size * args.iterations


def main(argv=None) -> int:
    args = parse_args(argv)
    profile = make_profile(args.parameter)
    codec = registry.instance().factory(args.plugin, profile, device=args.device)
    if args.verbose:
        print(
            f"plugin={args.plugin} profile={profile} "
            f"k={codec.get_data_chunk_count()} m={codec.get_coding_chunk_count()}",
            file=sys.stderr,
        )
    if args.workload == "encode":
        elapsed, total_bytes = run_encode(codec, args)
    else:
        elapsed, total_bytes = run_decode(codec, args)
    # reference output format: "<seconds>\t<total KiB>"
    print(f"{elapsed:.6f}\t{total_bytes // 1024}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
