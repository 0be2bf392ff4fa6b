"""osdmaptool: inspect and exercise OSDMaps offline
(reference:src/tools/osdmaptool.cc).

The port's own copy of ``ceph_tpu/tools/osdmaptool.py``, with the same
output.  ``--test-map-pgs`` walks each PG through the scalar mapper, as
the reference does.

The reference tool prints maps, simulates PG mappings (--test-map-pgs,
--test-map-object), and edits state (--mark-out, --createsimple).  Maps
are this framework's JSON wire form (OSDMap.to_dict).

Usage:
  osdmaptool --createsimple N -o map.json
  osdmaptool map.json --print
  osdmaptool map.json --test-map-pgs [--pool ID]
  osdmaptool map.json --test-map-object NAME --pool ID
  osdmaptool map.json --mark-out N -o new.json
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

from ..osd.osdmap import OSDMap, build_simple


def _load(path: str) -> OSDMap:
    with open(path) as f:
        return OSDMap.from_dict(json.load(f))


def _save(m: OSDMap, path: str) -> None:
    with open(path, "w") as f:
        json.dump(m.to_dict(), f, indent=1)


def _print(m: OSDMap) -> None:
    print(f"epoch {m.epoch}")
    print(f"fsid {m.fsid}")
    print(f"max_osd {m.max_osd}")
    for pool in m.pools.values():
        kind = "erasure" if pool.type == 3 else "replicated"
        print(
            f"pool {pool.id} '{pool.name}' {kind} size {pool.size} "
            f"min_size {pool.min_size} pg_num {pool.pg_num} "
            f"crush_ruleset {pool.crush_ruleset}"
            + (
                f" profile {pool.erasure_code_profile}"
                if pool.erasure_code_profile else ""
            )
        )
    for osd in range(m.max_osd):
        if not m.exists(osd):
            continue
        state = ("up" if m.is_up(osd) else "down") + (
            " in" if m.is_in(osd) else " out"
        )
        addr = m.get_addr(osd) or "-"
        print(f"osd.{osd} {state} {addr}")


def _test_map_pgs(m: OSDMap, pool_id: int | None) -> int:
    if pool_id is not None:
        pool = m.pools.get(pool_id)
        if pool is None:
            print(f"pool {pool_id} does not exist", file=sys.stderr)
            return 1
        pools = [pool]
    else:
        pools = list(m.pools.values())
    if not pools:
        print("no pools", file=sys.stderr)
        return 1
    counts: Counter[int] = Counter()
    primaries: Counter[int] = Counter()
    total = 0
    short = 0
    for pool in pools:
        for pg in m.pgs_of_pool(pool.id):
            _up, _upp, acting, primary = m.pg_to_up_acting_osds(pg)
            placed = [o for o in acting if o >= 0]
            counts.update(placed)
            if primary >= 0:
                primaries[primary] += 1
            total += 1
            if len(placed) < pool.size:
                short += 1
    print(f"pool pg_count {total} (undersized {short})")
    if counts:
        avg = sum(counts.values()) / len(counts)
        print("#osd\tcount\tprimary")
        for osd in sorted(counts):
            print(f"osd.{osd}\t{counts[osd]}\t{primaries.get(osd, 0)}")
        lo, hi = min(counts.values()), max(counts.values())
        print(f"avg {avg:.1f} min {lo} max {hi} spread {hi - lo}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool", description=__doc__)
    p.add_argument("mapfile", nargs="?")
    p.add_argument("--createsimple", type=int, metavar="N")
    p.add_argument("-o", "--output")
    p.add_argument("--print", dest="do_print", action="store_true")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--test-map-object", metavar="NAME")
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--mark-out", type=int, metavar="OSD", default=None)
    args = p.parse_args(argv)

    if args.createsimple:
        m = build_simple(args.createsimple)
        if not args.output:
            print("--createsimple needs -o", file=sys.stderr)
            return 2
        _save(m, args.output)
        print(f"wrote {args.output} with {args.createsimple} osds")
        return 0

    if not args.mapfile:
        p.print_usage()
        return 2
    m = _load(args.mapfile)

    if args.do_print:
        _print(m)
    if args.test_map_pgs:
        rc = _test_map_pgs(m, args.pool)
        if rc:
            return rc
    if args.test_map_object:
        if args.pool is None:
            print("--test-map-object needs --pool", file=sys.stderr)
            return 2
        pg, acting, primary = m.object_to_acting(
            args.test_map_object, args.pool
        )
        print(
            f"object '{args.test_map_object}' -> pg {pg} -> "
            f"acting {acting} primary osd.{primary}"
        )
    if args.mark_out is not None:
        m.mark_out(args.mark_out)
        m.epoch += 1
        if not args.output:
            print("--mark-out needs -o", file=sys.stderr)
            return 2
        _save(m, args.output)
        print(f"marked osd.{args.mark_out} out -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
