"""ceph-monstore-tool: offline inspection of a mon's store
(reference:src/tools/ceph_monstore_tool.cc).

Usage:
  monstore_tool <store-dir> dump            # versions + meta
  monstore_tool <store-dir> get-osdmap [--version N] [-o FILE]

Counterpart of ``ceph_tpu/tools/monstore_tool.py``, over the port's
``mon/store.py``, whose format is the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..mon.store import MonitorDBStore


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="monstore_tool", description=__doc__)
    p.add_argument("store", help="MonitorDBStore directory")
    p.add_argument("op", choices=["dump", "get-osdmap"])
    p.add_argument("--version", type=int, default=None)
    p.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)

    db = MonitorDBStore(args.store)
    try:
        if args.op == "dump":
            versions = db.versions()
            print(json.dumps({
                "last_committed": db.last_committed(),
                "election_epoch": db.election_epoch(),
                "versions": versions,
            }, indent=1))
            return 0
        m = db.get_map(args.version)
        if m is None:
            print(f"no osdmap version {args.version}", file=sys.stderr)
            return 1
        text = json.dumps(m, indent=1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
