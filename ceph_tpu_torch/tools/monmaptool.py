"""monmaptool: create/edit/inspect monmap files
(reference:src/tools/monmaptool.cc).

Counterpart of ``ceph_tpu/tools/monmaptool.py``: the same files and the
same output, plus :func:`resolve_mon_arg` (the reference keeps it in its
rados client), which the port's ``tools/daemon.py`` applies to
``--monmap``.

The monmap file is the cluster-bootstrap artifact: daemons and clients
that are handed one know every monitor without asking anybody.  Format
is JSON: {"epoch": N, "mons": [{"rank", "name", "addr"}...]} — a
``--monmap`` flag accepts such a file in place of an address list.

Usage:
  monmaptool --create [--add NAME ADDR]... -o monmap.json
  monmaptool monmap.json --add mon.b 127.0.0.1:6790 [-o out.json]
  monmaptool monmap.json --rm mon.b [-o out.json]
  monmaptool monmap.json --print
"""

from __future__ import annotations

import argparse
import json
import sys


def load_monmap(path: str) -> dict:
    with open(path) as f:
        m = json.load(f)
    if "mons" not in m or not isinstance(m["mons"], list):
        raise ValueError(f"{path}: not a monmap (missing 'mons')")
    return m


def save_monmap(m: dict, path: str) -> None:
    normalized = {  # the caller's dict is left untouched
        **m,
        "mons": [
            {**mon, "rank": i}
            for i, mon in enumerate(
                sorted(m["mons"], key=lambda x: x["rank"])
            )
        ],
    }
    with open(path, "w") as f:
        json.dump(normalized, f, indent=1)
        f.write("\n")


def monmap_addrs(m: dict) -> list[str]:
    """Rank-ordered addresses (what Monitor.set_monmap and the clients
    consume)."""
    return [
        mon["addr"] for mon in sorted(m["mons"], key=lambda x: x["rank"])
    ]


def resolve_mon_arg(spec: str) -> "str | list[str]":
    """A mon argument: one address, a comma list, or a monmap FILE.  A
    broken monmap file exits with a CLI-friendly error, not a traceback
    — this only runs on operator-supplied values."""
    import os

    if os.path.isfile(spec):
        try:
            return monmap_addrs(load_monmap(spec))
        except Exception as e:
            print(f"error: bad monmap file {spec!r}: {e}", file=sys.stderr)
            raise SystemExit(2) from e
    return spec.split(",") if "," in spec else spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="monmaptool", description=__doc__)
    p.add_argument("monmap", nargs="?", help="existing monmap file")
    p.add_argument("--create", action="store_true")
    p.add_argument("--clobber", action="store_true",
                   help="--create may overwrite an existing file")
    p.add_argument("--add", nargs=2, action="append", default=[],
                   metavar=("NAME", "ADDR"))
    p.add_argument("--rm", action="append", default=[], metavar="NAME")
    p.add_argument("--print", dest="do_print", action="store_true")
    p.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)

    if args.create:
        import os

        target = args.out or args.monmap
        if target and os.path.exists(target) and not args.clobber:
            print(f"error: {target!r} exists (use --clobber to overwrite)",
                  file=sys.stderr)
            return 1
        m = {"epoch": 1, "mons": []}
    elif args.monmap:
        try:
            m = load_monmap(args.monmap)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    else:
        p.error("need a monmap file or --create")

    changed = False
    for name, addr in args.add:
        if any(x["name"] == name for x in m["mons"]):
            print(f"error: {name!r} already in the monmap", file=sys.stderr)
            return 1
        if any(x["addr"] == addr for x in m["mons"]):
            print(f"error: {addr!r} already in the monmap", file=sys.stderr)
            return 1
        m["mons"].append(
            {"rank": len(m["mons"]), "name": name, "addr": addr}
        )
        changed = True
    for name in args.rm:
        before = len(m["mons"])
        m["mons"] = [x for x in m["mons"] if x["name"] != name]
        if len(m["mons"]) == before:
            print(f"error: no mon {name!r}", file=sys.stderr)
            return 1
        for i, mon in enumerate(m["mons"]):
            mon["rank"] = i
        changed = True
    if changed:
        m["epoch"] = int(m.get("epoch", 0)) + 1

    if args.do_print or (not changed and not args.create and not args.out):
        print(f"epoch {m.get('epoch', 0)}")
        for mon in sorted(m["mons"], key=lambda x: x["rank"]):
            print(f"{mon['rank']}: {mon['addr']} {mon['name']}")
    out = args.out or (args.monmap if (changed or args.create) else None)
    if out:
        save_monmap(m, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
