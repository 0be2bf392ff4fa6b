"""ceph-objectstore-tool: offline surgery on an OSD's store
(reference:src/tools/ceph_objectstore_tool.cc).

Operates on a WalStore directory while the daemon is DOWN — list
PGs/objects, dump one object (data+attrs+omap), export a PG to a file,
import it into another store, remove objects.  The reference tool is
the disaster-recovery path for unrecoverable PGs; same role here.

Usage:
  objectstore_tool --data-path /var/osd.0 --op list
  objectstore_tool --data-path ... --op list-pgs
  objectstore_tool --data-path ... --op dump --pgid 1.3 --oid obj1
  objectstore_tool --data-path ... --op export --pgid 1.3 --file pg.export
  objectstore_tool --data-path ... --op import --file pg.export
  objectstore_tool --data-path ... --op remove --pgid 1.3 --oid obj1

Counterpart of ``ceph_tpu/tools/objectstore_tool.py``, over the port's
stores.  The journal and checkpoint formats are the reference's, so
either package's tool reads a store the other wrote.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys

from ..store import CollectionId, ObjectId, Transaction
from ..store.wal import WalStore


def _open(path: str) -> WalStore:
    store = WalStore(path)
    store.mount()
    return store


def _b64(b: bytes) -> str:
    return base64.b64encode(bytes(b)).decode()


def _object_record(store: WalStore, cid: CollectionId, oid: ObjectId) -> dict:
    return {
        "oid": oid.name,
        "shard": oid.shard,
        "data": _b64(store.read(cid, oid)),
        "attrs": {k: _b64(v) for k, v in store.getattrs(cid, oid).items()},
        "omap": {k: _b64(v) for k, v in store.omap_get(cid, oid).items()},
    }


def _op_list(store: WalStore, args) -> int:
    for cid in sorted(store.list_collections(), key=str):
        if args.pgid and not str(cid).startswith(args.pgid):
            continue
        for oid in store.list_objects(cid):
            print(json.dumps([str(cid), oid.name, oid.shard]))
    return 0


def _op_list_pgs(store: WalStore, args) -> int:
    for cid in sorted(store.list_collections(), key=str):
        if str(cid) != "meta":
            print(cid)
    return 0


def _op_dump(store: WalStore, args) -> int:
    cid = CollectionId(args.pgid)
    for oid in store.list_objects(cid):
        if oid.name == args.oid:
            json.dump(_object_record(store, cid, oid), sys.stdout, indent=1)
            print()
            return 0
    print(f"object {args.oid!r} not found in {args.pgid}", file=sys.stderr)
    return 1


def _op_export(store: WalStore, args) -> int:
    cid = CollectionId(args.pgid)
    if not store.collection_exists(cid):
        print(f"no pg {args.pgid}", file=sys.stderr)
        return 1
    out = {
        "pgid": args.pgid,
        "objects": [
            _object_record(store, cid, oid)
            for oid in store.list_objects(cid)
        ],
    }
    with open(args.file, "w") as f:
        json.dump(out, f)
    print(f"exported {len(out['objects'])} objects from {args.pgid}")
    return 0


def _op_import(store: WalStore, args) -> int:
    with open(args.file) as f:
        data = json.load(f)
    cid = CollectionId(data["pgid"])
    txn = Transaction().create_collection(cid)
    for rec in data["objects"]:
        oid = ObjectId(rec["oid"], rec.get("shard", -1))
        txn.remove(cid, oid)
        txn.write(cid, oid, 0, base64.b64decode(rec["data"]))
        for k, v in rec.get("attrs", {}).items():
            txn.setattr(cid, oid, k, base64.b64decode(v))
        if rec.get("omap"):
            txn.omap_setkeys(
                cid, oid,
                {k: base64.b64decode(v) for k, v in rec["omap"].items()},
            )
    store.apply(txn)
    print(f"imported {len(data['objects'])} objects into {data['pgid']}")
    return 0


def _op_remove(store: WalStore, args) -> int:
    cid = CollectionId(args.pgid)
    txn = Transaction().remove(cid, ObjectId(args.oid, args.shard))
    store.apply(txn)
    print(f"removed {args.pgid}/{args.oid}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="objectstore_tool", description=__doc__)
    p.add_argument("--data-path", required=True,
                   help="the OSD's WalStore directory (daemon must be down)")
    p.add_argument("--op", required=True,
                   choices=["list", "list-pgs", "dump", "export", "import",
                            "remove"])
    p.add_argument("--pgid", default=None)
    p.add_argument("--oid", default=None)
    p.add_argument("--shard", type=int, default=-1)
    p.add_argument("--file", default=None)
    args = p.parse_args(argv)

    need = {"dump": ("pgid", "oid"), "export": ("pgid", "file"),
            "import": ("file",), "remove": ("pgid", "oid")}
    for field in need.get(args.op, ()):
        if getattr(args, field) is None:
            p.error(f"--op {args.op} requires --{field}")

    store = _open(args.data_path)
    try:
        fn = {
            "list": _op_list, "list-pgs": _op_list_pgs, "dump": _op_dump,
            "export": _op_export, "import": _op_import, "remove": _op_remove,
        }[args.op]
        return fn(store, args)
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
