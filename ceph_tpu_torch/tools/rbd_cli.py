"""rbd: the block-image CLI (reference:src/tools/rbd/ — `rbd` command).

The reference's operator surface for images:
  rbd -m MON -p POOL create NAME --size BYTES [--order N]
  rbd -m MON -p POOL ls
  rbd -m MON -p POOL info NAME
  rbd -m MON -p POOL rm NAME
  rbd -m MON -p POOL resize NAME --size BYTES
  rbd -m MON -p POOL snap create NAME@SNAP   (also: snap ls/rm/rollback)
  rbd -m MON -p POOL import LOCALFILE NAME
  rbd -m MON -p POOL export NAME LOCALFILE
  rbd -m MON -p POOL bench NAME --io-size N --io-total N
  rbd -m MON -p POOL lock ls NAME

Counterpart of ``ceph_tpu/tools/rbd_cli.py``: the same commands print the
same output, and its export-diff streams keep the reference's magic, so
either package's ``import-diff`` applies the other's.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from ..rados.client import RadosClient, RadosError, resolve_mon_arg
from ..rbd import RBD, Image


def _split_snap(spec: str) -> tuple[str, str]:
    if "@" not in spec:
        print(f"error: need IMAGE@SNAP, got {spec!r}", file=sys.stderr)
        raise SystemExit(2)
    name, snap = spec.split("@", 1)
    return name, snap


async def _cmd_create(rbd, io, args) -> int:
    kw = {}
    if args.order:
        kw["order"] = args.order
    if getattr(args, "journaling", False):
        kw["features"] = ["journaling"]
    await rbd.create(args.image, args.size, **kw)
    return 0


async def _cmd_mirror(rbd, io, args) -> int:
    """One-way journal mirroring into another pool (rbd-mirror lite,
    reference:src/tools/rbd_mirror)."""
    from ..rbd.mirror import ImageMirrorer, resolve_image_id

    dst_io = io.client.io_ctx(args.dest_pool)
    m = ImageMirrorer(io, dst_io, args.image, mirror_id=args.id)
    if args.mirror_cmd == "bootstrap":
        await m.bootstrap()
        print(f"bootstrapped {args.image} -> pool {args.dest_pool} "
              f"(position {m.position})")
        return 0
    from ..rbd.mirror import MirrorNotRegistered

    # sync resumes from the registered position (held by the source)
    m.image_id = await resolve_image_id(io, args.image)
    try:
        applied = await m.sync()
    except MirrorNotRegistered:
        print(
            f"error: {args.image} is not registered for mirror id "
            f"{args.id!r}; run `rbd mirror bootstrap` first",
            file=sys.stderr,
        )
        return 1
    print(f"replayed {applied} event(s)")
    return 0


async def _cmd_ls(rbd, io, args) -> int:
    for name in await rbd.list():
        print(name)
    return 0


async def _cmd_du(rbd, io, args) -> int:
    """`rbd du`: provisioned vs allocated bytes (sparse-aware),
    reference:src/tools/rbd/action/DiskUsage.cc."""
    img = await Image.open(io, args.image)
    try:
        d = await img.du()
    finally:
        await img.close()
    print(f"{'NAME':<20} {'PROVISIONED':>12} {'USED':>12} {'OBJECTS':>8}")
    print(f"{d['name']:<20} {d['provisioned']:>12} {d['used']:>12} "
          f"{d['objects']:>8}")
    return 0


async def _cmd_info(rbd, io, args) -> int:
    img = await Image.open(io, args.image)
    try:
        st = await img.stat()
    finally:
        await img.close()
    print(f"rbd image '{st['name']}':")
    print(f"\tsize {st['size']} bytes in {st['num_objs']} objects")
    print(f"\torder {st['order']} ({st['object_size']} byte objects)")
    print(f"\tid: {st['id']}")
    if st["snaps"]:
        print(f"\tsnapshots: {', '.join(st['snaps'])}")
    return 0


async def _cmd_rm(rbd, io, args) -> int:
    await rbd.remove(args.image)
    return 0


async def _cmd_resize(rbd, io, args) -> int:
    img = await Image.open(io, args.image)
    try:
        await img.resize(args.size)
    finally:
        await img.close()
    return 0


async def _cmd_snap(rbd, io, args) -> int:
    if args.snap_cmd == "ls":
        img = await Image.open(io, args.spec)
        try:
            for name in sorted(img.snaps):
                s = img.snaps[name]
                print(f"{s['id']}\t{name}\t{s['size']}")
        finally:
            await img.close()
        return 0
    name, snap = _split_snap(args.spec)
    img = await Image.open(io, name)
    try:
        if args.snap_cmd == "create":
            await img.snap_create(snap)
        elif args.snap_cmd == "rm":
            await img.snap_remove(snap)
        elif args.snap_cmd == "rollback":
            await img.snap_rollback(snap)
        elif args.snap_cmd == "protect":
            await img.snap_protect(snap)
        elif args.snap_cmd == "unprotect":
            await img.snap_unprotect(snap)
    finally:
        await img.close()
    return 0


async def _cmd_clone(rbd, io, args) -> int:
    parent, snap = _split_snap(args.parent_spec)
    await rbd.clone(parent, snap, args.child)
    return 0


async def _cmd_flatten(rbd, io, args) -> int:
    img = await Image.open(io, args.image)
    try:
        await img.flatten()
    finally:
        await img.close()
    return 0


async def _cmd_children(rbd, io, args) -> int:
    name, snap = _split_snap(args.spec)
    img = await Image.open(io, name)
    try:
        for child in await img.list_children(snap):
            print(child)
    finally:
        await img.close()
    return 0


async def _cmd_import(rbd, io, args) -> int:
    data = (
        sys.stdin.buffer.read() if args.path == "-"
        else open(args.path, "rb").read()
    )
    try:
        await rbd.create(args.image, len(data))
    except RadosError as e:
        if e.code != -17:  # EEXIST: import into the existing image
            raise
    img = await Image.open(io, args.image)
    if img.size_bytes != len(data):
        # the image must EQUAL the imported file afterwards: growing
        # only (and keeping a stale tail) would export mixed bytes
        await img.resize(len(data))
    try:
        step = 4 << 20
        for off in range(0, len(data), step):
            await img.write(off, data[off : off + step])
    finally:
        await img.close()
    return 0


DIFF_MAGIC = b"ceph_tpu-rbd-diff-v1\n"


async def _cmd_export_diff(rbd, io, args) -> int:
    """`rbd export-diff <image> <path> [--from-snap S] [--snap T]`:
    incremental backup between snapshots (reference:src/tools/rbd/
    action/ExportDiff.cc; object-granular records, same contract)."""
    import json as _json

    img = await Image.open(io, args.image)
    try:
        # validate snaps BEFORE opening/writing the output: a typo'd
        # snap name must be a clean error, not a traceback after a
        # partial file
        for name in (args.from_snap, args.snap):
            if name is not None and name not in img.snaps:
                print(f"error: no snap {name!r}", file=sys.stderr)
                return 1
        out = (
            sys.stdout.buffer if args.path == "-"
            else open(args.path, "wb")
        )
        try:
            to_size = (
                int(img.snaps[args.snap]["size"]) if args.snap
                else img.size_bytes
            )
            out.write(DIFF_MAGIC)
            out.write((_json.dumps({
                "from_snap": args.from_snap, "to_snap": args.snap,
                "size": to_size, "object_size": img.object_size,
            }) + "\n").encode())
            records = 0
            async for objectno, data in img.export_diff(
                args.from_snap, args.snap
            ):
                out.write((_json.dumps({
                    "objectno": objectno,
                    "len": None if data is None else len(data),
                }) + "\n").encode())
                if data is not None:
                    out.write(data)
                records += 1
            out.write(b'{"end": true}\n')
        finally:
            if out is not sys.stdout.buffer:
                out.close()  # flushed even on error: no silent partials
        print(f"exported {records} changed object(s)", file=sys.stderr)
    finally:
        await img.close()
    return 0


async def _cmd_import_diff(rbd, io, args) -> int:
    """`rbd import-diff <path> <image>`: apply an export-diff stream
    (reference ImportDiff): verifies the from-snap exists on the
    destination, applies records, and creates the to-snap at the
    end, so chained diffs replay in order."""
    import json as _json

    src = (
        sys.stdin.buffer if args.path == "-" else open(args.path, "rb")
    )
    try:
        if src.readline() != DIFF_MAGIC:
            print("error: not an rbd diff stream", file=sys.stderr)
            return 1
        hdr = _json.loads(src.readline())
        img = await Image.open(io, args.image)
        try:
            if hdr["from_snap"] and hdr["from_snap"] not in img.snaps:
                print(f"error: destination lacks from-snap "
                      f"{hdr['from_snap']!r}", file=sys.stderr)
                return 1
            if hdr.get("object_size") != img.object_size:
                # record offsets are object-granular: a different
                # destination order would land every record at the
                # wrong offset
                print(f"error: object size mismatch (stream "
                      f"{hdr.get('object_size')}, image "
                      f"{img.object_size})", file=sys.stderr)
                return 1
            if img.size_bytes != hdr["size"]:
                await img.resize(hdr["size"])
            try:
                while True:
                    rec = _json.loads(src.readline())
                    if rec.get("end"):
                        break
                    data = None
                    if rec["len"] is not None:
                        data = src.read(rec["len"])
                        if len(data) != rec["len"]:
                            raise ValueError("short record")
                    await img.apply_diff_record(rec["objectno"], data)
            except (ValueError, KeyError, AttributeError, TypeError) as e:
                # truncated/corrupt stream: a clean error, and NO
                # to-snap — a retry after a fresh export re-applies
                # over the partial state (records are idempotent)
                print(f"error: corrupt diff stream ({e}); image "
                      "partially imported, to-snap NOT created",
                      file=sys.stderr)
                return 1
            if hdr["to_snap"]:
                await img.snap_create(hdr["to_snap"])
        finally:
            await img.close()
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    return 0


async def _cmd_export(rbd, io, args) -> int:
    img = await Image.open(io, args.image, snap_name=args.snap)
    try:
        size = (
            int(img.snaps[args.snap]["size"]) if args.snap
            else img.size_bytes
        )
        out = (
            sys.stdout.buffer if args.path == "-"
            else open(args.path, "wb")
        )
        step = 4 << 20
        for off in range(0, size, step):
            out.write(await img.read(off, min(step, size - off)))
        if out is not sys.stdout.buffer:
            out.close()
    finally:
        await img.close()
    return 0


async def _cmd_bench(rbd, io, args) -> int:
    img = await Image.open(io, args.image)
    try:
        payload = b"\xa5" * args.io_size
        n = max(1, args.io_total // args.io_size)
        t0 = time.monotonic()
        for i in range(n):
            off = (i * args.io_size) % max(
                img.size_bytes - args.io_size, 1
            )
            await img.write(off, payload)
        dt = time.monotonic() - t0
        mb = n * args.io_size / 1e6
        print(f"elapsed {dt:.2f}s, {n} ops, {mb / dt:.2f} MB/s")
    finally:
        await img.close()
    return 0


async def _cmd_lock(rbd, io, args) -> int:
    img = await Image.open(io, args.image)
    try:
        if args.lock_cmd == "ls":
            for owner in await img.lock_owners():
                print(f"{owner['entity']}\t{owner['cookie']}")
    finally:
        await img.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rbd", description=__doc__)
    p.add_argument("-m", "--mon", required=True)
    p.add_argument("-p", "--pool", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create")
    c.add_argument("image")
    c.add_argument("--size", type=int, required=True)
    c.add_argument("--order", type=int, default=None)
    c.add_argument("--journaling", action="store_true",
                   help="crash-consistent op journal (enables mirroring)")
    mi = sub.add_parser("mirror")
    mi.add_argument("mirror_cmd", choices=["bootstrap", "sync"])
    mi.add_argument("image")
    mi.add_argument("--dest-pool", required=True)
    mi.add_argument("--id", default="peer")
    sub.add_parser("ls")
    for verb in ("info", "rm", "du"):
        v = sub.add_parser(verb)
        v.add_argument("image")
    r = sub.add_parser("resize")
    r.add_argument("image")
    r.add_argument("--size", type=int, required=True)
    s = sub.add_parser("snap")
    s.add_argument("snap_cmd", choices=["create", "ls", "rm", "rollback",
                                        "protect", "unprotect"])
    s.add_argument("spec", help="IMAGE@SNAP (ls: IMAGE)")
    cl = sub.add_parser("clone")
    cl.add_argument("parent_spec", help="PARENT@SNAP")
    cl.add_argument("child")
    fl = sub.add_parser("flatten")
    fl.add_argument("image")
    ch = sub.add_parser("children")
    ch.add_argument("spec", help="IMAGE@SNAP")
    imp = sub.add_parser("import")
    imp.add_argument("path")
    imp.add_argument("image")
    exp = sub.add_parser("export")
    exp.add_argument("image")
    exp.add_argument("path")
    exp.add_argument("--snap", default=None)
    ed = sub.add_parser("export-diff")
    ed.add_argument("image")
    ed.add_argument("path")
    ed.add_argument("--from-snap", dest="from_snap", default=None)
    ed.add_argument("--snap", default=None)
    idf = sub.add_parser("import-diff")
    idf.add_argument("path")
    idf.add_argument("image")
    b = sub.add_parser("bench")
    b.add_argument("image")
    b.add_argument("--io-size", type=int, default=65536)
    b.add_argument("--io-total", type=int, default=4 << 20)
    lk = sub.add_parser("lock")
    lk.add_argument("lock_cmd", choices=["ls"])
    lk.add_argument("image")
    args = p.parse_args(argv)

    fn = {
        "create": _cmd_create, "ls": _cmd_ls, "info": _cmd_info,
        "du": _cmd_du,
        "rm": _cmd_rm, "resize": _cmd_resize, "snap": _cmd_snap,
        "clone": _cmd_clone, "flatten": _cmd_flatten,
        "children": _cmd_children,
        "import": _cmd_import, "export": _cmd_export,
        "export-diff": _cmd_export_diff, "import-diff": _cmd_import_diff,
        "bench": _cmd_bench, "lock": _cmd_lock,
        "mirror": _cmd_mirror,
    }[args.cmd]

    async def run() -> int:
        client = await RadosClient(resolve_mon_arg(args.mon)).connect()
        try:
            io = client.io_ctx(args.pool)
            rbd = RBD(io)
            return await fn(rbd, io, args)
        except RadosError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        finally:
            await client.shutdown()

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
