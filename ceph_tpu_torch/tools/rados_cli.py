"""rados: the object-store CLI (reference:src/tools/rados/rados.cc).

The reference's operator surface, narrowed to the verbs this framework
serves: pool admin (lspools/mkpool/rmpool), object I/O
(put/get/ls/rm/stat), xattrs (setxattr/getxattr/listxattr/rmxattr),
scrub, df-style status, and a bench workload
(reference:rados.cc bench / `rados bench`).

Connects to a mon (or a comma-separated monmap) with -m/--mon.

Usage examples:
  rados -m 127.0.0.1:6789 lspools
  rados -m ... mkpool data erasure
  rados -m ... -p data put objname localfile
  rados -m ... -p data get objname - | sha1sum
  rados -m ... -p data ls
  rados -m ... -p data scrub
  rados -m ... bench data 5 write

Counterpart of ``ceph_tpu/tools/rados_cli.py``, every verb, over the
port's client.  ``bench`` is the reference's: serial, ``write`` then
``seq``, one output line.  The client has no card, so the CLI takes no
``--device``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

from ..rados.client import RadosClient, RadosError, resolve_mon_arg


async def _with_client(args, fn) -> int:
    client = await RadosClient(resolve_mon_arg(args.mon)).connect()
    try:
        return await fn(client)
    finally:
        await client.shutdown()


def _need_pool(args) -> str:
    if not args.pool:
        print("error: -p/--pool required", file=sys.stderr)
        raise SystemExit(2)
    return args.pool


async def _cmd_lspools(client, args) -> int:
    _code, _status, out = await client.command({"prefix": "osd pool ls"})
    for name in out or []:
        print(name)
    return 0


async def _cmd_mkpool(client, args) -> int:
    kw = {"prefix": "osd pool create", "pool": args.name,
          "pool_type": args.pool_type}
    if args.profile:
        kw["erasure_code_profile"] = args.profile
    if args.size:
        kw["size"] = args.size
    code, status, _ = await client.command(kw)
    if code < 0:
        print(f"error: {status}", file=sys.stderr)
        return 1
    print(f"pool '{args.name}' created")
    return 0


async def _cmd_rmpool(client, args) -> int:
    code, status, _ = await client.command(
        {"prefix": "osd pool rm", "pool": args.name}
    )
    if code < 0:
        print(f"error: {status}", file=sys.stderr)
        return 1
    return 0


async def _cmd_df(client, args) -> int:
    _code, _status, out = await client.command({"prefix": "status"})
    for k, v in (out or {}).items():
        print(f"{k}: {v}")
    return 0


async def _cmd_put(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    data = (
        sys.stdin.buffer.read() if args.infile == "-"
        else open(args.infile, "rb").read()
    )
    await io.write_full(args.obj, data)
    return 0


async def _cmd_get(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    data = await io.read(args.obj)
    if args.outfile == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.outfile, "wb") as f:
            f.write(data)
    return 0


async def _cmd_ls(client, args) -> int:
    for n in await client.list_objects(_need_pool(args)):
        print(n)
    return 0


async def _cmd_rm(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.remove(args.obj)
    return 0


async def _cmd_stat(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    size = await io.stat(args.obj)
    print(f"{args.pool}/{args.obj} size {size}")
    return 0


async def _cmd_mksnap(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    snapid = await io.create_snap(args.snap)
    print(f"created pool {args.pool} snap {args.snap} (id {snapid})")
    return 0


async def _cmd_rmsnap(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.remove_snap(args.snap)
    print(f"removed pool {args.pool} snap {args.snap}")
    return 0


async def _cmd_lssnap(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    snaps = await io.list_pool_snaps()
    for s in snaps:
        print(f"{s['snapid']}\t{s['name']}")
    print(f"{len(snaps)} snaps")
    return 0


async def _cmd_rollback(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.rollback(args.obj, args.snap)
    print(f"rolled back {args.pool}/{args.obj} to {args.snap}")
    return 0


async def _cmd_listsnaps(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    ss = await io.list_snaps(args.obj)
    print(f"{args.obj}: seq {ss['seq']}, head={'yes' if ss['head_exists'] else 'no'}")
    for c in ss["clones"]:
        print(f"  clone {c['cloneid']}: snaps {c['snaps']} size {c['size']}")
    return 0


async def _omap_pages(io, obj):
    """Yield (key, value) in omap order, one ranged page at a time —
    the single copy of the start_after/truncated paging protocol."""
    after = ""
    while True:
        page, more = await io.omap_get_range(
            obj, start_after=after, max_entries=1000
        )
        for k in sorted(page):
            yield k, page[k]
        if not more or not page:
            return
        after = max(page)


async def _cmd_cppool(client, args) -> int:
    """`rados cppool <src> <dst>` (reference:rados.cc do_copy_pool):
    copy every object — data, xattrs, omap — into an existing pool."""
    src = client.io_ctx(args.src)
    dst = client.io_ctx(args.dst)
    names = await client.list_objects(args.src)
    copied = 0
    for oid in sorted(names):
        data = await src.read(oid)
        await dst.write_full(oid, data)
        for k, v in (await src.getxattrs(oid)).items():
            await dst.setxattr(oid, k, v)
        try:
            omap = await src.omap_get(oid)
        except RadosError as e:
            if e.code != -95:  # EOPNOTSUPP: EC pools have no omap
                raise  # anything else is data loss, not a skip
            omap = {}
        if omap:
            await dst.omap_set(oid, omap)
        copied += 1
    print(f"copied {copied} object(s) from {args.src} to {args.dst}")
    return 0


async def _cmd_listomapkeys(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    async for k, _v in _omap_pages(io, args.obj):
        print(k)
    return 0


async def _cmd_listomapvals(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    async for k, v in _omap_pages(io, args.obj):
        print(f"{k} ({len(v)} bytes):")
        sys.stdout.flush()  # keep text/binary layers in order when piped
        sys.stdout.buffer.write(v)
        sys.stdout.buffer.flush()
        print()
    return 0


async def _cmd_getomapval(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    got = await io.omap_get_keys(args.obj, [args.key])
    if args.key not in got:
        print(f"error: no key {args.key!r}", file=sys.stderr)
        return 1
    sys.stdout.buffer.write(got[args.key])
    return 0


async def _cmd_setomapval(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.omap_set(args.obj, {args.key: args.value.encode()})
    return 0


async def _cmd_rmomapkey(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.omap_rmkeys(args.obj, [args.key])
    return 0


async def _cmd_setxattr(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.setxattr(args.obj, args.key, args.value.encode())
    return 0


async def _cmd_getxattr(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    sys.stdout.buffer.write(await io.getxattr(args.obj, args.key))
    return 0


async def _cmd_listxattr(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    for k in sorted(await io.getxattrs(args.obj)):
        print(k)
    return 0


async def _cmd_rmxattr(client, args) -> int:
    io = client.io_ctx(_need_pool(args))
    await io.rmxattr(args.obj, args.key)
    return 0


async def _cmd_scrub(client, args) -> int:
    reports = await client.scrub_pool(
        _need_pool(args), repair=not args.no_repair
    )
    errors = sum(len(r["errors"]) for r in reports)
    repaired = sum(r["repaired"] for r in reports)
    objects = sum(r["objects"] for r in reports)
    print(
        f"scrubbed {len(reports)} pgs, {objects} objects: "
        f"{errors} errors, {repaired} repaired"
    )
    return 0 if errors == repaired else 1


async def _cmd_bench(client, args) -> int:
    """`rados bench <pool> <seconds> write|seq` (reference:rados.cc bench)."""
    io = client.io_ctx(args.name)
    size = args.object_size
    deadline = time.monotonic() + args.seconds
    n = 0
    payload = os.urandom(size)
    t0 = time.monotonic()
    if args.mode == "write":
        while time.monotonic() < deadline:
            await io.write_full(f"bench_{n}", payload)
            n += 1
    else:
        # seq: read the objects a prior `bench ... write` run left behind
        names = [
            x for x in await client.list_objects(args.name)
            if x.startswith("bench_")
        ]
        if not names:
            print("seq: no bench_* objects (run `bench ... write` first)",
                  file=sys.stderr)
            return 1
        sizes = await io.stat(names[0])
        size = max(sizes, 1)
        t0 = time.monotonic()
        while time.monotonic() < deadline:
            await io.read(names[n % len(names)])
            n += 1
    dt = time.monotonic() - t0
    total_mb = n * size / 1e6
    print(
        f"{args.mode}: {n} ops, {total_mb:.1f} MB in {dt:.2f}s = "
        f"{total_mb / dt:.2f} MB/s, {n / dt:.1f} ops/s"
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rados", description=__doc__)
    p.add_argument("-m", "--mon", required=True,
                   help="mon address (comma-separate a monmap)")
    p.add_argument("-p", "--pool", default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("lspools")
    mk = sub.add_parser("mkpool")
    mk.add_argument("name")
    mk.add_argument("pool_type", nargs="?", default="replicated",
                    choices=["replicated", "erasure"])
    mk.add_argument("--profile", default=None)
    mk.add_argument("--size", type=int, default=None)
    cp = sub.add_parser("cppool")
    cp.add_argument("src")
    cp.add_argument("dst")
    rm = sub.add_parser("rmpool")
    rm.add_argument("name")
    sub.add_parser("df")

    put = sub.add_parser("put")
    put.add_argument("obj")
    put.add_argument("infile")
    get = sub.add_parser("get")
    get.add_argument("obj")
    get.add_argument("outfile")
    ls = sub.add_parser("ls")
    rmo = sub.add_parser("rm")
    rmo.add_argument("obj")
    st = sub.add_parser("stat")
    st.add_argument("obj")

    mks = sub.add_parser("mksnap")
    mks.add_argument("snap")
    rms = sub.add_parser("rmsnap")
    rms.add_argument("snap")
    sub.add_parser("lssnap")
    rb = sub.add_parser("rollback")
    rb.add_argument("obj")
    rb.add_argument("snap")
    lsn = sub.add_parser("listsnaps")
    lsn.add_argument("obj")

    sx = sub.add_parser("setxattr")
    sx.add_argument("obj")
    sx.add_argument("key")
    sx.add_argument("value")
    gx = sub.add_parser("getxattr")
    gx.add_argument("obj")
    gx.add_argument("key")
    lx = sub.add_parser("listxattr")
    lx.add_argument("obj")
    rx = sub.add_parser("rmxattr")
    rx.add_argument("obj")
    rx.add_argument("key")

    # omap (reference:rados.cc listomapkeys/listomapvals/getomapval/
    # setomapval/rmomapkey)
    lok = sub.add_parser("listomapkeys")
    lok.add_argument("obj")
    lov = sub.add_parser("listomapvals")
    lov.add_argument("obj")
    gov = sub.add_parser("getomapval")
    gov.add_argument("obj")
    gov.add_argument("key")
    sov = sub.add_parser("setomapval")
    sov.add_argument("obj")
    sov.add_argument("key")
    sov.add_argument("value")
    rok = sub.add_parser("rmomapkey")
    rok.add_argument("obj")
    rok.add_argument("key")

    sc = sub.add_parser("scrub")
    sc.add_argument("--no-repair", action="store_true")

    be = sub.add_parser("bench")
    be.add_argument("name")
    be.add_argument("seconds", type=int)
    be.add_argument("mode", choices=["write", "seq"])
    be.add_argument("--object-size", type=int, default=65536)

    args = p.parse_args(argv)
    fn = {
        "lspools": _cmd_lspools, "mkpool": _cmd_mkpool,
        "rmpool": _cmd_rmpool, "df": _cmd_df,
        "cppool": _cmd_cppool,
        "put": _cmd_put, "get": _cmd_get, "ls": _cmd_ls, "rm": _cmd_rm,
        "stat": _cmd_stat,
        "setxattr": _cmd_setxattr, "getxattr": _cmd_getxattr,
        "listxattr": _cmd_listxattr, "rmxattr": _cmd_rmxattr,
        "listomapkeys": _cmd_listomapkeys,
        "listomapvals": _cmd_listomapvals,
        "getomapval": _cmd_getomapval,
        "setomapval": _cmd_setomapval,
        "rmomapkey": _cmd_rmomapkey,
        "mksnap": _cmd_mksnap, "rmsnap": _cmd_rmsnap,
        "lssnap": _cmd_lssnap, "rollback": _cmd_rollback,
        "listsnaps": _cmd_listsnaps,
        "scrub": _cmd_scrub, "bench": _cmd_bench,
    }[args.cmd]

    async def run(client):
        try:
            return await fn(client, args)
        except RadosError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    return asyncio.run(_with_client(args, run))


if __name__ == "__main__":
    sys.exit(main())
