"""rgw_admin: gateway administration (reference:src/rgw/rgw_admin.cc —
the radosgw-admin command).

Usage:
  rgw_admin -m MON user create --uid alice [--display-name "Alice"]
  rgw_admin -m MON user ls
  rgw_admin -m MON user info --uid alice
  rgw_admin -m MON user rm --uid alice
  rgw_admin -m MON bucket ls [--uid alice]
  rgw_admin -m MON bucket stats --bucket photos
  rgw_admin -m MON serve [--host H] [--port P]     # run the S3 gateway

Counterpart of ``ceph_tpu/tools/rgw_admin.py``: the same commands print
the same output.  The tool runs no kernel: on an erasure-coded data pool
the OSDs encode and rebuild the objects, so ``serve`` opens its admin
socket's trace windows on the host (``device="cpu"``) and needs no card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..rados.client import RadosClient, RadosError, resolve_mon_arg
from ..rgw import RGWStore
from ..rgw.http import S3Server


async def _cmd_user(store: RGWStore, args) -> int:
    if args.sub == "create":
        rec = await store.create_user(args.uid, args.display_name or "")
        print(json.dumps(rec, indent=1))
    elif args.sub == "ls":
        for uid in await store.list_users():
            print(uid)
    elif args.sub == "info":
        print(json.dumps(await store.get_user(args.uid), indent=1))
    elif args.sub == "rm":
        await store.remove_user(args.uid)
    return 0


async def _cmd_bucket(store: RGWStore, args) -> int:
    if args.sub == "ls":
        for b in await store.list_buckets(args.uid):
            print(b)
    elif args.sub == "stats":
        print(json.dumps(await store.bucket_stats(args.bucket), indent=1))
    return 0


async def _cmd_quota(store: RGWStore, args) -> int:
    """`rgw_admin quota set|get --bucket B [--max-objects N]
    [--max-size BYTES]` (reference:radosgw-admin quota set)."""
    if args.sub == "set":
        # unspecified flags PRESERVE the existing cap (the reference
        # keeps unmentioned quota fields); pass an explicit 0 to clear
        cur = (await store.bucket_info(args.bucket)).get("quota", {})
        await store.set_bucket_quota(
            args.bucket,
            max_objects=(cur.get("max_objects", 0)
                         if args.max_objects is None
                         else args.max_objects),
            max_bytes=(cur.get("max_bytes", 0)
                       if args.max_size is None else args.max_size),
        )
        print(f"quota set on bucket {args.bucket!r}")
    else:
        info = await store.bucket_info(args.bucket)
        print(json.dumps(
            info.get("quota", {"max_objects": 0, "max_bytes": 0}),
            indent=1,
        ))
    return 0


async def _cmd_serve(store: RGWStore, args) -> int:
    server = S3Server(store, device="cpu")
    addr = await server.start(args.host, args.port)
    print(f"rgw listening on {addr}", flush=True)
    try:
        await asyncio.Event().wait()  # serve until interrupted
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await server.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rgw_admin", description=__doc__)
    p.add_argument("-m", "--mon", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)

    u = sub.add_parser("user")
    u.add_argument("sub", choices=["create", "ls", "info", "rm"])
    u.add_argument("--uid")
    u.add_argument("--display-name")
    b = sub.add_parser("bucket")
    b.add_argument("sub", choices=["ls", "stats"])
    b.add_argument("--uid", default=None)
    b.add_argument("--bucket")
    q = sub.add_parser("quota")
    q.add_argument("sub", choices=["set", "get"])
    q.add_argument("--bucket", required=True)
    q.add_argument("--max-objects", type=int, default=None)
    q.add_argument("--max-size", type=int, default=None)
    s = sub.add_parser("serve")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    if args.cmd == "user" and args.sub != "ls" and not args.uid:
        p.error("--uid required")
    if args.cmd == "bucket" and args.sub == "stats" and not args.bucket:
        p.error("--bucket required")

    async def run() -> int:
        client = await RadosClient(resolve_mon_arg(args.mon)).connect()
        try:
            store = await RGWStore.create(client)
            fn = {"user": _cmd_user, "bucket": _cmd_bucket,
                  "quota": _cmd_quota, "serve": _cmd_serve}[args.cmd]
            return await fn(store, args)
        except RadosError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        finally:
            await client.shutdown()

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
