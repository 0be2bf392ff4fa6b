"""cephfs: filesystem CLI (the cephfs-shell / libcephfs-tool analog,
reference:src/tools/cephfs/).

Usage:
  cephfs -m MON ls /path
  cephfs -m MON mkdir /path
  cephfs -m MON put LOCALFILE /path
  cephfs -m MON get /path LOCALFILE      (- for stdout)
  cephfs -m MON cat /path
  cephfs -m MON rm /path
  cephfs -m MON rmdir /path
  cephfs -m MON mv /src /dst
  cephfs -m MON stat /path
  cephfs -m MON statfs

Counterpart of ``ceph_tpu/tools/cephfs_cli.py``: the same commands print
the same output.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..mds import CephFSClient, FSError
from ..rados.client import RadosClient, RadosError, resolve_mon_arg


async def _run(args) -> int:
    client = await RadosClient(resolve_mon_arg(args.mon)).connect()
    try:
        fs = await CephFSClient.mount(client)
        if args.cmd == "ls":
            for name, inode in (await fs.readdir(args.path)).items():
                kind = "d" if inode["type"] == "dir" else "-"
                size = inode.get("size", 0)
                print(f"{kind} {size:>10} {name}")
        elif args.cmd == "mkdir":
            await fs.mkdir(args.path)
        elif args.cmd == "put":
            data = (
                sys.stdin.buffer.read() if args.src == "-"
                else open(args.src, "rb").read()
            )
            await fs.write_file(args.path, data)
        elif args.cmd in ("get", "cat"):
            data = await fs.read_file(args.path)
            if args.cmd == "cat" or args.dst == "-":
                sys.stdout.buffer.write(data)
            else:
                open(args.dst, "wb").write(data)
        elif args.cmd == "rm":
            await fs.unlink(args.path)
        elif args.cmd == "rmdir":
            await fs.rmdir(args.path)
        elif args.cmd == "mv":
            await fs.rename(args.src, args.dst)
        elif args.cmd == "stat":
            print(json.dumps(await fs.stat(args.path), indent=1))
        elif args.cmd == "statfs":
            print(json.dumps(await fs.statfs(), indent=1))
        return 0
    except (FSError, RadosError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await client.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cephfs", description=__doc__)
    p.add_argument("-m", "--mon", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)
    for verb in ("ls", "mkdir", "rm", "rmdir", "cat", "stat"):
        v = sub.add_parser(verb)
        v.add_argument("path")
    put = sub.add_parser("put")
    put.add_argument("src")
    put.add_argument("path")
    get = sub.add_parser("get")
    get.add_argument("path")
    get.add_argument("dst")
    mv = sub.add_parser("mv")
    mv.add_argument("src")
    mv.add_argument("dst")
    sub.add_parser("statfs")
    args = p.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
