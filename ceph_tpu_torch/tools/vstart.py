"""vstart: launch a whole dev cluster in one process
(reference:src/vstart.sh — the developer cluster launcher).

Boots N mons + N OSDs (+ mgr, mds, rgw on request) on loopback, prints
the connection lines every other CLI needs, and serves until Ctrl-C.

Usage:
  vstart --osds 4 --mons 3 --mgr --mds --rgw [--auth] [--device cpu]
         [--store-dir DIR] [--crush-hosts 2x2]
  vstart --multiprocess --osds 4 --store-dir DIR   # real daemons
  # then, from other shells:
  rados -m <mon> lspools
  ceph -m <mon> status
  rbd -m <mon> -p rbd create img --size 1048576
  cephfs -m <mon> ls /

``--multiprocess`` boots every mon/OSD as its OWN process with a durable
store (the reference's run_mon/run_osd tier,
reference:src/test/erasure-code/test-erasure-code.sh:32-38) — kill -9 a
daemon and watch the cluster absorb it.

Counterpart of ``ceph_tpu/tools/vstart.py``.  The OSDs run their erasure
code on the card: ``--device`` has the daemon's meaning (default the
CUDA card, which must be present; ``cpu`` for tests), in process and
with ``--multiprocess``.  ``--rgw`` serves the S3/Swift gateway in
process, its ``admin`` user made at start (refused with
``--multiprocess``, as the reference refuses it); the gateway's admin
socket, if any, opens its windows on ``--device``.  ``--mds`` starts an
MDS in process (refused with ``--multiprocess``, as the reference refuses
it); the MDS runs no kernel, and on an erasure-coded data pool the OSDs
encode and rebuild the files' data.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ..rados import MiniCluster
from .daemon import _arm_term


def _parse_hosts(spec: str | None, n_osds: int):
    """"2x2" = 2 hosts x 2 osds; None = flat."""
    if not spec:
        return None
    hosts, per = (int(x) for x in spec.lower().split("x", 1))
    if hosts * per != n_osds:
        raise SystemExit(f"--crush-hosts {spec} != --osds {n_osds}")
    return [list(range(h * per, (h + 1) * per)) for h in range(hosts)]


async def _run_multiprocess(args) -> int:
    from ..rados.proc_cluster import ProcCluster
    from .daemon import _until_term

    if not args.store_dir:
        raise SystemExit("--multiprocess requires --store-dir (durable stores)")
    unsupported = [
        flag for flag, on in (
            ("--mgr", args.mgr), ("--mds", args.mds), ("--rgw", args.rgw),
            ("--auth", args.auth), ("--crush-hosts", args.crush_hosts),
        ) if on
    ]
    if unsupported:
        raise SystemExit(
            f"--multiprocess does not support {' '.join(unsupported)} yet"
        )
    pc = ProcCluster(
        args.store_dir, n_osds=args.osds, n_mons=args.mons,
        log_dir=args.store_dir + "/logs", device=args.device,
    )
    await pc.start()
    print(f"mon:    {','.join(pc.monmap)}")
    for i, proc in sorted(pc.osd_procs.items()):
        print(f"osd.{i}: pid {proc.pid}")
    print(f"logs:   {args.store_dir}/logs", flush=True)
    stop = _arm_term()
    print("ready — Ctrl-C to stop", flush=True)
    await _until_term(stop)
    print("stopping...", flush=True)
    await pc.stop()
    return 0


async def _run(args) -> int:
    if args.multiprocess:
        return await _run_multiprocess(args)
    cluster = MiniCluster(
        n_osds=args.osds,
        n_mons=args.mons,
        store_dir=args.store_dir,
        auth=args.auth,
        crush_hosts=_parse_hosts(args.crush_hosts, args.osds),
        heartbeat_interval=args.heartbeat_interval,
        device=args.device,
    )
    await cluster.start()
    monmap = ",".join(cluster.monmap)
    print(f"mon:    {monmap}")
    if args.write_monmap:
        from .monmaptool import save_monmap

        save_monmap({
            "epoch": 1,
            "mons": [
                {"rank": i, "name": f"mon.{i}", "addr": a}
                for i, a in enumerate(cluster.monmap)
            ],
        }, args.write_monmap)
        print(f"monmap: {args.write_monmap}")
    if args.auth:
        print(f"keyring: {cluster._keyring_path} (client.admin)")
    if args.mgr:
        mgr = await cluster.start_mgr()
        await cluster.wait_for_active_mgr()
        print(f"mgr:    {mgr.name} @ {mgr.addr}")
    if args.mds:
        mds = await cluster.start_mds()
        await cluster.wait_for_active_mds()
        print(f"mds:    {mds.name} @ {mds.addr}")
    rgw_srv = None
    if args.rgw:
        from ..rgw import RGWError, RGWStore
        from ..rgw.http import S3Server

        cl = await cluster.client()
        store = await RGWStore.create(cl)
        try:
            user = await store.create_user("admin", "vstart admin")
        except RGWError:  # a durable store's admin from an earlier run
            user = await store.get_user("admin")
        rgw_srv = S3Server(store, device=args.device)
        addr = await rgw_srv.start(port=args.rgw_port)
        print(f"rgw:    http://{addr}  (AWS {user['access_key']}:...)")
    print(f"osds:   {args.osds} up", flush=True)
    stop = _arm_term()
    print("ready — Ctrl-C to stop", flush=True)
    await stop.wait()
    print("stopping...", flush=True)
    if rgw_srv is not None:
        await rgw_srv.stop()
    await cluster.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vstart", description=__doc__)
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--mons", type=int, default=1)
    p.add_argument("--mgr", action="store_true")
    p.add_argument("--mds", action="store_true")
    p.add_argument("--rgw", action="store_true")
    p.add_argument("--rgw-port", type=int, default=0)
    p.add_argument("--auth", action="store_true", help="enable cephx")
    p.add_argument("--multiprocess", action="store_true",
                   help="each daemon is its own OS process (needs "
                        "--store-dir)")
    p.add_argument("--store-dir", default=None,
                   help="durable WalStores here (default: in-memory)")
    p.add_argument("--crush-hosts", default=None, metavar="HxP",
                   help='hierarchy, e.g. "2x2" = 2 hosts x 2 osds')
    p.add_argument("--heartbeat-interval", type=float, default=1.0)
    p.add_argument("--write-monmap", default=None, metavar="PATH",
                   help="write the bootstrap monmap file (every CLI's "
                        "-m accepts it)")
    p.add_argument("--device", default=None,
                   help="torch device the OSDs' codecs live on "
                        "(default: the CUDA card; 'cpu' for tests)")
    args = p.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
