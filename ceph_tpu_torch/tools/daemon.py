"""ceph-daemon: run ONE daemon in its own OS process.

Counterpart of ``ceph_tpu/tools/daemon.py``, of which the ``accel`` role
is ported: ``python -m ceph_tpu_torch.tools.daemon accel --id 0 --addr
127.0.0.1:0 [--device cpu]`` runs one :class:`AccelDaemon` until
SIGTERM and prints ``accel.<id> up at <addr>``.  The daemon owns the
card: without ``--device cpu`` it raises ``DeviceUnavailableError`` when
CUDA is absent.  The ``mon`` and ``osd`` roles raise
``NotImplementedError`` until their slices (ROADMAP Queue A items 11
and 6), and so does ``--monmap`` until the Monitor's.  OSD dispatchers
feed the daemon over the messenger (``accel.client.AccelClient`` as an
``ECDispatcher``'s ``remote``).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

_NOT_PORTED = {
    "mon": "the Monitor waits for ROADMAP Queue A item 11",
    "osd": "the OSD daemon waits for ROADMAP Queue A item 6",
}


async def _run_accel(args) -> None:
    from ..accel import AccelDaemon

    acc = AccelDaemon(
        f"accel.{args.id}",
        mon_addr=(args.monmap.split(",") if args.monmap else None),
        device=args.device,
    )
    # a real process: suicide must end the PROCESS even when a wedged
    # device call sits in a non-daemon executor thread (same contract
    # as the OSD's launch watchdog)
    acc.suicide_hard_exit = True
    host, port = args.addr.rsplit(":", 1)
    await acc.start(host, int(port))
    # SIGTERM handling is armed before the "up" line: a harness may
    # signal the moment it reads it
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"accel.{args.id} up at {acc.addr}", flush=True)
    await stop.wait()
    await acc.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-daemon", description=__doc__)
    sub = p.add_subparsers(dest="role", required=True)
    for role in _NOT_PORTED:
        sub.add_parser(role, add_help=False)
    pa = sub.add_parser("accel")
    pa.add_argument("--id", type=int, required=True)
    pa.add_argument("--addr", required=True, help="host:port to bind")
    pa.add_argument("--monmap", default=None,
                    help="comma-sep mon addrs (map subscription, AccelMap "
                         "registration + mgr reporting; not ported yet: "
                         "refused)")
    pa.add_argument("--device", default=None,
                    help="torch device the daemon's codecs live on "
                         "(default: the CUDA card; 'cpu' for tests)")
    pa.add_argument("--verbose", action="store_true")
    args, rest = p.parse_known_args(argv)
    if args.role in _NOT_PORTED:
        raise NotImplementedError(
            f"the {args.role} role is not supported: "
            f"{_NOT_PORTED[args.role]}")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(message)s",
        )
    asyncio.run(_run_accel(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
