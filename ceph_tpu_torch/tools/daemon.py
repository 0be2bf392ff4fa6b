"""ceph-daemon: run ONE daemon in its own OS process.

Counterpart of ``ceph_tpu/tools/daemon.py``, of which the ``mon`` and
``accel`` roles are ported:

- ``python -m ceph_tpu_torch.tools.daemon mon --rank 0 --addr
  127.0.0.1:0 --monmap 127.0.0.1:0 --store DIR [--max-osds N]`` runs one
  :class:`~ceph_tpu_torch.mon.Monitor` with a durable store until SIGTERM
  and prints ``mon.<rank> up at <addr>``.  The mon has no card.
- ``python -m ceph_tpu_torch.tools.daemon accel --id 0 --addr
  127.0.0.1:0 [--monmap ADDRS] [--locality LABEL] [--device cpu]`` runs
  one :class:`~ceph_tpu_torch.accel.AccelDaemon` until SIGTERM and prints
  ``accel.<id> up at <addr>``.  With ``--monmap`` it registers into the
  mon-published AccelMap under ``--locality``.  The daemon owns the card:
  without ``--device cpu`` it raises ``DeviceUnavailableError`` when CUDA
  is absent.

Both roles read their options from the environment, as every
``Config()`` does (``CEPH_TPU_ARGS='--name value ...'``,
``common/config.py``), with no flag of their own:
``CEPH_TPU_ARGS='--admin_socket /run/{name}.asok'`` serves each
daemon's admin socket at that path, ``{name}`` expanded to
``mon.<rank>`` or ``accel.<id>``.

``--monmap`` takes one address, a comma list, or a monmap file written
by ``tools/monmaptool.py``.  ``--watch-parent PID`` makes the daemon exit
when that process dies, so a harness never leaks daemons.  The ``osd``
role raises ``NotImplementedError`` until its slice (ROADMAP Queue A
item 6).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

_NOT_PORTED = {
    "osd": "the OSD daemon waits for ROADMAP Queue A item 6",
}


async def _run_mon(args) -> None:
    from ..mon import Monitor
    from .monmaptool import resolve_mon_arg

    host, port = args.addr.rsplit(":", 1)
    mon = Monitor(
        name=f"mon.{args.rank}",
        rank=args.rank,
        max_osds=args.max_osds,
        store_path=args.store,
        failure_min_reporters=1,
    )
    await mon.start(host, int(port))
    monmap = resolve_mon_arg(args.monmap)
    mon.set_monmap(monmap if isinstance(monmap, list) else [monmap])
    await mon.start_quorum()
    stop = _arm_term()
    print(f"mon.{args.rank} up at {mon.addr}", flush=True)
    await _until_term(stop, args.watch_parent)
    await mon.stop()


async def _run_accel(args) -> None:
    from ..accel import AccelDaemon
    from .monmaptool import resolve_mon_arg

    config = None
    if args.locality:
        from ..common import Config

        config = Config(overrides={"accel_locality": args.locality})
    acc = AccelDaemon(
        f"accel.{args.id}",
        mon_addr=(resolve_mon_arg(args.monmap) if args.monmap else None),
        config=config,
        device=args.device,
    )
    # a real process: suicide must end the PROCESS even when a wedged
    # device call sits in a non-daemon executor thread (same contract
    # as the OSD's launch watchdog)
    acc.suicide_hard_exit = True
    host, port = args.addr.rsplit(":", 1)
    await acc.start(host, int(port))
    stop = _arm_term()
    print(f"accel.{args.id} up at {acc.addr}", flush=True)
    await _until_term(stop, args.watch_parent)
    await acc.stop()


def _arm_term() -> asyncio.Event:
    """SIGINT/SIGTERM set the returned event.  Armed before the "up"
    line: a harness may signal the moment it reads it."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    return stop


def _arm_parent_death(watch_pid: int | None) -> None:
    """Never outlive the spawner.  Two layers: PR_SET_PDEATHSIG delivers
    SIGKILL the instant the parent dies — even if the parent itself was
    SIGKILLed — and the explicit pid is polled in _until_term as the
    portable fallback (pdeathsig tracks the parent THREAD; a harness
    forking from a worker thread would slip through it).  Armed only
    when the spawner opted in via --watch-parent — a manually-launched
    daemon keeps normal daemon semantics."""
    if watch_pid is None:
        return
    try:
        import ctypes

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except Exception:  # swallow-ok: non-Linux fallback is the poll
        pass
    # close the set-after-parent-died race: if the parent is already
    # gone, exit now instead of waiting for a signal that already fired
    if not _pid_alive(watch_pid):
        sys.exit(0)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        # PermissionError means it exists but is not ours; treat a
        # recycled-to-other-user pid as gone for watchdog purposes
        return False


async def _until_term(stop: asyncio.Event,
                      watch_pid: int | None = None) -> None:
    while not stop.is_set():
        try:
            async with asyncio.timeout(2.0):
                await stop.wait()
        except TimeoutError:
            if watch_pid is not None and not _pid_alive(watch_pid):
                print("parent gone; exiting", flush=True)
                return


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-daemon", description=__doc__)
    sub = p.add_subparsers(dest="role", required=True)
    for role in _NOT_PORTED:
        sub.add_parser(role, add_help=False)
    pm = sub.add_parser("mon")
    pm.add_argument("--rank", type=int, required=True)
    pm.add_argument("--addr", required=True, help="host:port to bind")
    pm.add_argument("--monmap", required=True,
                    help="mon addrs: comma-sep list or a monmap file")
    pm.add_argument("--store", required=True)
    pm.add_argument("--max-osds", type=int, default=16)
    pa = sub.add_parser("accel")
    pa.add_argument("--id", type=int, required=True)
    pa.add_argument("--addr", required=True, help="host:port to bind")
    pa.add_argument("--monmap", default=None,
                    help="mon addrs, comma-sep or a monmap file "
                         "(optional: enables map subscription, AccelMap "
                         "registration + mgr reporting)")
    pa.add_argument("--locality", default="",
                    help="AccelMap locality label (match the crush "
                         "host of co-located OSDs; decode batches "
                         "prefer the matching accelerator)")
    pa.add_argument("--device", default=None,
                    help="torch device the daemon's codecs live on "
                         "(default: the CUDA card; 'cpu' for tests)")
    for sp in (pm, pa):
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument(
            "--watch-parent", type=int, default=None, metavar="PID",
            help="exit when this pid dies (leak-proofing for harnesses)",
        )
    args, rest = p.parse_known_args(argv)
    if args.role in _NOT_PORTED:
        raise NotImplementedError(
            f"the {args.role} role is not supported: "
            f"{_NOT_PORTED[args.role]}")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    _arm_parent_death(args.watch_parent)
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(message)s",
        )
    coro = {"mon": _run_mon, "accel": _run_accel}[args.role](args)
    asyncio.run(coro)
    return 0


if __name__ == "__main__":
    sys.exit(main())
