"""Time the messenger alone, and say where a round's host time goes.

Run from the root of the repository (no card needed: the messenger is
host code)::

    python3 -m ceph_tpu_torch.tools.wire_profile [--objects 64]
        [--object-mib 4] [--per-rpc 4] [--clients 4] [--top 6]

It carries the frames of ``chip_smoke.py`` phase 9's pool A encode step
with no erasure code at all: ``--clients`` client messengers send the
objects as ``MAccelEncode`` frames of ``--per-rpc`` members to one
server messenger in the same event loop, which answers each with an
``MAccelReply`` of the members back and 3 parity-sized blobs a member
(an RS(8,3) object's parity).  It prints the object bytes / wall of the
``asyncio.gather`` (host clock) of a round whose connections are
already up, then runs one more round under ``cProfile`` and prints the
``--top`` functions by own time.  ``chip_smoke.py`` times one such
round through :func:`wire_round`.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import pstats
import time
from pathlib import Path

import numpy as np

from ..msg import AsyncMessenger, Dispatcher, messages

PARITY_SHARDS = 3  # RS(8,3): three parity shards an object
DATA_SHARDS = 8


class _Echo(Dispatcher):
    def __init__(self, parity: bytes):
        self.parity = parity

    async def ms_dispatch(self, conn, msg):
        conn.send(messages.MAccelReply(
            tid=msg.tid, result=0,
            blobs=list(msg.blobs)
            + [self.parity] * (PARITY_SHARDS * len(msg.blobs))))


class _Waiter(Dispatcher):
    def __init__(self):
        self.futs: dict[int, asyncio.Future] = {}

    async def ms_dispatch(self, conn, msg):
        self.futs.pop(msg.tid).set_result(msg)


class WireBench:
    """One server messenger and ``clients`` client messengers, connected
    by :meth:`start`; :meth:`round` sends ``objs`` in RPCs of
    ``per_rpc`` members and returns the round's wall seconds."""

    def __init__(self, objs, per_rpc: int, clients: int):
        self.objs = objs
        self.per_rpc = per_rpc
        self.parity = bytes(len(objs[0]) // DATA_SHARDS)
        self.server = AsyncMessenger("wire.0", _Echo(self.parity))
        self.clients = [AsyncMessenger(f"wire.{i + 1}", _Waiter())
                        for i in range(clients)]
        self.conns = []

    async def start(self) -> None:
        addr = await self.server.bind("127.0.0.1", 0)
        self.conns = [await m.connect(addr, "wire.0") for m in self.clients]

    async def round(self) -> float:
        loop = asyncio.get_running_loop()

        async def rpc(tid, members):
            i = tid % len(self.clients)
            fut = self.clients[i].dispatcher.futs[tid] = loop.create_future()
            self.conns[i].send(messages.MAccelEncode(
                tid=tid, stripes=[1] * len(members), blobs=members))
            reply = await fut
            if len(reply.blobs) != (1 + PARITY_SHARDS) * len(members):
                raise AssertionError(f"wire echo: {len(reply.blobs)} blobs")

        groups = [self.objs[i:i + self.per_rpc]
                  for i in range(0, len(self.objs), self.per_rpc)]
        t0 = time.perf_counter()
        await asyncio.gather(*(rpc(t, g) for t, g in enumerate(groups)))
        return time.perf_counter() - t0

    def describe(self) -> str:
        size = len(self.objs[0])
        n_rpc = -(-len(self.objs) // self.per_rpc)
        return (f"{n_rpc} RPCs of {self.per_rpc * size >> 20} MiB out and "
                f"{self.per_rpc * (size + PARITY_SHARDS * len(self.parity)) >> 20}"
                f" MiB back over {len(self.clients)} client messengers, "
                f"no erasure code")

    async def stop(self) -> None:
        for m in self.clients:
            await m.shutdown()
        await self.server.shutdown()


async def wire_round(objs, per_rpc: int, clients: int) -> tuple[float, str]:
    """Connect, then time one round; returns (seconds, description)."""
    bench = WireBench(objs, per_rpc, clients)
    await bench.start()
    try:
        return await bench.round(), bench.describe()
    finally:
        await bench.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wire_profile", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--objects", type=int, default=64)
    p.add_argument("--object-mib", type=int, default=4)
    p.add_argument("--per-rpc", type=int, default=4)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--top", type=int, default=6)
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    objs = [rng.integers(0, 256, args.object_mib << 20, dtype=np.uint8)
            for _ in range(args.objects)]
    nbytes = sum(o.size for o in objs)

    async def run():
        bench = WireBench(objs, args.per_rpc, args.clients)
        await bench.start()
        try:
            s = await bench.round()
            print(f"the messenger alone ({bench.describe()}): "
                  f"{nbytes / s / 1e9:.3f} GB/s of object bytes "
                  f"({s * 1e3:.1f} ms, host clock)", flush=True)
            prof = cProfile.Profile()
            prof.enable()
            s = await bench.round()
            prof.disable()
        finally:
            await bench.stop()
        print(f"profiled round: {nbytes / s / 1e9:.3f} GB/s "
              f"({s * 1e3:.1f} ms, host clock, under cProfile)")
        top = sorted(pstats.Stats(prof).stats.items(),
                     key=lambda kv: -kv[1][2])[:args.top]
        for fn, (_cc, nc, tt, _ct, _callers) in top:
            print(f"  {fn[2]} ({Path(fn[0]).name}) {tt * 1e3:.1f} ms "
                  f"own time over {nc} calls")

    asyncio.run(asyncio.wait_for(run(), 600))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
