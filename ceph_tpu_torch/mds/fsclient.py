"""The CephFS client (reference:src/client/Client.cc + libcephfs).

Metadata ops go to the active MDS (discovered through the map, with
retry across failover); file I/O goes DIRECTLY to the data pool via
the striper — the MDS is not on the data path, exactly like the
reference.

Counterpart of ``ceph_tpu/mds/fsclient.py``: the same calls and errors
over this package's striper, which issues one RADOS op per backing
object where the reference's issues one per stripe unit; the bytes that
land are the same."""

from __future__ import annotations

import asyncio
import logging

from ..msg import messages
from ..rados.client import ENOENT, RadosClient, RadosError
from ..rados.striper import StripedObject
from .daemon import DATA_POOL, data_obj

logger = logging.getLogger("ceph_tpu_torch.cephfs")

EAGAIN = 11
EREMOTE = 66  # forwarded to the authoritative rank (multi-active)


class FSError(RadosError):
    pass


class CephFSClient:
    """A mounted filesystem view (reference libcephfs ceph_mount)."""

    def __init__(self, client: RadosClient):
        self.client = client
        self.data = None  # io_ctx bound at mount (pool must exist)

    @classmethod
    async def mount(cls, client: RadosClient) -> "CephFSClient":
        fs = cls(client)
        # the MDS creates the pools; wait for them (fresh cluster races)
        await client.wait_for_pool(DATA_POOL)
        fs.data = client.io_ctx(DATA_POOL)
        return fs

    # -- MDS round trip ------------------------------------------------------
    async def _mds(self, op: str, **args) -> dict:
        cl = self.client
        last = None
        target: "tuple[str, str] | None" = None  # (addr, name) override
        for _attempt in range(cl.max_retries):
            m = cl.osdmap
            entry = None
            if m is not None:
                # bootstrap from ANY occupied rank, not just rank 0
                # (a vacant rank 0 with other ranks active would
                # block every op forever; the EREMOTE redirect
                # protocol routes from whichever rank answers first)
                if m.mds_addr:
                    entry = (m.mds_addr, m.mds_name)
                else:
                    for rname, raddr in m.mds_rank_table():
                        if raddr:
                            entry = (raddr, rname)
                            break
            if entry is None:
                await cl._wait_for_map_change(
                    m.epoch if m else -1, cl.op_timeout
                )
                continue
            addr, name = target or entry
            target = None
            try:
                conn = await cl.messenger.connect(addr, name)
                # the client's own allocator: private counters collide
                # in the shared _op_futs map across mounts
                tid = next(cl._tid)
                fut = asyncio.get_running_loop().create_future()
                cl._op_futs[tid] = fut
                cl._fut_conns[tid] = conn
                try:
                    conn.send(messages.MClientRequest(
                        tid=tid, op=op, args=args,
                    ))
                    async with asyncio.timeout(cl.op_timeout):
                        reply = await fut
                finally:
                    cl._op_futs.pop(tid, None)
                    cl._fut_conns.pop(tid, None)
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
                await cl._wait_for_map_change(cl.osdmap.epoch, 2.0)
                continue
            if reply.result == -EAGAIN:
                # standby answered / failover raced: wait for a map that
                # names the real active and retry (Objecter-style resend)
                await cl._wait_for_map_change(cl.osdmap.epoch, 2.0)
                continue
            if (
                reply.result == -EREMOTE
                and isinstance(reply.out, dict)
                and reply.out.get("addr")
            ):
                # multi-active: the subtree lives on another rank —
                # follow the forward (reference:Server.cc
                # respond_to_request forwarding to the auth mds)
                rank = reply.out.get("redirect")
                target = (
                    reply.out["addr"], f"mds.rank{rank}"
                )
                continue
            if reply.result < 0:
                raise FSError(
                    reply.result, reply.out.get("error", op)
                )
            return reply.out
        raise FSError(-EAGAIN, f"mds op {op} exhausted retries") from last

    # -- namespace ops -------------------------------------------------------
    async def mkdir(self, path: str, mode: int = 0o755) -> None:
        await self._mds("mkdir", path=path, mode=mode)

    async def readdir(self, path: str) -> dict[str, dict]:
        return (await self._mds("readdir", path=path))["entries"]

    async def stat(self, path: str) -> dict:
        return (await self._mds("lookup", path=path))["inode"]

    async def exists(self, path: str) -> bool:
        try:
            await self.stat(path)
            return True
        except FSError as e:
            if e.code == -ENOENT:
                return False
            raise

    async def unlink(self, path: str) -> None:
        await self._mds("unlink", path=path)

    async def rmdir(self, path: str) -> None:
        await self._mds("rmdir", path=path)

    async def rename(self, src: str, dst: str) -> None:
        await self._mds("rename", src=src, dst=dst)

    async def export_subtree(self, path: str, rank: int) -> dict:
        """Move a subtree's authority to another MDS rank (admin op,
        reference: `ceph mds export dir`); routed to the current owner
        via the redirect protocol like any other op."""
        return await self._mds("export", path=path, rank=rank)

    async def statfs(self) -> dict:
        return await self._mds("statfs")

    # -- file I/O ------------------------------------------------------------
    async def open(self, path: str, create: bool = True) -> "FSFile":
        if create:
            out = await self._mds("create", path=path)
        else:
            out = await self._mds("lookup", path=path)
            if out["inode"]["type"] != "file":
                raise FSError(-21, f"{path!r} is a directory")
        return FSFile(self, path, out["inode"])

    async def write_file(self, path: str, data: bytes) -> None:
        f = await self.open(path)
        await f.truncate(0)
        await f.write(data, 0)
        await f.close()

    async def read_file(self, path: str) -> bytes:
        f = await self.open(path, create=False)
        try:
            return await f.read(0, f.size)
        finally:
            await f.close()


class FSFile:
    """An open file handle: striper-backed data, size flushed to the
    MDS on close (the reference's cap flush collapsed to setattr)."""

    def __init__(self, fs: CephFSClient, path: str, inode: dict):
        self.fs = fs
        self.path = path
        self.inode = inode
        self.size = int(inode.get("size", 0))
        self._sobj = StripedObject(fs.data, data_obj(inode["ino"]))
        self._dirty = False

    async def write(self, data: bytes, offset: int) -> int:
        await self._sobj.write(data, offset)
        self.size = max(self.size, offset + len(data))
        self._dirty = True
        return len(data)

    async def read(self, offset: int, length: int) -> bytes:
        end = min(offset + length, self.size)
        if offset >= end:
            return b""
        try:
            return await self._sobj.read(offset, end - offset)
        except RadosError as e:
            if e.code == -ENOENT:
                return b"\x00" * (end - offset)  # never-written extent
            raise

    async def truncate(self, size: int) -> None:
        if size == 0:
            await self._sobj.remove()
        self.size = size
        self._dirty = True

    async def close(self) -> None:
        if self._dirty:
            await self.fs._mds("setattr", path=self.path, size=self.size)
            self._dirty = False
