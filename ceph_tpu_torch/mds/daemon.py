"""The MDS daemon (reference:src/mds/MDSDaemon.cc, Server.cc metadata
op handlers, MDLog journaling, MDCache directory objects).

Namespace layout (see package docstring): directories are omap objects
``dir.<ino>`` in the metadata pool; each entry embeds its inode (the
reference's primary-dentry inode embedding, reference:src/mds/
CDentry.h).  Every mutation is journaled to ``mds_journal`` BEFORE the
dir objects change (reference:src/mds/MDLog.cc submit_entry), so a
crashed MDS's successor replays the tail idempotently.

Counterpart of ``ceph_tpu/mds/daemon.py``, whole.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any

from ..msg import AsyncMessenger, Connection, Dispatcher, messages
from ..msg.message import Message
from ..rados.client import ENOENT, IoCtx, RadosClient, RadosError
from ..rados.striper import StripedObject

logger = logging.getLogger("ceph_tpu_torch.mds")

META_POOL = ".cephfs.meta"
DATA_POOL = ".cephfs.data"
JOURNAL_OBJ = "mds_journal"
META_OBJ = "mds_meta"
SUBTREE_OBJ = "mds_subtrees"  # path -> owning rank (the subtree map)
ROOT_INO = 1

EEXIST = 17
EINVAL = 22
ENOTDIR = 20
EISDIR = 21
ENOTEMPTY = 39
EXDEV = 18
EREMOTE = 66  # op belongs to another rank: reply carries the redirect

JOURNAL_TRIM_EVERY = 256  # applied events kept before a trim
MAX_MDS_RANKS = 16  # ino-allocation stride: rank r allocates r mod 16


def _norm_path(path: str) -> str:
    return "/" + "/".join(p for p in path.split("/") if p)


def _parent_path(path: str) -> str:
    parts = [p for p in path.split("/") if p]
    return "/" + "/".join(parts[:-1])


def _dir_obj(ino: int) -> str:
    return f"dir.{ino:x}"


def data_obj(ino: int) -> str:
    return f"data.{ino:x}"


class MDSDaemon(Dispatcher):
    """Active-or-standby metadata server."""

    def __init__(self, name: str, mon_addr: "str | list[str]", config=None,
                 data_pool_type: str = "replicated",
                 data_profile: str | None = None):
        from ..common import Config

        self.config = config or Config()
        # data objects are striped byte streams (no omap): an EC data
        # pool works; the omap-bearing metadata pool stays replicated
        # (the reference's cephfs EC-data-pool layout)
        self.data_pool_type = data_pool_type
        self.data_profile = data_profile
        self.name = name
        self.mon_addr = mon_addr
        self.messenger = AsyncMessenger(name, self)
        self.messenger.apply_config(self.config)
        from ..auth import daemon_auth_context

        self.messenger.auth = daemon_auth_context(self.config, name)
        self.addr = ""
        self.active = False
        self.osdmap = None
        self.client: RadosClient | None = None
        self.meta: IoCtx | None = None
        self.data: IoCtx | None = None
        self._mon_conn: Connection | None = None
        self._redirect_addr: str | None = None
        self._beacon_task: asyncio.Task | None = None
        self._stopping = False
        self._next_ino = 0  # allocator cursor (persisted in mds_meta)
        self._journal_seq = 0
        self._applied_seq = 0
        self._lock = asyncio.Lock()  # one metadata mutation at a time
        # multi-active (reference:src/mds/MDSMap.h ranks): assigned by
        # the mon; each rank has its own journal and owns the subtrees
        # the subtree map assigns it
        self.rank: int | None = None

    @property
    def _journal_obj(self) -> str:
        # rank 0 keeps the legacy name so single-active stores upgrade
        r = self.rank or 0
        return JOURNAL_OBJ if r == 0 else f"{JOURNAL_OBJ}.{r}"

    def _meta_key(self, base: str) -> str:
        r = self.rank or 0
        return base if r == 0 else f"{base}.{r}"

    # -- lifecycle -----------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self.addr = await self.messenger.bind(host, port)
        self.client = RadosClient(self.mon_addr)
        # the MDS's internal rados client is a cluster daemon: it talks
        # to mon/OSDs with the cluster-secret-backed authorizer
        self.client.messenger.auth = self.messenger.auth
        await self.client.connect()
        await self.client.create_pool(META_POOL, "replicated")
        kw = {}
        if self.data_pool_type == "erasure" and self.data_profile:
            kw["erasure_code_profile"] = self.data_profile
        await self.client.create_pool(DATA_POOL, self.data_pool_type, **kw)
        self.meta = self.client.io_ctx(META_POOL)
        self.data = self.client.io_ctx(DATA_POOL)
        # NO journal recovery here: a STANDBY replaying (and trimming)
        # the active's live journal would resurrect unlinked entries and
        # clobber mds_meta under it — recovery runs on ACTIVATION only
        self._beacon_task = asyncio.ensure_future(self._beacon_loop())
        return self.addr

    async def stop(self) -> None:
        self._stopping = True
        if self._beacon_task:
            self._beacon_task.cancel()
        if self.client is not None:
            await self.client.shutdown()
        await self.messenger.shutdown()

    async def _recover(self) -> None:
        """Journal replay for THIS RANK (reference:src/mds/MDLog.cc
        replay; rejoin of a failed rank's standby): re-apply every
        event past the trim point — events are idempotent, so a crash
        between journal write and dir update just replays."""
        meta = await self._omap(self.meta, META_OBJ)
        self._next_ino = int(
            meta.get(self._meta_key("next_ino"), b"1")
        )
        self._applied_seq = int(
            meta.get(self._meta_key("applied_seq"), b"0")
        )
        journal = await self._omap(self.meta, self._journal_obj)
        seqs = sorted(int(k) for k in journal)
        self._journal_seq = seqs[-1] if seqs else 0
        replayed = 0
        for seq in seqs:
            if seq <= self._applied_seq:
                continue
            ev = json.loads(journal[str(seq)])
            await self._apply_event(ev)
            self._applied_seq = seq
            replayed += 1
        if replayed:
            logger.info(
                "%s: rank %s replayed %d journal events",
                self.name, self.rank, replayed,
            )
            await self._checkpoint()
        if self.rank == 0:
            # rank 0 owns the root: ensure it and the subtree map exist
            if not await self._dir_exists(ROOT_INO):
                await self.meta.omap_set(_dir_obj(ROOT_INO), {})
            table = await self._omap(self.meta, SUBTREE_OBJ)
            if not table:
                await self.meta.omap_set(SUBTREE_OBJ, {"/": b"0"})

    # -- beacon (same shape as the mgr's; MDSMonitor beacon analog) ----------
    @property
    def _mon_addrs(self) -> list[str]:
        if isinstance(self.mon_addr, str):
            return [self.mon_addr]
        return list(self.mon_addr)

    async def _connect_mon(self) -> Connection:
        last: Exception | None = None
        addrs = self._mon_addrs
        if self._redirect_addr:
            addrs = [self._redirect_addr, *addrs]
            self._redirect_addr = None
        for addr in addrs:
            try:
                conn = await self.messenger.connect(addr, "mon")
                conn.send(messages.MMonGetMap(have=0))
                self._mon_conn = conn
                return conn
            except (ConnectionError, OSError) as e:
                last = e
        raise ConnectionError(f"no mon reachable: {last}")

    async def _beacon_loop(self) -> None:
        tid = 0
        try:
            while not self._stopping:
                tid += 1
                try:
                    conn = self._mon_conn or await self._connect_mon()
                    conn.send(messages.MMonCommand(
                        tid=tid,
                        cmd={"prefix": "mds beacon", "name": self.name,
                             "addr": self.addr},
                    ))
                except (ConnectionError, OSError):
                    self._mon_conn = None
                await asyncio.sleep(self.config.mgr_beacon_interval)
        except asyncio.CancelledError:
            pass

    # -- dispatch ------------------------------------------------------------
    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, messages.MOSDMapMsg):
            if self.osdmap is None or msg.epoch > self.osdmap.epoch:
                from ..osd.osdmap import advance_map

                m = advance_map(
                    self.osdmap, msg.epoch, msg.osdmap, msg.incrementals
                )
                if m is None:
                    conn.send(messages.MMonGetMap(have=None))
                    return
                self.osdmap = m
                ranks = self.osdmap.mds_rank_table()
                my_rank = next(
                    (i for i, (n, _a) in enumerate(ranks)
                     if n == self.name),
                    None,
                )
                if my_rank is not None and (
                    not self.active or self.rank != my_rank
                ):
                    logger.info(
                        "%s: now ACTIVE as mds rank %d", self.name, my_rank
                    )
                    # adopt THIS RANK's journal tail BEFORE serving: an
                    # op that raced replay would allocate inos the
                    # un-replayed tail already owns
                    self.rank = my_rank
                    await self._recover()
                    self.active = True
                elif my_rank is None:
                    self.active = False
                    self.rank = None
        elif isinstance(msg, messages.MMonCommandReply):
            if (msg.code == -11 and isinstance(msg.out, dict)
                    and msg.out.get("addr")):
                self._redirect_addr = msg.out["addr"]
                self._mon_conn = None
        elif isinstance(msg, messages.MClientRequest):
            t = asyncio.ensure_future(self._handle_request(conn, msg))
            t.add_done_callback(lambda _t: None)

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._mon_conn:
            self._mon_conn = None

    async def _handle_request(
        self, conn: Connection, msg: messages.MClientRequest
    ) -> None:
        try:
            handler = getattr(self, f"_op_{msg.op}", None)
            if handler is None:
                result, out = -EINVAL, {"error": f"bad op {msg.op!r}"}
            elif not self.active:
                result, out = -11, {"error": "not the active mds"}
            else:
                result, out = await handler(dict(msg.args or {}))
        except FSOpError as e:
            result = e.code
            out = e.out if e.out is not None else {"error": str(e)}
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.exception("%s: op %s failed", self.name, msg.op)
            result, out = -EINVAL, {"error": str(e)}
        conn.send(messages.MClientReply(
            tid=msg.tid, result=result, out=out,
        ))

    # -- journal -------------------------------------------------------------
    async def _journal(self, ev: dict) -> None:
        """Write-ahead: the event hits RADOS before the dirs change."""
        self._journal_seq += 1
        await self.meta.omap_set(
            self._journal_obj,
            {str(self._journal_seq): json.dumps(ev).encode()},
        )

    async def _mark_applied(self) -> None:
        self._applied_seq = self._journal_seq
        if self._journal_seq % JOURNAL_TRIM_EVERY == 0:
            await self._checkpoint()

    async def _checkpoint(self) -> None:
        """Persist allocator + trim point, drop applied journal entries
        (reference:MDLog trim)."""
        await self.meta.omap_set(META_OBJ, {
            self._meta_key("next_ino"): str(self._next_ino).encode(),
            self._meta_key("applied_seq"):
                str(self._applied_seq).encode(),
        })
        journal = await self._omap(self.meta, self._journal_obj)
        dead = [k for k in journal if int(k) <= self._applied_seq]
        if dead:
            await self.meta.omap_rmkeys(self._journal_obj, dead)

    async def _apply_event(self, ev: dict) -> None:
        """Idempotent application of one journal event to dir objects."""
        kind = ev["kind"]
        if kind == "link":
            # replay must advance the allocator past every ino it sees,
            # or a failed-over MDS hands out inos that collide with live
            # files (shared data objects = corruption).  The counter is
            # in ALLOCATION units: invert the striped formula with a
            # ceiling so even another rank's ino (a renamed-in entry)
            # bounds us safely (the un-inverted form would blow the
            # counter up ~16x per replay)
            self._next_ino = max(
                self._next_ino,
                (int(ev["inode"]["ino"]) - ROOT_INO) // MAX_MDS_RANKS + 1,
            )
            await self.meta.omap_set(
                _dir_obj(ev["dir"]),
                {ev["name"]: json.dumps(ev["inode"]).encode()},
            )
            if ev["inode"]["type"] == "dir":
                if not await self._dir_exists(ev["inode"]["ino"]):
                    await self.meta.omap_set(
                        _dir_obj(ev["inode"]["ino"]), {}
                    )
        elif kind == "unlink":
            try:
                await self.meta.omap_rmkeys(
                    _dir_obj(ev["dir"]), [ev["name"]]
                )
            except RadosError as e:
                if e.code != -ENOENT:
                    raise
        elif kind == "update":
            await self.meta.omap_set(
                _dir_obj(ev["dir"]),
                {ev["name"]: json.dumps(ev["inode"]).encode()},
            )
        elif kind == "rmdir_obj":
            try:
                await self.meta.remove(_dir_obj(ev["ino"]))
            except RadosError as e:
                if e.code != -ENOENT:
                    raise

    # -- namespace helpers ---------------------------------------------------
    async def _omap(self, io: IoCtx, obj: str) -> dict[str, bytes]:
        try:
            return await io.omap_get(obj)
        except RadosError as e:
            if e.code == -ENOENT:
                return {}
            raise

    async def _dir_exists(self, ino: int) -> bool:
        try:
            await self.meta.stat(_dir_obj(ino))
            return True
        except RadosError:
            return False

    async def _resolve(self, path: str) -> tuple[int, str, dict | None]:
        """path -> (parent dir ino, final name, inode-or-None).
        '/' resolves to (0, '', root-inode)."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            return 0, "", {"ino": ROOT_INO, "type": "dir"}
        ino = ROOT_INO
        for i, name in enumerate(parts):
            entries = await self._omap(self.meta, _dir_obj(ino))
            last = i == len(parts) - 1
            raw = entries.get(name)
            if last:
                return ino, name, (
                    json.loads(raw) if raw is not None else None
                )
            if raw is None:
                raise FSOpError(-ENOENT, f"no such directory: {name!r}")
            inode = json.loads(raw)
            if inode["type"] != "dir":
                raise FSOpError(-ENOTDIR, f"{name!r} is not a directory")
            ino = inode["ino"]
        raise AssertionError("unreachable")

    def _alloc_ino(self) -> int:
        """Rank-striped allocation: rank r hands out inos congruent to
        r mod MAX_MDS_RANKS, so concurrent active ranks can never
        collide (the reference partitions its inotable per rank,
        reference:src/mds/InoTable.h)."""
        self._next_ino += 1
        return (
            self._next_ino * MAX_MDS_RANKS + (self.rank or 0) + ROOT_INO
        )

    # -- subtree authority (reference:src/mds/MDCache.h subtree map +
    # Migrator.cc export; collapsed to an authoritative path->rank table
    # in the shared metadata pool) -------------------------------------------

    _SUBTREE_TTL = 2.0

    async def _subtree_table(self, fresh: bool = False) -> dict[str, int]:
        """The subtree map, cached briefly (a full omap read per metadata
        op under the global lock would cost too much).  Safe because ownership
        only ever changes THROUGH the current owner (_op_export), which
        invalidates its own cache — a stale cache can produce an extra
        redirect hop, never a stale-positive claim of ownership."""
        now = time.monotonic()
        cache = getattr(self, "_subtree_cache", None)
        if not fresh and cache is not None and (
            now - cache[0] < self._SUBTREE_TTL
        ):
            return cache[1]
        raw = await self._omap(self.meta, SUBTREE_OBJ)
        table = {_norm_path(k): int(v) for k, v in raw.items()}
        self._subtree_cache = (now, table)
        return table

    def _invalidate_subtrees(self) -> None:
        self._subtree_cache = None

    async def _authority(self, path: str) -> int:
        """Longest-prefix owner of ``path`` in the subtree map; vacant
        table or unmatched paths belong to rank 0."""
        table = await self._subtree_table()
        p = _norm_path(path)
        best, best_len = 0, -1
        for pref, rank in table.items():
            if pref == "/" or p == pref or p.startswith(pref + "/"):
                if len(pref) > best_len:
                    best, best_len = rank, len(pref)
        return best

    async def _subtree_boundary_below(self, path: str) -> "str | None":
        """A subtree-map entry at or beneath ``path`` (other than the
        root default), or None.  Directory renames/removals across such
        a boundary are refused: the table is keyed by path, so moving
        the directory would silently re-home the exported subtree (the
        reference freezes subtree bounds during such ops)."""
        table = await self._subtree_table()
        p = _norm_path(path)
        for pref in table:
            if pref == "/":
                continue
            if pref == p or pref.startswith(p + "/"):
                return pref
        return None

    async def _require_auth(self, path: str) -> None:
        """Mutations re-validate authority with a FRESH table read
        UNDER the op lock: an export committing between dispatch and
        lock acquisition must not let the old owner mutate (the
        reference's export freeze/unfreeze exclusion)."""
        auth = await self._authority(path)
        if auth == self.rank:
            return
        ranks = self.osdmap.mds_ranks if self.osdmap else []
        addr = (
            ranks[auth][1]
            if 0 <= auth < len(ranks) and ranks[auth][0] else ""
        )
        if not addr:
            raise FSOpError(-11, f"rank {auth} has no active mds")
        raise FSOpError(
            -EREMOTE, f"subtree owned by rank {auth}",
            out={"redirect": auth, "addr": addr},
        )

    async def _op_export(self, args: dict) -> tuple[int, dict]:
        """Move a subtree's authority to another rank (reference:
        src/mds/Migrator.cc collapsed: dir objects live in shared
        RADOS, so migration IS the table handoff — flush our journal,
        then commit the new owner)."""
        path = _norm_path(args["path"])
        rank = int(args["rank"])
        ranks = self.osdmap.mds_ranks if self.osdmap else []
        if not (0 <= rank < len(ranks)) or not ranks[rank][0]:
            return -EINVAL, {"error": f"rank {rank} is not active"}
        async with self._lock:
            self._invalidate_subtrees()  # decide on the durable table
            await self._require_auth(path)
            _parent, _name, inode = await self._resolve(path)
            if inode is None or inode["type"] != "dir":
                return -ENOTDIR, {"error": f"{path!r} is not a directory"}
            # drain: everything journaled here is applied before the
            # handoff, so the new owner starts from committed state
            await self._checkpoint()
            await self.meta.omap_set(
                SUBTREE_OBJ, {path: str(rank).encode()}
            )
            self._invalidate_subtrees()
        logger.info(
            "%s: exported subtree %s -> rank %d", self.name, path, rank
        )
        return 0, {"path": path, "rank": rank}

    # -- ops (reference:src/mds/Server.cc handle_client_*) -------------------
    async def _op_mkdir(self, args: dict) -> tuple[int, dict]:
        async with self._lock:
            await self._require_auth(_parent_path(args["path"]))
            parent, name, inode = await self._resolve(args["path"])
            if not name:
                return -EEXIST, {"error": "/ exists"}
            if inode is not None:
                return -EEXIST, {"error": f"{name!r} exists"}
            ino = self._alloc_ino()
            node = {"ino": ino, "type": "dir", "mode": args.get("mode", 0o755),
                    "mtime": time.time()}
            await self._journal({"kind": "link", "dir": parent,
                                 "name": name, "inode": node})
            await self._apply_event({"kind": "link", "dir": parent,
                                     "name": name, "inode": node})
            await self._mark_applied()
            return 0, {"inode": node}

    async def _op_create(self, args: dict) -> tuple[int, dict]:
        async with self._lock:
            await self._require_auth(_parent_path(args["path"]))
            parent, name, inode = await self._resolve(args["path"])
            if inode is not None:
                if inode["type"] == "dir":
                    return -EISDIR, {"error": f"{name!r} is a directory"}
                return 0, {"inode": inode, "existed": True}
            ino = self._alloc_ino()
            node = {"ino": ino, "type": "file", "size": 0,
                    "mode": args.get("mode", 0o644), "mtime": time.time()}
            await self._journal({"kind": "link", "dir": parent,
                                 "name": name, "inode": node})
            await self._apply_event({"kind": "link", "dir": parent,
                                     "name": name, "inode": node})
            await self._mark_applied()
            return 0, {"inode": node}

    async def _op_lookup(self, args: dict) -> tuple[int, dict]:
        _parent, name, inode = await self._resolve(args["path"])
        if inode is None:
            return -ENOENT, {"error": f"no such entry {name!r}"}
        return 0, {"inode": inode}

    async def _op_readdir(self, args: dict) -> tuple[int, dict]:
        _parent, _name, inode = await self._resolve(args["path"])
        if inode is None:
            return -ENOENT, {"error": "no such directory"}
        if inode["type"] != "dir":
            return -ENOTDIR, {"error": "not a directory"}
        entries = await self._omap(self.meta, _dir_obj(inode["ino"]))
        return 0, {
            "entries": {
                n: json.loads(raw) for n, raw in sorted(entries.items())
            }
        }

    async def _op_unlink(self, args: dict) -> tuple[int, dict]:
        async with self._lock:
            await self._require_auth(_parent_path(args["path"]))
            parent, name, inode = await self._resolve(args["path"])
            if inode is None:
                return -ENOENT, {"error": f"no such entry {name!r}"}
            if inode["type"] == "dir":
                return -EISDIR, {"error": "is a directory (use rmdir)"}
            await self._journal({"kind": "unlink", "dir": parent,
                                 "name": name})
            await self._apply_event({"kind": "unlink", "dir": parent,
                                     "name": name})
            await self._mark_applied()
            # file data dies with the last link (no hardlinks here)
            await StripedObject(self.data, data_obj(inode["ino"])).remove()
            return 0, {}

    async def _op_rmdir(self, args: dict) -> tuple[int, dict]:
        async with self._lock:
            await self._require_auth(_parent_path(args["path"]))
            parent, name, inode = await self._resolve(args["path"])
            if inode is None:
                return -ENOENT, {"error": f"no such entry {name!r}"}
            if inode["type"] != "dir":
                return -ENOTDIR, {"error": "not a directory"}
            children = await self._omap(self.meta, _dir_obj(inode["ino"]))
            if children:
                return -ENOTEMPTY, {"error": "directory not empty"}
            boundary = await self._subtree_boundary_below(args["path"])
            if boundary is not None:
                return -16, {"error": f"subtree boundary {boundary!r}: "
                                      "export it back before rmdir"}
            for ev in (
                {"kind": "unlink", "dir": parent, "name": name},
                {"kind": "rmdir_obj", "ino": inode["ino"]},
            ):
                await self._journal(ev)
                await self._apply_event(ev)
            await self._mark_applied()
            return 0, {}

    async def _op_rename(self, args: dict) -> tuple[int, dict]:
        async with self._lock:
            s = [p for p in args["src"].split("/") if p]
            d = [p for p in args["dst"].split("/") if p]
            if s == d:
                return 0, {}  # POSIX: rename to self is a no-op
            if d[: len(s)] == s:
                # moving a directory into its own subtree would orphan
                # it as an unreachable cycle (POSIX EINVAL)
                return -EINVAL, {"error": "cannot move a directory "
                                          "into itself"}
            await self._require_auth(_parent_path(args["src"]))
            for side in ("src", "dst"):
                boundary = await self._subtree_boundary_below(args[side])
                if boundary is not None:
                    # the subtree map is path-keyed: renaming over a
                    # boundary would silently re-home the export
                    return -16, {"error": f"subtree boundary "
                                          f"{boundary!r} under {side}"}
            dst_auth = await self._authority(_parent_path(args["dst"]))
            if dst_auth != self.rank:
                # the reference migrates for cross-rank renames
                # (Migrator); here the subtree handoff is explicit, so
                # clients see the POSIX cross-device answer instead
                return -EXDEV, {"error": "rename crosses mds subtrees"}
            sparent, sname, sinode = await self._resolve(args["src"])
            if sinode is None:
                return -ENOENT, {"error": f"no such entry {sname!r}"}
            dparent, dname, dinode = await self._resolve(args["dst"])
            if dinode is not None:
                return -EEXIST, {"error": f"{dname!r} exists"}
            # journal both halves BEFORE either dir changes: a crash in
            # between replays to completion (the reference's EUpdate
            # covers multi-dir renames the same way)
            for ev in (
                {"kind": "link", "dir": dparent, "name": dname,
                 "inode": sinode},
                {"kind": "unlink", "dir": sparent, "name": sname},
            ):
                await self._journal(ev)
            for ev in (
                {"kind": "link", "dir": dparent, "name": dname,
                 "inode": sinode},
                {"kind": "unlink", "dir": sparent, "name": sname},
            ):
                await self._apply_event(ev)
            await self._mark_applied()
            return 0, {}

    async def _op_setattr(self, args: dict) -> tuple[int, dict]:
        async with self._lock:
            await self._require_auth(_parent_path(args["path"]))
            parent, name, inode = await self._resolve(args["path"])
            if inode is None:
                return -ENOENT, {"error": f"no such entry {name!r}"}
            for k in ("size", "mode", "mtime"):
                if k in args:
                    inode[k] = args[k]
            ev = {"kind": "update", "dir": parent, "name": name,
                  "inode": inode}
            await self._journal(ev)
            await self._apply_event(ev)
            await self._mark_applied()
            return 0, {"inode": inode}

    async def _op_statfs(self, args: dict) -> tuple[int, dict]:
        root = await self._omap(self.meta, _dir_obj(ROOT_INO))
        return 0, {"root_entries": len(root),
                   "next_ino": self._next_ino}


class FSOpError(Exception):
    def __init__(self, code: int, msg: str, out: dict | None = None):
        super().__init__(msg)
        self.code = code
        self.out = out
