"""Cache tiering: hit sets, promote-on-miss, the flush/evict agent.

Re-expression of the reference's cache-tier machinery
(reference:src/osd/PrimaryLogPG.cc maybe_handle_cache_detail /
promote_object / agent_work; reference:src/osd/HitSet.h): a replicated
CACHE pool fronts a base pool (often EC).  With the overlay set, clients
target the cache pool (Objecter read_tier/write_tier redirection —
``rados/client.py`` operate); the cache primary then:

- records every access in per-PG HIT SETS (a sliding window of
  ``hit_set_count`` sets rotated every ``hit_set_period`` seconds —
  the reference's persisted bloom HitSets collapsed to in-memory exact
  sets, sized by this framework's test-cluster scale),
- PROMOTES missing objects from the base pool before serving ops that
  need existing state (reads, stats, xattrs, partial writes),
- marks mutated objects DIRTY in the same transaction as the mutation
  (an injected internal ``tier.dirty`` opcode),
- propagates client deletes to the base (the reference defers via
  whiteouts; collapsed to synchronous delete — same visible result,
  no async trim debt),

while the AGENT (one task per OSD) walks cache PGs this OSD leads:
dirty objects older than ``cache_min_flush_age`` FLUSH (write back to
base, clear dirty), and when the pool is over
``cache_target_full_ratio`` of ``target_max_objects``/``bytes``, clean
COLD objects (temperature 0 in the hit sets, older than
``cache_min_evict_age``) EVICT — dropped from the cache only; the base
still holds them, so a later access re-promotes.

Counterpart of ``ceph_tpu/osd/tiering.py``, whole: the same hit-set
bytes (``BloomHitSet.to_bytes``), the same pg-meta omap keys for the
archive and the whiteouts, and the same ``_tier_dirty_`` marker, so a
cache PG's state reads in either package.  A flush into an EC base runs
the base primary's EC write (the card's encode), and a promote from it
the EC read (the card's decode when the read is degraded).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING

from ..msg import messages
from .osdmap import POOL_TYPE_ERASURE
from ..store.objectstore import CollectionId, ObjectId, Transaction

if TYPE_CHECKING:  # pragma: no cover
    from .daemon import OSD

logger = logging.getLogger("ceph_tpu_torch.osd.tiering")

# raw (non-user) xattr marking a cache object as not-yet-flushed
DIRTY_KEY = "_tier_dirty_"

# pg-meta omap key prefix recording "client delete acked, base delete
# pending" (the reference's whiteout).  The oid is hex-encoded so the key
# can never contain "." — every "."-keyed entry in the pgmeta omap is
# parsed as a pg_log record (``pg_log.read_log``).
_WHITEOUT_PREFIX = "tierwh/"


def whiteout_key(oid: str) -> str:
    return _WHITEOUT_PREFIX + oid.encode().hex()


def _whiteout_oid(key: str) -> str:
    return bytes.fromhex(key[len(_WHITEOUT_PREFIX):]).decode()
# ops that need the object's EXISTING state: a miss must promote first.
# This is everything except "delete" — even writefull and setxattr keep
# rados semantics only relative to prior state (xattrs survive
# write_full; a bare setxattr must not materialize an empty object whose
# flush would clobber the base copy).
_NEED_STATE_EXEMPT = {"delete", "watch", "unwatch", "notify"}
_WRITE_OPS = {
    "write", "writefull", "append", "zero", "truncate", "setxattr",
    "rmxattr", "omap_setkeys", "omap_rmkeys", "omap_clear", "call",
}


class BloomHitSet:
    """Fixed-size bloom filter over object names — the reference's
    BloomHitSet (reference:src/osd/HitSet.h compressible_bloom_filter):
    memory is BOUNDED by the configured target regardless of workload
    (exact sets would grow without limit), membership may
    rarely false-positive (same contract as the reference; temperature
    is advisory), and the byte image round-trips for persistence."""

    __slots__ = ("nbits", "k", "bits", "inserted")

    def __init__(self, target_objects: int = 20000, fpp: float = 0.01):
        import math

        n = max(16, int(target_objects))
        nbits = max(64, int(-n * math.log(fpp) / (math.log(2) ** 2)))
        self.nbits = nbits
        self.k = max(1, round(nbits / n * math.log(2)))
        self.bits = bytearray((nbits + 7) // 8)
        self.inserted = 0

    def _idx(self, oid: str):
        import zlib

        b = oid.encode()
        h1 = zlib.crc32(b)
        h2 = zlib.crc32(b, 0x9747B28C) | 1  # odd: full-period stepping
        for i in range(self.k):
            yield (h1 + i * h2) % self.nbits

    def insert(self, oid: str) -> None:
        for i in self._idx(oid):
            self.bits[i >> 3] |= 1 << (i & 7)
        self.inserted += 1

    def __contains__(self, oid: str) -> bool:
        return all(
            self.bits[i >> 3] & (1 << (i & 7)) for i in self._idx(oid)
        )

    def __len__(self) -> int:  # approximate (insert() may re-add)
        return self.inserted

    # -- persistence ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        import struct

        return struct.pack(">IIQ", self.nbits, self.k, self.inserted) + bytes(
            self.bits
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BloomHitSet":
        import struct

        nbits, k, inserted = struct.unpack_from(">IIQ", raw)
        nbytes = (nbits + 7) // 8
        if len(raw) < 16 + nbytes or nbits == 0 or k == 0:
            # a truncated payload must fail HERE, inside from_omap's
            # corruption guard — not as an IndexError in the agent's
            # hot path later
            raise ValueError("truncated bloom hit set")
        hs = cls.__new__(cls)
        hs.nbits = nbits
        hs.k = k
        hs.inserted = inserted
        hs.bits = bytearray(raw[16 : 16 + nbytes])
        return hs


class HitSetTracker:
    """Per-PG sliding window of bloom access sets (reference:
    src/osd/HitSet.h + PrimaryLogPG::hit_set_create/persist): bounded
    memory per set, persisted to the pg meta omap by the agent so
    temperature survives a primary restart/failover."""

    def __init__(self, count: int, period: float,
                 target_objects: int = 20000):
        self.count = max(1, count)
        self.period = max(0.001, period)
        self.target_objects = target_objects
        self.sets: list[tuple[float, BloomHitSet]] = [
            (time.monotonic(), BloomHitSet(target_objects))
        ]
        self.dirty = 0  # bumped on every mutation; persistence cursor

    def _rotate(self) -> None:
        now = time.monotonic()
        if now - self.sets[-1][0] >= self.period:
            self.sets.append((now, BloomHitSet(self.target_objects)))
            del self.sets[: -self.count]
            self.dirty += 1

    def record(self, oid: str) -> None:
        self._rotate()
        self.sets[-1][1].insert(oid)
        self.dirty += 1

    def temperature(self, oid: str) -> int:
        """How many of the recent hit sets contain the object (0 =
        stone cold, the eviction candidate ordering)."""
        self._rotate()
        return sum(1 for _t, s in self.sets if oid in s)

    def dump(self) -> dict:
        return {
            "count": self.count, "period": self.period,
            "sets": [
                {"age": round(time.monotonic() - t, 1), "objects": len(s)}
                for t, s in self.sets
            ],
        }

    # -- persistence (the reference archives hit sets as PG objects;
    # here they ride the pg meta omap, replicated like the pg log) -----------
    def to_omap(self) -> dict[str, bytes]:
        import struct

        now = time.monotonic()
        kv = {
            HITSET_COUNT_KEY: str(len(self.sets)).encode(),
        }
        for i, (stamp, hs) in enumerate(self.sets):
            kv[f"{HITSET_PREFIX}{i}"] = (
                struct.pack(">d", now - stamp) + hs.to_bytes()
            )
        return kv

    @classmethod
    def from_omap(cls, count: int, period: float,
                  omap: dict[str, bytes]) -> "HitSetTracker | None":
        import struct

        try:
            n = int(omap.get(HITSET_COUNT_KEY, b"0"))
            if n <= 0:
                return None
            tr = cls(count, period)
            now = time.monotonic()
            sets = []
            for i in range(n):
                raw = omap[f"{HITSET_PREFIX}{i}"]
                (age,) = struct.unpack_from(">d", raw)
                sets.append((now - age, BloomHitSet.from_bytes(raw[8:])))
            tr.sets = sets[-count:]
            return tr
        except (KeyError, ValueError, struct.error):
            return None  # partial/corrupt archive: start fresh


# pg-meta omap keys for the hit-set archive (no "." — every dotted key
# in the pgmeta omap parses as a pg_log record)
HITSET_PREFIX = "hitset/"
HITSET_COUNT_KEY = "hitset_n"


class TieringService:
    """The OSD-side cache logic + agent."""

    def __init__(self, osd: "OSD", agent_interval: float = 1.0):
        self.osd = osd
        self.agent_interval = agent_interval
        self._hit_sets: dict[str, HitSetTracker] = {}  # pgid -> tracker
        self._futs: dict[int, asyncio.Future] = {}  # internal op tids
        self._agent_task: asyncio.Task | None = None
        self.stats = {
            "promotes": 0, "flushes": 0, "evictions": 0, "hits": 0,
        }

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._agent_task is None:
            self._agent_task = asyncio.ensure_future(self._agent_loop())

    def stop(self) -> None:
        if self._agent_task is not None:
            self._agent_task.cancel()
            self._agent_task = None

    def on_reply(self, msg: "messages.MOSDOpReply") -> bool:
        fut = self._futs.pop(msg.tid, None)
        if fut is not None and not fut.done():
            fut.set_result(msg)
            return True
        return False

    # -- hit sets -------------------------------------------------------------
    def tracker(self, pg, pool) -> HitSetTracker:
        key = str(pg)
        tr = self._hit_sets.get(key)
        if tr is None or tr.count != pool.hit_set_count or (
            tr.period != pool.hit_set_period
        ):
            tr = None
            # a restarted/failed-over primary resumes the persisted
            # archive so temperatures survive
            try:
                from .pg_log import meta_oid

                omap = self.osd.store.omap_get(
                    CollectionId(str(pg)), meta_oid(-1)
                )
                tr = HitSetTracker.from_omap(
                    pool.hit_set_count, pool.hit_set_period, omap
                )
            except KeyError:
                pass
            if tr is None:
                tr = HitSetTracker(
                    pool.hit_set_count, pool.hit_set_period
                )
            self._hit_sets[key] = tr
        return tr

    async def _persist_hit_sets(self, pg, acting, tr: HitSetTracker) -> None:
        """Archive the tracker to the (replicated) pg meta omap — the
        reference persists hit sets as PG objects for the same reason:
        an evicting agent on a new primary must not see everything as
        stone cold."""
        marker = getattr(tr, "_persisted", -1)
        if tr.dirty == marker:
            return
        from .pg_log import meta_oid

        cid = CollectionId(str(pg))
        txn = Transaction().omap_setkeys(cid, meta_oid(-1), tr.to_omap())
        r = await self.osd._meta_rep_commit(pg, acting, txn)
        if r == 0:
            tr._persisted = tr.dirty

    def dump_hit_sets(self) -> dict:
        return {k: t.dump() for k, t in self._hit_sets.items()}

    # -- the op-path hook -----------------------------------------------------
    async def prepare(self, pg, pool, acting, msg) -> None:
        """Runs in _execute_op for ops on a writeback cache pool, BEFORE
        pg-lock acquisition: record the hit, promote on miss, and inject
        the dirty marker into mutating op batches (atomic with them)."""
        names = [op.get("op") for op in msg.ops]
        tr = self.tracker(pg, pool)
        tr.record(msg.oid)
        self.stats["hits"] += 1
        osd = self.osd
        cid = CollectionId(str(pg))
        missing = not osd.store.exists(cid, ObjectId(msg.oid))
        whiteouted = missing and self._has_whiteout(cid, msg.oid)
        if (
            missing and not whiteouted
            and any(n not in _NEED_STATE_EXEMPT for n in names)
        ):
            # a pending whiteout means the object was deleted here but
            # the base copy may still exist: promoting it would
            # resurrect an acked delete
            await self._promote(pg, pool, acting, msg.oid)
        if any(n in _WRITE_OPS for n in names) and "delete" not in names:
            # same-batch dirty marking: the rep engine executes the
            # injected op inside the SAME transaction as the mutation
            msg.ops = list(msg.ops) + [{"op": "tier.dirty"}]
            if whiteouted:
                # the client recreates a deleted object: the new data
                # supersedes the pending base delete (a later flush
                # overwrites the stale base copy), so drop the whiteout
                # atomically with the creating write
                msg.ops = list(msg.ops) + [{"op": "tier.clear_whiteout"}]
        elif "delete" in names:
            # record the pending base delete IN the delete transaction:
            # if propagation to the base fails below, the whiteout (not
            # a re-promotion) defines what a later miss sees
            msg.ops = list(msg.ops) + [{"op": "tier.whiteout"}]

    def _has_whiteout(self, cid: CollectionId, oid: str) -> bool:
        from .pg_log import meta_oid

        try:
            omap = self.osd.store.omap_get(cid, meta_oid(-1))
        except KeyError:
            return False
        return whiteout_key(oid) in omap

    def _pending_whiteouts(self, cid: CollectionId) -> list[str]:
        from .pg_log import meta_oid

        try:
            omap = self.osd.store.omap_get(cid, meta_oid(-1))
        except KeyError:
            return []
        return [
            _whiteout_oid(k) for k in omap if k.startswith(_WHITEOUT_PREFIX)
        ]

    async def _clear_whiteout(self, pg, acting, oid: str) -> None:
        from .pg_log import meta_oid

        cid = CollectionId(str(pg))
        txn = Transaction().omap_rmkeys(
            cid, meta_oid(-1), [whiteout_key(oid)]
        )
        r = await self.osd._meta_rep_commit(pg, acting, txn)
        if r != 0:
            logger.warning(
                "%s: clearing whiteout for %s failed: %s",
                self.osd.name, oid, r,
            )

    async def finish(self, pg, pool, acting, msg, result: int) -> None:
        """Post-op: propagate a successful client delete to the base.

        The whiteout recorded in the delete transaction (prepare) stays
        until the base confirms; on failure the agent loop retries —
        never losing an acked delete."""
        if result != 0 or "delete" not in [o.get("op") for o in msg.ops]:
            return
        base = self.osd.osdmap.pools.get(pool.tier_of)
        if base is None:
            return
        reply = await self._pool_op(base.id, msg.oid, [{"op": "delete"}], [])
        if reply is not None and reply.result in (0, -2):  # ENOENT ok
            await self._clear_whiteout(pg, acting, msg.oid)
        else:
            logger.warning(
                "%s: tier delete of %s in base %s failed (%s); whiteout "
                "kept, agent will retry", self.osd.name, msg.oid,
                base.name, None if reply is None else reply.result,
            )

    async def _promote(self, pg, pool, acting, oid: str) -> None:
        """Copy base object (data + user xattrs + omap) into the cache,
        clean.  A base miss is fine: the op proceeds and sees
        ENOENT/creates."""
        base = self.osd.osdmap.pools.get(pool.tier_of)
        if base is None:
            return
        # EC base pools have no omap (reference: -EOPNOTSUPP on EC
        # omap ops) — only ask a replicated base for it
        base_omap = base.type != POOL_TYPE_ERASURE
        ops_r = [{"op": "read", "offset": 0, "length": 0},
                 {"op": "getxattrs"}]
        if base_omap:
            ops_r.append({"op": "omap_get"})
        reply = await self._pool_op(base.id, oid, ops_r, [])
        if reply is None or reply.result < 0:
            return  # not in base (or base degraded): nothing to promote
        data = reply.blobs[reply.out[0]["data"]]
        attrs = {
            k: reply.blobs[bi] for k, bi in reply.out[1]["attrs"].items()
        }
        omap = {}
        if base_omap:
            omap = {
                k: reply.blobs[bi]
                for k, bi in reply.out[2].get("keys", {}).items()
            }
        ops = [{"op": "writefull", "data": 0}]
        blobs = [bytes(data)]
        for k, v in attrs.items():
            ops.append({"op": "setxattr", "key": k, "data": len(blobs)})
            blobs.append(bytes(v))
        if omap:
            keymap = {}
            for k, v in omap.items():
                keymap[k] = len(blobs)
                blobs.append(bytes(v))
            ops.append({"op": "omap_setkeys", "keys": keymap})
        synthetic = messages.MOSDOp(
            tid=0, epoch=self.osd._epoch(), pool=pool.id, oid=oid,
            ops=ops, blobs=blobs,
        )
        # direct _rep_execute: we ARE the cache PG's primary, and going
        # through _execute_op would recurse into this hook
        async with self.osd.pg_lock(pg):
            cid = CollectionId(str(pg))
            if self.osd.store.exists(cid, ObjectId(oid)):
                # a racing op created or promoted it while our base read
                # was in flight: the resident copy (possibly with an
                # acked client write) must win — clobbering it with
                # stale base bytes would lose the write
                return
            r, _out, _blobs = await self.osd._rep_execute(
                pg, pool, acting, synthetic, locked=True
            )
        if r == 0:
            self.stats["promotes"] += 1
        else:
            logger.warning(
                "%s: promote of %s into %s failed: %s",
                self.osd.name, oid, pool.name, r,
            )

    # -- internal client ops to other pools -----------------------------------
    async def _pool_op(
        self, pool_id: int, oid: str, ops: list[dict], blobs: list[bytes],
        timeout: float = 10.0,
    ):
        """One MOSDOp round trip to ``oid``'s primary in another pool
        (the OSD acting as its own Objecter for tier traffic)."""
        osd = self.osd
        for _attempt in range(3):
            try:
                pg, acting, primary = osd.osdmap.object_to_acting(
                    oid, pool_id
                )
            except KeyError:
                return None
            if primary < 0:
                await asyncio.sleep(0.2)
                continue
            if primary == osd.osd_id:
                pool = osd.osdmap.pools[pool_id]
                synthetic = messages.MOSDOp(
                    tid=0, epoch=osd._epoch(), pool=pool_id, oid=oid,
                    ops=ops, blobs=blobs,
                )
                r, out, rblobs = await osd._execute_op(synthetic)
                return messages.MOSDOpReply(
                    tid=0, result=r, epoch=osd._epoch(), out=out,
                    blobs=rblobs,
                )
            addr = osd.osdmap.get_addr(primary)
            if not addr:
                await asyncio.sleep(0.2)
                continue
            tid = osd._new_tid()
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._futs[tid] = fut
            try:
                conn = await osd.messenger.connect(addr, f"osd.{primary}")
                conn.send(messages.MOSDOp(
                    tid=tid, epoch=osd._epoch(), pool=pool_id, oid=oid,
                    ops=ops, blobs=blobs,
                ))
                async with asyncio.timeout(timeout):
                    reply = await fut
                if reply.result == -11 and _attempt < 2:  # EAGAIN: re-peer
                    await asyncio.sleep(0.3)
                    continue
                return reply
            except (ConnectionError, OSError, TimeoutError):
                await asyncio.sleep(0.2)
            finally:
                self._futs.pop(tid, None)
        return None

    # -- the agent ------------------------------------------------------------
    async def _agent_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.agent_interval)
                try:
                    await self._agent_pass()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("%s: tier agent pass failed",
                                     self.osd.name)
        except asyncio.CancelledError:
            pass

    async def _agent_pass(self) -> None:
        osd = self.osd
        if osd.osdmap is None:
            return
        for pool in list(osd.osdmap.pools.values()):
            if pool.tier_of < 0 or pool.cache_mode != "writeback":
                continue
            for pg in osd.osdmap.pgs_of_pool(pool.id):
                try:
                    _u, _up, acting, primary = (
                        osd.osdmap.pg_to_up_acting_osds(pg)
                    )
                except Exception:
                    continue
                if primary != osd.osd_id:
                    continue
                await self._agent_pg(pg, pool, acting)

    async def _agent_pg(self, pg, pool, acting) -> None:
        osd = self.osd
        cid = CollectionId(str(pg))
        if not osd.store.collection_exists(cid):
            return
        base = osd.osdmap.pools.get(pool.tier_of)
        if base is None:
            return
        from . import snaps as snaps_mod
        from .pg_log import is_stash_name

        # retry pending base deletes (whiteouts) before anything else:
        # while one is pending, a miss on that oid must not re-promote
        for w_oid in self._pending_whiteouts(cid):
            if osd.store.exists(cid, ObjectId(w_oid)):
                # object was recreated; whiteout is stale (clear should
                # have ridden the write — sweep it here regardless)
                await self._clear_whiteout(pg, acting, w_oid)
                continue
            reply = await self._pool_op(base.id, w_oid, [{"op": "delete"}], [])
            if reply is not None and reply.result in (0, -2):
                await self._clear_whiteout(pg, acting, w_oid)

        now = time.monotonic()
        tr = self.tracker(pg, pool)
        await self._persist_hit_sets(pg, acting, tr)
        objects = []
        for o in osd.store.list_objects(cid):
            if (
                o.name == "_pgmeta_" or is_stash_name(o.name)
                or snaps_mod.is_clone_name(o.name)
            ):
                continue
            objects.append(o)
        n_bytes = 0
        dirty = []
        clean = []
        for o in objects:
            try:
                attrs = osd.store.getattrs(cid, o)
                n_bytes += osd.store.stat(cid, o)
            except KeyError:
                continue
            (dirty if DIRTY_KEY in attrs else clean).append(o)
        # flush: every dirty object past min_flush_age (age via hit-set
        # recency is the collapse: a just-written object is in the
        # newest set)
        for o in dirty:
            if pool.cache_min_flush_age > 0 and tr.temperature(o.name) > 0:
                # recently touched: honor min_flush_age by skipping while
                # it is still hot within the newest period
                age_ok = (
                    now - tr.sets[-1][0] >= pool.cache_min_flush_age
                )
                if not age_ok:
                    continue
            await self._flush_object(pg, pool, base, acting, cid, o)
        # evict: only when over the configured target.  The agent sees
        # one PG at a time, so the pool-level target is split across the
        # PGs (reference:PrimaryLogPG::agent_choose_mode divides
        # target_max_* by the pool's pg count)
        if pool.target_max_objects or pool.target_max_bytes:
            pgn = max(pool.pg_num, 1)
            over_objs = pool.target_max_objects and (
                len(objects)
                > pool.cache_target_full_ratio
                * pool.target_max_objects / pgn
            )
            over_bytes = pool.target_max_bytes and (
                n_bytes
                > pool.cache_target_full_ratio
                * pool.target_max_bytes / pgn
            )
            if over_objs or over_bytes:
                # coldest-first among CLEAN objects, and ONLY until the
                # PG is back under target — draining every cold object
                # would thrash the cache with re-promotions (the
                # reference's agent evicts to the target)
                obj_target = (
                    pool.cache_target_full_ratio
                    * pool.target_max_objects / pgn
                    if pool.target_max_objects else float("inf")
                )
                byte_target = (
                    pool.cache_target_full_ratio
                    * pool.target_max_bytes / pgn
                    if pool.target_max_bytes else float("inf")
                )
                count = len(objects)
                ranked = sorted(
                    clean, key=lambda o: tr.temperature(o.name)
                )
                for o in ranked:
                    if count <= obj_target and n_bytes <= byte_target:
                        break
                    if tr.temperature(o.name) > 0:
                        break  # only genuinely cold objects evict
                    try:
                        size = self.osd.store.stat(cid, o)
                    except KeyError:
                        continue
                    await self._evict_object(pg, pool, acting, cid, o)
                    count -= 1
                    n_bytes -= size

    async def _flush_object(self, pg, pool, base, acting, cid, o) -> None:
        osd = self.osd
        from .daemon import OI_KEY

        async with osd.pg_lock(pg):
            try:
                data = bytes(osd.store.read(cid, o))
                attrs = osd.store.getattrs(cid, o)
                omap = osd.store.omap_get(cid, o)
            except KeyError:
                return  # raced a delete
            if DIRTY_KEY not in attrs:
                return  # raced another flush
            oi_snapshot = attrs.get(OI_KEY)
        base_omap = base.type != POOL_TYPE_ERASURE
        if omap and not base_omap:
            # the reference cannot flush omap objects to an EC base
            # either (EC pools reject omap): stay dirty, warn once
            logger.warning(
                "%s: cannot flush %s: object has omap but base %s is "
                "erasure-coded", osd.name, o.name, base.name,
            )
            return
        ops = [{"op": "writefull", "data": 0}]
        blobs = [data]
        plen = len(osd.USER_XATTR_PREFIX)
        cache_keys = set()
        for k, v in attrs.items():
            if k.startswith(osd.USER_XATTR_PREFIX):
                cache_keys.add(k[plen:])
                ops.append(
                    {"op": "setxattr", "key": k[plen:], "data": len(blobs)}
                )
                blobs.append(bytes(v))
        # xattrs REMOVED on the cache copy must not survive on the base
        # (flush->evict->re-promote would resurrect them): fetch
        # the base's current keys and ride rmxattr for the stale ones in
        # the same (atomic) mutating batch as the writefull.  A FAILED
        # probe aborts the flush (object stays dirty, agent retries):
        # proceeding without the rmxattr set would mark the object clean
        # while a stale key survives — the very bug this closes
        probe = await self._pool_op(base.id, o.name, [{"op": "getxattrs"}], [])
        if probe is None or probe.result not in (0, -2):  # ENOENT: no base copy
            logger.warning(
                "%s: flush of %s deferred: base xattr probe failed (%s)",
                osd.name, o.name, None if probe is None else probe.result,
            )
            return
        if probe.result == 0:
            base_keys = set(probe.out[0].get("attrs", {}))
            for stale in sorted(base_keys - cache_keys):
                ops.append({"op": "rmxattr", "key": stale})
        if base_omap:
            ops.append({"op": "omap_clear"})
            if omap:
                keymap = {}
                for k, v in omap.items():
                    keymap[k] = len(blobs)
                    blobs.append(bytes(v))
                ops.append({"op": "omap_setkeys", "keys": keymap})
        reply = await self._pool_op(base.id, o.name, ops, blobs)
        if reply is None or reply.result < 0:
            return  # base degraded: stay dirty, retry next pass
        # clear the dirty marker ONLY if the object is unchanged —
        # compared by OI version, which ANY committed mutation (data,
        # xattr, omap) bumps; a concurrent write during the flush
        # re-dirtied it and must win
        async with osd.pg_lock(pg):
            try:
                if osd.store.getattrs(cid, o).get(OI_KEY) != oi_snapshot:
                    return
            except KeyError:
                return
            txn = Transaction().rmattr(cid, o, DIRTY_KEY)
            r = await osd._rep_commit_locked(
                pg, acting, txn, o.name, "modify",
                osd.store.stat(cid, o),
            )
        if r == 0:
            self.stats["flushes"] += 1

    async def _evict_object(self, pg, pool, acting, cid, o) -> None:
        osd = self.osd
        async with osd.pg_lock(pg):
            try:
                attrs = osd.store.getattrs(cid, o)
            except KeyError:
                return
            if DIRTY_KEY in attrs:
                return  # dirtied since ranking: flush first
            txn = Transaction().remove(cid, o)
            r = await osd._rep_commit_locked(
                pg, acting, txn, o.name, "delete", 0
            )
        if r == 0:
            self.stats["evictions"] += 1
