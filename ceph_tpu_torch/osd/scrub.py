"""Scrub / deep-scrub + repair.

Re-expression of the reference's deep scrub for the mini-RADOS: the PG
primary reads every shard of every object at rest, verifies the stored
bytes against the per-stripe crc32c table (HashInfo analog) and the
shards' version agreement, and repairs what it finds — rebuilding EC
chunks from the surviving shards (one batched device decode) and
re-pushing authoritative replicas on replicated pools
(reference:src/osd/ECBackend.cc:2313 be_deep_scrub;
reference:src/osd/PrimaryLogPG.cc scrub repair flow).

Error classes (the reference's scrub-error taxonomy, narrowed):
- ``missing``: a shard/replica the acting set should hold is absent
- ``crc``: stored bytes do not match the shard's own crc table (bitrot)
- ``stale``: a shard holds an older version than its peers
- ``attr``: object-info / crc-table xattr unreadable or absent

Repair uses the same sub-write path as recovery (log entry omitted: a
repair restores committed state, it is not a new version).

Counterpart of ``ceph_tpu/osd/scrub.py``.  The repair's decode is one
``ec_util.decode`` an object, straight on the pool's codec: on the card
that launches ``gf_matmul`` (``bitmatrix_xor`` for a bit-matrix pool).
A data fault in that decode leaves the object unrepaired, as in the
reference; a device fault (``classify_engine_error``'s "fatal", the
dispatcher's split: a CUDA error, a kernel's build or launch failure, a
card that is not there) is not caught: it fails the PG's scrub, and the
``MOSDScrub`` is answered with the error.
"""

from __future__ import annotations

import asyncio
import json
import logging

import numpy as np

from ..models.matrix_codec import classify_engine_error
from ..store import CollectionId, ObjectId, Transaction
from . import ec_util
from .ec_util import StripeHashes
from .osdmap import CRUSH_ITEM_NONE, PGid, Pool, POOL_TYPE_ERASURE
from .pg_log import is_stash_name
from .recovery import OI_KEY
from .scheduler import QosDeferred

logger = logging.getLogger("ceph_tpu_torch.osd.scrub")

ENOENT = 2
EIO = 5



class ScrubManager:
    """On-demand (and optionally periodic) scrubbing of the PGs this OSD
    currently leads."""

    def __init__(self, osd, interval: float = 0.0):
        self.osd = osd
        self.interval = interval
        self._task: asyncio.Task | None = None
        # pg -> unrepaired count from its LATEST pass: the health check
        # needs the CURRENT inconsistency, not lifetime counters — the
        # cumulative errors counter re-counts the same bad shard every
        # pass, so errors-repaired would inflate forever
        self._unrepaired: dict[str, int] = {}

    # stats read through the perf counters so the manager and `perf dump`
    # can never disagree
    @property
    def scrubs_done(self) -> int:
        return self.osd.perf.get("scrub").get("scrubs")

    @property
    def errors_found(self) -> int:
        return self.osd.perf.get("scrub").get("errors")

    @property
    def errors_repaired(self) -> int:
        return self.osd.perf.get("scrub").get("repaired")

    def start(self) -> None:
        if self.interval > 0 and self._task is None:
            self._task = asyncio.ensure_future(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        try:
            while self.interval > 0:  # config set to 0 stops the loop
                await asyncio.sleep(self.interval)
                if self.osd.osdmap is not None and (
                    {"noscrub", "nodeep-scrub"}
                    & self.osd.osdmap.cluster_flags
                ):
                    # `ceph osd set noscrub` parks SCHEDULED scrubs
                    # (operator-initiated scrub_pool stays allowed);
                    # every scrub here is a deep scrub, so either flag
                    # parks the loop
                    continue
                try:
                    await self.scrub_all(
                        repair=self.osd.config.osd_scrub_auto_repair
                    )
                except asyncio.CancelledError:
                    raise
                # swallow-ok: logged; the next interval re-runs the pass
                except Exception:
                    logger.exception(
                        "%s: background scrub failed", self.osd.name
                    )
        # swallow-ok: daemon stop: the scrub loop ends
        except asyncio.CancelledError:
            pass
        finally:
            self._task = None  # allow a restart when re-enabled

    async def scrub_all(self, repair: bool = True) -> list[dict]:
        """Scrub every PG this OSD is primary for."""
        osd = self.osd
        reports = []
        if osd.osdmap is None:
            return reports
        led: set[str] = set()
        for pool in list(osd.osdmap.pools.values()):
            for pg in osd.osdmap.pgs_of_pool(pool.id):
                _up, _upp, acting, primary = osd.osdmap.pg_to_up_acting_osds(pg)
                if primary != osd.osd_id:
                    continue
                led.add(str(pg))
                # QoS grant per PG (scheduled scrubs only — operator
                # `ceph pg scrub` commands call scrub_pg directly and
                # jump the queue, like the reference's must_scrub): a
                # shed pass is simply picked up by the next interval
                try:
                    async with osd.scheduler.grant("scrub"):
                        reports.append(
                            await self.scrub_pg(pg, pool, acting, repair)
                        )
                # swallow-ok: QoS shed: the next interval re-scrubs this pg
                except QosDeferred:
                    continue
        # prune gauge state for PGs this OSD no longer leads (primary
        # moved, pool deleted): a stale entry would pin OSD_SCRUB_ERRORS
        # at HEALTH_ERR forever after the NEW primary repairs the pg
        stale = set(self._unrepaired) - led
        if stale:
            for k in stale:
                del self._unrepaired[k]
            self.osd.perf.get("scrub").set(
                "unrepaired", sum(self._unrepaired.values())
            )
        return reports

    async def scrub_pg(
        self, pg: PGid, pool: Pool, acting: list[int], repair: bool = True
    ) -> dict:
        """Deep-scrub one PG; returns the scrub report.

        The PG lock is taken per OBJECT, not across the whole scrub
        (the reference scrubs in chunks for the same reason: a PG-wide
        lock would stall every client write for the scrub's duration)."""
        osd = self.osd
        erasure = pool.type == POOL_TYPE_ERASURE
        if erasure:
            report = await self._scrub_ec(pg, pool, acting, repair)
        else:
            report = await self._scrub_replicated(pg, pool, acting, repair)
        pscrub = self.osd.perf.get("scrub")
        pscrub.inc("scrubs")
        pscrub.inc("errors", len(report["errors"]))
        pscrub.inc("repaired", report["repaired"])
        self._unrepaired[str(pg)] = (
            len(report["errors"]) - report["repaired"]
        )
        pscrub.set("unrepaired", sum(self._unrepaired.values()))
        report["clean"] = not report["errors"]
        if report["errors"]:
            # corruption is cluster-visible news (reference: scrub
            # errors go to clog and `ceph health`)
            self.osd.clog(
                "error",
                f"pg {pg} deep-scrub: {len(report['errors'])} errors, "
                f"{report['repaired']} repaired",
            )
        return report

    def _scrub_targets(
        self, scans: dict[int, tuple[dict, list]]
    ) -> list[str]:
        """Object names worth scrubbing: listed anywhere, EXCEPT objects
        whose authoritative (log-merged) state is a delete — scrubbing
        those would resurrect committed deletes from a stale rejoined
        member (recovery owns delete propagation)."""
        from .recovery import RecoveryManager

        auth = RecoveryManager._merge(scans)
        return sorted(
            n
            for n, state in auth.items()
            if state["op"] != "delete" and not is_stash_name(n)
        )

    # -- EC ------------------------------------------------------------------

    async def _scrub_ec(
        self, pg: PGid, pool: Pool, acting: list[int], repair: bool
    ) -> dict:
        osd = self.osd
        codec, sinfo = osd._pool_codec(pool)
        km = codec.get_chunk_count()
        k = codec.get_data_chunk_count()
        shards = {s: o for s, o in enumerate(acting[:km]) if o != CRUSH_ITEM_NONE}
        report = {"pg": str(pg), "objects": 0, "errors": [], "repaired": 0}

        scans = await osd.recovery._scan_shards(pg, shards, erasure=True)
        if scans is None:
            report["errors"].append({"oid": None, "kind": "scan_timeout"})
            return report

        for oid in self._scrub_targets(scans):
            # object-family exclusion (incl. in-flight extent writes):
            # excludes the EC client pipeline for exactly this object,
            # bounded write stall for the rest
            async with osd.ec_exclusive(pg, oid):
                await self._scrub_ec_object(
                    pg, codec, sinfo, k, shards, oid, repair, report
                )
        return report

    async def _scrub_ec_object(
        self, pg: PGid, codec, sinfo, k: int, shards: dict[int, int],
        oid: str, repair: bool, report: dict,
    ) -> None:
        osd = self.osd
        report["objects"] += 1
        data, attrs, errs = await osd._read_shards(
            pg, oid, dict(shards), want_data=True
        )
        if errs and all(e == -ENOENT for e in errs.values()) and len(
            errs
        ) == len(shards):
            report["objects"] -= 1
            return  # deleted under us: not an inconsistency

        # classify each shard
        newest = (0, 0)
        ois: dict[int, dict] = {}
        tables: dict[int, StripeHashes] = {}
        for s, a in attrs.items():
            raw = a.get(OI_KEY)
            if raw is not None:
                try:
                    ois[s] = json.loads(raw)
                    newest = max(newest, tuple(ois[s].get("version", [0, 0])))
                # swallow-ok: unreadable OI classifies the shard as attr-bad below
                except ValueError:
                    pass
            hraw = a.get(StripeHashes.XATTR_KEY)
            if hraw is not None:
                try:
                    tables[s] = StripeHashes.from_dict(json.loads(hraw))
                # swallow-ok: unreadable crc table classifies the shard as attr-bad below
                except Exception:
                    pass

        # expected shard length from the authoritative object size: a
        # truncated-at-chunk-boundary shard passes its own crcs, so the
        # length itself must be scrubbed too
        newest_size = max(
            (
                int(oi.get("size", 0))
                for oi in ois.values()
                if tuple(oi.get("version", [0, 0])) == newest
            ),
            default=0,
        )
        stripes = sinfo.logical_to_next_stripe_offset(newest_size) // (
            sinfo.stripe_width
        )
        expect_len = stripes * sinfo.chunk_size

        bad: dict[int, str] = {}
        good: dict[int, np.ndarray] = {}
        for s in shards:
            if s in errs:
                bad[s] = "missing" if errs[s] == -ENOENT else "io"
                continue
            if s not in ois or s not in tables:
                bad[s] = "attr"
                continue
            if tuple(ois[s].get("version", [0, 0])) < newest:
                bad[s] = "stale"
                continue
            buf = np.frombuffer(data.get(s, b""), dtype=np.uint8)
            if buf.size != expect_len:
                bad[s] = "size"
                continue
            if buf.size and not tables[s].verify(s, 0, buf):
                bad[s] = "crc"
                continue
            good[s] = buf

        for s, kind in sorted(bad.items()):
            report["errors"].append({"oid": oid, "shard": s, "kind": kind})
            logger.warning(
                "%s: scrub %s/%s shard %d: %s", osd.name, pg, oid, s, kind
            )
        if not bad or not repair:
            return
        if len(good) < k:
            logger.error(
                "%s: scrub cannot repair %s/%s: only %d/%d clean shards",
                osd.name, pg, oid, len(good), k,
            )
            return

        # rebuild the bad shards from the clean ones: one batched
        # device decode (the recovery reconstruct path, §3.3); the
        # device math is background EC traffic — pace it through the
        # QoS scheduler so a repair-heavy scrub yields the device to
        # queued client stripes
        await osd.scheduler.pace(
            "ec_background", cost=float(max(1, stripes))
        )
        try:
            rebuilt = ec_util.decode(sinfo, codec, good, want=sorted(bad))
        # swallow-ok: a data fault is logged; errors stay in the report,
        # next scrub retries.  A device fault fails the scrub instead.
        except Exception as e:
            if classify_engine_error(e) == "fatal":
                raise
            logger.exception(
                "%s: scrub decode failed for %s/%s", osd.name, pg, oid
            )
            return
        ref_s = next(iter(good))
        hinfo_b = json.dumps(tables[ref_s].to_dict()).encode()
        oi_b = json.dumps(ois[ref_s]).encode()
        for s in sorted(bad):
            cid = CollectionId(f"{pg}s{s}")
            soid = ObjectId(oid, s)
            txn = (
                Transaction()
                .create_collection(cid)
                .remove(cid, soid)
                .write(cid, soid, 0, rebuilt[s].tobytes())
                .setattr(cid, soid, StripeHashes.XATTR_KEY, hinfo_b)
                .setattr(cid, soid, OI_KEY, oi_b)
            )
            if await osd.recovery._push_txn(pg, s, shards[s], txn, None):
                report["repaired"] += 1
                logger.info(
                    "%s: scrub repaired %s/%s shard %d (%s)",
                    osd.name, pg, oid, s, bad[s],
                )

    # -- replicated ----------------------------------------------------------

    async def _scrub_replicated(
        self, pg: PGid, pool: Pool, acting: list[int], repair: bool
    ) -> dict:
        osd = self.osd
        members = {o: o for o in acting if o != CRUSH_ITEM_NONE}
        report = {"pg": str(pg), "objects": 0, "errors": [], "repaired": 0}

        scans = await osd.recovery._scan_shards(pg, members, erasure=False)
        if scans is None:
            report["errors"].append({"oid": None, "kind": "scan_timeout"})
            return report

        for oid in self._scrub_targets(scans):
            async with osd.pg_lock(pg):  # per-object: bounded write stall
                await self._scrub_rep_object(
                    pg, members, oid, repair, report
                )
        return report

    async def _scrub_rep_object(
        self, pg: PGid, members: dict[int, int], oid: str,
        repair: bool, report: dict,
    ) -> None:
        osd = self.osd
        report["objects"] += 1
        data, attrs, errs = await osd._read_shards(
            pg, oid, dict(members), want_data=True, store_shard=-1
        )
        if errs and all(e == -ENOENT for e in errs.values()) and len(
            errs
        ) == len(members):
            report["objects"] -= 1
            return

        digests = {m: ec_util.native.crc32c(
            ec_util.CRC_SEED, np.frombuffer(d, dtype=np.uint8)
        ) for m, d in data.items()}
        vers = {}
        for m, a in attrs.items():
            raw = a.get(OI_KEY)
            if raw:
                try:
                    vers[m] = tuple(json.loads(raw).get("version", [0, 0]))
                # swallow-ok: unreadable OI reads as version (0,0): shard classifies stale
                except ValueError:
                    vers[m] = (0, 0)
            else:
                vers[m] = (0, 0)
        newest = max(vers.values(), default=(0, 0))

        # authoritative digest = STRICT majority among newest-version
        # holders (the reference's be_compare_scrubmaps). Without a
        # majority there is no authoritative copy: report the PG
        # inconsistent rather than guess — auto-"repairing" from an
        # arbitrary replica could overwrite the only good copy.
        candidates = [
            m for m in digests if vers.get(m) == newest and m not in errs
        ]
        if not candidates:
            for m in members:
                report["errors"].append(
                    {"oid": oid, "shard": m, "kind": "missing"}
                )
            return
        counts: dict[int, int] = {}
        for m in candidates:
            counts[digests[m]] = counts.get(digests[m], 0) + 1
        best = max(counts.values())
        winners = [d for d, c in counts.items() if c == best]
        if len(winners) > 1:
            report["errors"].append(
                {"oid": oid, "shard": None, "kind": "inconsistent"}
            )
            logger.error(
                "%s: scrub %s/%s: digest tie %s — no authoritative copy, "
                "NOT auto-repairing", osd.name, pg, oid, sorted(counts),
            )
            return
        auth_digest = winners[0]
        auth_member = next(m for m in candidates if digests[m] == auth_digest)

        bad: dict[int, str] = {}
        for m in members:
            if m in errs:
                bad[m] = "missing" if errs[m] == -ENOENT else "io"
            elif vers.get(m, (0, 0)) < newest:
                bad[m] = "stale"
            elif digests.get(m) != auth_digest:
                bad[m] = "crc"
        for m, kind in sorted(bad.items()):
            report["errors"].append({"oid": oid, "shard": m, "kind": kind})
            logger.warning(
                "%s: scrub %s/%s replica osd.%d: %s",
                osd.name, pg, oid, m, kind,
            )
        if not bad or not repair:
            return

        auth_data = bytes(data[auth_member])
        auth_attrs = {
            ak: av.encode("latin-1")
            for ak, av in attrs[auth_member].items()
        }
        for m in sorted(bad):
            if await osd.recovery.push_replica_object(
                pg, m, oid, auth_data, auth_attrs, None
            ):
                report["repaired"] += 1
                logger.info(
                    "%s: scrub repaired %s/%s on osd.%d (%s)",
                    osd.name, pg, oid, m, bad[m],
                )
