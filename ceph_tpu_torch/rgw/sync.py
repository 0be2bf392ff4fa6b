"""Multisite zone sync: one-way replication between RGW zones.

Re-expression of the reference's data/metadata sync
(reference:src/rgw/rgw_data_sync.cc RGWDataSyncCR full/incremental
phases, reference:src/rgw/rgw_sync.cc metadata sync): a ZoneSyncer
pulls the source zone's change log (RGWStore.datalog — the
rgw_datalog analog) and applies the changes to the destination zone,
copying user/bucket metadata verbatim (keys included, like the
reference's metadata sync — one logical account across zones).

Phases, exactly like the reference:

- FULL SYNC (first run, or when the peer lags past the trimmed log):
  snapshot the log cursor, copy every user, bucket, and object, then
  adopt the cursor — changes racing the copy replay incrementally.
- INCREMENTAL: apply log entries past the stored cursor, deduplicated
  to the newest op per (bucket, key).

The cursor persists in the DESTINATION zone's meta pool (``sync_state``
omap, keyed by source zone id), so a restarted syncer resumes.

Counterpart of ``ceph_tpu/rgw/sync.py``, whole: the same cursor, origin
keys and phases, so a sync state written by one package resumes in the
other.
"""

from __future__ import annotations

from .store import RGWError, RGWStore

SYNC_STATE_OBJ = "sync_state"
SYNC_ORIGIN_PREFIX = "sync_origin."  # + src zone id, in dst's meta pool
ENOENT = 2


class ZoneSyncer:
    """One-way src-zone -> dst-zone replicator (run both directions for
    active-active, like the reference's per-zone sync threads).

    ``delete_mode`` governs what full sync may delete at the destination
    (reference: full sync diffs per-bucket sync status rather than
    blind-deleting):

    - ``"tracked"`` (default, safe for active-active): only entries this
      syncer itself created — recorded in the destination's
      ``sync_origin.<zone>`` omap — are reconcile-deleted when absent at
      the source.  Destination-local writes that have not replicated
      back yet are never destroyed.
    - ``"mirror"``: the destination is a pure replica of the source;
      anything absent at the source is deleted.  Use only for one-way
      primary->replica topologies, NEVER with two syncers running in
      both directions.
    """

    def __init__(self, src: RGWStore, dst: RGWStore,
                 src_zone_id: str = "zone-src",
                 delete_mode: str = "tracked"):
        if delete_mode not in ("tracked", "mirror"):
            raise ValueError(f"unknown delete_mode {delete_mode!r}")
        self.src = src
        self.dst = dst
        self.src_zone_id = src_zone_id
        self.delete_mode = delete_mode

    # -- sync-origin tracking (what full sync may safely delete) -------------
    @property
    def _origin_obj(self) -> str:
        return SYNC_ORIGIN_PREFIX + self.src_zone_id

    @staticmethod
    def _okey(bucket: str, key: str) -> str:
        # disjoint "o"/"b" namespaces: a bucket literally named
        # "bucket" must not make object markers collide with bucket
        # markers
        return f"o\x00{bucket}\x00{key}"

    @staticmethod
    def _bkey(bucket: str) -> str:
        return f"b\x00{bucket}"

    async def _tracked(self) -> set:
        d = await self.dst._omap(self.dst.meta, self._origin_obj)
        return set(d)

    async def _track(self, *names: str) -> None:
        await self.dst.meta.omap_set(
            self._origin_obj, {n: b"1" for n in names}
        )

    async def _untrack(self, *names: str) -> None:
        from ..rados.client import RadosError

        try:
            await self.dst.meta.omap_rmkeys(self._origin_obj, list(names))
        except RadosError as e:
            # a never-written origin object is fine to "untrack";
            # anything else (OSD flap mid-rmkeys) must propagate — a
            # silently-kept stale entry later AUTHORIZES deleting a
            # destination-local write
            if e.code != -2:  # -ENOENT
                raise

    # -- cursor --------------------------------------------------------------
    async def _cursor(self) -> "str | None":
        state = await self.dst._omap(self.dst.meta, SYNC_STATE_OBJ)
        raw = state.get(self.src_zone_id)
        return raw.decode() if raw is not None else None

    async def _set_cursor(self, cursor: str) -> None:
        await self.dst.meta.omap_set(
            SYNC_STATE_OBJ, {self.src_zone_id: cursor.encode()}
        )

    # -- metadata sync (verbatim copy — one account across zones) ------------
    async def _sync_users(self) -> None:
        from .store import USERS_OBJ

        users = await self.src._omap(self.src.meta, USERS_OBJ)
        if users:
            await self.dst.meta.omap_set(USERS_OBJ, dict(users))

    async def _ensure_bucket(self, bucket: str) -> bool:
        try:
            info = await self.src.bucket_info(bucket)
        except RGWError:
            return False  # bucket deleted at source since the log entry
        try:
            await self.dst.bucket_info(bucket)
        except RGWError:
            await self._sync_users()
            await self.dst.create_bucket(bucket, info["owner"])
            await self._track(self._bkey(bucket))
        return True

    # -- object application --------------------------------------------------
    async def _apply(self, entry: dict) -> None:
        bucket, key, op = entry["bucket"], entry["key"], entry["op"]
        if op == "put":
            if not await self._ensure_bucket(bucket):
                return
            try:
                data, meta = await self.src.get_object(bucket, key)
            except RGWError as e:
                if -e.code == ENOENT:
                    return  # deleted again since: the del entry follows
                raise
            # track BEFORE the put: a crash between put and track would
            # leave a synced object invisible to tracked-mode reconcile
            # forever (stale data serving); a stale track entry for a
            # never-put key is at worst a no-op delete
            await self._track(self._okey(bucket, key))
            await self.dst.put_object(
                bucket, key, data,
                content_type=meta.get("content_type",
                                      "binary/octet-stream"),
                acl=meta.get("acl", "private"),
                meta=meta.get("meta"),
            )
        elif op == "del":
            try:
                await self.dst.delete_object(bucket, key)
            except RGWError as e:
                if -e.code != ENOENT:
                    raise
            await self._untrack(self._okey(bucket, key))

    # -- the sync pass -------------------------------------------------------
    async def sync(self) -> dict:
        """One pull+apply pass; returns {"phase", "applied"}."""
        log, trimmed = await self.src.datalog()
        keys = sorted(log)
        cursor = await self._cursor()
        if cursor is None or (trimmed and cursor < trimmed):
            # FULL: first contact, or we lag past the trimmed window
            applied = await self._full_sync()
            await self._set_cursor(keys[-1] if keys else "")
            return {"phase": "full", "applied": applied}
        pending = [k for k in keys if k > cursor]
        # newest op per (bucket, key) wins — earlier ones are superseded
        latest: dict[tuple[str, str], str] = {}
        for k in pending:
            e = log[k]
            latest[(e["bucket"], e["key"])] = k
        applied = 0
        for k in pending:
            e = log[k]
            if latest[(e["bucket"], e["key"])] != k:
                continue
            await self._apply(e)
            applied += 1
        if pending:
            await self._set_cursor(pending[-1])
        return {"phase": "incremental", "applied": applied}

    async def _full_sync(self) -> int:
        """Reconcile, not just copy: destination objects and buckets
        that no longer exist at the source are deleted (a
        trim-gap recovery that only copied left deleted-at-source data
        serving forever) — but ONLY entries this syncer is known to have
        created (the ``sync_origin`` set), unless ``delete_mode=
        "mirror"``.  Full sync fires on first contact (cursor None), so
        a blind delete would destroy destination-zone writes that have
        not replicated back yet in an active-active pair."""
        await self._sync_users()
        applied = 0
        may_delete = await self._tracked() if self.delete_mode == "tracked" \
            else None  # None = everything (mirror mode)
        src_buckets = await self.src.list_buckets()
        for bucket in src_buckets:
            if not await self._ensure_bucket(bucket):
                continue
            listing = await self.src.list_objects(bucket, max_keys=1000000)
            src_keys = {e["key"] for e in listing["contents"]}
            if src_keys:
                # track the whole bucket's keys BEFORE the puts (same
                # ordering rule as _apply: a crash mid-bucket must err
                # toward no-op deletes, not stale-serving objects)
                await self._track(
                    *(self._okey(bucket, k) for k in sorted(src_keys))
                )
            for e in listing["contents"]:
                try:
                    data, meta = await self.src.get_object(bucket, e["key"])
                except RGWError as err:
                    if -err.code == ENOENT:
                        # deleted at the source mid-pass: the key was
                        # pre-tracked but never put — untrack it, or the
                        # stale entry later authorizes deleting a
                        # destination-local write of the same name
                        await self._untrack(self._okey(bucket, e["key"]))
                        continue
                    raise
                await self.dst.put_object(
                    bucket, e["key"], data,
                    content_type=meta.get("content_type",
                                          "binary/octet-stream"),
                    acl=meta.get("acl", "private"),
                    meta=meta.get("meta"),
                )
                applied += 1
            dst_listing = await self.dst.list_objects(
                bucket, max_keys=1000000
            )
            for e in dst_listing["contents"]:
                if e["key"] in src_keys:
                    continue
                okey = self._okey(bucket, e["key"])
                if may_delete is not None and okey not in may_delete:
                    continue  # not ours: a destination-local write
                try:
                    await self.dst.delete_object(bucket, e["key"])
                    applied += 1
                except RGWError as err:
                    if -err.code != ENOENT:
                        raise
                await self._untrack(okey)
        for bucket in await self.dst.list_buckets():
            if bucket in src_buckets:
                continue
            if may_delete is not None and self._bkey(bucket) not in may_delete:
                continue  # bucket this syncer never created
            listing = await self.dst.list_objects(bucket, max_keys=1000000)
            removed_all = True
            for e in listing["contents"]:
                okey = self._okey(bucket, e["key"])
                if may_delete is not None and okey not in may_delete:
                    removed_all = False  # local write: keep the bucket
                    continue
                try:
                    await self.dst.delete_object(bucket, e["key"])
                except RGWError as err:
                    if -err.code != ENOENT:
                        raise
                await self._untrack(okey)
            if not removed_all:
                continue
            try:
                await self.dst.delete_bucket(bucket)
                applied += 1
            except RGWError as err:
                if -err.code != ENOENT:
                    raise
            await self._untrack(self._bkey(bucket))
        return applied
