"""The RGW object-store engine (reference:src/rgw/rgw_rados.cc — user,
bucket, object and multipart operations over rados; bucket index
reference:src/cls/rgw/).

Counterpart of ``ceph_tpu/rgw/store.py``, whole: the same pools, errors,
index keys and JSON entries, so a store written through one package reads
back through the other.  Object data goes to the data pool through the
striper; on an erasure-coded data pool the OSDs encode and rebuild it
(on the card, for OSDs that run there).  The gateway itself runs no
kernel."""

from __future__ import annotations

import hashlib
import json
import secrets
import time

from ..cls.rgw_index import CANNED_ACLS, META_NS
from ..rados.client import ENOENT, IoCtx, RadosClient, RadosError
from ..rados.striper import StripedObject

META_POOL = ".rgw.meta"
DATA_POOL = ".rgw.buckets"
INDEX_POOL = ".rgw.buckets.index"  # omap lives here; data pool may be EC
USERS_OBJ = "users"
BUCKETS_OBJ = "buckets"

EEXIST = 17
EINVAL = 22
EACCES = 13
ENOTEMPTY = 39


class RGWError(RadosError):
    pass


def _check_acl(acl: str) -> None:
    if acl not in CANNED_ACLS:
        raise RGWError(-EINVAL, f"unsupported canned acl {acl!r}")


def _now() -> float:
    return time.time()


DATALOG_OBJ = "zone_datalog"  # per-zone change log (rgw_data_sync feed)
DATALOG_MAX = 10000  # entries kept; laggards past this full-resync
DATALOG_TRIM = 1000
DATALOG_TRIMMED_KEY = "~trimmed_to"  # sorts after time_ns keys


class RGWStore:
    """One gateway's view of the cluster (RGWRados analog)."""

    def __init__(self, client: RadosClient, zone: str = ""):
        # ``zone`` suffixes the pool names so multiple zones can share
        # one cluster (the reference's zone-qualified pool placement,
        # reference:src/rgw/rgw_zone.cc)
        suffix = f".{zone}" if zone else ""
        self.client = client
        self.zone = zone
        self.meta = client.io_ctx(META_POOL + suffix)
        self.index = client.io_ctx(INDEX_POOL + suffix)
        self.data = client.io_ctx(DATA_POOL + suffix)
        self._log_seq = 0
        self._log_count: int | None = None  # lazy; avoids per-op scans

    # -- zone change log (reference:src/rgw/rgw_datalog.cc — every index
    # mutation is recorded so a peer zone's sync agent can replay it;
    # bounded: peers further behind than DATALOG_MAX detect the gap and
    # full-resync, the reference's full-sync fallback) -----------------------
    async def _log_change(self, op: str, bucket: str, key: str) -> None:
        self._log_seq += 1
        lk = f"{time.time_ns():020d}{self._log_seq % 1000000:06d}"
        await self.meta.omap_set(DATALOG_OBJ, {
            lk: json.dumps(
                {"op": op, "bucket": bucket, "key": key, "t": _now()}
            ).encode()
        })
        if self._log_count is None:
            raw = await self._omap(self.meta, DATALOG_OBJ)
            self._log_count = sum(
                1 for k in raw if k != DATALOG_TRIMMED_KEY
            )
        else:
            self._log_count += 1
        # the approximate counter keeps the write path free of full-log
        # scans; the real fetch happens only when a trim is
        # actually due
        if self._log_count > DATALOG_MAX and (
            self._log_seq % DATALOG_TRIM == 0
        ):
            raw = await self._omap(self.meta, DATALOG_OBJ)
            entries = sorted(k for k in raw if k != DATALOG_TRIMMED_KEY)
            if len(entries) > DATALOG_MAX:
                drop = entries[: len(entries) - DATALOG_MAX]
                # the durable trim watermark lets a peer tell "behind
                # the trimmed window" (full resync) from "caught up on
                # an empty log" (incremental from here)
                await self.meta.omap_set(
                    DATALOG_OBJ, {DATALOG_TRIMMED_KEY: drop[-1].encode()}
                )
                await self.meta.omap_rmkeys(DATALOG_OBJ, drop)
            self._log_count = min(len(entries), DATALOG_MAX)

    async def datalog(self) -> "tuple[dict[str, dict], str]":
        """(entries, trimmed_to watermark)."""
        raw = await self._omap(self.meta, DATALOG_OBJ)
        trimmed = raw.pop(DATALOG_TRIMMED_KEY, b"").decode()
        return {k: json.loads(v) for k, v in raw.items()}, trimmed

    @classmethod
    async def create(
        cls, client: RadosClient,
        data_pool_type: str = "replicated",
        data_profile: str | None = None,
        zone: str = "",
    ) -> "RGWStore":
        """Bootstrap: ensure the gateway pools exist
        (reference:rgw_rados.cc open_root_pool-style lazy creation).
        ``data_pool_type="erasure"`` puts object DATA on an EC pool —
        the omap-bearing index/meta pools stay replicated, the
        reference's .rgw.buckets.index split."""
        suffix = f".{zone}" if zone else ""
        for pool in (META_POOL + suffix, INDEX_POOL + suffix):
            await client.create_pool(pool, "replicated")
        kw = {}
        if data_pool_type == "erasure" and data_profile:
            kw["erasure_code_profile"] = data_profile
        await client.create_pool(DATA_POOL + suffix, data_pool_type, **kw)
        return cls(client, zone=zone)

    # -- users (reference:src/rgw/rgw_user.cc) -------------------------------
    async def create_user(
        self, uid: str, display_name: str = ""
    ) -> dict:
        users = await self._omap(self.meta, USERS_OBJ)
        if uid in users:
            raise RGWError(-EEXIST, f"user {uid!r} exists")
        rec = {
            "uid": uid,
            "display_name": display_name or uid,
            "access_key": secrets.token_hex(10),
            "secret_key": secrets.token_hex(20),
            "created": _now(),
        }
        await self.meta.omap_set(
            USERS_OBJ, {uid: json.dumps(rec).encode()}
        )
        return rec

    async def get_user(self, uid: str) -> dict:
        users = await self._omap(self.meta, USERS_OBJ)
        raw = users.get(uid)
        if raw is None:
            raise RGWError(-ENOENT, f"no user {uid!r}")
        return json.loads(raw)

    async def list_users(self) -> list[str]:
        return sorted(await self._omap(self.meta, USERS_OBJ))

    async def user_by_access_key(self, access_key: str) -> dict | None:
        for raw in (await self._omap(self.meta, USERS_OBJ)).values():
            rec = json.loads(raw)
            if rec["access_key"] == access_key:
                return rec
        return None

    async def remove_user(self, uid: str) -> None:
        await self.get_user(uid)
        for b in await self.list_buckets(uid):
            raise RGWError(-ENOTEMPTY, f"user {uid!r} owns bucket {b!r}")
        await self.meta.omap_rmkeys(USERS_OBJ, [uid])

    # -- buckets (reference:src/rgw/rgw_bucket.cc) ---------------------------
    def _index_obj(self, bucket: str) -> str:
        return f".index.{bucket}"

    # -- in-OSD index ops (reference:src/cls/rgw — the bucket index is
    # mutated by class methods so the stats header stays atomic with the
    # entries; cls/rgw_index.py) -------------------------------------------
    async def _index_put(
        self, bucket: str, key: str, entry: dict,
        quota: dict | None = None,
    ) -> None:
        inp: dict = {"key": key, "entry": entry}
        if quota and (quota.get("max_objects") or quota.get("max_bytes")):
            inp["quota"] = quota
        try:
            await self.index.exec(
                self._index_obj(bucket), "rgw", "put", inp
            )
        except RadosError as e:
            if e.code == -122:  # EDQUOT from the atomic quota check
                raise RGWError(
                    -122, f"bucket {bucket!r} quota exceeded"
                ) from None
            raise

    async def _index_rm(self, bucket: str, key: str) -> None:
        try:
            await self.index.exec(
                self._index_obj(bucket), "rgw", "rm", {"key": key}
            )
        except RadosError as e:
            if e.code != -ENOENT:
                raise

    async def _quota_preflight(
        self, bucket: str, quota: dict, *,
        delta_entries: int, delta_bytes: int,
    ) -> None:
        try:
            await self.index.exec(
                self._index_obj(bucket), "rgw", "quota_check",
                {"quota": quota, "delta_entries": delta_entries,
                 "delta_bytes": delta_bytes},
            )
        except RadosError as e:
            if e.code == -122:
                raise RGWError(
                    -122, f"bucket {bucket!r} quota exceeded"
                ) from None
            if e.code != -ENOENT:  # fresh bucket: empty index object
                raise

    async def set_bucket_quota(
        self, bucket: str, max_objects: int = 0, max_bytes: int = 0
    ) -> None:
        """radosgw-admin quota set --bucket analog; 0 clears.  The
        update is an in-OSD class op, atomic under the PG lock."""
        try:
            await self.meta.exec(
                BUCKETS_OBJ, "rgw", "bucket_set_quota",
                {"bucket": bucket, "max_objects": int(max_objects),
                 "max_bytes": int(max_bytes)},
            )
        except RadosError as e:
            if e.code == -ENOENT:
                raise RGWError(-ENOENT, f"no bucket {bucket!r}") from None
            raise

    async def _index_stats(self, bucket: str) -> dict:
        try:
            return await self.index.exec(
                self._index_obj(bucket), "rgw", "stats", {}
            )
        except RadosError as e:
            if e.code != -ENOENT:
                raise
            return {"header": {"entries": 0, "bytes": 0}, "meta_entries": 0}

    async def _index_pages(
        self, bucket: str, prefix: str = "", marker: str = "",
        page_size: int = 1000,
    ):
        """Yield {key: entry} pages from the in-OSD paged listing."""
        obj = self._index_obj(bucket)
        while True:
            try:
                page = await self.index.exec(
                    obj, "rgw", "list",
                    {"prefix": prefix, "marker": marker,
                     "max_entries": page_size},
                )
            except RadosError as e:
                if e.code == -ENOENT:
                    return
                raise
            if page["entries"]:
                yield page["entries"]
            if not page["truncated"]:
                return
            marker = page["next_marker"]

    async def create_bucket(
        self, bucket: str, owner: str, acl: str = "private"
    ) -> None:
        if not bucket or "/" in bucket:
            raise RGWError(-EINVAL, f"bad bucket name {bucket!r}")
        _check_acl(acl)
        await self.get_user(owner)
        buckets = await self._omap(self.meta, BUCKETS_OBJ)
        if bucket in buckets:
            rec = json.loads(buckets[bucket])
            if rec["owner"] != owner:
                raise RGWError(-EEXIST, f"bucket {bucket!r} taken")
            return  # idempotent re-create by the owner, like S3
        await self.meta.omap_set(BUCKETS_OBJ, {
            bucket: json.dumps(
                {"owner": owner, "created": _now(), "acl": acl}
            ).encode()
        })
        await self.index.exec(self._index_obj(bucket), "rgw", "init", {})

    async def set_bucket_acl(self, bucket: str, acl: str) -> None:
        """Canned-ACL subset of the reference's RGWAccessControlPolicy
        (reference:src/rgw/rgw_acl.cc): private | public-read.  The
        update is an in-OSD class op, atomic under the PG lock."""
        _check_acl(acl)
        try:
            await self.meta.exec(
                BUCKETS_OBJ, "rgw", "bucket_set_acl",
                {"bucket": bucket, "acl": acl},
            )
        except RadosError as e:
            if e.code == -ENOENT:
                raise RGWError(-ENOENT, f"no bucket {bucket!r}") from None
            raise

    async def set_object_acl(self, bucket: str, key: str, acl: str) -> None:
        _check_acl(acl)
        try:
            await self.index.exec(
                self._index_obj(bucket), "rgw", "set_acl",
                {"key": key, "acl": acl},
            )
        except RadosError as e:
            if e.code == -ENOENT:
                raise RGWError(-ENOENT, f"no object {bucket}/{key}") \
                    from None
            raise

    async def bucket_info(self, bucket: str) -> dict:
        buckets = await self._omap(self.meta, BUCKETS_OBJ)
        raw = buckets.get(bucket)
        if raw is None:
            raise RGWError(-ENOENT, f"no bucket {bucket!r}")
        return json.loads(raw)

    async def list_buckets(self, owner: str | None = None) -> list[str]:
        out = []
        for name, raw in (await self._omap(self.meta, BUCKETS_OBJ)).items():
            if owner is None or json.loads(raw)["owner"] == owner:
                out.append(name)
        return sorted(out)

    async def delete_bucket(self, bucket: str) -> None:
        await self.bucket_info(bucket)
        st = await self._index_stats(bucket)
        # in-progress multipart uploads (namespace entries) block the
        # delete too, like S3
        if st["header"]["entries"] or st.get("meta_entries"):
            raise RGWError(-ENOTEMPTY, f"bucket {bucket!r} not empty")
        try:
            await self.index.remove(self._index_obj(bucket))
        except RadosError as e:
            if e.code != -ENOENT:
                raise
        await self.meta.omap_rmkeys(BUCKETS_OBJ, [bucket])

    # -- objects (reference:src/rgw/rgw_op.cc put/get/delete/list) -----------
    def _data_obj(self, bucket: str, key: str) -> StripedObject:
        return StripedObject(self.data, f"{bucket}/{key}")

    async def put_object(
        self, bucket: str, key: str, data: bytes,
        content_type: str = "binary/octet-stream",
        acl: str = "private",
        meta: dict | None = None,
    ) -> dict:
        info = await self.bucket_info(bucket)
        if not key:
            raise RGWError(-EINVAL, "empty object key")
        _check_acl(acl)
        sobj = self._data_obj(bucket, key)
        old = await self._index_entry(bucket, key)
        quota = info.get("quota")
        if quota and (quota.get("max_objects") or quota.get("max_bytes")):
            # pre-flight BEFORE any data mutation: an overwrite must
            # never destroy the old bytes only to be refused.  The
            # atomic in-put check backstops creates (safe cleanup);
            # overwrite races past the cap are bounded by one object,
            # like the reference's (far looser, async) quota accounting
            await self._quota_preflight(
                bucket, quota,
                delta_entries=0 if old is not None else 1,
                delta_bytes=len(data) - (old or {}).get("size", 0),
            )
        if old is not None:
            await sobj.remove()  # overwrite drops the old extents
        await sobj.write(data, 0)
        entry = {
            "size": len(data),
            "etag": hashlib.md5(data).hexdigest(),
            "mtime": _now(),
            "content_type": content_type,
            "acl": acl,
        }
        if meta:
            # user metadata (x-amz-meta-*, reference:rgw_op.cc
            # rgw_get_request_metadata -> RGW_ATTR_META_PREFIX attrs)
            entry["meta"] = {str(k): str(v) for k, v in meta.items()}
        try:
            await self._index_put(
                bucket, key, entry,
                quota=quota if old is None else None,
            )
        except RGWError as e:
            if e.code == -122 and old is None:
                await sobj.remove()  # lost the create race: no orphan
            raise
        await self._log_change("put", bucket, key)
        return entry

    async def get_object(self, bucket: str, key: str) -> tuple[bytes, dict]:
        entry = await self.head_object(bucket, key)
        data = await self._data_obj(bucket, key).read(0, entry["size"])
        return data, entry

    async def get_object_range(
        self, bucket: str, key: str, off: int, length: int,
        entry: dict | None = None,
    ) -> tuple[bytes, dict]:
        """Ranged read straight from the striper — only the covered
        stripes travel (reference:rgw_op.cc RGWGetObj range support).
        Callers that already hold the index ``entry`` pass it to avoid
        a second omap lookup (and a TOCTOU against an overwrite)."""
        if entry is None:
            entry = await self.head_object(bucket, key)
        size = entry["size"]
        if off < 0 or off >= size or length <= 0:
            raise RGWError(-EINVAL, "range out of bounds")
        length = min(length, size - off)
        data = await self._data_obj(bucket, key).read(off, length)
        return data, entry

    async def head_object(self, bucket: str, key: str) -> dict:
        entry = await self._index_entry(bucket, key)
        if entry is None:
            raise RGWError(-ENOENT, f"no object {bucket}/{key}")
        return entry

    async def delete_object(self, bucket: str, key: str) -> None:
        entry = await self._index_entry(bucket, key)
        if entry is None:
            raise RGWError(-ENOENT, f"no object {bucket}/{key}")
        await self._data_obj(bucket, key).remove()
        await self._index_rm(bucket, key)
        await self._log_change("del", bucket, key)

    async def copy_object(
        self, src_bucket: str, src_key: str, dst_bucket: str, dst_key: str,
        meta: dict | None = None,
    ) -> dict:
        """S3 copy; user metadata follows the COPY directive by default
        (source meta carried), or is REPLACED when ``meta`` is given."""
        data, entry = await self.get_object(src_bucket, src_key)
        return await self.put_object(
            dst_bucket, dst_key, data,
            content_type=entry.get("content_type", "binary/octet-stream"),
            meta=meta if meta is not None else entry.get("meta"),
        )

    async def list_objects(
        self, bucket: str, prefix: str = "", marker: str = "",
        max_keys: int = 1000, delimiter: str = "",
    ) -> dict:
        """The S3 ListObjects contract: sorted keys after ``marker``
        under ``prefix``, collapsed into common prefixes at
        ``delimiter`` (reference:rgw_op.cc RGWListBucket)."""
        await self.bucket_info(bucket)
        contents: list[dict] = []
        common: list[str] = []
        truncated = False
        last_item = ""  # key OR common prefix — next_marker must be the
        # last item RETURNED, else delimiter pages repeat/loop (S3 rule)
        # pages come from the in-OSD class already sorted, post-marker
        # and prefix-filtered (reference cls_rgw bucket_list).  Without
        # a delimiter each index entry yields at most one result, so
        # cap the page at the caller's budget (+1 for the truncated
        # probe) like the reference's bucket_list num_entries; with a
        # delimiter a whole page can roll up into one common prefix, so
        # keep full pages
        page_size = 1000 if delimiter else max(1, min(1000, max_keys + 1))
        async for page in self._index_pages(bucket, prefix, marker,
                                            page_size):
            for k in sorted(page):
                if (delimiter and marker.endswith(delimiter)
                        and k.startswith(marker)):
                    # the marker was a common prefix: its whole
                    # rolled-up group was already returned last page
                    continue
                if delimiter:
                    rest = k[len(prefix):]
                    cut = rest.find(delimiter)
                    if cut >= 0:
                        cp = prefix + rest[: cut + len(delimiter)]
                        if not common or common[-1] != cp:
                            if len(contents) + len(common) >= max_keys:
                                truncated = True
                                break
                            common.append(cp)
                            last_item = cp
                        continue
                if len(contents) + len(common) >= max_keys:
                    truncated = True
                    break
                # PROJECTED entry, the S3 ListObjects shape: raw index
                # records carry x-amz-meta-* user metadata and per-object
                # ACLs, which must not leak to every principal allowed to
                # list (real S3 exposes only
                # key/size/etag/mtime)
                e = page[k]
                contents.append({
                    "key": k,
                    "size": e.get("size", 0),
                    "etag": e.get("etag", ""),
                    "mtime": e.get("mtime", 0),
                })
                last_item = k
            if truncated:
                break
        return {
            "contents": contents,
            "common_prefixes": common,
            "truncated": truncated,
            "next_marker": last_item if truncated else "",
        }

    # -- multipart (reference:src/rgw/rgw_multi.cc) --------------------------
    def _part_name(self, bucket: str, key: str, upload: str, n: int) -> str:
        return f"{bucket}/{key}.{upload}.{n:05d}"

    def _upload_key(self, key: str, upload: str) -> str:
        # META_NS-tagged: object entries all live under the index
        # class's OBJ_NS tag, so no S3-legal key — '.upload.…' included
        # — can collide with multipart bookkeeping
        return f"{META_NS}upload.{key}.{upload}"

    def _part_key(self, key: str, upload: str, n: int) -> str:
        return f"{META_NS}upload.{key}.{upload}.part.{n:05d}"

    def _upload_pending_key(self, key: str, upload: str) -> str:
        # pending-bytes counter for the per-part quota gate; 'pend'
        # sorts outside the '.part.' prefix scan
        return f"{META_NS}upload.{key}.{upload}.pend"

    async def _bucket_rec(self, bucket: str) -> dict:
        """O(1) keyed read of one bucket record (bucket_info copies the
        whole BUCKETS_OBJ omap — fine for admin ops, not per-part)."""
        got = await self.meta.omap_get_keys(BUCKETS_OBJ, [bucket])
        if bucket not in got:
            raise RGWError(-ENOENT, f"no bucket {bucket!r}")
        return json.loads(got[bucket])

    async def init_multipart(
        self, bucket: str, key: str, acl: str = "private",
        meta: dict | None = None,
    ) -> str:
        await self.bucket_info(bucket)
        _check_acl(acl)
        upload = secrets.token_hex(8)
        rec = {"key": key, "started": _now(), "acl": acl}
        if meta:
            # metadata supplied at CreateMultipartUpload rides the
            # upload record into the completed entry, like real S3
            rec["meta"] = {str(k): str(v) for k, v in meta.items()}
        await self.index.omap_set(
            self._index_obj(bucket),
            {self._upload_key(key, upload): json.dumps(rec).encode()},
        )
        return upload

    async def upload_part(
        self, bucket: str, key: str, upload: str, part_num: int, data: bytes
    ) -> dict:
        """Each part is its OWN index key — concurrent part uploads
        (standard S3 client behavior) must not lose each other in a
        read-modify-write of shared metadata."""
        await self._upload_meta(bucket, key, upload)
        quota = (await self._bucket_rec(bucket)).get("quota") or {}
        pkey = self._part_key(key, upload, part_num)
        old_part = 0
        if quota.get("max_bytes"):
            # a byte-capped bucket must not accumulate unbounded PART
            # data (not only a cap evaluated at complete).
            # O(1) per part: the upload's PENDING total rides an
            # atomic counter key (numops on the index object), a
            # re-uploaded part's old size and the destination object
            # being replaced are credited, and the LIVE quota is read
            # (a snapshot would wrongly reject parts after the admin
            # raised the cap).  Concurrent uploads to
            # different keys still multiply the bound, like the
            # reference's approximate quota accounting; complete's
            # atomic gate is authoritative for the final object
            got = await self.index.omap_get_keys(
                self._index_obj(bucket),
                [pkey, self._upload_pending_key(key, upload)],
            )
            old_part = (json.loads(got[pkey])["size"]
                        if pkey in got else 0)
            pending = int(
                got.get(self._upload_pending_key(key, upload), b"0")
            )
            old_entry = await self._index_entry(bucket, key)
            await self._quota_preflight(
                bucket, quota, delta_entries=0,
                delta_bytes=pending + len(data) - old_part
                - (old_entry or {}).get("size", 0),
            )
        sobj = StripedObject(
            self.data, self._part_name(bucket, key, upload, part_num)
        )
        await sobj.write(data, 0)
        etag = hashlib.md5(data).hexdigest()
        await self.index.omap_set(
            self._index_obj(bucket),
            {pkey: json.dumps(
                {"size": len(data), "etag": etag}
            ).encode()},
        )
        if quota.get("max_bytes") and len(data) != old_part:
            # atomic under the PG lock: concurrent parts of the same
            # upload cannot lose each other's accounting
            await self.index.exec(
                self._index_obj(bucket), "numops", "add",
                {"key": self._upload_pending_key(key, upload),
                 "value": len(data) - old_part},
            )
        return {"etag": etag}

    async def _upload_parts(
        self, bucket: str, key: str, upload: str
    ) -> dict[int, dict]:
        """Ranged read over this upload's part prefix — O(parts), not a
        full index copy."""
        obj = self._index_obj(bucket)
        prefix = f"{self._upload_key(key, upload)}.part."
        parts: dict[int, dict] = {}
        after = ""
        while True:
            try:
                page, truncated = await self.index.omap_get_range(
                    obj, start_after=after, prefix=prefix,
                    max_entries=1000,
                )
            except RadosError as e:
                if e.code == -ENOENT:
                    return parts
                raise
            for k, v in page.items():
                suffix = k[len(prefix):]
                if not suffix.isdigit():
                    # another upload's meta key for an S3-legal object
                    # key like 'a.<U>.part.00001' sorts inside this
                    # prefix range — skip it
                    continue
                parts[int(suffix)] = json.loads(v)
            if not truncated or not page:
                return parts
            after = max(page)

    async def complete_multipart(
        self, bucket: str, key: str, upload: str
    ) -> dict:
        """Assemble parts in part-number order into the final object
        (reference completes by linking manifests; a copy-through is the
        same contract at this scale)."""
        meta = await self._upload_meta(bucket, key, upload)
        parts = await self._upload_parts(bucket, key, upload)
        if not parts:
            raise RGWError(-EINVAL, "no parts uploaded")
        info = await self.bucket_info(bucket)
        quota = info.get("quota")
        old = await self._index_entry(bucket, key)
        if quota and (quota.get("max_objects") or quota.get("max_bytes")):
            # before assembling over the destination object
            await self._quota_preflight(
                bucket, quota,
                delta_entries=0 if old is not None else 1,
                delta_bytes=sum(p["size"] for p in parts.values())
                - (old or {}).get("size", 0),
            )
        # data assembles BEFORE the index entry publishes, and part
        # objects are removed only after the index accepts — an EDQUOT
        # lost-race on the create path removes the freshly built final
        # and leaves every part intact for a retry (another ordering
        # would destroy the upload on that race, and a publish-first
        # ordering would break concurrent readers).
        # OVERWRITE CAVEAT: when a previous object exists
        # its striped data is removed and rewritten in place (the data
        # object name is derived from the key, so there is no temp-name
        # + swap-at-publish path without a manifest indirection) — a
        # concurrent GET holding the OLD index entry can read torn or
        # partially-assembled bytes during assembly.  The window is
        # bounded by the assembly itself and matches put_object's
        # overwrite semantics; the index entry is only published once
        # the new data is fully in place.
        total = sum(parts[n]["size"] for n in parts)
        md5s = hashlib.md5()
        for n in sorted(parts):
            md5s.update(bytes.fromhex(parts[n]["etag"]))
        etag = f"{md5s.hexdigest()}-{len(parts)}"
        entry = {
            "size": total, "etag": etag, "mtime": _now(),
            "content_type": "binary/octet-stream",
            # the acl requested at initiate-time (so multipart objects
            # can be created public-read)
            "acl": meta.get("acl", "private"),
        }
        if meta.get("meta"):
            entry["meta"] = meta["meta"]
        final = self._data_obj(bucket, key)
        if old is not None:
            await final.remove()
        off = 0
        for n in sorted(parts):
            part = StripedObject(
                self.data, self._part_name(bucket, key, upload, n)
            )
            data = await part.read()
            await final.write(data, off)
            off += len(data)
        try:
            await self._index_put(
                bucket, key, entry, quota=quota if old is None else None
            )
        except RGWError as e:
            if e.code == -122 and old is None:
                await final.remove()  # parts survive for the retry
            raise
        for n in sorted(parts):
            await StripedObject(
                self.data, self._part_name(bucket, key, upload, n)
            ).remove()
        await self.index.omap_rmkeys(
            self._index_obj(bucket),
            [self._upload_key(key, upload),
             self._upload_pending_key(key, upload)]
            + [self._part_key(key, upload, n) for n in parts],
        )
        await self._log_change("put", bucket, key)
        return entry

    async def abort_multipart(
        self, bucket: str, key: str, upload: str
    ) -> None:
        await self._upload_meta(bucket, key, upload)
        parts = await self._upload_parts(bucket, key, upload)
        for n in parts:
            await StripedObject(
                self.data, self._part_name(bucket, key, upload, n)
            ).remove()
        await self.index.omap_rmkeys(
            self._index_obj(bucket),
            [self._upload_key(key, upload),
             self._upload_pending_key(key, upload)]
            + [self._part_key(key, upload, n) for n in parts],
        )

    # -- stats ----------------------------------------------------------------
    async def bucket_stats(self, bucket: str) -> dict:
        """Served from the index header the class maintains atomically
        with every entry mutation — no listing required
        (reference:cls_rgw bucket stats via the omap header)."""
        info = await self.bucket_info(bucket)
        hdr = (await self._index_stats(bucket))["header"]
        return {
            "bucket": bucket,
            "owner": info["owner"],
            "num_objects": hdr["entries"],
            "size_bytes": hdr["bytes"],
        }

    async def check_index(self, bucket: str, fix: bool = False) -> dict:
        """bucket_check_index / bucket_rebuild_index analog
        (reference:src/cls/rgw cls_rgw_bucket_check_index)."""
        await self.bucket_info(bucket)
        method = "rebuild" if fix else "check"
        out = await self.index.exec(
            self._index_obj(bucket), "rgw", method, {}
        )
        if fix:
            return {"header": out["header"], "fixed": True}
        return out

    # -- internals ------------------------------------------------------------
    async def _omap(self, io: IoCtx, obj: str) -> dict[str, bytes]:
        try:
            return await io.omap_get(obj)
        except RadosError as e:
            if e.code == -ENOENT:
                return {}
            raise

    async def _index_entry(self, bucket: str, key: str) -> dict | None:
        try:
            out = await self.index.exec(
                self._index_obj(bucket), "rgw", "get", {"key": key}
            )
        except RadosError as e:
            if e.code == -ENOENT:
                return None
            raise
        return out["entry"]

    async def _upload_meta(self, bucket: str, key: str, upload: str) -> dict:
        ukey = self._upload_key(key, upload)
        try:
            got = await self.index.omap_get_keys(
                self._index_obj(bucket), [ukey]
            )
        except RadosError as e:
            if e.code != -ENOENT:
                raise
            got = {}
        raw = got.get(ukey)
        if raw is None:
            raise RGWError(-ENOENT, f"no upload {upload!r} for {key!r}")
        return json.loads(raw)
