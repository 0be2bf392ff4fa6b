"""RGW bucket-index helpers (reference:src/cls/rgw/cls_rgw.cc).

The reference keeps each bucket's object listing in an omap index whose
mutations run IN the OSD so the per-bucket stats header (entry count,
byte total) updates atomically with the entry — a client-side
omap_set could never keep the two consistent under concurrent writers.
This class mirrors the subset RGW's data path needs:

- ``init``           bucket_init_index: fresh header
- ``put``            bucket_complete_op(ADD): upsert entry + stats delta
- ``rm``             bucket_complete_op(DEL): drop entry + stats delta
- ``get``            single-entry lookup
- ``list``           bucket_list: server-side paged listing with
                     marker/prefix (the reference pages through omap the
                     same way)
- ``stats``          header read (bucket stats without listing)
- ``check``          bucket_check_index: recompute vs header
- ``rebuild``        bucket_rebuild_index: reset header from entries

Entries are JSON dicts (size/etag/mtime/...); the header lives in an
xattr (the reference uses the omap header slot).  The omap keyspace is
NAMESPACED the way the reference's bucket-index is (cls_rgw's
instance/ns key encoding): object entries live under ``o:<key>`` —
written only by this class — and multipart bookkeeping lives under
``m:...`` (META_NS), written via plain omap by the gateway.  Because
EVERY user key is stored tag-prefixed, no S3-legal key (including ones
that look like the meta namespace) can collide with or hide in the
meta namespace.  Meta entries are excluded from the header, ``list``,
``check`` and ``rebuild`` and surfaced only as a count in ``stats``.

Listing uses the store's ranged omap pages (MethodContext
.omap_get_range): each ``list`` call returns one page without copying
the whole index, and ``stats``'s meta count scans only the META_NS
range — O(live uploads), not O(objects).

ON-DISK FORMAT BREAK (documented pre-release policy): the
OBJ_NS/META_NS re-namespacing is not migrated.  Indexes written by the
earlier flat layout (untagged object keys, ``.upload.`` meta keys) have
their entries invisible to get/list/stats and their old meta keys
orphaned.  Rebuild such buckets by re-putting their objects (or run
``rebuild`` after re-tagging by hand); no automatic migration path
exists — or will — before the first release freezes the format.

Counterpart of ``ceph_tpu/cls/rgw_index.py``, whole.
"""

from __future__ import annotations

import json

from . import (
    CLS_METHOD_RD,
    CLS_METHOD_WR,
    ClsError,
    EINVAL,
    ENOENT,
    MethodContext,
    register_class,
)

HEADER_KEY = "rgw_index_header"
OBJ_NS = "o:"   # object entries: every user key is stored as OBJ_NS+key
META_NS = "m:"  # multipart bookkeeping, written via plain omap
CANNED_ACLS = ("private", "public-read")  # rgw_acl.cc canned subset

cls = register_class("rgw")


def _header(ctx: MethodContext) -> dict:
    return ctx.get_json(HEADER_KEY) or {"entries": 0, "bytes": 0}


def _put_header(ctx: MethodContext, hdr: dict) -> None:
    ctx.set_json(HEADER_KEY, hdr)


@cls.method("init", CLS_METHOD_WR)
def init(ctx: MethodContext, input: dict) -> dict:
    _put_header(ctx, {"entries": 0, "bytes": 0})
    return {}


EDQUOT = 122


@cls.method("put", CLS_METHOD_RD | CLS_METHOD_WR)
def put(ctx: MethodContext, input: dict) -> dict:
    """Upsert + stats delta; optional ``quota`` {max_objects,
    max_bytes} is checked against the UPDATED header in the same
    atomic op (the whole point of the in-OSD class: the reference's
    bucket quota rides cls_rgw the same way, and a client-side check
    would race concurrent writers past the cap)."""
    key = input.get("key")
    entry = input.get("entry")
    if not key or not isinstance(entry, dict):
        raise ClsError(EINVAL, "rgw.put: need key + entry dict")
    okey = OBJ_NS + key
    hdr = _header(ctx)
    old = ctx.omap_get_keys([okey]).get(okey)
    if old is not None:
        hdr["entries"] -= 1
        hdr["bytes"] -= json.loads(old).get("size", 0)
    hdr["entries"] += 1
    hdr["bytes"] += int(entry.get("size", 0))
    quota = input.get("quota") or {}
    max_objects = int(quota.get("max_objects") or 0)
    max_bytes = int(quota.get("max_bytes") or 0)
    if (max_objects and hdr["entries"] > max_objects) or (
        max_bytes and hdr["bytes"] > max_bytes
    ):
        # overwrites that SHRINK usage still pass (delta already
        # folded into hdr); only net growth past the cap rejects
        raise ClsError(EDQUOT, "bucket quota exceeded")
    _put_header(ctx, hdr)
    ctx.omap_set({okey: json.dumps(entry).encode()})
    return {"header": hdr}


@cls.method("rm", CLS_METHOD_RD | CLS_METHOD_WR)
def rm(ctx: MethodContext, input: dict) -> dict:
    key = input.get("key")
    if not key:
        raise ClsError(EINVAL, "rgw.rm: need key")
    okey = OBJ_NS + key
    old = ctx.omap_get_keys([okey]).get(okey)
    if old is None:
        raise ClsError(ENOENT, f"rgw.rm: no entry {key!r}")
    hdr = _header(ctx)
    hdr["entries"] -= 1
    hdr["bytes"] -= json.loads(old).get("size", 0)
    _put_header(ctx, hdr)
    ctx.omap_rm([okey])
    return {"header": hdr}


@cls.method("get", CLS_METHOD_RD)
def get(ctx: MethodContext, input: dict) -> dict:
    key = input.get("key")
    if not key:
        raise ClsError(EINVAL, "rgw.get: need key")
    raw = ctx.omap_get_keys([OBJ_NS + key]).get(OBJ_NS + key)
    if raw is None:
        raise ClsError(ENOENT, f"no entry {key!r}")
    return {"entry": json.loads(raw)}


@cls.method("list", CLS_METHOD_RD)
def list_(ctx: MethodContext, input: dict) -> dict:
    """Paged listing: entries strictly after ``marker``, filtered by
    ``prefix``, at most ``max_entries`` — plus ``truncated`` so the
    caller pages exactly like the reference's bucket_list.  Marker and
    prefix are user-space keys; the OBJ_NS tag is applied (and
    stripped) here."""
    marker = input.get("marker", "")
    prefix = input.get("prefix", "")
    max_entries = int(input.get("max_entries", 1000))
    if max_entries <= 0:
        raise ClsError(EINVAL, "rgw.list: max_entries must be positive")
    page, truncated = ctx.omap_get_range(
        start_after=OBJ_NS + marker, prefix=OBJ_NS + prefix,
        max_entries=max_entries,
    )
    names = sorted(page)
    return {
        "entries": {k[len(OBJ_NS):]: json.loads(page[k]) for k in names},
        "truncated": truncated,
        "next_marker": names[-1][len(OBJ_NS):] if names else marker,
    }


@cls.method("quota_check", CLS_METHOD_RD)
def quota_check(ctx: MethodContext, input: dict) -> dict:
    """Pre-flight: would applying (delta_entries, delta_bytes) exceed
    the quota?  Read-only — the gateway runs this BEFORE touching the
    data object so an overwrite never destroys existing bytes only to
    be refused (the atomic check inside ``put`` remains the
    authoritative backstop for creates, where cleanup is safe)."""
    quota = input.get("quota") or {}
    max_objects = int(quota.get("max_objects") or 0)
    max_bytes = int(quota.get("max_bytes") or 0)
    hdr = _header(ctx)
    entries = hdr["entries"] + int(input.get("delta_entries") or 0)
    nbytes = hdr["bytes"] + int(input.get("delta_bytes") or 0)
    if (max_objects and entries > max_objects) or (
        max_bytes and nbytes > max_bytes
    ):
        raise ClsError(EDQUOT, "bucket quota exceeded")
    return {"header": hdr}


@cls.method("set_acl", CLS_METHOD_RD | CLS_METHOD_WR)
def set_acl(ctx: MethodContext, input: dict) -> dict:
    """Atomic acl update on one index entry: the RMW runs under the PG
    lock, so a concurrent put_object cannot be clobbered by a stale
    entry written back (a client-side head+put would lose size/etag
    updates)."""
    key = input.get("key")
    acl = input.get("acl")
    if not key or acl not in CANNED_ACLS:
        raise ClsError(EINVAL, "rgw.set_acl: need key + canned acl")
    okey = OBJ_NS + key
    raw = ctx.omap_get_keys([okey]).get(okey)
    if raw is None:
        raise ClsError(ENOENT, f"no entry {key!r}")
    entry = json.loads(raw)
    entry["acl"] = acl
    ctx.omap_set({okey: json.dumps(entry).encode()})
    return {"entry": entry}


@cls.method("bucket_set_quota", CLS_METHOD_RD | CLS_METHOD_WR)
def bucket_set_quota(ctx: MethodContext, input: dict) -> dict:
    """Atomic quota update on a bucket record (meta pool's buckets
    object) — reference:radosgw-admin quota set --bucket."""
    bucket = input.get("bucket")
    if not bucket:
        raise ClsError(EINVAL, "rgw.bucket_set_quota: need bucket")
    try:
        max_objects = int(input.get("max_objects") or 0)
        max_bytes = int(input.get("max_bytes") or 0)
    except (TypeError, ValueError):
        raise ClsError(EINVAL, "quota values must be integers") from None
    if max_objects < 0 or max_bytes < 0:
        raise ClsError(EINVAL, "quota values must be >= 0 (0 clears)")
    raw = ctx.omap_get_keys([bucket]).get(bucket)
    if raw is None:
        raise ClsError(ENOENT, f"no bucket {bucket!r}")
    rec = json.loads(raw)
    rec["quota"] = {"max_objects": max_objects, "max_bytes": max_bytes}
    ctx.omap_set({bucket: json.dumps(rec).encode()})
    return {"bucket": rec}


@cls.method("bucket_set_acl", CLS_METHOD_RD | CLS_METHOD_WR)
def bucket_set_acl(ctx: MethodContext, input: dict) -> dict:
    """Atomic acl update on a bucket record (runs on the meta pool's
    buckets object): cannot resurrect a concurrently deleted bucket or
    clobber a concurrent create."""
    bucket = input.get("bucket")
    acl = input.get("acl")
    if not bucket or acl not in CANNED_ACLS:
        raise ClsError(EINVAL, "rgw.bucket_set_acl: need bucket + acl")
    raw = ctx.omap_get_keys([bucket]).get(bucket)
    if raw is None:
        raise ClsError(ENOENT, f"no bucket {bucket!r}")
    rec = json.loads(raw)
    rec["acl"] = acl
    ctx.omap_set({bucket: json.dumps(rec).encode()})
    return {"bucket": rec}


@cls.method("stats", CLS_METHOD_RD)
def stats(ctx: MethodContext, input: dict) -> dict:
    meta = 0
    after = ""
    while True:
        page, truncated = ctx.omap_get_range(
            start_after=after, prefix=META_NS, max_entries=1000
        )
        meta += len(page)
        if not truncated or not page:
            break
        after = max(page)
    return {"header": _header(ctx), "meta_entries": meta}


def _recount(ctx: MethodContext) -> dict:
    hdr = {"entries": 0, "bytes": 0}
    after = ""
    while True:
        page, truncated = ctx.omap_get_range(
            start_after=after, prefix=OBJ_NS, max_entries=1000
        )
        for raw in page.values():
            hdr["entries"] += 1
            hdr["bytes"] += json.loads(raw).get("size", 0)
        if not truncated or not page:
            break
        after = max(page)
    return hdr


@cls.method("check", CLS_METHOD_RD)
def check(ctx: MethodContext, input: dict) -> dict:
    actual = _recount(ctx)
    hdr = _header(ctx)
    return {"header": hdr, "actual": actual, "consistent": hdr == actual}


@cls.method("rebuild", CLS_METHOD_RD | CLS_METHOD_WR)
def rebuild(ctx: MethodContext, input: dict) -> dict:
    hdr = _recount(ctx)
    _put_header(ctx, hdr)
    return {"header": hdr}
