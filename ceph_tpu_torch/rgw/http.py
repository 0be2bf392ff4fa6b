"""The S3 REST front end (reference:src/rgw/rgw_main.cc over civetweb;
op demux reference:src/rgw/rgw_rest_s3.cc).

A deliberately small asyncio HTTP/1.1 server speaking the S3 calling
convention this framework's store supports:

  GET    /                         list buckets (owner of the key)
  PUT    /<bucket>                 create bucket
  DELETE /<bucket>                 delete bucket
  GET    /<bucket>?prefix&marker&delimiter&max-keys   list objects
  PUT    /<bucket>/<key>           put object (or ?uploadId&partNumber)
  GET    /<bucket>/<key>           get object
  HEAD   /<bucket>/<key>           head object
  DELETE /<bucket>/<key>           delete object (or abort ?uploadId)
  POST   /<bucket>/<key>?uploads   initiate multipart
  POST   /<bucket>/<key>?uploadId  complete multipart

Auth: ``Authorization: AWS <access_key>:<signature>`` — AWS signature
v2 (reference:src/rgw/rgw_auth_s3.h rgw_create_s3_canonical_header /
RGW_Auth_S3): the signature is base64(HMAC-SHA1(secret_key,
StringToSign)) over method, content-md5, content-type, date, and the
canonical resource path; the server recomputes it from the stored
secret and compares constant-time.  Knowing the (public) access key id
alone no longer grants access.  Clock-skew checking and the x-amz-*
header canonicalization are the simplifications vs the reference.
Responses are JSON rather than XML — a deliberate re-design; the
verbs, status codes, and listing semantics are the S3 ones.

Counterpart of ``ceph_tpu/rgw/http.py``, whole: the same routes, statuses,
headers and bodies.  The gateway launches no kernel: object data is
encoded and rebuilt in the OSDs.  ``S3Server(..., device=)`` is where
its admin socket's ``kernel trace`` windows look (``register_common``'s
``device``).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import logging
import time
from urllib.parse import parse_qs, unquote, urlsplit

from .store import RGWError, RGWStore

logger = logging.getLogger("ceph_tpu_torch.rgw")

_STATUS = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 500: "Internal Server Error",
}

_ERRNO_HTTP = {2: 404, 17: 409, 39: 409, 13: 403, 22: 400,
               122: 403}  # EDQUOT -> QuotaExceeded (403, like S3)

# Subresources that are part of the canonical resource string in AWS sig v2
# (the subset this gateway implements).  "acl" MUST be here (it is in
# the reference's rgw_auth_s3.cc list): leaving it unsigned let a
# captured signed PUT be replayed with ?acl=public-read appended to
# flip an object public without a signature for that mutation.
_SIGNED_SUBRESOURCES = ("acl", "delete", "uploads", "uploadId",
                        "partNumber")


def string_to_sign(method: str, target: str, headers: dict) -> str:
    """AWS signature-v2 StringToSign, canonicalized the way real S3 v2
    clients compute it (query-string-order subresources and ignored
    x-amz-* headers would break interop with standard signers):

    method, content-md5, content-type, date (empty when x-amz-date is
    present — the amz header then rides in the canonical-headers block),
    lowercased x-amz-* headers sorted and folded ``key:value\\n``, then
    the canonical resource: the decoded path plus signed subresources
    sorted lexicographically (reference:src/rgw/rgw_auth_s3.cc
    rgw_create_s3_canonical_header).
    """
    parts = urlsplit(target)
    resource = unquote(parts.path) or "/"
    sub = sorted(
        p for p in parts.query.split("&")
        if p and p.split("=", 1)[0] in _SIGNED_SUBRESOURCES
    )
    if sub:
        resource += "?" + "&".join(sub)
    # header keys are case-insensitive on the wire; the server lowercases
    # them on receipt, so the client side must sign over the same view
    h = {k.lower(): v.strip() if isinstance(v, str) else v
         for k, v in headers.items()}
    amz = sorted(
        (k, v) for k, v in h.items()
        if k.startswith("x-amz-") and k != "x-amz-date"
    )
    if "x-amz-date" in h:
        # per the v2 spec the Date line is empty and x-amz-date is folded
        # with the other amz headers
        date = ""
        amz = sorted(amz + [("x-amz-date", h["x-amz-date"])])
    else:
        date = h.get("date", "")
    amz_block = "".join(f"{k}:{v}\n" for k, v in amz)
    return "\n".join([
        method.upper(),
        h.get("content-md5", ""),
        h.get("content-type", ""),
        date,
    ]) + "\n" + amz_block + resource


def sign_request(secret_key: str, method: str, target: str,
                 headers: dict) -> str:
    """base64(HMAC-SHA1(secret, StringToSign)) — the v2 signature."""
    mac = hmac.new(
        secret_key.encode(),
        string_to_sign(method, target, headers).encode(),
        hashlib.sha1,
    )
    return base64.b64encode(mac.digest()).decode()


def auth_header(access_key: str, secret_key: str, method: str,
                target: str, headers: dict) -> str:
    """Convenience for clients: the full Authorization header value."""
    return f"AWS {access_key}:{sign_request(secret_key, method, target, headers)}"


def _prefixed_meta(headers: dict, prefix: str) -> dict:
    """Prefixed request headers -> user metadata dict — ONE rule for
    both APIs (the reference maps x-amz-meta-* and X-Object-Meta-* onto
    the same RGW_ATTR_META_PREFIX attrs, reference:rgw_op.cc
    rgw_get_request_metadata, so metadata round-trips across APIs)."""
    return {
        k[len(prefix):]: v
        for k, v in headers.items() if k.startswith(prefix)
    }


def _amz_meta(headers: dict) -> dict:
    return _prefixed_meta(headers, "x-amz-meta-")


def _swift_meta(headers: dict) -> dict:
    return _prefixed_meta(headers, "x-object-meta-")


def _etag_set(header: str | None) -> set[str]:
    """RFC 7232 If-(None-)Match value -> set of unquoted etags."""
    if not header:
        return set()
    return {part.strip().strip('"') for part in header.split(",")}


def _parse_range(header: str | None, size: int):
    """``Range: bytes=a-b`` / ``bytes=a-`` / ``bytes=-n`` -> (off, len);
    None = no/ignorable range (serve 200 full, per RFC 7233 for
    unsupported units or multi-range), "bad" = unsatisfiable (416)."""
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):]
    if "," in spec:  # multi-range unsupported: serve the full object
        return None
    start_s, _, end_s = spec.partition("-")
    try:
        if not start_s:  # suffix form: last n bytes
            n = int(end_s)
            if n < 0:
                return None  # 'bytes=--5': malformed spec, ignore
            if n == 0:  # valid form, nothing satisfiable
                return "bad"
            n = min(n, size)
            return (size - n, n) if size else "bad"
        start = int(start_s)
        if end_s:
            end = int(end_s)
            if end < start:
                # RFC 7233: an EXPLICIT last-pos below first-pos is an
                # invalid byte-range-spec — ignore, serve 200
                return None
        else:
            end = size - 1  # open-ended: to the last byte
        if start >= size:
            return "bad"  # syntactically valid but unsatisfiable
        return start, min(end, size - 1) - start + 1
    except ValueError:
        return None  # malformed: ignore the header


class S3Server:
    # request verbs tracked individually (everything else lands in
    # "other"); the reference's l_rgw per-op counters
    _VERBS = ("get", "put", "post", "head", "delete", "copy")

    def __init__(self, store: RGWStore, stats_interval: float = 1.0,
                 name: str | None = None,
                 admin_socket: str | None = None,
                 device=None):
        self.store = store
        # where the admin socket's kernel trace windows look: None the
        # card when there is one, "cpu" host-only windows (a gateway
        # whose process runs no kernel, as rgw_admin serve's)
        self.device = device
        self._server: asyncio.AbstractServer | None = None
        self.addr = ""
        # `ceph daemon rgw.<zone> <cmd>` surface (perf dump/schema/
        # reset, dump_histograms, dump_kernel_profile); '{name}'
        # expands like the daemon config pattern
        self._admin_path = admin_socket
        self._admin = None
        # mgr-report identity: must be instance-unique or two gateways
        # serving the same zone clobber each other's mgr.daemon_stats
        # entry (and their prometheus series flip-flop); the default
        # appends the bound addr once start() knows it
        self.name = name
        # observability (reference:src/rgw/rgw_perf_counters via
        # rgw_main): per-verb request counts + latency avgs, error
        # classes, payload volume — a full collection (the gateway's
        # rados-client messenger wire counters ride along, as they do
        # for mon/osd) reported to the active mgr so the prometheus
        # module exports rgw series
        from ..common import PerfCountersCollection

        self.perf_coll = PerfCountersCollection()
        self.perf_coll.attach(store.client.messenger.perf)
        from ..utils.buffers import data_path_perf

        # the zero-copy audit family (utils/buffers.py): the gateway is
        # the top of the data path, so its perf dump carries the
        # process-wide copied-bytes evidence too
        self.perf_coll.attach(data_path_perf())
        self.perf = self.perf_coll.create("rgw")
        for verb in (*self._VERBS, "other"):
            self.perf.add_counter(f"req_{verb}", f"{verb.upper()} requests")
            self.perf.add_time_avg(f"lat_{verb}",
                                   f"{verb.upper()} wall time")
        (self.perf
         .add_counter("req_4xx", "requests answered 4xx")
         .add_counter("req_5xx", "requests answered 5xx")
         .add_counter("bytes_in", "request body bytes")
         .add_counter("bytes_out", "response payload bytes")
         # payload size x wall time across all verbs: the per-verb
         # latency avgs above collapse a 100-byte HEAD and a 64 MiB PUT
         # into one number; the 2D grid keeps them apart
         .add_histogram("req_latency_histogram",
                        "request payload size x wall time"))
        self.stats_interval = stats_interval
        self._stats_task: asyncio.Task | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(self._serve, host, port)
        h, p = self._server.sockets[0].getsockname()[:2]
        self.addr = f"{h}:{p}"
        if self.stats_interval > 0:
            self._stats_task = asyncio.ensure_future(self._stats_loop())
        if self._admin_path:
            from ..common import AdminSocket, register_common

            # the socket path must be addr-free (sockets are created
            # from the config pattern before clients know the port)
            asok_name = self.name or f"rgw.{self.store.zone or 'default'}"
            self._admin = AdminSocket(
                self._admin_path.replace("{name}", asok_name)
            )
            register_common(self._admin, perf=self.perf_coll,
                            device=self.device)
            self._admin.register(
                "status",
                lambda req: {"name": asok_name, "addr": self.addr,
                             "zone": self.store.zone or "default"},
                "gateway identity",
            )
            await self._admin.start()
        return self.addr

    async def stop(self) -> None:
        if self._stats_task is not None:
            self._stats_task.cancel()
            self._stats_task = None
        if self._admin is not None:
            await self._admin.stop()
            self._admin = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _stats_loop(self) -> None:
        """Periodic MDaemonStats to the active mgr (the reference rgw's
        MMgrReport): best-effort — a gateway must keep serving when the
        mgr is down."""
        from ..msg.messenger import send_daemon_stats

        name = self.name or (
            f"rgw.{self.store.zone or 'default'}({self.addr})"
        )
        try:
            while True:
                await asyncio.sleep(self.stats_interval)
                client = self.store.client
                await send_daemon_stats(
                    client.messenger, client.osdmap, name,
                    self.perf_coll.dump(),
                )
        except asyncio.CancelledError:
            pass

    # -- http plumbing -------------------------------------------------------
    async def _serve(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
                try:
                    method, target, _ver = line.decode().split(None, 2)
                except ValueError:
                    break
                headers: dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                n = int(headers.get("content-length", 0) or 0)
                if n:
                    body = await reader.readexactly(n)
                verb = method.lower()
                if verb not in self._VERBS:
                    verb = "other"
                self.perf.inc(f"req_{verb}")
                self.perf.inc("bytes_in", len(body))
                t0 = time.perf_counter()
                status, out_headers, payload = await self._route(
                    method.upper(), target, headers, body
                )
                dt = time.perf_counter() - t0
                self.perf.observe(f"lat_{verb}", dt)
                self.perf.hist("req_latency_histogram",
                               len(body) + len(payload), dt)
                if 400 <= status < 500:
                    self.perf.inc("req_4xx")
                elif status >= 500:
                    self.perf.inc("req_5xx")
                self.perf.inc("bytes_out", len(payload))
                reason = _STATUS.get(status, "?")
                head = [f"HTTP/1.1 {status} {reason}"]
                out_headers.setdefault("content-length", str(len(payload)))
                out_headers.setdefault("connection", "keep-alive")
                for k, v in out_headers.items():
                    head.append(f"{k}: {v}")
                # vectored response: header bytes and the payload view
                # go to the transport separately — GET payloads are
                # striper gather buffers handed down uncopied
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
                if len(payload):
                    writer.write(payload)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    @staticmethod
    def _json(obj) -> tuple[dict, bytes]:
        return (
            {"content-type": "application/json"},
            json.dumps(obj).encode(),
        )

    # -- request routing (RGWHandler_REST_S3 analog; /auth + /v1 take
    # the Swift handler, reference:src/rgw/rgw_rest_swift.cc +
    # rgw_swift_auth.cc TempAuth) ---------------------------------------------
    async def _route(
        self, method: str, target: str, headers: dict, body: bytes
    ) -> tuple[int, dict, bytes]:
        try:
            swift_path = urlsplit(target).path
            # exact-segment matches only: an S3 bucket named "authors"
            # or "auth-logs" must keep routing to the S3 handler (a
            # bare startswith would hijack those buckets)
            if swift_path == "/auth" or swift_path.startswith("/auth/"):
                return await self._swift_auth(headers)
            if swift_path == "/v1" or swift_path.startswith("/v1/"):
                return await self._swift(method, target, headers, body)
            user = await self._auth(method, target, headers)
            if user is None and not (
                method in ("GET", "HEAD")
                and not headers.get("authorization")
            ):
                # bad credentials always fail; a credential-less read
                # proceeds as the ANONYMOUS principal and succeeds only
                # on public-read resources (reference: rgw anonymous
                # user + RGWAccessControlPolicy verification)
                h, b = self._json({"error": "access denied"})
                return 403, h, b
            parts = urlsplit(target)
            q = {
                k: v[0] for k, v in parse_qs(
                    parts.query, keep_blank_values=True
                ).items()
            }
            path = unquote(parts.path).strip("/")
            bucket, _, key = path.partition("/")
            if not bucket:
                return await self._svc(method, user)
            if not key:
                return await self._bucket(method, user, bucket, q,
                                          headers, body)
            return await self._object(
                method, user, bucket, key, q, body, headers
            )
        except RGWError as e:
            status = _ERRNO_HTTP.get(-e.code, 400)
            h, b = self._json({"error": str(e)})
            return status, h, b
        except Exception:
            logger.exception("rgw: request failed")
            h, b = self._json({"error": "internal error"})
            return 500, h, b

    async def _auth(
        self, method: str, target: str, headers: dict
    ) -> dict | None:
        """Verify the AWS v2 signature against the stored secret_key.

        The access key id only *selects* the user; access requires the
        request HMAC to check out (key-id-only auth would be a
        bypass — ids are not secrets in the S3 model)."""
        auth = headers.get("authorization", "")
        if not auth.startswith("AWS "):
            return None
        access_key, _, signature = auth[4:].partition(":")
        user = await self.store.user_by_access_key(access_key)
        if user is None:
            return None
        want = sign_request(user["secret_key"], method, target, headers)
        if not hmac.compare_digest(signature.strip(), want):
            return None
        return user

    async def _svc(self, method: str, user: dict | None):
        if user is None:
            return 403, *self._json({"error": "access denied"})
        if method != "GET":
            return 405, *self._json({"error": "bad method"})
        names = await self.store.list_buckets(user["uid"])
        return 200, *self._json({"owner": user["uid"], "buckets": names})

    async def _bucket(
        self, method: str, user: dict | None, bucket: str, q: dict,
        headers: dict | None = None, body: bytes = b"",
    ):
        if method == "POST" and "delete" in q:
            # bulk delete (S3 DeleteObjects): body {"objects": [keys]};
            # per-key results, like the reference's multi-delete —
            # missing keys report deleted (S3 semantics)
            await self._check_owner(user, bucket)
            try:
                parsed = json.loads(body or b"{}")
            except json.JSONDecodeError:
                return 400, *self._json({"error": "bad delete body"})
            if not isinstance(parsed, dict):
                # valid-JSON scalars/lists must be the same clean 400,
                # not an AttributeError traceback
                return 400, *self._json({"error": "bad delete body"})
            keys = parsed.get("objects") or []
            if not isinstance(keys, list) or len(keys) > 1000:
                return 400, *self._json(
                    {"error": "objects must be a list of <= 1000 keys"}
                )
            deleted, errors = [], []
            for k in keys:
                try:
                    await self.store.delete_object(bucket, str(k))
                    deleted.append(str(k))
                except RGWError as e:
                    if e.code == -2:
                        deleted.append(str(k))  # already gone: S3 says ok
                    else:
                        errors.append({"key": str(k), "error": str(e)})
            return 200, *self._json(
                {"deleted": deleted, "errors": errors}
            )
        if method == "PUT" and "acl" in q:
            await self._check_owner(user, bucket)
            await self.store.set_bucket_acl(bucket, q.get("acl") or "")
            return 200, {}, b""
        if method == "GET" and "acl" in q:
            info = await self._check_owner(user, bucket)
            return 200, *self._json({
                "owner": info["owner"],
                "acl": info.get("acl", "private"),
            })
        if method == "PUT":
            if user is None:
                return 403, *self._json({"error": "access denied"})
            await self.store.create_bucket(
                bucket, user["uid"],
                acl=(headers or {}).get("x-amz-acl", "private"),
            )
            return 200, *self._json({"bucket": bucket})
        if method == "HEAD":
            # bucket existence/access probe (S3 HeadBucket): mirrors
            # the GET branch — owner or public-read bucket (boto-style
            # head_bucket probes must agree with the reads that
            # follow); 404 when absent
            info = await self.store.bucket_info(bucket)
            if (user is None or info["owner"] != user["uid"]) and \
                    info.get("acl", "private") != "public-read":
                raise RGWError(-13, "access denied")
            return 200, {}, b""
        if method == "DELETE":
            await self._check_owner(user, bucket)
            await self.store.delete_bucket(bucket)
            return 204, {}, b""
        if method == "GET":
            # listing: owner, or anyone on a public-read bucket
            info = await self.store.bucket_info(bucket)
            if (user is None or info["owner"] != user["uid"]) and \
                    info.get("acl", "private") != "public-read":
                raise RGWError(-13, "access denied")
            listing = await self.store.list_objects(
                bucket,
                prefix=q.get("prefix", ""),
                marker=q.get("marker", ""),
                max_keys=int(q.get("max-keys", 1000)),
                delimiter=q.get("delimiter", ""),
            )
            return 200, *self._json({"name": bucket, **listing})
        return 405, *self._json({"error": "bad method"})

    async def _object(
        self, method: str, user: dict | None, bucket: str, key: str,
        q: dict, body: bytes, headers: dict,
    ):
        store = self.store
        if method in ("PUT", "POST", "DELETE"):
            # writes are owner-only (the canned subset has no
            # public-read-write), incl. the ?acl subresource
            await self._check_owner(user, bucket)
        if method == "PUT":
            if "acl" in q:
                await store.set_object_acl(bucket, key, q.get("acl") or "")
                return 200, {}, b""
            if "uploadId" in q:
                out = await store.upload_part(
                    bucket, key, q["uploadId"],
                    int(q.get("partNumber", 1)), body,
                )
                return 200, {"etag": out["etag"]}, b""
            entry = await store.put_object(
                bucket, key, body,
                content_type=headers.get(
                    "content-type", "binary/octet-stream"
                ),
                acl=headers.get("x-amz-acl", "private"),
                meta=_amz_meta(headers),
            )
            return 200, {"etag": entry["etag"]}, b""
        if method == "POST":
            if "uploads" in q:
                upload = await store.init_multipart(
                    bucket, key,
                    acl=headers.get("x-amz-acl", "private"),
                    meta=_amz_meta(headers),
                )
                return 200, *self._json({"uploadId": upload})
            if "uploadId" in q:
                entry = await store.complete_multipart(
                    bucket, key, q["uploadId"]
                )
                return 200, *self._json(entry)
            return 400, *self._json({"error": "bad post"})
        if method in ("GET", "HEAD"):
            info = await self.store.bucket_info(bucket)
            is_owner = user is not None and info["owner"] == user["uid"]
            try:
                entry = await store.head_object(bucket, key)
            except RGWError as e:
                if e.code == -2 and not is_owner:
                    # non-owners get 403 whether or not the key exists
                    # (404 here is an existence oracle for private
                    # buckets; matches real S3)
                    raise RGWError(-13, "access denied") from None
                raise
            await self._check_read(user, is_owner, entry)
            if method == "GET" and "acl" in q:
                return 200, *self._json({
                    "owner": info["owner"],
                    "acl": entry.get("acl", "private"),
                })
            # conditional requests (reference:rgw_op.cc RGWGetObj
            # if_match/if_nomatch); headers may carry RFC 7232
            # comma-separated etag lists
            etag = entry["etag"]
            inm = _etag_set(headers.get("if-none-match"))
            if inm and (etag in inm or "*" in inm):
                return 304, {"etag": etag}, b""
            im = _etag_set(headers.get("if-match"))
            if im and etag not in im and "*" not in im:
                return 412, *self._json({"error": "precondition failed"})
            base = {
                "content-type": entry.get("content_type",
                                          "binary/octet-stream"),
                "etag": etag,
                "accept-ranges": "bytes",
                **{f"x-amz-meta-{k}": v
                   for k, v in (entry.get("meta") or {}).items()},
            }
            if method == "HEAD":
                return 200, {**base,
                             "content-length": str(entry["size"])}, b""
            rng = _parse_range(headers.get("range"), entry["size"])
            if rng == "bad":
                return 416, {
                    "content-range": f"bytes */{entry['size']}"
                }, b""
            if rng is not None:
                off, length = rng
                data, _e = await store.get_object_range(
                    bucket, key, off, length, entry=entry
                )
                return 206, {
                    **base,
                    "content-range": f"bytes {off}-{off + len(data) - 1}"
                                     f"/{entry['size']}",
                }, data
            data, _e = await store.get_object(bucket, key)
            return 200, base, data
        if method == "DELETE":
            if "uploadId" in q:
                await store.abort_multipart(bucket, key, q["uploadId"])
                return 204, {}, b""
            await store.delete_object(bucket, key)
            return 204, {}, b""
        return 405, *self._json({"error": "bad method"})

    async def _check_read(
        self, user: dict | None, is_owner: bool, entry: dict
    ) -> None:
        """Owner, or anyone (authenticated or anonymous) when the
        OBJECT is public-read — the canned subset of the reference's
        RGWAccessControlPolicy::verify_permission."""
        if entry.get("acl", "private") == "public-read":
            return
        if not is_owner:
            raise RGWError(-13, "access denied")

    async def _check_owner(self, user: dict | None, bucket: str) -> dict:
        """Owner gate; returns the bucket info it fetched so callers
        don't re-read BUCKETS_OBJ."""
        info = await self.store.bucket_info(bucket)
        if user is None or info["owner"] != user["uid"]:
            raise RGWError(-13, "access denied")
        return info

    # ===================== Swift API (rgw_rest_swift analog) ================

    SWIFT_TOKEN_TTL = 3600.0

    def _swift_token(self, user: dict, now: float | None = None) -> str:
        """Stateless TempAuth-style token: uid + expiry, HMAC-signed
        with the user's secret key (reference:rgw_swift_auth.cc builds
        the same self-validating token from the swift key)."""
        exp = int(
            (now if now is not None else time.time())
            + self.SWIFT_TOKEN_TTL
        )
        sig = hmac.new(
            user["secret_key"].encode(),
            f"{user['uid']}|{exp}".encode(), hashlib.sha1,
        ).hexdigest()
        raw = json.dumps(
            {"uid": user["uid"], "exp": exp, "sig": sig}
        ).encode()
        return "AUTH_tk" + base64.urlsafe_b64encode(raw).decode()

    async def _swift_user(self, headers: dict) -> dict | None:
        """Validate X-Auth-Token; returns the user or None."""
        token = headers.get("x-auth-token", "")
        if not token.startswith("AUTH_tk"):
            return None
        try:
            d = json.loads(base64.urlsafe_b64decode(token[7:]))
            uid, exp, sig = d["uid"], int(d["exp"]), d["sig"]
        except (ValueError, KeyError, TypeError):
            return None
        if exp < time.time():
            return None
        try:
            user = await self.store.get_user(uid)
        except RGWError:
            return None
        want = hmac.new(
            user["secret_key"].encode(),
            f"{uid}|{exp}".encode(), hashlib.sha1,
        ).hexdigest()
        if not hmac.compare_digest(sig, want):
            return None
        return user

    async def _swift_auth(self, headers: dict) -> tuple[int, dict, bytes]:
        """GET /auth/v1.0 with X-Auth-User "<uid>:swift" + X-Auth-Key
        (the user's secret key) -> X-Auth-Token + X-Storage-Url
        (Swift TempAuth, reference:rgw_swift_auth.cc)."""
        auth_user = headers.get("x-auth-user", "")
        auth_key = headers.get("x-auth-key", "")
        uid = auth_user.split(":", 1)[0]
        try:
            user = await self.store.get_user(uid)
        except RGWError:
            return 401, *self._json({"error": "bad credentials"})
        if not hmac.compare_digest(auth_key, user["secret_key"]):
            return 401, *self._json({"error": "bad credentials"})
        return 200, {
            "x-auth-token": self._swift_token(user),
            "x-storage-token": self._swift_token(user),
            "x-storage-url": f"http://{self.addr}/v1/AUTH_{uid}",
        }, b""

    async def _swift(
        self, method: str, target: str, headers: dict, body: bytes
    ) -> tuple[int, dict, bytes]:
        user = await self._swift_user(headers)
        if user is None:
            return 401, *self._json({"error": "invalid token"})
        parts = urlsplit(target)
        q = {
            k: v[0] for k, v in parse_qs(
                parts.query, keep_blank_values=True
            ).items()
        }
        segs = unquote(parts.path).strip("/").split("/", 3)
        # segs: ["v1", "AUTH_<acct>", container?, object?]
        if len(segs) < 2 or not segs[1].startswith("AUTH_"):
            return 404, *self._json({"error": "bad path"})
        if segs[1] != f"AUTH_{user['uid']}":
            return 403, *self._json({"error": "wrong account"})
        container = segs[2] if len(segs) > 2 and segs[2] else None
        obj = segs[3] if len(segs) > 3 and segs[3] else None
        if container is None:
            return await self._swift_account(method, user)
        if obj is None:
            return await self._swift_container(method, user, container, q)
        return await self._swift_object(
            method, user, container, obj, body, headers
        )

    async def _swift_account(self, method: str, user: dict):
        if method not in ("GET", "HEAD"):
            return 405, *self._json({"error": "bad method"})
        names = await self.store.list_buckets(user["uid"])
        if method == "HEAD":
            return 204, {"x-account-container-count": str(len(names))}, b""
        return 200, {"content-type": "text/plain"}, (
            "\n".join(names) + ("\n" if names else "")
        ).encode()

    async def _swift_container(
        self, method: str, user: dict, container: str, q: dict
    ):
        store = self.store
        if method == "PUT":
            try:
                info = await store.bucket_info(container)
            except RGWError as e:
                if -e.code != 2:  # ENOENT: fresh name
                    raise
                await store.create_bucket(container, user["uid"])
                return 201, {}, b""
            if info["owner"] != user["uid"]:
                # the container namespace is global: taken by another
                # account is a 403, never a phantom "Created"
                return 403, *self._json({"error": "access denied"})
            return 202, {}, b""  # owner re-create: Swift Accepted
        await self._check_owner(user, container)
        if method == "DELETE":
            await store.delete_bucket(container)
            return 204, {}, b""
        if method == "HEAD":
            stats = await store.bucket_stats(container)
            return 204, {
                "x-container-object-count": str(stats["num_objects"]),
                "x-container-bytes-used": str(stats["size_bytes"]),
            }, b""
        if method == "GET":
            listing = await store.list_objects(
                container,
                prefix=q.get("prefix", ""),
                marker=q.get("marker", ""),
                delimiter=q.get("delimiter", ""),
                max_keys=int(q.get("limit", 10000)),
            )
            names = [e["key"] for e in listing["contents"]]
            names += listing.get("common_prefixes", [])
            if q.get("format") == "json":
                return 200, *self._json([
                    {
                        "name": e["key"], "bytes": e["size"],
                        "hash": e["etag"],
                    }
                    for e in listing["contents"]
                ])
            return 200, {"content-type": "text/plain"}, (
                "\n".join(sorted(names)) + ("\n" if names else "")
            ).encode()
        return 405, *self._json({"error": "bad method"})

    async def _swift_object(
        self, method: str, user: dict, container: str, obj: str,
        body: bytes, headers: dict,
    ):
        await self._check_owner(user, container)
        store = self.store
        if method == "PUT":
            entry = await store.put_object(
                container, obj, body,
                content_type=headers.get(
                    "content-type", "application/octet-stream"
                ),
                meta=_swift_meta(headers),
            )
            return 201, {"etag": entry["etag"]}, b""
        if method == "GET":
            data, entry = await store.get_object(container, obj)
            return 200, {
                "content-type": entry.get(
                    "content_type", "application/octet-stream"
                ),
                "etag": entry["etag"],
                **{f"x-object-meta-{k}": v
                   for k, v in (entry.get("meta") or {}).items()},
            }, data
        if method == "HEAD":
            entry = await store.head_object(container, obj)
            return 200, {
                "content-length": str(entry["size"]),
                "content-type": entry.get(
                    "content_type", "application/octet-stream"
                ),
                "etag": entry["etag"],
                **{f"x-object-meta-{k}": v
                   for k, v in (entry.get("meta") or {}).items()},
            }, b""
        if method == "DELETE":
            await store.delete_object(container, obj)
            return 204, {}, b""
        if method == "COPY":
            dest = headers.get("destination", "")
            dc, _, dk = dest.strip("/").partition("/")
            if not dc or not dk:
                return 400, *self._json({"error": "bad Destination"})
            await self._check_owner(user, dc)
            entry = await store.copy_object(container, obj, dc, dk)
            return 201, {"etag": entry["etag"]}, b""
        return 405, *self._json({"error": "bad method"})
