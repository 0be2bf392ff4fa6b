"""The port's RGW gateway (``ceph_tpu_torch.rgw``) held against the
reference's, on the CPU.

- **Twins** of every case of ``tests/test_rgw.py`` (users and buckets,
  objects and listings, multipart, SigV2 canonicalization, REST end to
  end, canned ACLs, ranges, conditional GETs, user metadata, bulk delete
  and HEAD bucket), of the gateway's admin socket case of
  ``tests/test_histograms.py`` and of the rgw series case of
  ``tests/test_observability.py``.  Each runs one scenario on the
  reference's ``MiniCluster`` with the reference's ``RGWStore`` and
  ``S3Server``, and on the port's (``MiniCluster(device="cpu")``) with the
  port's, the same requests with the same payloads.  Each keeps the
  reference case's own checks and records what it reads: every HTTP
  status, header set and body, and every store call's answer or errno.
  After the scenario, every object of the gateway's pools is recorded:
  its bytes, its xattrs (the bucket index's stats header among them) and,
  in a replicated pool, its omap (users, buckets, index entries, the
  zone's datalog).  The two records must be equal, byte for byte.
- Access keys, secret keys and upload ids come from ``secrets`` and the
  entries' times, datalog keys and Swift tokens' expiries from the clock,
  so :func:`deterministic` gives both packages' ``rgw.store`` one seeded
  ``token_hex``, and ``time.time`` / ``time.time_ns`` a clock that steps
  a millisecond a call for callers in the gateway modules only (the rest
  of the process keeps the real clock), started afresh for each
  package's run.  The only substitution
  in a record is the gateway's own address, written ``{addr}``: each run
  listens on a port of its own.
- **Crosses:** on each package's cluster, both packages' ``RGWStore``s
  (each over its own package's client) and gateways read back, equal,
  what the other wrote.
- **Pure helpers:** ``string_to_sign``, ``sign_request``, ``auth_header``,
  ``_parse_range``, ``_etag_set`` and the metadata header helpers equal
  the reference's on the published AWS example and on hypothesis inputs.

Every scenario runs under ``asyncio.wait_for`` (``LIMIT_S``).
"""

import asyncio
import contextlib
import hashlib
import json
import random
import sys
import time
import types

import pytest
from hypothesis import given, settings, strategies as st

import ceph_tpu.rados as ref_rados
import ceph_tpu.rgw as ref_rgw
import ceph_tpu.rgw.http as ref_http
import ceph_tpu.rgw.store as ref_store
import ceph_tpu_torch.rados as port_rados
import ceph_tpu_torch.rgw as port_rgw
import ceph_tpu_torch.rgw.http as port_http
import ceph_tpu_torch.rgw.store as port_store
from ceph_tpu.common.admin_socket import admin_command as ref_admin_command
from ceph_tpu.tools.ceph_cli import _mgr_command as ref_mgr_command
from ceph_tpu_torch.common.admin_socket import admin_command as port_admin_command
from ceph_tpu_torch.tools.ceph_cli import _mgr_command as port_mgr_command
from tests.test_torch_rados import OI_KEY, REF as RADOS_REF, PORT as RADOS_PORT, store_state

LIMIT_S = 30.0
SEED = 20261018
CLOCK_START_NS = 1_800_000_000 * 10**9
DATE = "Thu, 01 Jan 2026 00:00:00 GMT"

REF = types.SimpleNamespace(
    name="ref", rados=ref_rados, rgw=ref_rgw, http=ref_http, store=ref_store,
    admin_command=ref_admin_command, mgr_command=ref_mgr_command,
    osd=RADOS_REF, kw={}, gw_kw={})
PORT = types.SimpleNamespace(
    name="port", rados=port_rados, rgw=port_rgw, http=port_http, store=port_store,
    admin_command=port_admin_command, mgr_command=port_mgr_command,
    osd=RADOS_PORT, kw={"device": "cpu"}, gw_kw={"device": "cpu"})


GATEWAY_MODULES = ("ceph_tpu.rgw.", "ceph_tpu_torch.rgw.")


class _Clock:
    """A clock that steps one millisecond a call from a fixed start."""

    def __init__(self):
        self._calls = 0

    def time_ns(self) -> int:
        self._calls += 1
        return CLOCK_START_NS + self._calls * 1_000_000


class _Secrets:
    """``secrets.token_hex`` from a seeded generator."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_hex(self, nbytes: int) -> str:
        return self._rng.randbytes(nbytes).hex()


@contextlib.contextmanager
def deterministic(seed: int = SEED, callers=GATEWAY_MODULES, secret_modules=None):
    """For the length of one run: one seeded ``token_hex`` in both
    packages' ``rgw.store`` (or in ``secret_modules``), and ``time.time``
    / ``time.time_ns`` that answer a stepping clock to callers in the
    gateway's modules (or in the modules named by the prefixes
    ``callers``; the reference's function-local ``import time``
    included) and the real clock to everyone else (the OSDs, the mon,
    the messenger)."""
    clock, secrets = _Clock(), _Secrets(seed)
    real_time, real_time_ns = time.time, time.time_ns

    def gateway_caller() -> bool:
        return sys._getframe(2).f_globals.get("__name__", "").startswith(callers)

    def fake_time_ns() -> int:
        return clock.time_ns() if gateway_caller() else real_time_ns()

    def fake_time() -> float:
        return clock.time_ns() / 1e9 if gateway_caller() else real_time()

    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_store, port_store) if secret_modules is None else secret_modules:
            mp.setattr(mod, "secrets", secrets)
        mp.setattr(time, "time", fake_time)
        mp.setattr(time, "time_ns", fake_time_ns)
        yield


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


async def http(P, addr, method, path, body=b"", headers=None, creds=None):
    """One signed (or anonymous) HTTP round trip against a gateway, signed
    with the package's own ``auth_header`` (``tests/test_rgw.py``'s
    ``_http``)."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        h = {"content-length": str(len(body)), **(headers or {})}
        if creds is not None:
            h.setdefault("date", DATE)
            h["authorization"] = P.http.auth_header(
                creds["access_key"], creds["secret_key"], method, path, h)
        head = f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in h.items()) + "\r\n"
        writer.write(head.encode() + body)
        await writer.drain()
        status = int((await reader.readline()).decode().split()[1])
        resp_headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            resp_headers[k.strip().lower()] = v.strip()
        n = int(resp_headers.get("content-length", 0))
        payload = await reader.readexactly(n) if n and method != "HEAD" else b""
        return status, resp_headers, payload
    finally:
        writer.close()


class Run:
    """One package's run of a scenario: its cluster, its gateways and
    what it records."""

    def __init__(self, P, cluster):
        self.P = P
        self.cluster = cluster
        self.rec: list = []
        self.servers: list = []
        self.addrs: list[str] = []

    def note(self, what, value):
        self.rec.append((what, value))
        return value

    async def store(self, **kw):
        cl = await self.cluster.client()
        return await self.P.rgw.RGWStore.create(cl, **kw)

    async def gateway(self, store, **kw) -> str:
        srv = self.P.http.S3Server(store, **kw, **self.P.gw_kw)
        addr = await srv.start()
        self.servers.append(srv)
        self.addrs.append(addr)
        return addr

    def _unaddr(self, value: str) -> str:
        for addr in self.addrs:
            value = value.replace(addr, "{addr}")
        return value

    async def http(self, addr, method, path, body=b"", headers=None, creds=None):
        st_, h, payload = await http(self.P, addr, method, path, body, headers, creds)
        self.note(f"{method} {path}", (st_, {k: self._unaddr(v) for k, v in h.items()},
                                       payload))
        return st_, h, payload

    async def call(self, what, coro):
        """A store call's answer, recorded."""
        return self.note(what, await coro)

    async def fails(self, what, coro):
        """A store call that must raise ``RGWError``; its errno and message
        are recorded."""
        with pytest.raises(self.P.rgw.RGWError) as e:
            await coro
        return self.note(what, ("errno", e.value.code, str(e.value)))


async def pool_state(cluster, prefixes=(".rgw",)) -> dict:
    """Every object of the gateway's pools (``.rgw*``, or the pools whose
    names start with one of ``prefixes``), read through the cluster's own
    client: bytes, xattrs and, in a replicated pool, omap."""
    cl = await cluster.client()
    out = {}
    for pool in sorted(cl.osdmap.pools.values(), key=lambda p: p.name):
        if not pool.name.startswith(tuple(prefixes)):
            continue
        io = cl.io_ctx(pool.name)
        for oid in await cl.list_objects(pool.name):
            obj = {"data": bytes(await io.read(oid)),
                   "xattrs": {k: bytes(v) for k, v in (await io.getxattrs(oid)).items()}}
            if not pool.is_erasure():
                obj["omap"] = {k: bytes(v) for k, v in (await io.omap_get(oid)).items()}
            out[(pool.name, oid)] = obj
    return out


def shard_state(P, cluster) -> dict:
    """Every OSD store's head objects (``tests/test_torch_rados.py``'s
    ``store_state``): each shard's bytes and xattrs, its crc table among
    them, and the size in its object info.  The object info's version and
    the PG logs count the writes that made an object, and the port's
    striper writes a backing object in one op where the reference's
    writes each stripe unit, so they are left out."""
    out = {}
    for key, obj in store_state(P.osd, cluster).items():
        if key[2] == "log":
            continue
        attrs = dict(obj["attrs"])
        if OI_KEY in attrs:
            attrs[OI_KEY] = json.loads(attrs[OI_KEY])["size"]
        out[key] = {"data": obj["data"], "attrs": attrs}
    return out


def twin(scenario, n_osds=3, shards=False, cluster_kw=None, packages=(REF, PORT)):
    """Run ``scenario(run)`` on each package's cluster, each under
    :func:`deterministic`; then record the gateway pools' objects (and
    with ``shards`` every OSD store's shards, :func:`shard_state`).  The
    records must be equal; returns them by package."""
    out = {}
    for P in packages:
        async def main(P=P):
            async with P.rados.MiniCluster(n_osds=n_osds, **(cluster_kw or {}),
                                           **P.kw) as cluster:
                r = Run(P, cluster)
                try:
                    await scenario(r)
                finally:
                    for srv in r.servers:
                        await srv.stop()
                r.note("pools", await pool_state(cluster))
                if shards:
                    r.note("shards", shard_state(P, cluster))
                return r.rec

        with deterministic():
            out[P.name] = run(main())
    if len(packages) == 2:
        assert_same_records(out["port"], out["ref"])
    return out


def assert_same_records(port: list, ref: list) -> None:
    """Two runs' records, ``(what, value)`` in order, must be equal; a
    dict value (a pool or store record) is compared key by key, so a
    difference names its object."""
    assert [w for w, _ in port] == [w for w, _ in ref]
    for (what, got), (_, want) in zip(port, ref):
        if isinstance(want, dict):
            assert sorted(got, key=repr) == sorted(want, key=repr), what
            for key in want:
                assert got[key] == want[key], (what, key)
        else:
            assert got == want, what


async def _user_store(r, uid="alice", **kw):
    s = await r.store(**kw)
    return s, await r.call(f"create_user {uid}", s.create_user(uid))


# -- TestUsersBuckets -----------------------------------------------------------


def test_user_lifecycle():
    async def scenario(r):
        s = await r.store()
        rec = await r.call("create", s.create_user("alice", "Alice A"))
        assert rec["access_key"] and rec["secret_key"]
        await r.fails("again", s.create_user("alice"))
        assert await r.call("ls", s.list_users()) == ["alice"]
        found = await r.call("by key", s.user_by_access_key(rec["access_key"]))
        assert found["uid"] == "alice"
        assert await r.call("by bad key", s.user_by_access_key("nope")) is None
        await s.remove_user("alice")
        assert await r.call("ls after rm", s.list_users()) == []

    twin(scenario)


def test_bucket_lifecycle():
    async def scenario(r):
        s = await r.store()
        await s.create_user("alice")
        await s.create_user("bob")
        await s.create_bucket("photos", "alice")
        await s.create_bucket("photos", "alice")  # idempotent
        await r.fails("taken", s.create_bucket("photos", "bob"))
        assert await r.call("ls", s.list_buckets("alice")) == ["photos"]
        await r.fails("rm owner", s.remove_user("alice"))
        await r.call("put", s.put_object("photos", "img", b"x"))
        await r.fails("rm full bucket", s.delete_bucket("photos"))
        await s.delete_object("photos", "img")
        await s.delete_bucket("photos")
        assert await r.call("ls after", s.list_buckets("alice")) == []

    twin(scenario)


# -- TestObjects ----------------------------------------------------------------


def test_put_get_overwrite_delete():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u")
        body = b"hello world" * 1000
        entry = await r.call("put", s.put_object("b", "k", body, content_type="text/plain"))
        assert entry["etag"] == hashlib.md5(body).hexdigest()
        got, meta = await r.call("get", s.get_object("b", "k"))
        assert got == body and meta["content_type"] == "text/plain"
        await s.put_object("b", "k", b"short")  # shorter: no stale tail
        got, meta = await r.call("get short", s.get_object("b", "k"))
        assert got == b"short" and meta["size"] == 5
        await s.delete_object("b", "k")
        await r.fails("get deleted", s.get_object("b", "k"))

    twin(scenario)


def test_listing_semantics():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u")
        for k in ("a/1", "a/2", "b/1", "b/sub/2", "top"):
            await s.put_object("b", k, k.encode())
        out = await r.call("all", s.list_objects("b"))
        assert [c["key"] for c in out["contents"]] == ["a/1", "a/2", "b/1", "b/sub/2", "top"]
        out = await r.call("prefix", s.list_objects("b", prefix="a/"))
        assert [c["key"] for c in out["contents"]] == ["a/1", "a/2"]
        out = await r.call("delimiter", s.list_objects("b", delimiter="/"))
        assert out["common_prefixes"] == ["a/", "b/"]
        assert [c["key"] for c in out["contents"]] == ["top"]
        out = await r.call("both", s.list_objects("b", prefix="b/", delimiter="/"))
        assert out["common_prefixes"] == ["b/sub/"]
        assert [c["key"] for c in out["contents"]] == ["b/1"]
        out = await r.call("page 1", s.list_objects("b", max_keys=2))
        assert out["truncated"] and len(out["contents"]) == 2
        out2 = await r.call("page 2", s.list_objects("b", marker=out["next_marker"],
                                                     max_keys=10))
        assert [c["key"] for c in out2["contents"]] == ["b/1", "b/sub/2", "top"]

    twin(scenario)


def test_listing_projects_entries_no_meta_or_acl_leak():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u", acl="public-read")
        await s.put_object("b", "secretive", b"payload", acl="private",
                           meta={"owner-ssn": "123-45-6789"})
        out = await r.call("list", s.list_objects("b"))
        [entry] = out["contents"]
        assert set(entry) == {"key", "size", "etag", "mtime"}
        assert entry["key"] == "secretive" and entry["size"] == len(b"payload")
        assert entry["etag"] == hashlib.md5(b"payload").hexdigest()
        assert entry["mtime"] > 0
        addr = await r.gateway(s, stats_interval=0)
        st_, _h, payload = await r.http(addr, "GET", "/b")
        assert st_ == 200
        assert "ssn" not in payload.decode()
        assert all(set(e) == {"key", "size", "etag", "mtime"}
                   for e in json.loads(payload)["contents"])

    twin(scenario)


def test_copy():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("src", "u")
        await s.create_bucket("dst", "u")
        await s.put_object("src", "k", b"payload")
        await r.call("copy", s.copy_object("src", "k", "dst", "k2"))
        got, _ = await r.call("get", s.get_object("dst", "k2"))
        assert got == b"payload"

    twin(scenario)


# -- TestMultipart --------------------------------------------------------------


def test_multipart_lifecycle():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u")
        up = await r.call("init", s.init_multipart("b", "big"))
        p1, p2, p3 = b"A" * 7000, b"B" * 5000, b"C" * 100
        for n, p in ((2, p2), (1, p1), (3, p3)):  # assembly is by part number
            await r.call(f"part {n}", s.upload_part("b", "big", up, n, p))
        entry = await r.call("complete", s.complete_multipart("b", "big", up))
        assert entry["size"] == 12100 and entry["etag"].endswith("-3")
        got, _ = await r.call("get", s.get_object("b", "big"))
        assert got == p1 + p2 + p3
        out = await r.call("list", s.list_objects("b"))
        assert [c["key"] for c in out["contents"]] == ["big"]

    twin(scenario)


def test_concurrent_part_uploads():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u")
        up = await r.call("init", s.init_multipart("b", "big"))
        parts = {n: bytes([n]) * 1000 for n in range(1, 9)}
        r.note("parts", await asyncio.gather(*(
            s.upload_part("b", "big", up, n, data) for n, data in parts.items())))
        entry = await r.call("complete", s.complete_multipart("b", "big", up))
        assert entry["size"] == 8000 and entry["etag"].endswith("-8")
        got, _ = await r.call("get", s.get_object("b", "big"))
        assert got == b"".join(parts[n] for n in sorted(parts))

    twin(scenario)


def test_delimiter_pagination_no_duplicates():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u")
        for k in ("a", "b/1", "b/2", "b/3", "c/1", "d"):
            await s.put_object("b", k, b"x")
        seen: list[str] = []
        marker = ""
        for _ in range(10):
            out = await r.call(f"page after {marker!r}", s.list_objects(
                "b", delimiter="/", max_keys=2, marker=marker))
            seen += [c["key"] for c in out["contents"]] + out["common_prefixes"]
            if not out["truncated"]:
                break
            assert out["next_marker"]
            marker = out["next_marker"]
        else:
            raise AssertionError("pagination never terminated")
        assert sorted(seen) == ["a", "b/", "c/", "d"]

    twin(scenario)


def test_multipart_abort():
    async def scenario(r):
        s = await r.store()
        await s.create_user("u")
        await s.create_bucket("b", "u")
        up = await r.call("init", s.init_multipart("b", "k"))
        await s.upload_part("b", "k", up, 1, b"data")
        await s.abort_multipart("b", "k", up)
        await r.fails("complete aborted", s.complete_multipart("b", "k", up))
        assert (await r.call("list", s.list_objects("b")))["contents"] == []

    twin(scenario)


# -- TestSigV2Canonicalization ----------------------------------------------------

AWS_HEADERS = {
    "Content-Md5": "c8fdb181845a4ca6b8fec737b3581d76",
    "Content-Type": "text/html",
    "Date": "Thu, 17 Nov 2005 18:49:58 GMT",
    "X-Amz-Magic": "abracadabra",
    "X-Amz-Meta-Author": "foo@bar.com",
}
AWS_SECRET = "OtxrzxIsfpFjA7SwPzILwy8Bw21TLhquhboDYROV"


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_matches_published_aws_example(P):
    """The StringToSign and signature of the worked example in the public
    AWS S3 Developer Guide (REST authentication), from each package."""
    assert P.http.string_to_sign("PUT", "/quotes/nelson", AWS_HEADERS) == (
        "PUT\nc8fdb181845a4ca6b8fec737b3581d76\ntext/html\n"
        "Thu, 17 Nov 2005 18:49:58 GMT\n"
        "x-amz-magic:abracadabra\nx-amz-meta-author:foo@bar.com\n"
        "/quotes/nelson")
    assert P.http.sign_request(AWS_SECRET, "PUT", "/quotes/nelson",
                               AWS_HEADERS) == "jZNOcbfWmD/A/f3hSvVzXZjM2HU="


def test_subresources_sorted_and_amz_date_folds():
    got = {}
    for P in (REF, PORT):
        sts = P.http.string_to_sign("POST", "/b/k?uploadId=7&uploads&partNumber=2",
                                    {"x-amz-date": "Thu, 17 Nov 2005 18:49:58 GMT"})
        lines = sts.split("\n")
        assert lines[3] == ""  # Date line empty when x-amz-date signs
        assert lines[4].startswith("x-amz-date:")
        assert lines[-1] == "/b/k?partNumber=2&uploadId=7&uploads"
        got[P.name] = sts
    assert got["port"] == got["ref"]


_token = st.text(alphabet=st.characters(min_codepoint=33, max_codepoint=126,
                                        blacklist_characters="&=?#%"), max_size=8)
_header_names = st.sampled_from([
    "Content-MD5", "content-type", "Date", "x-amz-date", "X-Amz-Meta-Color", "x-amz-acl",
    "x-amz-meta-rev", "X-Object-Meta-Color", "range", "If-Match", "Host"])
_headers = st.dictionaries(_header_names, st.text(max_size=12), max_size=6)
_subresources = st.lists(st.tuples(
    st.sampled_from(["acl", "delete", "uploads", "uploadId", "partNumber", "prefix",
                     "marker", "max-keys", "format"]),
    st.one_of(st.none(), _token)), max_size=4)


@settings(max_examples=100, deadline=None)
@given(method=st.sampled_from(["GET", "put", "POST", "HEAD", "DELETE", "COPY"]),
       path=st.lists(_token, max_size=3), query=_subresources, headers=_headers,
       secret=st.text(max_size=20))
def test_signing_equals_the_references(method, path, query, headers, secret):
    target = "/" + "/".join(path)
    if query:
        target += "?" + "&".join(k if v is None else f"{k}={v}" for k, v in query)
    for fn, args in (("string_to_sign", (method, target, headers)),
                     ("sign_request", (secret, method, target, headers)),
                     ("auth_header", ("AK", secret, method, target, headers))):
        assert outcome(getattr(port_http, fn), *args) == outcome(getattr(ref_http, fn), *args)


def outcome(fn, *args):
    """A helper's answer, or the type of what it raised (``urlsplit``
    refuses some targets, the same way in both packages)."""
    try:
        return "ok", fn(*args)
    except Exception as e:
        return "raised", type(e).__name__, str(e)


_range = st.one_of(
    st.none(), st.text(max_size=12),
    st.builds(lambda a, b: f"bytes={a}-{b}",
              st.one_of(st.just(""), st.integers(-5, 300).map(str)),
              st.one_of(st.just(""), st.integers(-5, 300).map(str))),
    st.builds(lambda a, b, c: f"bytes={a}-{b},{c}", st.integers(0, 9), st.integers(0, 9),
              st.integers(0, 9)))


@settings(max_examples=300, deadline=None)
@given(header=_range, size=st.integers(0, 256))
def test_parse_range_equals_the_references(header, size):
    assert port_http._parse_range(header, size) == ref_http._parse_range(header, size)


@settings(max_examples=150, deadline=None)
@given(header=st.one_of(st.none(), st.text(max_size=30),
                        st.lists(st.sampled_from(['"e1"', "e2", " *", '"e3" ', "W/x"]),
                                 max_size=4).map(",".join)),
       headers=_headers)
def test_etag_set_and_meta_helpers_equal_the_references(header, headers):
    assert port_http._etag_set(header) == ref_http._etag_set(header)
    low = {k.lower(): v for k, v in headers.items()}
    assert port_http._amz_meta(low) == ref_http._amz_meta(low)
    assert port_http._swift_meta(low) == ref_http._swift_meta(low)
    assert port_http._prefixed_meta(low, "x-") == ref_http._prefixed_meta(low, "x-")


# -- TestHTTPGateway --------------------------------------------------------------


def test_rest_end_to_end():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        st_, _, _ = await r.http(addr, "GET", "/")
        assert st_ == 403
        st_, _, _ = await r.http(addr, "PUT", "/photos", creds=user)
        assert st_ == 200
        body = b"jpegjpegjpeg" * 500
        st_, h, _ = await r.http(addr, "PUT", "/photos/cat.jpg", body=body, creds=user)
        assert st_ == 200 and h["etag"] == hashlib.md5(body).hexdigest()
        st_, h, payload = await r.http(addr, "GET", "/photos/cat.jpg", creds=user)
        assert st_ == 200 and payload == body
        st_, h, _ = await r.http(addr, "HEAD", "/photos/cat.jpg", creds=user)
        assert st_ == 200 and int(h["content-length"]) == len(body)
        st_, _, payload = await r.http(addr, "GET", "/photos?prefix=cat", creds=user)
        assert json.loads(payload)["contents"][0]["key"] == "cat.jpg"
        st_, _, payload = await r.http(addr, "POST", "/photos/big?uploads", creds=user)
        up = json.loads(payload)["uploadId"]
        st_, _, _ = await r.http(addr, "PUT", f"/photos/big?uploadId={up}&partNumber=1",
                                 body=b"P1" * 3000, creds=user)
        assert st_ == 200
        await r.http(addr, "PUT", f"/photos/big?uploadId={up}&partNumber=2",
                     body=b"P2" * 10, creds=user)
        st_, _, payload = await r.http(addr, "POST", f"/photos/big?uploadId={up}",
                                       creds=user)
        assert st_ == 200 and json.loads(payload)["size"] == 6020
        st_, _, payload = await r.http(addr, "GET", "/photos/big", creds=user)
        assert payload == b"P1" * 3000 + b"P2" * 10
        st_, _, _ = await r.http(addr, "GET", "/photos/ghost", creds=user)
        assert st_ == 404
        st_, _, _ = await r.http(addr, "DELETE", "/photos/cat.jpg", creds=user)
        assert st_ == 204
        other = await r.call("create_user eve", s.create_user("eve"))
        st_, _, _ = await r.http(addr, "GET", "/photos", creds=other)
        assert st_ == 403
        bad = {"authorization": f"AWS {user['access_key']}:bogus", "date": DATE}
        st_, _, _ = await r.http(addr, "GET", "/photos", headers=bad)
        assert st_ == 403
        stolen = dict(user, secret_key=other["secret_key"])
        st_, _, _ = await r.http(addr, "GET", "/photos", creds=stolen)
        assert st_ == 403

    twin(scenario)


# -- TestACLRangeConditional -----------------------------------------------------


def test_canned_acls_and_anonymous_reads():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/pub", creds=user)
        body = b"public bytes"
        st_, _, _ = await r.http(addr, "PUT", "/pub/open.txt", body=body,
                                 headers={"x-amz-acl": "public-read"}, creds=user)
        assert st_ == 200
        st_, _, _ = await r.http(addr, "PUT", "/pub/secret.txt", body=b"s", creds=user)
        assert st_ == 200
        st_, _, payload = await r.http(addr, "GET", "/pub/open.txt")
        assert st_ == 200 and payload == body
        assert (await r.http(addr, "GET", "/pub/secret.txt"))[0] == 403
        assert (await r.http(addr, "GET", "/pub"))[0] == 403
        assert (await r.http(addr, "PUT", "/pub?acl=public-read", creds=user))[0] == 200
        st_, _, payload = await r.http(addr, "GET", "/pub")
        assert st_ == 200
        assert [c["key"] for c in json.loads(payload)["contents"]] == [
            "open.txt", "secret.txt"]
        st_, _, payload = await r.http(addr, "GET", "/pub/open.txt?acl", creds=user)
        assert json.loads(payload)["acl"] == "public-read"
        assert (await r.http(addr, "PUT", "/pub/open.txt?acl=private",
                             creds=user))[0] == 200
        assert (await r.http(addr, "GET", "/pub/open.txt"))[0] == 403
        assert (await r.http(addr, "PUT", "/pub?acl=public-read-write",
                             creds=user))[0] == 400
        assert (await r.http(addr, "PUT", "/pub/x", body=b"y"))[0] == 403

    twin(scenario)


def test_range_reads():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/b", creds=user)
        body = bytes(range(256)) * 64  # 16 KiB, multi-stripe
        await r.http(addr, "PUT", "/b/o", body=body, creds=user)
        cases = {
            "bytes=0-99": body[:100],
            "bytes=100-199": body[100:200],
            "bytes=16300-": body[16300:],
            "bytes=-50": body[-50:],
            "bytes=0-999999": body,  # end clamped
        }
        for hdr, want in cases.items():
            st_, h, payload = await r.http(addr, "GET", "/b/o", headers={"range": hdr},
                                           creds=user)
            assert st_ == 206 and payload == want, hdr
            assert h["content-range"].endswith(f"/{len(body)}"), hdr
        st_, h, _ = await r.http(addr, "GET", "/b/o", headers={"range": "bytes=999999-"},
                                 creds=user)
        assert st_ == 416 and h["content-range"] == f"bytes */{len(body)}"
        for hdr in ("bytes=0-1,5-9", "lines=0-4"):
            st_, _, payload = await r.http(addr, "GET", "/b/o", headers={"range": hdr},
                                           creds=user)
            assert st_ == 200 and payload == body, hdr

    twin(scenario)


def test_conditional_requests():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/b", creds=user)
        body = b"versioned content"
        _st, h, _ = await r.http(addr, "PUT", "/b/o", body=body, creds=user)
        etag = h["etag"]
        assert (await r.http(addr, "GET", "/b/o", headers={"if-none-match": etag},
                             creds=user))[0] == 304
        st_, _, payload = await r.http(addr, "GET", "/b/o",
                                       headers={"if-none-match": "deadbeef"}, creds=user)
        assert st_ == 200 and payload == body
        assert (await r.http(addr, "GET", "/b/o", headers={"if-match": etag},
                             creds=user))[0] == 200
        assert (await r.http(addr, "GET", "/b/o", headers={"if-match": "deadbeef"},
                             creds=user))[0] == 412

    twin(scenario)


def test_no_existence_oracle_for_private_buckets():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/priv", creds=user)
        await r.http(addr, "PUT", "/priv/real", body=b"x", creds=user)
        for path in ("/priv/real", "/priv/ghost"):
            assert (await r.http(addr, "GET", path))[0] == 403, path
        assert (await r.http(addr, "GET", "/priv/ghost", creds=user))[0] == 404
        for hdr in ("bytes=5-3", "bytes=--5"):
            st_, _, payload = await r.http(addr, "GET", "/priv/real",
                                           headers={"range": hdr}, creds=user)
            assert st_ == 200 and payload == b"x", hdr

    twin(scenario)


def test_acl_subresource_is_signed():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/b", creds=user)
        await r.http(addr, "PUT", "/b/o", body=b"x", creds=user)
        # a signature for the bare path, sent with ?acl appended
        h = {"content-length": "0", "date": DATE}
        h["authorization"] = r.P.http.auth_header(user["access_key"], user["secret_key"],
                                                  "PUT", "/b/o", h)
        assert (await r.http(addr, "PUT", "/b/o?acl=public-read", headers=h))[0] == 403
        assert (await r.http(addr, "GET", "/b/o"))[0] == 403  # still private

    twin(scenario)


def test_multipart_objects_honor_initiate_acl():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/b", creds=user)
        _st, _, payload = await r.http(addr, "POST", "/b/big?uploads",
                                       headers={"x-amz-acl": "public-read"}, creds=user)
        up = json.loads(payload)["uploadId"]
        part = b"P" * 4096
        await r.http(addr, "PUT", f"/b/big?uploadId={up}&partNumber=1", body=part,
                     creds=user)
        assert (await r.http(addr, "POST", f"/b/big?uploadId={up}", creds=user))[0] == 200
        st_, _, payload = await r.http(addr, "GET", "/b/big")  # anonymous
        assert st_ == 200 and payload == part

    twin(scenario)


# -- TestUserMetadata -------------------------------------------------------------


def test_meta_roundtrip_and_copy_directive():
    async def scenario(r):
        s, user = await _user_store(r)
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/b", creds=user)
        st_, _, _ = await r.http(addr, "PUT", "/b/o", body=b"x",
                                 headers={"x-amz-meta-color": "teal", "x-amz-meta-rev": "7"},
                                 creds=user)
        assert st_ == 200
        for method in ("GET", "HEAD"):
            st_, h, _ = await r.http(addr, method, "/b/o", creds=user)
            assert st_ == 200 and h["x-amz-meta-color"] == "teal"
            assert h["x-amz-meta-rev"] == "7"
        await r.call("copy", s.copy_object("b", "o", "b", "o2"))
        _st, h, _ = await r.http(addr, "HEAD", "/b/o2", creds=user)
        assert h["x-amz-meta-color"] == "teal"
        await r.call("copy replace", s.copy_object("b", "o", "b", "o3", meta={"rev": "8"}))
        _st, h, _ = await r.http(addr, "HEAD", "/b/o3", creds=user)
        assert "x-amz-meta-color" not in h and h["x-amz-meta-rev"] == "8"
        _st, _, payload = await r.http(addr, "POST", "/b/big?uploads",
                                       headers={"x-amz-meta-origin": "mp"}, creds=user)
        up = json.loads(payload)["uploadId"]
        await r.http(addr, "PUT", f"/b/big?uploadId={up}&partNumber=1", body=b"P" * 2048,
                     creds=user)
        assert (await r.http(addr, "POST", f"/b/big?uploadId={up}", creds=user))[0] == 200
        _st, h, _ = await r.http(addr, "HEAD", "/b/big", creds=user)
        assert h["x-amz-meta-origin"] == "mp"

    twin(scenario)


# -- TestBulkDeleteHeadBucket ------------------------------------------------------


def test_multi_delete_and_head_bucket():
    async def scenario(r):
        s, user = await _user_store(r)
        other = await r.call("create_user bob", s.create_user("bob"))
        addr = await r.gateway(s)
        await r.http(addr, "PUT", "/b", creds=user)
        for k in ("a", "d/e", "f"):
            await r.http(addr, "PUT", f"/b/{k}", body=b"x", creds=user)
        st_, _, payload = await r.http(
            addr, "POST", "/b?delete",
            body=json.dumps({"objects": ["a", "d/e", "ghost"]}).encode(), creds=user)
        assert st_ == 200
        out = json.loads(payload)
        assert sorted(out["deleted"]) == ["a", "d/e", "ghost"] and out["errors"] == []
        listing = await r.call("list", s.list_objects("b"))
        assert [c["key"] for c in listing["contents"]] == ["f"]
        assert (await r.http(addr, "HEAD", "/b", creds=user))[0] == 200
        assert (await r.http(addr, "HEAD", "/b", creds=other))[0] == 403
        assert (await r.http(addr, "HEAD", "/nosuch", creds=user))[0] == 404
        assert (await r.http(addr, "POST", "/b?delete", body=b"not json",
                             creds=user))[0] == 400

    twin(scenario)


# -- the gateway's admin socket (tests/test_histograms.py) ---------------------------


def test_rgw_admin_socket(tmp_path):
    """The gateway's admin socket answers ``dump_histograms``, ``perf
    schema``, ``dump_kernel_profile`` and ``perf reset``; the port's is
    opened with ``device="cpu"``.  Counts, types and the command list are
    held equal; latencies are timings and are not compared."""

    async def scenario(r):
        sock = str(tmp_path / f"{r.P.name}-{{name}}.asok")
        s = await r.store()
        addr = await r.gateway(s, stats_interval=0, admin_socket=sock)
        user = await r.call("create_user", s.create_user("alice"))
        assert (await r.http(addr, "PUT", "/b", creds=user))[0] == 200
        assert (await r.http(addr, "PUT", "/b/k", body=b"x" * 2048, creds=user))[0] == 200
        path = sock.replace("{name}", "rgw.default")
        cmd = r.P.admin_command
        hists = await cmd(path, "dump_histograms")
        assert r.note("count", hists["rgw"]["req_latency_histogram"]["count"]) >= 2
        schema = await cmd(path, "perf schema")
        assert r.note("type", schema["rgw"]["req_latency_histogram"]["type"]) == "histogram"
        r.note("rgw schema", schema["rgw"])
        prof = await cmd(path, "dump_kernel_profile")
        assert r.note("engines", "engines" in prof)
        status = await cmd(path, "status")
        r.note("status", dict(status, addr=r._unaddr(status["addr"])))
        assert "success" in r.note("reset", await cmd(path, "perf reset"))
        perf = await cmd(path, "perf dump")
        assert r.note("req_put", perf["rgw"]["req_put"]) == 0
        r.note("families", sorted(perf))
        r.note("commands", sorted((await cmd(path, "no such command"))["commands"]))

    twin(scenario)


# -- rgw series in the mgr's prometheus output (tests/test_observability.py) --------


def test_metrics_expose_all_subsystems():
    """The mgr's ``metrics`` carries the messenger, mon, rgw, EC-engine
    and osd series, the gateway's reported by its stats loop."""
    want = (
        'ceph_msgr_msg_send{daemon="osd.',
        'ceph_mon_map_publishes{daemon="mon.0"}',
        'ceph_rgw_req_put{daemon="rgw.default(',
        'ceph_msgr_msg_send{daemon="rgw.default(',
        'ceph_ec_encode_gbps{daemon="osd.',
        'ceph_osd_op_latency_sum{',
        'ceph_osd_op_latency_count{',
        'ceph_mgr_commands{daemon="mgr.',
    )

    async def scenario(r):
        cluster = r.cluster
        await cluster.start_mgr()
        await cluster.wait_for_active_mgr()
        cl = await cluster.client()
        await cl.create_pool("ecp", "erasure")
        await cl.io_ctx("ecp").write_full("eobj", bytes(range(256)) * 32)
        s = await r.store()
        addr = await r.gateway(s, stats_interval=0.1)
        user = await r.call("create_user", s.create_user("alice"))
        assert (await r.http(addr, "PUT", "/b", creds=user))[0] == 200
        assert (await r.http(addr, "PUT", "/b/k", body=b"data", creds=user))[0] == 200
        async with asyncio.timeout(20):
            while True:
                rc, metrics = await r.P.mgr_command(cl, {"prefix": "metrics"})
                assert rc == 0
                if all(w in metrics for w in want):
                    break
                await asyncio.sleep(0.2)
        line = next(ln for ln in metrics.splitlines()
                    if ln.startswith("ceph_ec_encode_gbps")
                    and not ln.endswith(" 0") and not ln.endswith(" 0.0"))
        assert float(line.rsplit(" ", 1)[1]) > 0
        r.note("series", [w for w in want if w in metrics])

    twin(scenario, n_osds=4, cluster_kw={"config_overrides": {"osd_mgr_report_interval": 0.1}})


# -- the striper's ops -------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(offset=st.integers(0, 1 << 20), length=st.integers(0, 1 << 20),
       su=st.sampled_from([1024, 4096]), sc=st.integers(1, 5), spo=st.integers(1, 8))
def test_object_runs_place_the_bytes_the_extent_table_places(offset, length, su, sc, spo):
    """``StripedLayout.object_runs`` (one run a backing object and
    contiguous range) places every byte of the caller's buffer where the
    reference's extent table does."""
    from ceph_tpu.rados.striper import StripedLayout as RefLayout
    from ceph_tpu_torch.rados.striper import StripedLayout

    def placed(extents):
        out = set()
        for obj, ooff, n, boff in extents:
            out.update((int(obj), int(ooff) + i, int(boff) + i) for i in range(0, int(n), 509))
            out.add((int(obj), int(ooff) + int(n) - 1, int(boff) + int(n) - 1))
        return out

    ref = RefLayout(su, sc, su * spo).extent_table(offset, length)
    runs = StripedLayout(su, sc, su * spo).object_runs(offset, length)
    got = [(obj, base + r0, n, b0) for obj, base, _len, pieces in runs for b0, r0, n in pieces]
    assert placed(got) == placed(zip(*ref))
    for _obj, _base, run_len, pieces in runs:
        assert sum(n for _b, _r, n in pieces) == run_len  # a run is contiguous
    assert len({(obj, base) for obj, base, _l, _p in runs}) == len(runs)


def test_striper_writes_and_reads_one_op_a_backing_object():
    """A 4 MiB striped object at the default layout takes 4 writes and 4
    reads in the port (one a backing object), where the reference takes
    1024 of each; the reference's striper reads the port's object back
    and the other way round."""
    from ceph_tpu.rados.striper import StripedObject as RefStriped
    from ceph_tpu_torch.rados.striper import StripedObject

    body = bytes(range(256)) * (16 << 10)

    async def main():
        async with PORT.rados.MiniCluster(n_osds=3, **PORT.kw) as cluster:
            mon = cluster.monmap or cluster.mon.addr
            port_cl = await PORT.rados.RadosClient(mon).connect()
            ref_cl = await REF.rados.RadosClient(mon).connect()
            await port_cl.create_pool("s", "replicated", size=2)
            io, ref_io = port_cl.io_ctx("s"), ref_cl.io_ctx("s")
            ops = {"write": 0, "read": 0}
            for op in ops:
                plain = getattr(io, op)

                async def counted(*a, _plain=plain, _op=op, **kw):
                    ops[_op] += 1
                    return await _plain(*a, **kw)

                setattr(io, op, counted)
            await StripedObject(io, "big").write(body)
            assert bytes(await StripedObject(io, "big").read()) == body
            assert ops == {"write": 4, "read": 4}
            assert bytes(await RefStriped(ref_io, "big").read()) == body
            await RefStriped(ref_io, "ref").write(body)
            assert bytes(await StripedObject(io, "ref").read()) == body

    run(main())


# -- crosses ---------------------------------------------------------------------------


@pytest.mark.parametrize("cluster_pkg", [REF, PORT], ids=["ref-cluster", "port-cluster"])
def test_packages_read_back_each_others_objects(cluster_pkg):
    """On one package's cluster, each package's ``RGWStore`` over its own
    client, and each package's gateway, read back equal what the other
    wrote: users and keys, bucket records, index entries, plain and
    multipart objects, ranges and listings."""

    async def main():
        async with cluster_pkg.rados.MiniCluster(n_osds=3, **cluster_pkg.kw) as cluster:
            mon = cluster.monmap or cluster.mon.addr
            stores, gws = {}, {}
            for P in (REF, PORT):
                cl = await P.rados.RadosClient(mon).connect()
                stores[P.name] = await P.rgw.RGWStore.create(cl)
                gws[P.name] = P.http.S3Server(stores[P.name], stats_interval=0, **P.gw_kw)
            try:
                addrs = {n: await g.start() for n, g in gws.items()}
                user = await stores["ref"].create_user("alice")
                assert await stores["port"].get_user("alice") == user
                body = bytes(range(256)) * 70
                for writer, reader in (("ref", "port"), ("port", "ref")):
                    W = REF if writer == "ref" else PORT
                    R = PORT if writer == "ref" else REF
                    bucket = f"from-{writer}"
                    assert (await http(W, addrs[writer], "PUT", f"/{bucket}",
                                       creds=user))[0] == 200
                    st_, h, _ = await http(W, addrs[writer], "PUT", f"/{bucket}/obj",
                                           body=body, creds=user,
                                           headers={"x-amz-meta-k": "v"})
                    assert st_ == 200
                    up = await stores[writer].init_multipart(bucket, "mp")
                    await stores[writer].upload_part(bucket, "mp", up, 2, b"B" * 5000)
                    await stores[writer].upload_part(bucket, "mp", up, 1, b"A" * 7000)
                    await stores[writer].complete_multipart(bucket, "mp", up)
                    # the other package's store reads the same entries and bytes
                    for key, want in (("obj", body), ("mp", b"A" * 7000 + b"B" * 5000)):
                        got_w = await stores[writer].get_object(bucket, key)
                        got_r = await stores[reader].get_object(bucket, key)
                        assert got_r == got_w and got_r[0] == want
                    assert await stores[reader].bucket_info(bucket) == \
                        await stores[writer].bucket_info(bucket)
                    assert await stores[reader].list_objects(bucket) == \
                        await stores[writer].list_objects(bucket)
                    assert await stores[reader].bucket_stats(bucket) == \
                        await stores[writer].bucket_stats(bucket)
                    # ... and the other package's gateway serves them
                    for path, hdrs in ((f"/{bucket}/obj", {}), (f"/{bucket}/mp", {}),
                                       (f"/{bucket}/obj", {"range": "bytes=100-4099"}),
                                       (f"/{bucket}?prefix=m", {})):
                        want = await http(W, addrs[writer], "GET", path, headers=hdrs,
                                          creds=user)
                        got = await http(R, addrs[reader], "GET", path, headers=hdrs,
                                         creds=user)
                        assert got == want and want[0] in (200, 206), path
                    await stores[reader].delete_object(bucket, "obj")
                    await r_missing(stores[writer], bucket, "obj", W)
            finally:
                for g in gws.values():
                    await g.stop()

    async def r_missing(store, bucket, key, P):
        with pytest.raises(P.rgw.RGWError):
            await store.head_object(bucket, key)

    run(main())
