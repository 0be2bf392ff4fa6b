"""The port's Swift dialect of the gateway held against the reference's,
on the CPU.

Twins of the five cases of ``tests/test_rgw_swift.py`` (the TempAuth
token flow, account, container and object verbs, listings with prefix
and delimiter, COPY, container HEAD and PUT semantics, S3 and Swift over
one store, object metadata across both APIs).  Each runs one scenario on
the reference's ``MiniCluster`` with the reference's gateway and on the
port's with the port's (``tests/test_torch_rgw.py``'s ``twin``: the same
seeded keys and stepping clock in both, every status, header set and
body recorded through ``urllib`` as the reference's cases send them, and
every object of the gateway's pools after the scenario), and the two
records must be equal.  The tokens carry the clock's expiry, so they are
equal too; the storage URL's address is written ``{addr}``.
"""

import asyncio
import json
import urllib.error
import urllib.request

from tests.test_torch_rgw import twin


def _req(addr, method, path, body=None, headers=None):
    r = urllib.request.Request(f"http://{addr}{path}", data=body, headers=headers or {},
                               method=method)
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class Swift:
    """A scenario's gateway and its recorded urllib round trips."""

    def __init__(self, r):
        self.r = r

    async def start(self):
        self.store = await self.r.store()
        self.user = await self.r.call("create_user acct",
                                      self.store.create_user("acct", "Account One"))
        self.addr = await self.r.gateway(self.store)
        return self

    async def req(self, method, path, body=None, headers=None):
        loop = asyncio.get_running_loop()
        st, h, payload = await loop.run_in_executor(
            None, lambda: _req(self.addr, method, path, body, headers))
        h = {k.lower(): self.r._unaddr(v) for k, v in h.items()}
        self.r.note(f"{method} {path}", (st, h, payload))
        return st, h, payload

    async def token(self, uid="acct", key=None):
        _st, h, _ = await self.req("GET", "/auth/v1.0", None, {
            "X-Auth-User": f"{uid}:swift",
            "X-Auth-Key": key or self.user["secret_key"]})
        return {"X-Auth-Token": h["x-auth-token"]}

    def s3(self, method, path, body=None, extra=None):
        headers = {"Date": "Thu, 17 Nov 2005 18:49:58 GMT"}
        if body:
            headers["Content-Type"] = "application/octet-stream"
        headers.update(extra or {})
        headers["Authorization"] = self.r.P.http.auth_header(
            self.user["access_key"], self.user["secret_key"], method, path, headers)
        return self.req(method, path, body, headers)


def test_auth_and_object_lifecycle():
    async def scenario(r):
        g = await Swift(r).start()
        st, h, _ = await g.req("GET", "/auth/v1.0", None, {
            "X-Auth-User": "acct:swift", "X-Auth-Key": g.user["secret_key"]})
        assert st == 200 and "x-auth-token" in h
        T = {"X-Auth-Token": h["x-auth-token"]}
        base = f"/v1/AUTH_{g.user['uid']}"
        assert (await g.req("GET", "/auth/v1.0", None, {
            "X-Auth-User": "acct:swift", "X-Auth-Key": "wrong"}))[0] == 401
        assert (await g.req("GET", base))[0] == 401
        assert (await g.req("PUT", f"{base}/photos", None, T))[0] == 201
        assert (await g.req("PUT", f"{base}/photos/cat.jpg", b"meow",
                            {**T, "Content-Type": "image/jpeg"}))[0] == 201
        st, h, body = await g.req("GET", f"{base}/photos/cat.jpg", None, T)
        assert st == 200 and body == b"meow" and h["content-type"] == "image/jpeg"
        assert (await g.req("HEAD", f"{base}/photos/cat.jpg", None, T))[0] == 200
        st, _h, body = await g.req("GET", base, None, T)
        assert st == 200 and b"photos" in body
        st, _h, body = await g.req("GET", f"{base}/photos", None, T)
        assert st == 200 and body == b"cat.jpg\n"
        _st, _h, body = await g.req("GET", f"{base}/photos?format=json", None, T)
        listing = json.loads(body)
        assert listing[0]["name"] == "cat.jpg" and listing[0]["bytes"] == 4
        assert (await g.req("COPY", f"{base}/photos/cat.jpg", None,
                            {**T, "Destination": "/photos/copy.jpg"}))[0] == 201
        assert (await g.req("GET", f"{base}/photos/copy.jpg", None, T))[2] == b"meow"
        for p in ("photos/cat.jpg", "photos/copy.jpg"):
            assert (await g.req("DELETE", f"{base}/{p}", None, T))[0] == 204
        assert (await g.req("DELETE", f"{base}/photos", None, T))[0] == 204

    twin(scenario)


def test_container_head_put_semantics_and_s3_auth_buckets():
    async def scenario(r):
        g = await Swift(r).start()
        other = await r.call("create_user other", g.store.create_user("other"))
        T = await g.token()
        base = f"/v1/AUTH_{g.user['uid']}"
        assert (await g.req("PUT", f"{base}/cont", None, T))[0] == 201
        assert (await g.req("PUT", f"{base}/cont", None, T))[0] == 202
        await g.req("PUT", f"{base}/cont/a", b"12345", T)
        st, h, _ = await g.req("HEAD", f"{base}/cont", None, T)
        assert st == 204 and h["x-container-object-count"] == "1"
        assert h["x-container-bytes-used"] == "5"
        T2 = await g.token("other", other["secret_key"])
        assert (await g.req("PUT", "/v1/AUTH_other/cont", None, T2))[0] == 403
        # an S3 bucket whose name merely starts with "auth" routes to S3
        assert (await g.s3("PUT", "/authors"))[0] == 200

    twin(scenario)


def test_prefix_delimiter_listing():
    async def scenario(r):
        g = await Swift(r).start()
        T = await g.token()
        base = f"/v1/AUTH_{g.user['uid']}"
        await g.req("PUT", f"{base}/c", None, T)
        for k in ("a/1", "a/2", "b/1", "top"):
            assert (await g.req("PUT", f"{base}/c/{k}", b"x", T))[0] == 201
        _st, _h, body = await g.req("GET", f"{base}/c?delimiter=/", None, T)
        assert set(body.decode().split()) == {"a/", "b/", "top"}
        _st, _h, body = await g.req("GET", f"{base}/c?prefix=a/", None, T)
        assert set(body.decode().split()) == {"a/1", "a/2"}

    twin(scenario)


def test_s3_and_swift_share_the_store():
    async def scenario(r):
        g = await Swift(r).start()
        assert (await g.s3("PUT", "/shared"))[0] == 200
        assert (await g.s3("PUT", "/shared/from-s3", b"s3 bytes"))[0] == 200
        T = await g.token()
        base = f"/v1/AUTH_{g.user['uid']}"
        st, _h, body = await g.req("GET", f"{base}/shared/from-s3", None, T)
        assert st == 200 and body == b"s3 bytes"
        assert (await g.req("PUT", f"{base}/shared/from-swift", b"swift", T))[0] == 201
        st, _h, body = await g.s3("GET", "/shared/from-swift")
        assert st == 200 and body == b"swift"

    twin(scenario)


def test_object_metadata_roundtrips_across_both_apis():
    async def scenario(r):
        g = await Swift(r).start()
        T = await g.token()
        base = f"/v1/AUTH_{g.user['uid']}"
        await g.req("PUT", f"{base}/c", None, T)
        assert (await g.req("PUT", f"{base}/c/o", b"x",
                            {**T, "X-Object-Meta-Color": "teal"}))[0] == 201
        _st, h, _ = await g.req("HEAD", f"{base}/c/o", None, T)
        assert h["x-object-meta-color"] == "teal"
        entry = await r.call("head", g.store.head_object("c", "o"))
        assert entry["meta"] == {"color": "teal"}

    twin(scenario)
