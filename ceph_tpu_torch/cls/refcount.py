"""Reference counting on objects (reference:src/cls/refcount/).

RGW uses this to share one RADOS object between logical copies: ``get``
adds a tag, ``put`` drops one, and the object self-destructs when the
last tag goes (the reference returns -ENOENT sentinel behavior via
``cls_cxx_remove``; here ``put`` reports ``{"last": true}`` and the
OSD's call op removes the object when asked to).

Counterpart of ``ceph_tpu/cls/refcount.py``, whole.
"""

from __future__ import annotations

from . import (
    CLS_METHOD_RD,
    CLS_METHOD_WR,
    ClsError,
    EINVAL,
    ENOENT,
    MethodContext,
    register_class,
)

_KEY = "refcount"

cls = register_class("refcount")


def _refs(ctx: MethodContext) -> list[str]:
    d = ctx.get_json(_KEY)
    return d["refs"] if d else []


@cls.method("get", CLS_METHOD_RD | CLS_METHOD_WR)
def get(ctx: MethodContext, input: dict) -> dict:
    tag = input.get("tag")
    if not tag:
        raise ClsError(EINVAL, "refcount.get: need tag")
    refs = _refs(ctx)
    if tag not in refs:
        refs.append(tag)
    ctx.set_json(_KEY, {"refs": refs})
    return {"count": len(refs)}


@cls.method("put", CLS_METHOD_RD | CLS_METHOD_WR)
def put(ctx: MethodContext, input: dict) -> dict:
    tag = input.get("tag")
    refs = _refs(ctx)
    if tag not in refs:
        # implicit ref semantics: an untagged object counts as one ref
        # (reference:cls_refcount_put with no set yet)
        if refs:
            raise ClsError(ENOENT, f"no ref {tag!r}")
        return {"count": 0, "last": True}
    refs.remove(tag)
    ctx.set_json(_KEY, {"refs": refs})
    return {"count": len(refs), "last": not refs}


@cls.method("read", CLS_METHOD_RD)
def read(ctx: MethodContext, input: dict) -> dict:
    return {"refs": _refs(ctx)}
