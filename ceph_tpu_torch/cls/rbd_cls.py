"""RBD helper class (reference:src/cls/rbd/cls_rbd.cc dir_* methods).

The image directory must be mutated atomically — a bare
read-check-then-omap_set from the client races concurrent creates.
These methods run under the PG lock like every cls call, so
name-claiming is linearized exactly as the reference's
``dir_add_image``/``dir_remove_image``/``dir_rename_image`` are.

Counterpart of ``ceph_tpu/cls/rbd_cls.py``, whole.
"""

from __future__ import annotations

from . import (
    CLS_METHOD_RD,
    CLS_METHOD_WR,
    ClsError,
    EEXIST,
    ENOENT,
    EINVAL,
    MethodContext,
    register_class,
)

cls = register_class("rbd")


@cls.method("dir_add", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_add(ctx: MethodContext, input: dict) -> dict:
    name, image_id = input.get("name"), input.get("id")
    if not name or not image_id:
        raise ClsError(EINVAL, "dir_add: need name and id")
    omap = ctx.omap_get()
    if f"name_{name}" in omap:
        raise ClsError(EEXIST, f"image {name!r} exists")
    if f"id_{image_id}" in omap:
        raise ClsError(EEXIST, f"image id {image_id!r} exists")
    ctx.omap_set({
        f"name_{name}": image_id.encode(),
        f"id_{image_id}": name.encode(),
    })
    return {}


@cls.method("dir_remove", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_remove(ctx: MethodContext, input: dict) -> dict:
    name, image_id = input.get("name"), input.get("id")
    omap = ctx.omap_get()
    if omap.get(f"name_{name}") != (image_id or "").encode():
        raise ClsError(ENOENT, f"no image {name!r} with id {image_id!r}")
    ctx.omap_rm([f"name_{name}", f"id_{image_id}"])
    return {}


@cls.method("child_add", CLS_METHOD_RD | CLS_METHOD_WR)
def child_add(ctx: MethodContext, input: dict) -> dict:
    """Register a clone under parent@snap — atomic under the PG lock,
    like the reference's cls_rbd add_child (a client-side
    read-modify-write would lose concurrent registrations)."""
    key, child = input.get("key"), input.get("child")
    if not key or not child:
        raise ClsError(EINVAL, "child_add: need key and child")
    import json as _json

    omap = ctx.omap_get()
    ids = _json.loads(omap.get(key, b"[]"))
    if child not in ids:
        ids.append(child)
        ctx.omap_set({key: _json.dumps(ids).encode()})
    return {"children": ids}


@cls.method("child_remove", CLS_METHOD_RD | CLS_METHOD_WR)
def child_remove(ctx: MethodContext, input: dict) -> dict:
    key, child = input.get("key"), input.get("child")
    import json as _json

    omap = ctx.omap_get()
    ids = _json.loads(omap.get(key, b"[]"))
    ids = [c for c in ids if c != child]
    if ids:
        ctx.omap_set({key: _json.dumps(ids).encode()})
    else:
        ctx.omap_rm([key])
    return {"children": ids}


@cls.method("children_get", CLS_METHOD_RD)
def children_get(ctx: MethodContext, input: dict) -> dict:
    import json as _json

    omap = ctx.omap_get()
    return {
        "children": _json.loads(omap.get(input.get("key", ""), b"[]"))
    }


@cls.method("dir_rename", CLS_METHOD_RD | CLS_METHOD_WR)
def dir_rename(ctx: MethodContext, input: dict) -> dict:
    src, dst = input.get("src"), input.get("dst")
    omap = ctx.omap_get()
    raw = omap.get(f"name_{src}")
    if raw is None:
        raise ClsError(ENOENT, f"no image {src!r}")
    if f"name_{dst}" in omap:
        raise ClsError(EEXIST, f"image {dst!r} exists")
    image_id = raw.decode()
    ctx.omap_set({
        f"name_{dst}": raw,
        f"id_{image_id}": dst.encode(),
    })
    ctx.omap_rm([f"name_{src}"])
    return {}
