"""Advisory object locks (reference:src/cls/lock/cls_lock.cc).

The reference's rados lock class: named locks on an object, exclusive
or shared, owned by (entity, cookie) pairs, with optional expiration —
used by rbd exclusive-lock and rgw.  State lives in one xattr per lock
name (the reference uses a lock_info_t attr keyed ``lock.<name>``).

Methods: ``lock`` (acquire), ``unlock`` (release), ``break_lock``
(evict another owner), ``get_info``, ``list_locks``.

Counterpart of ``ceph_tpu/cls/lock.py``, whole.
"""

from __future__ import annotations

import json
import time

from . import (
    CLS_METHOD_RD,
    CLS_METHOD_WR,
    ClsError,
    EBUSY,
    ENOENT,
    EINVAL,
    MethodContext,
    register_class,
)

LOCK_NONE = 0
LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

_PREFIX = "lock."

cls = register_class("lock")


def _key(name: str) -> str:
    return _PREFIX + name


def _now() -> float:
    return time.time()


def _load(ctx: MethodContext, name: str) -> dict:
    info = ctx.get_json(_key(name)) or {
        "type": LOCK_NONE, "lockers": {}, "tag": ""
    }
    # expire stale owners on every touch (reference checks expiration at
    # lock/unlock/get_info time, cls_lock.cc lock_obj)
    live = {}
    for owner, ent in info["lockers"].items():
        if ent.get("expires", 0) and ent["expires"] < _now():
            continue
        live[owner] = ent
    info["lockers"] = live
    if not live:
        info["type"] = LOCK_NONE
    return info


def _owner(input: dict) -> str:
    ent = input.get("entity", "client")
    cookie = input.get("cookie", "")
    return f"{ent}\x1f{cookie}"


@cls.method("lock", CLS_METHOD_RD | CLS_METHOD_WR)
def lock(ctx: MethodContext, input: dict) -> dict:
    name = input.get("name")
    ltype = int(input.get("type", LOCK_EXCLUSIVE))
    if not name or ltype not in (LOCK_EXCLUSIVE, LOCK_SHARED):
        raise ClsError(EINVAL, "lock: need name and a valid type")
    info = _load(ctx, name)
    owner = _owner(input)
    tag = input.get("tag", "")
    if info["lockers"]:
        if info["tag"] != tag:
            raise ClsError(EBUSY, "lock held with a different tag")
        if ltype == LOCK_EXCLUSIVE or info["type"] == LOCK_EXCLUSIVE:
            if list(info["lockers"]) != [owner]:
                raise ClsError(EBUSY, "lock held")
    duration = float(input.get("duration", 0))
    info["type"] = ltype
    info["tag"] = tag
    info["lockers"][owner] = {
        "description": input.get("description", ""),
        "expires": _now() + duration if duration else 0,
    }
    ctx.set_json(_key(name), info)
    _index_update(ctx, name, held=True)
    return {}


@cls.method("unlock", CLS_METHOD_RD | CLS_METHOD_WR)
def unlock(ctx: MethodContext, input: dict) -> dict:
    name = input.get("name")
    info = _load(ctx, name)
    owner = _owner(input)
    if owner not in info["lockers"]:
        raise ClsError(ENOENT, "not the lock owner")
    del info["lockers"][owner]
    if not info["lockers"]:
        info["type"] = LOCK_NONE
        _index_update(ctx, name, held=False)
    ctx.set_json(_key(name), info)
    return {}


@cls.method("break_lock", CLS_METHOD_RD | CLS_METHOD_WR)
def break_lock(ctx: MethodContext, input: dict) -> dict:
    """Evict a (possibly dead) owner — rbd's fence path."""
    name = input.get("name")
    info = _load(ctx, name)
    victim = f"{input.get('entity', '')}\x1f{input.get('cookie', '')}"
    if victim not in info["lockers"]:
        raise ClsError(ENOENT, "no such locker")
    del info["lockers"][victim]
    if not info["lockers"]:
        info["type"] = LOCK_NONE
        _index_update(ctx, name, held=False)
    ctx.set_json(_key(name), info)
    return {}


@cls.method("get_info", CLS_METHOD_RD)
def get_info(ctx: MethodContext, input: dict) -> dict:
    info = _load(ctx, input.get("name"))
    return {
        "type": info["type"],
        "tag": info["tag"],
        "lockers": [
            {
                "entity": owner.split("\x1f")[0],
                "cookie": owner.split("\x1f", 1)[1],
                **ent,
            }
            for owner, ent in sorted(info["lockers"].items())
        ],
    }


def _index_update(ctx: MethodContext, name: str, held: bool) -> None:
    """Lock names live in xattr keys; the context exposes only
    get-by-key, so a name index is stored alongside (the reference
    iterates the attr map instead).  Released names are pruned."""
    idx = ctx.get_json(_PREFIX + "_index") or {"names": []}
    names = set(idx["names"])
    want = (names | {name}) if held else (names - {name})
    if want != names:
        ctx.set_json(_PREFIX + "_index", {"names": sorted(want)})


@cls.method("list_locks", CLS_METHOD_RD)
def list_locks(ctx: MethodContext, input: dict) -> dict:
    names = []
    idx = ctx.get_json(_PREFIX + "_index")
    if idx:
        names = [n for n in idx.get("names", []) if _load(ctx, n)["lockers"]]
    return {"names": names}
