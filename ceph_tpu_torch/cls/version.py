"""Object-version class (reference:src/cls/version/cls_version.cc).

Tracks a monotonically increasing {ver, tag} pair on one object, with
conditional bumps — the primitive RGW's metadata cache coherence is
built on: a writer bumps the version iff its cached {ver, tag} still
matches, so a racing writer's update cannot be silently overwritten.

Methods (mirroring cls_version_ops.h):
- ``set``         unconditional overwrite of {ver, tag}
- ``inc``         ver += 1 (fresh random-ish tag kept)
- ``inc_conds``   ver += 1 iff every condition holds, else -ECANCELED
- ``read``        current {ver, tag}
- ``check_conds`` read-only condition check, -ECANCELED on mismatch

Conditions are {"ver": N, "cmp": op} / {"tag": T, "cmp": "eq"} with op
in eq/ne/gt/ge/lt/le (cls_version's VER_COND_* set).

Counterpart of ``ceph_tpu/cls/version.py``, whole.
"""

from __future__ import annotations

from . import (
    CLS_METHOD_RD,
    CLS_METHOD_WR,
    ClsError,
    EINVAL,
    MethodContext,
    register_class,
)

ECANCELED = 125

VER_KEY = "cls_version"

cls = register_class("version")

_CMPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}


def _read_ver(ctx: MethodContext) -> dict:
    return ctx.get_json(VER_KEY) or {"ver": 0, "tag": ""}


def _check(cur: dict, conds: list) -> bool:
    for c in conds:
        cmp = _CMPS.get(c.get("cmp", "eq"))
        if cmp is None:
            raise ClsError(EINVAL, f"bad cmp {c.get('cmp')!r}")
        if "ver" in c:
            if not cmp(int(cur["ver"]), int(c["ver"])):
                return False
        elif "tag" in c:
            if not cmp(cur["tag"], str(c["tag"])):
                return False
        else:
            raise ClsError(EINVAL, "condition needs ver or tag")
    return True


@cls.method("set", CLS_METHOD_WR)
def set_(ctx: MethodContext, input: dict) -> dict:
    ver = {"ver": int(input.get("ver", 0)), "tag": str(input.get("tag", ""))}
    ctx.set_json(VER_KEY, ver)
    return {"objv": ver}


@cls.method("inc", CLS_METHOD_RD | CLS_METHOD_WR)
def inc(ctx: MethodContext, input: dict) -> dict:
    cur = _read_ver(ctx)
    cur["ver"] = int(cur["ver"]) + 1
    if input.get("tag"):
        cur["tag"] = str(input["tag"])
    ctx.set_json(VER_KEY, cur)
    return {"objv": cur}


@cls.method("inc_conds", CLS_METHOD_RD | CLS_METHOD_WR)
def inc_conds(ctx: MethodContext, input: dict) -> dict:
    cur = _read_ver(ctx)
    if not _check(cur, list(input.get("conds", []))):
        raise ClsError(ECANCELED, "version conditions failed")
    cur["ver"] = int(cur["ver"]) + 1
    if input.get("tag"):
        cur["tag"] = str(input["tag"])
    ctx.set_json(VER_KEY, cur)
    return {"objv": cur}


@cls.method("read", CLS_METHOD_RD)
def read(ctx: MethodContext, input: dict) -> dict:
    return {"objv": _read_ver(ctx)}


@cls.method("check_conds", CLS_METHOD_RD)
def check_conds(ctx: MethodContext, input: dict) -> dict:
    cur = _read_ver(ctx)
    if not _check(cur, list(input.get("conds", []))):
        raise ClsError(ECANCELED, "version conditions failed")
    return {"objv": cur}
