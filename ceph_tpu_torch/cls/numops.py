"""Numeric read-modify-write on omap values (reference:src/cls/numops/
cls_numops.cc).

The reference stores decimal strings in omap values and exposes atomic
``add`` and ``mul`` (subtract/divide are client-side negate/reciprocal,
reference:src/cls/numops/client.cc): the in-OSD RMW makes concurrent
counters race-free without watch/notify or compare-and-swap loops.
Values parse as floats (the reference uses strtod); a non-numeric
stored value answers -EBADMSG exactly like the reference.

Counterpart of ``ceph_tpu/cls/numops.py``, whole.
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

EBADMSG = 74

cls = register_class("numops")


def _apply(ctx: MethodContext, input: dict, op) -> dict:
    key = input.get("key")
    if not key:
        raise ClsError(EINVAL, "numops: need key")
    try:
        diff = float(input["value"])
    except (KeyError, TypeError, ValueError):
        raise ClsError(EINVAL, "numops: need numeric value") from None
    raw = ctx.omap_get_keys([key]).get(key)
    if raw is None:
        cur = 0.0
    else:
        try:
            cur = float(raw.decode())
        except (UnicodeDecodeError, ValueError):
            raise ClsError(
                EBADMSG, f"stored value for {key!r} is not a number"
            ) from None
    new = op(cur, diff)
    # integers print without a trailing .0, like the reference's %lf
    # trimming in practice (values round-trip through strtod)
    text = repr(int(new)) if float(new).is_integer() else repr(new)
    ctx.omap_set({key: text.encode()})
    return {"value": text}


@cls.method("add", CLS_METHOD_RD | CLS_METHOD_WR)
def add(ctx: MethodContext, input: dict) -> dict:
    return _apply(ctx, input, lambda a, b: a + b)


@cls.method("mul", CLS_METHOD_RD | CLS_METHOD_WR)
def mul(ctx: MethodContext, input: dict) -> dict:
    return _apply(ctx, input, lambda a, b: a * b)
