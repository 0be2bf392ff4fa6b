"""Time-indexed log class (reference:src/cls/log/cls_log.cc).

An omap-backed append log ordered by timestamp — the primitive the
reference's RGW metadata/data change logs (mdlog/datalog) and multisite
sync machinery ride on.  (This framework's gateway keeps its own
equivalent change log in ``rgw/store.py`` ``_log_change``, which
predates this class; the class is provided for parity and for user
workloads.)  Keys are ``1_<ts>_<counter>`` (the reference's
LOG_INDEX_PREFIX + timestamp encoding): zero-padded so lexicographic
omap order IS time order, with a per-call counter to keep concurrent
same-timestamp entries distinct.

Methods (mirroring cls_log_ops.h):
- ``add``        append entries [{ts?, section, name, data}]
- ``list``       time-window page [from, to) after ``marker``,
                 returns entries + marker + truncated
- ``trim``       delete [from, to) or everything up to ``to_marker``
- ``info``       header {max_marker, max_time}

Timestamps are float seconds; entries carry them back out unmodified.
The ranged reads ride MethodContext.omap_get_range, so list/trim touch
only the window, never the whole log.

Counterpart of ``ceph_tpu/cls/log.py``, whole.
"""

from __future__ import annotations

import json

from . import (
    CLS_METHOD_RD,
    CLS_METHOD_WR,
    ClsError,
    EINVAL,
    MethodContext,
    register_class,
)

HEADER_KEY = "cls_log_header"
PREFIX = "1_"  # the reference's log-index key namespace

cls = register_class("log")


def _ts_key(ts: float, counter: int) -> str:
    # ON-DISK FORMAT, frozen: fixed-width 17.6f covers dates far past
    # 2100 with µs resolution; the 12-digit seq keeps lexicographic ==
    # numeric to 10^12 entries.  Widths must never change again — keys
    # of different widths interleave wrongly under the same timestamp
    return f"{PREFIX}{ts:017.6f}_{counter:012d}"


def _header(ctx: MethodContext) -> dict:
    return ctx.get_json(HEADER_KEY) or {
        "max_marker": "", "max_time": 0.0, "seq": 0,
    }


@cls.method("add", CLS_METHOD_RD | CLS_METHOD_WR)
def add(ctx: MethodContext, input: dict) -> dict:
    entries = input.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ClsError(EINVAL, "log.add: need entries list")
    hdr = _header(ctx)
    # the counter is a header-resident GLOBAL sequence, never derived
    # from max_marker: entries added with a timestamp older than
    # max_time would re-derive the same counter and silently overwrite
    # each other — and out-of-order
    # timestamps are exactly the clock-skew case a shared log sees
    seq = int(hdr.get("seq", 0))
    kv: dict[str, bytes] = {}
    for e in entries:
        if "section" not in e and "name" not in e and "data" not in e:
            raise ClsError(EINVAL, "log.add: entry needs section/name/data")
        ts = float(e.get("ts", hdr["max_time"]))
        key = _ts_key(ts, seq)
        seq += 1
        kv[key] = json.dumps({
            "ts": ts,
            "section": str(e.get("section", "")),
            "name": str(e.get("name", "")),
            "data": e.get("data", ""),
        }).encode()
        if key > hdr["max_marker"]:
            hdr["max_marker"] = key
        if ts > hdr["max_time"]:
            hdr["max_time"] = ts
    hdr["seq"] = seq
    ctx.omap_set(kv)
    ctx.set_json(HEADER_KEY, hdr)
    return {"header": hdr}


def _window(input: dict) -> tuple[str, str]:
    """[from, to) as key-space bounds; to=0/absent means unbounded."""
    t_from = float(input.get("from", 0.0))
    t_to = float(input.get("to", 0.0))
    lo = _ts_key(t_from, 0)
    hi = _ts_key(t_to, 0) if t_to > 0 else PREFIX + "~"  # '~' > digits
    return lo, hi


@cls.method("list", CLS_METHOD_RD)
def list_(ctx: MethodContext, input: dict) -> dict:
    max_entries = int(input.get("max_entries", 1000))
    if max_entries <= 0:
        raise ClsError(EINVAL, "log.list: max_entries must be positive")
    lo, hi = _window(input)
    marker = str(input.get("marker", ""))
    start = marker if marker else lo
    # keys strictly after start: omap_get_range is exclusive at
    # start_after, so the window's first key needs a just-below cursor
    start_after = start if marker else _just_below(lo)
    # the truncated flag must mean "more entries IN THE [from, to)
    # WINDOW", not "more keys under the prefix" (keys at or past
    # `to` would make the reply claim truncated=true and the caller's
    # next page come back empty, so pagination would never end).
    # Gather one entry PAST the budget: its existence is the proof.
    entries = []
    while len(entries) <= max_entries:
        page, more = ctx.omap_get_range(
            start_after=start_after, prefix=PREFIX,
            max_entries=min(1000, max_entries + 1 - len(entries)),
        )
        keys = [k for k in sorted(page) if k < hi]
        for k in keys:
            entries.append({"marker": k, **json.loads(page[k])})
            if len(entries) > max_entries:
                break
        if len(keys) < len(page):  # crossed the window's end
            break
        if not more or not page:
            break
        start_after = max(page)
    truncated = len(entries) > max_entries
    entries = entries[:max_entries]
    return {
        "entries": entries,
        "marker": entries[-1]["marker"] if entries else marker,
        "truncated": truncated,
    }


def _just_below(key: str) -> str:
    """Greatest string strictly below ``key`` for start_after cursors."""
    return key[:-1] + chr(ord(key[-1]) - 1) + "\x7f" if key else ""


@cls.method("trim", CLS_METHOD_RD | CLS_METHOD_WR)
def trim(ctx: MethodContext, input: dict) -> dict:
    lo, hi = _window(input)
    to_marker = str(input.get("to_marker", ""))
    if to_marker:
        hi = to_marker + "\x00"  # inclusive trim up to the marker
    removed = 0
    start_after = _just_below(lo)
    while True:
        page, more = ctx.omap_get_range(
            start_after=start_after, prefix=PREFIX, max_entries=1000
        )
        keys = [k for k in sorted(page) if k < hi]
        if keys:
            ctx.omap_rm(keys)
            removed += len(keys)
        if not more or not page or len(keys) < len(page):
            break
        start_after = max(page)
    return {"removed": removed}


@cls.method("info", CLS_METHOD_RD)
def info(ctx: MethodContext, input: dict) -> dict:
    return {"header": _header(ctx)}
