"""Lightweight tracepoints and the trace context
(reference:src/tracing/*.tp, common/EventTrace).

Counterpart of ``ceph_tpu/common/tracing.py``, whole, with the port's own
context variables and its own copy of the hop manifest
(``hop_manifest.json`` beside this file).  The op path sets
``current_trace`` and ``current_client`` once, and every task and call
below inherits them, so a flight record names the trace and the client
of each op it carried without any parameter threading.  The messenger
stamps ``current_trace`` into every outbound frame (minting an id where
none is set) and restores it before it dispatches an inbound one, so one
op's id follows it across processes: an OSD's dispatcher, the wire, the
accelerator daemon's dispatcher.  These are the port's variables, not
the reference's: a process that hosts the port's dispatcher must set
these.

A provider is a named ring buffer of timestamped events, cheap enough
to leave enabled, dumpable via the admin socket (``dump_tracepoints``)
and inspectable in tests.  Spans (``with provider.span("encode",
oid=...)``) record begin/end pairs with the elapsed time, the EventTrace
analog.  Every span gets a **stable id** (``<trace>/<entity>/<hop>`` for
waterfall spans, ``<provider>:<seq>`` for context-manager spans) and a
**parent link** to the enclosing span, so a merged timeline can render
nesting (the device wall inside the execute hop).  Every tracepoint
auto-attaches the active trace id; :func:`events_for_trace` merges the
per-provider rings back into that op's cross-daemon timeline, and
:func:`op_waterfall` folds the structured span events into ordered,
duration-attributed hops (the ``dump_op_waterfall`` admin body).

Cross-process timestamps: span events recorded in ANOTHER process ride
reply piggybacks with the sender's monotonic stamps; the receiver
aligns them through the messenger's clock table
(common/clocksync.py) before recording, and the alignment
``uncertainty`` field stays on the event — a waterfall built from
multi-process spans says how much its ordering can be trusted.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import time
from collections import deque
from typing import Any, Iterator

_providers: dict[str, "TraceProvider"] = {}
_default_capacity = 4096

# the committed span hop-name vocabulary: every hop name
# record_span/feed_hop sees must appear here — each one becomes a
# stack.lat_<hop> histogram and a ceph_stack_lat_<hop>_bucket
# prometheus family, so the manifest is the cardinality bound.
HOP_MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "hop_manifest.json"
)
_hop_manifest: frozenset[str] | None = None


def hop_manifest() -> frozenset[str]:
    """The committed hop-name set (loaded once per process)."""
    global _hop_manifest
    if _hop_manifest is None:
        with open(HOP_MANIFEST_PATH) as f:
            _hop_manifest = frozenset(json.load(f)["hops"])
    return _hop_manifest

# the active trace id for this task tree (None = untraced work)
current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "ceph_tpu_torch_trace", default=None
)
# the enclosing span's id (parent link for nested spans)
current_span: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "ceph_tpu_torch_span", default=None
)
# the originating client id for this task tree: set once at
# op dispatch, read wherever attribution is needed (EC dispatch _Op
# capture, flight records) — the same zero-threading pattern as
# current_trace, so deep call chains never grow a client= parameter
current_client: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "ceph_tpu_torch_client", default=None
)
_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)


def new_trace_id(origin: str) -> str:
    """Mint an origin-stamped trace id (``client.1:t17`` style) — unique
    per process, readable in dumps."""
    return f"{origin}:t{next(_trace_seq)}"


class TraceProvider:
    """One subsystem's tracepoint provider (an ``osd.tp`` analog)."""

    def __init__(self, name: str, capacity: int | None = None):
        self.name = name
        self.enabled = True
        self.capacity = int(capacity if capacity is not None
                            else _default_capacity)
        self._events: deque[dict] = deque(maxlen=self.capacity)
        # eviction accounting: a truncated timeline must be VISIBLY
        # truncated (dump carries dropped totals), not silently short
        self.dropped = 0
        self._dropped_at_dump = 0

    def set_capacity(self, capacity: int) -> None:
        """Re-size the ring live (``trace_ring_capacity`` observer),
        keeping the newest events; anything shed counts as dropped."""
        capacity = max(1, int(capacity))
        if capacity == self.capacity:
            return
        old = list(self._events)
        kept = old[-capacity:]
        self.dropped += len(old) - len(kept)
        self.capacity = capacity
        self._events = deque(kept, maxlen=capacity)

    def point(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return  # before the timestamp: a disabled provider is free
        self.point_at(time.monotonic(), event, **fields)

    def point_at(self, ts: float, event: str, **fields: Any) -> None:
        """Record an event with an explicit timestamp (spans aligned
        from another process carry translated stamps, not 'now')."""
        if not self.enabled:
            return
        fields.setdefault("trace", current_trace.get())
        if len(self._events) >= self.capacity:
            self.dropped += 1  # deque eviction is silent; this is not
        self._events.append({"ts": ts, "event": event, **fields})

    @contextlib.contextmanager
    def span(self, event: str, **fields: Any) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        # capture the trace id ONCE at entry: an enter/exit pair that
        # straddles a context switch (the exit running after the
        # dispatcher restored a different op's context) must land under
        # the trace that OPENED the span, not whatever is active at
        # exit — re-reading current_trace in the finally block filed
        # the two points under two different ops
        trace = fields.pop("trace", None)
        if trace is None:
            trace = current_trace.get()
        span_id = f"{self.name}:{next(_span_seq)}"
        parent = current_span.get()
        tok = current_span.set(span_id)
        t0 = time.monotonic()
        self.point(f"{event}_enter", trace=trace, span_id=span_id,
                   **({"parent": parent} if parent else {}), **fields)
        try:
            yield
        finally:
            current_span.reset(tok)
            self.point(
                f"{event}_exit", elapsed=time.monotonic() - t0,
                trace=trace, span_id=span_id,
                **({"parent": parent} if parent else {}), **fields
            )

    def events(self, event: str | None = None) -> list[dict]:
        return [
            e for e in self._events if event is None or e["event"] == event
        ]

    def clear(self) -> None:
        self._events.clear()

    def dump(self) -> dict:
        since = self.dropped - self._dropped_at_dump
        self._dropped_at_dump = self.dropped
        return {"name": self.name, "enabled": self.enabled,
                "capacity": self.capacity,
                "dropped": self.dropped,
                "dropped_since_dump": since,
                "events": list(self._events)}


def tracepoint_provider(name: str) -> TraceProvider:
    """Get-or-create, like TracepointProvider::instance
    (reference:src/common/TracepointProvider.h)."""
    if name not in _providers:
        _providers[name] = TraceProvider(name)
    return _providers[name]


def set_ring_capacity(capacity: int) -> None:
    """``trace_ring_capacity`` (live Option): re-size every provider's
    ring — existing AND future (the default applies at creation)."""
    global _default_capacity
    _default_capacity = max(1, int(capacity))
    for p in _providers.values():
        p.set_capacity(_default_capacity)


def dump_all(trace: str | None = None) -> dict:
    """Every provider's ring; ``trace`` filters each ring to one op."""
    out = {n: p.dump() for n, p in _providers.items()}
    if trace is not None:
        for d in out.values():
            d["events"] = [e for e in d["events"] if e.get("trace") == trace]
    return out


def events_for_trace(trace: str) -> list[dict]:
    """One op's cross-daemon timeline: every provider's events carrying
    this trace id, merged and time-ordered (the ``dump_tracepoints``
    reconstruction contract)."""
    merged = [
        {**e, "provider": name}
        for name, p in _providers.items()
        for e in p.events()
        if e.get("trace") == trace
    ]
    merged.sort(key=lambda e: e["ts"])
    return merged


# -- structured waterfall spans ----------------------------------------------

# the provider every waterfall span lands in (its own ring so a chatty
# oprequest/ec ring cannot evict a sampled op's hops)
STACK_PROVIDER = "stack"


def span_id_for(trace: str, entity: str, hop: str) -> str:
    """The STABLE id of one op's hop span: the same hop of the same op
    gets the same id wherever it is recorded (locally at the daemon
    that measured it, and again at the client that received the reply
    piggyback) — :func:`op_waterfall` dedupes on it, preferring the
    copy with the smaller alignment uncertainty."""
    return f"{trace}/{entity}/{hop}"


def record_span(hop: str, t0: float, dur: float, *, trace: str,
                entity: str, parent: str | None = None,
                uncertainty: float | None = None,
                **fields: Any) -> dict:
    """Record one hop span into the ``stack`` provider ring.  ``t0``
    is in THIS process's monotonic timeline (align cross-process
    stamps through clocksync first, and pass the alignment
    ``uncertainty``); ``dur`` in seconds.  ``parent`` is the enclosing
    hop's span id (None = a top-level path hop — only path hops sum
    against the client wall)."""
    ev = {
        "hop": hop,
        "dur": max(0.0, float(dur)),
        "span_id": span_id_for(trace, entity, hop),
        "entity": entity,
        **({"parent": parent} if parent else {}),
        **({"uncertainty": round(float(uncertainty), 9)}
           if uncertainty is not None else {}),
        **fields,
    }
    tracepoint_provider(STACK_PROVIDER).point_at(
        float(t0), "span", trace=trace, **ev
    )
    return ev


def has_spans(trace: str) -> bool:
    """Whether this process's ``stack`` ring already holds span events
    for ``trace`` — true when the daemon that measured them shares our
    process.  The client uses this to record only its OWN reply-side
    hops in that case: re-recording aligned reconstructions next to
    the true-clock originals would mix two rigid timelines in one
    waterfall, and per-span dedupe could then pick copies from
    different frames (a reordering no real clock ever produced)."""
    p = _providers.get(STACK_PROVIDER)
    if p is None:
        return False
    return any(
        e.get("event") == "span" and e.get("trace") == trace
        for e in p._events
    )


def op_waterfall(trace: str) -> dict:
    """One op's hop waterfall: the structured span events carrying
    ``trace``, deduped by stable span id (keep the lowest-uncertainty
    copy), time-ordered, with nesting resolved.  ``path_sum_s`` sums
    only top-level (parentless) hops — the honesty number the
    acceptance test holds against the client-observed wall time;
    ``dominant_hop`` names where the op's microseconds went.

    Any span carrying a ``client`` field (the OSD stamps its hops with
    the originating tenant id) surfaces it as a top-level ``client``
    key, so "whose op was this" reads straight off the waterfall."""
    spans: dict[str, dict] = {}
    for name, p in _providers.items():
        for e in p.events():
            if e.get("event") != "span" or e.get("trace") != trace:
                continue
            sid = e.get("span_id")
            if sid is None:
                continue
            cur = spans.get(sid)
            if cur is None or (
                e.get("uncertainty", 0.0) < cur.get("uncertainty", 0.0)
            ):
                spans[sid] = dict(e)
    if not spans:
        return {"trace": trace, "client": None, "hops": [],
                "path_sum_s": 0.0, "span_s": 0.0, "dominant_hop": None,
                "max_uncertainty_s": 0.0}
    # start-time order; at an exact tie the SHORTER span sorts first
    # (a zero-duration hop ends where its same-start neighbor begins —
    # a clamped-to-zero wire must still render before dispatch)
    ordered = sorted(spans.values(), key=lambda e: (e["ts"], e["dur"]))
    t_base = ordered[0]["ts"]
    client = next(
        (e["client"] for e in ordered if e.get("client") is not None),
        None,
    )
    hops = []
    path_sum = 0.0
    dominant = (None, -1.0)
    max_unc = 0.0
    for e in ordered:
        top_level = "parent" not in e
        if top_level:
            path_sum += e["dur"]
            if e["dur"] > dominant[1]:
                dominant = (e["hop"], e["dur"])
        max_unc = max(max_unc, e.get("uncertainty", 0.0))
        hops.append({
            "hop": e["hop"],
            "entity": e.get("entity", ""),
            "start_s": round(e["ts"] - t_base, 9),
            "dur_s": round(e["dur"], 9),
            **({"parent": e["parent"]} if not top_level else {}),
            **({"uncertainty_s": e["uncertainty"]}
               if "uncertainty" in e else {}),
        })
    span_s = max(
        (e["ts"] + e["dur"]) for e in ordered
    ) - t_base
    return {
        "trace": trace,
        "client": client,
        "hops": hops,
        "path_sum_s": round(path_sum, 9),
        "span_s": round(span_s, 9),
        "dominant_hop": dominant[0],
        "max_uncertainty_s": round(max_unc, 9),
    }
