"""Per-peer monotonic clock-offset estimation (NTP-style).

Counterpart of ``ceph_tpu/common/clocksync.py``, whole.

``time.monotonic()`` is only guaranteed comparable within one process,
but the op waterfall (common/tracing.py ``op_waterfall``) must merge
span timestamps recorded by daemons in *different* processes into one
ordered timeline.  The messenger therefore runs a tiny NTP-style
exchange over every connection (``MClockSync`` ping/pong, plus a probe
at connection start): four timestamps

    t0      requester's clock at probe send
    t_rx    responder's clock at probe receive
    t_tx    responder's clock at pong send
    t3      requester's clock at pong receive

yield the classic midpoint estimate (RFC 5905 s8, the reference mon's
clock-skew check in ``Monitor::timecheck`` does the same arithmetic)::

    offset      = ((t_rx - t0) + (t_tx - t3)) / 2    # peer - local
    rtt         = (t3 - t0) - (t_tx - t_rx)
    uncertainty = rtt / 2                            # worst-case error

The uncertainty bound is exact for arbitrary ASYMMETRIC path delays:
the true offset always lies within ±rtt/2 of the estimate (the error
is (d_fwd - d_back)/2).  Estimates are re-taken periodically
(``ms_clock_sync_interval``) and the table keeps, per peer, the
lowest-uncertainty estimate that is still fresh — one lucky low-RTT
exchange beats many congested ones, but a stale estimate must not pin
the table forever (clocks drift, peers restart).

Estimates live **per connection** (`Connection._clock`, one
single-entry table each): peer entity names are NOT unique across
processes — auto-assigned client names restart at ``client.1`` in
every process, so a name-keyed global table would thrash between two
unrelated clocks the moment two client processes hit one OSD.  The
process-global :func:`clock_table` is an observability MIRROR (it
backs ``dump_clock_sync`` and is keyed by entity name, best/last
writer wins) — alignment decisions always read the connection's own
estimate.
"""

from __future__ import annotations

import threading
import time

# a held estimate older than this is replaced by ANY fresh estimate,
# whatever its uncertainty: monotonic clocks drift apart and a pinned
# "precise" estimate goes stale (the re-estimation contract)
ESTIMATE_MAX_AGE_S = 30.0


class ClockTable:
    """Per-peer offset estimates (see module docstring)."""

    def __init__(self, max_age: float = ESTIMATE_MAX_AGE_S):
        self._lock = threading.Lock()
        self._peers: dict[str, dict] = {}
        self.max_age = float(max_age)

    # -- estimation ----------------------------------------------------------

    def observe(self, peer: str, t0: float, t_rx: float, t_tx: float,
                t3: float) -> dict | None:
        """Fold one four-timestamp exchange into the table; returns the
        estimate adopted (or None for a garbage sample: a pong that
        "arrived before" its ping, which a reordered or replayed frame
        could produce)."""
        rtt = (t3 - t0) - (t_tx - t_rx)
        if rtt < 0 or not peer:
            return None
        offset = ((t_rx - t0) + (t_tx - t3)) / 2.0
        now = time.monotonic()
        est = {
            "offset_s": offset,
            "uncertainty_s": rtt / 2.0,
            "rtt_s": rtt,
            "at": now,           # when THIS estimate was taken
            "checked_at": now,   # last sample that (re)confirmed it
            "samples": 1,
        }
        with self._lock:
            cur = self._peers.get(peer)
            if cur is not None:
                est["samples"] = cur["samples"] + 1
                age = est["at"] - cur["at"]
                if (age <= self.max_age
                        and cur["uncertainty_s"] <= est["uncertainty_s"]):
                    # the held estimate is both fresher-than-max-age and
                    # tighter: keep it, but mark it re-CHECKED — the
                    # probe scheduler keys freshness on checked_at, so
                    # a confirming pong quiets the cadence instead of
                    # being discarded and re-requested (age-out for
                    # drift still keys on the original 'at')
                    cur["samples"] = est["samples"]
                    cur["checked_at"] = now
                    return dict(cur)
            self._peers[peer] = est
            return dict(est)

    # -- reads ---------------------------------------------------------------

    def offset(self, peer: str) -> dict | None:
        with self._lock:
            est = self._peers.get(peer)
            return dict(est) if est is not None else None

    def fresh(self, peer: str, interval: float) -> bool:
        """Whether the held estimate was (re)confirmed within
        ``interval`` (the probe scheduler's "no need to re-probe yet"
        check) — a confirming sample counts even when it did not
        replace the held values."""
        with self._lock:
            est = self._peers.get(peer)
            if est is None:
                return False
            return time.monotonic() - est["checked_at"] < interval

    def align(self, peer: str,
              remote_ts: float) -> "tuple[float, float] | None":
        """Translate ``remote_ts`` (the peer's monotonic clock) into
        this process's monotonic timeline: ``(local_ts,
        uncertainty_s)``, or None when the peer was never estimated
        (the caller records the span unaligned or skips the hop)."""
        with self._lock:
            est = self._peers.get(peer)
            if est is None:
                return None
            return remote_ts - est["offset_s"], est["uncertainty_s"]

    def dump(self) -> dict:
        """Admin-socket body (``dump_clock_sync``)."""
        now = time.monotonic()
        with self._lock:
            return {
                peer: {
                    "offset_s": round(est["offset_s"], 9),
                    "uncertainty_s": round(est["uncertainty_s"], 9),
                    "rtt_s": round(est["rtt_s"], 9),
                    "age_s": round(now - est["at"], 3),
                    "samples": est["samples"],
                }
                for peer, est in sorted(self._peers.items())
            }

    def clear(self) -> None:
        with self._lock:
            self._peers.clear()


_table: ClockTable | None = None
_table_lock = threading.Lock()


def clock_table() -> ClockTable:
    """The process-global observability MIRROR (``dump_clock_sync``):
    keyed by peer entity name, so same-named peers from different
    processes overwrite each other here — which is why alignment
    decisions read the per-connection estimate instead (see module
    docstring)."""
    global _table
    if _table is None:
        with _table_lock:
            if _table is None:
                _table = ClockTable()
    return _table
