"""Accelerator fault domain: the EC engine health state machine.

Counterpart of ``ceph_tpu/osd/ec_failover.py``, whole.  The card sits
in the middle of every EC write and degraded read; without this layer
it is a silent single point of failure: a device-side error in a
batched launch fails every waiter, and a *hung* device call stalls ops
with no health signal.  This module
applies the reference's worker-liveness disciplines
(reference:src/common/HeartbeatMap.{h,cc} grace/suicide-grace;
``ms_inject_socket_failures``-style injection for proving it) to the
accelerator:

- :class:`EngineSupervisor` — a per-engine circuit breaker::

      HEALTHY --fatal--> SUSPECT --fatal--> TRIPPED <--> PROBING
         ^                  |                              |
         +----success-------+            canary ok --------+

  Launch failures are split by ``classify_engine_error``
  (models/matrix_codec): CUDA errors / OOM / kernel build or launch
  failures advance the breaker; data-shape errors surface to the caller
  untouched.  A blown launch deadline (a wedged device call) trips
  immediately — a hang is never transient.

- **failover replay** — the dispatcher (osd/ec_dispatch) replays the
  in-flight batch on the host fallback engine
  (ec_util.encode_fallback / decode_concat_fallback — native C or the
  numpy oracle, all pinned bit-identical to the device engines), so no
  waiter ever observes a device error.

- **re-promotion** — while TRIPPED, a background canary probe (one
  one-stripe encode on the device engine, checked byte-for-byte
  against the host oracle) runs on exponential backoff
  (``osd_ec_probe_interval`` doubling up to 32x); a verified probe
  promotes the engine back to HEALTHY.

While TRIPPED/PROBING the supervisor reports ``degraded`` to the OSD:
the ``ec.engine_state`` gauge feeds the mgr's ``ACCEL_DEGRADED``
health check, and the QoS scheduler squeezes background EC pacing to
reservation rate (capacity shrank — osd/scheduler.py
``capacity_degraded``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable

from ..models.matrix_codec import classify_engine_error

logger = logging.getLogger("ceph_tpu_torch.ec_failover")

# engine states (the ec.engine_state gauge values)
HEALTHY, SUSPECT, TRIPPED, PROBING = 0, 1, 2, 3
STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect",
               TRIPPED: "tripped", PROBING: "probing"}

# a SUSPECT engine decays back to HEALTHY if no second fatal error
# lands within this window (one isolated transient must not pin the
# breaker half-open forever)
SUSPECT_WINDOW_S = 30.0

# probe backoff ceiling: base * 2^5 (a dead device is probed ~every
# 32 * osd_ec_probe_interval seconds at steady state)
PROBE_BACKOFF_MAX_FACTOR = 32


class EngineSupervisor:
    """Health state machine for ONE device engine (the dispatcher's
    device batch lane).  The fallback engine needs no supervisor: it is
    the floor the failover lands on.

    ``perf`` is the owning daemon's ``ec`` PerfCounters (None for a
    standalone supervisor — dump() still carries its own totals).
    ``on_degraded(bool)`` fires on every TRIPPED/recovered edge (the
    OSD points it at the QoS scheduler's capacity_degraded flag).
    ``probe`` is an async callable returning True when the device
    engine produced oracle-identical bytes (the dispatcher installs
    its canary); without one a TRIPPED engine stays tripped until an
    operator clears it.
    """

    def __init__(self, *, enabled: bool = True,
                 probe_interval: float = 1.0,
                 perf=None,
                 on_degraded: Callable[[bool], None] | None = None,
                 probe: Callable[[], Awaitable[bool]] | None = None):
        self.enabled = bool(enabled)
        self.probe_interval = float(probe_interval)
        self._perf = perf
        self._on_degraded = on_degraded
        self.probe = probe
        self.state = HEALTHY
        self._suspect_at = 0.0
        self._probe_task: asyncio.Task | None = None
        self._stopping = False
        # dump()-side history, independent of the perf wiring
        # (mesh_fatal_errors slices fatal_errors by the dispatcher's
        # mesh lane — a slice losing one chip shows up HERE first)
        self.totals = {"fatal_errors": 0, "data_errors": 0,
                       "mesh_fatal_errors": 0,
                       "timeouts": 0, "trips": 0, "probes": 0,
                       "promotions": 0}
        self.last_failure: str | None = None
        self.last_failure_lane: str | None = None
        self.last_transition = time.monotonic()
        self._set_gauge()

    # -- queries -------------------------------------------------------------

    def device_ok(self) -> bool:
        """May the dispatcher launch on the device engine?  TRIPPED and
        PROBING route around it (the canary is the only device traffic
        until re-promotion); a disabled supervisor never gates."""
        return not self.enabled or self.state in (HEALTHY, SUSPECT)

    @property
    def degraded(self) -> bool:
        return self.enabled and self.state in (TRIPPED, PROBING)

    # -- transitions ---------------------------------------------------------

    def set_enabled(self, value: bool) -> None:
        """``osd_ec_engine_failover`` live toggle.  Disabling while
        TRIPPED/PROBING must restore the pre-failover world completely:
        back to HEALTHY (the gauge clears, so ACCEL_DEGRADED drops) and
        the QoS capacity squeeze released — a breaker the operator
        turned OFF must not keep throttling the cluster, even if the
        device really is sick (that is now the operator's call)."""
        value = bool(value)
        if self.enabled == value:
            return
        self.enabled = value
        if not value and self.state != HEALTHY:
            logger.warning(
                "EC engine failover disabled while %s: resetting to "
                "healthy (pre-failover behavior)",
                STATE_NAMES[self.state],
            )
            self._transition(HEALTHY)
            self._notify_degraded(False)

    def record_failure(self, exc: BaseException,
                       lane: str = "device") -> str:
        """Classify a launch failure; fatal errors advance the breaker
        (HEALTHY -> SUSPECT -> TRIPPED).  Returns the classification so
        the dispatcher can decide replay-vs-surface with one call.
        ``lane`` names the dispatcher route that failed ("device" /
        "mesh") — the mesh slice shares this breaker (one accelerator
        fault domain: losing a single chip in the slice fails the mesh
        program exactly like losing the only chip), but the
        dump attributes the failure so the operator can tell a sick
        mesh from a sick chip."""
        kind = classify_engine_error(exc)
        if kind != "fatal":
            self.totals["data_errors"] += 1
            return kind
        self.totals["fatal_errors"] += 1
        if lane == "mesh":
            self.totals["mesh_fatal_errors"] += 1
        self.last_failure = repr(exc)[:200]
        self.last_failure_lane = lane
        if not self.enabled:
            return kind
        now = time.monotonic()
        if self.state == HEALTHY or (
            self.state == SUSPECT
            and now - self._suspect_at > SUSPECT_WINDOW_S
        ):
            # first fatal (or first after a quiet window): half-open
            self._transition(SUSPECT)
            self._suspect_at = now
        elif self.state == SUSPECT:
            self._trip("second fatal error within the suspect window")
        # TRIPPED/PROBING: the canary's own failures land here too —
        # no further transition, the probe loop handles backoff
        return kind

    def record_timeout(self, deadline: float) -> None:
        """A launch blew ``osd_ec_launch_deadline``: the device call is
        wedged, and a hang is never transient — trip immediately."""
        self.totals["timeouts"] += 1
        self.last_failure = f"launch exceeded {deadline:g}s deadline"
        # PROBING is still inside the tripped domain: a wedged CANARY
        # must not re-trip (inflating totals, re-firing on_degraded,
        # resetting since_s) — the probe loop routes it back to TRIPPED
        if self.enabled and self.state not in (TRIPPED, PROBING):
            self._trip("launch deadline blown (wedged device call)")

    def record_success(self) -> None:
        """A device launch completed with good bytes: SUSPECT decays
        back to HEALTHY (the breaker closes)."""
        if self.state == SUSPECT:
            self._transition(HEALTHY)

    def _trip(self, why: str) -> None:
        self.totals["trips"] += 1
        logger.warning("EC device engine TRIPPED: %s (last failure: %s)",
                       why, self.last_failure)
        self._transition(TRIPPED)
        self._notify_degraded(True)
        self._start_probe_loop()

    def _promote(self) -> None:
        self.totals["promotions"] += 1
        logger.info("EC device engine re-promoted (canary verified)")
        self._transition(HEALTHY)
        self._notify_degraded(False)

    def _notify_degraded(self, flag: bool) -> None:
        if self._on_degraded is not None:
            try:
                self._on_degraded(flag)
            except Exception:  # swallow-ok: a notification hook must not wedge the state machine
                pass

    def _transition(self, state: int) -> None:
        self.state = state
        self.last_transition = time.monotonic()
        self._set_gauge()

    def _set_gauge(self) -> None:
        if self._perf is not None:
            try:
                self._perf.set("engine_state", self.state)
            except Exception:  # swallow-ok: observability is best-effort by contract
                pass

    def refresh_gauge(self) -> None:
        """Re-assert ``ec.engine_state`` (called off the OSD's report
        tick): the gauge is otherwise only written on transitions, so
        an admin ``perf reset`` would zero it and a TRIPPED OSD would
        read healthy at the mgr — silently clearing ACCEL_DEGRADED
        while EC still serves from the fallback engine."""
        self._set_gauge()

    # -- the canary probe loop -----------------------------------------------

    def _start_probe_loop(self) -> None:
        if self.probe is None or self._stopping:
            return
        if self._probe_task is not None and not self._probe_task.done():
            return
        try:
            self._probe_task = asyncio.ensure_future(self._probe_loop())
        # swallow-ok: no running event loop (sync-context tests) — the engine stays TRIPPED, the safe state
        except RuntimeError:
            self._probe_task = None

    async def _probe_loop(self) -> None:
        """Exponential-backoff canary: one-stripe encode on the device
        engine, checked against the host oracle; success re-promotes."""
        backoff = max(0.01, self.probe_interval)
        cap = backoff * PROBE_BACKOFF_MAX_FACTOR
        try:
            while not self._stopping and self.state in (TRIPPED, PROBING):
                await asyncio.sleep(backoff)
                if self._stopping or self.state not in (TRIPPED, PROBING):
                    return
                self._transition(PROBING)
                self.totals["probes"] += 1
                ok = False
                try:
                    ok = bool(await self.probe())
                # swallow-ok: a probe raising IS a failed probe — it routes back to TRIPPED below
                except Exception as e:
                    self.last_failure = repr(e)[:200]
                if self._stopping:
                    return
                if ok:
                    self._promote()
                    return
                self._transition(TRIPPED)
                backoff = min(backoff * 2, cap)
        # swallow-ok: probe loop cancelled at supervisor stop (teardown)
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        self._stopping = True
        t = self._probe_task
        if t is not None and not t.done():
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):  # swallow-ok: teardown drain
                pass
        self._probe_task = None

    # -- admin ---------------------------------------------------------------

    def dump(self) -> dict:
        """``dump_engine_health`` admin-socket body."""
        return {
            "enabled": self.enabled,
            "state": STATE_NAMES[self.state],
            "since_s": round(time.monotonic() - self.last_transition, 3),
            "probe_interval_s": self.probe_interval,
            "probe_pending": (
                self._probe_task is not None
                and not self._probe_task.done()
            ),
            "last_failure": self.last_failure,
            "last_failure_lane": self.last_failure_lane,
            "totals": dict(self.totals),
        }
