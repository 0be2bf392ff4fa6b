"""The port's config table and the QoS scheduler it configures.

- The option table equals the reference's: the same names, types,
  defaults and choices, so a daemon of either package reads the same
  settings (and the accelerator daemon's ``osd_mclock_scheduler_*``,
  ``osd_op_queue*``, ``osd_ec_*``, ``ec_inject_*``, ``ms_*`` and
  ``osd_op_thread_*`` knobs mean the same thing in both).
- ``Config`` layering and observers behave as the reference's.
- Twins of the unit cases of the reference's
  ``tests/test_qos_scheduler.py`` (all but the live-cluster wiring and
  ``AsyncReserver``, whose module waits for the port's OSD), run on
  ``ceph_tpu_torch.osd.scheduler``; the dispatcher class-lane cases run
  the port's dispatcher on a CPU codec's batching lane.

Every async body runs under ``asyncio.wait_for`` (:func:`run`).
"""

import asyncio
import os

import numpy as np
import pytest

from ceph_tpu_torch.common.config import OPTIONS, Config
from ceph_tpu_torch.osd.scheduler import (
    BEST_EFFORT,
    CLASSES,
    OpScheduler,
    QosDeferred,
    QosSpec,
)

# every async body's limit: the slowest case (the fifo storm) takes
# well under a second
ASYNC_LIMIT_S = 30.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, ASYNC_LIMIT_S))


# -- the option table ---------------------------------------------------------


def test_option_table_equals_the_reference():
    from ceph_tpu.common.config import OPTIONS as REF

    def table(opts):
        return {n: (o.type, o.default, getattr(o, "choices", None))
                for n, o in opts.items()}

    assert table(OPTIONS) == table(REF)
    assert list(OPTIONS) == list(REF)


def test_defaults_show_and_diff_equal_the_reference():
    from ceph_tpu.common.config import Config as RefConfig

    cfg, ref = Config(env=""), RefConfig(env="")
    assert cfg.show() == ref.show()
    overrides = {"osd_ec_dispatch_window": "0.002", "ms_op_batch_max": 4,
                 "osd_op_queue": "wpq", "osd_ec_engine_failover": "false"}
    cfg, ref = Config(overrides, env=""), RefConfig(overrides, env="")
    assert cfg.diff() == ref.diff()
    assert cfg.osd_ec_engine_failover is False


@pytest.mark.parametrize("name,raw", [
    ("osd_ec_launch_deadline", "2.5"),
    ("osd_ec_dispatch_bucket", "off"),
    ("ms_reply_coalesce_max", "1"),
    ("osd_mclock_scheduler_client_res", 40),
    ("ec_inject_engine_failure", "3"),
])
def test_coercion_equals_the_reference(name, raw):
    from ceph_tpu.common.config import Config as RefConfig

    cfg, ref = Config(env=""), RefConfig(env="")
    cfg.set(name, raw)
    ref.set(name, raw)
    assert cfg.get(name) == ref.get(name)
    assert type(cfg.get(name)) is type(ref.get(name))


def test_sources_layer_and_observers_fire(tmp_path):
    conf = tmp_path / "ceph.conf"
    conf.write_text("[global]\nosd ec dispatch window = 0.003\n"
                    "[accel.0]\naccel_beacon_interval = 0.25\n")
    cfg = Config({"ms_op_batch_max": 2}, conf_file=str(conf),
                 section="accel.0",
                 env="--osd_ec_launch_deadline 7 --ms-op-batch-max=9")
    assert cfg.osd_ec_dispatch_window == 0.003
    assert cfg.accel_beacon_interval == 0.25
    assert cfg.osd_ec_launch_deadline == 7.0
    assert cfg.ms_op_batch_max == 2  # overrides beat the environment
    fired = []

    def cb(n, v):
        fired.append((n, v))

    cfg.observe("osd_ec_dispatch_window", cb)
    cfg.set("osd_ec_dispatch_window", "0.001")
    cfg.unobserve("osd_ec_dispatch_window", cb)
    cfg.set("osd_ec_dispatch_window", "0.002")
    assert fired == [("osd_ec_dispatch_window", 0.001)]
    with pytest.raises(KeyError):
        cfg.set("no_such_option", 1)
    with pytest.raises(KeyError):
        cfg.observe("no_such_option", cb)


# -- twins of the reference's scheduler unit cases -----------------------------


async def _settle(n: int = 3):
    for _ in range(n):
        await asyncio.sleep(0)


class TestMClockOrdering:
    def test_reservation_beats_arrival_order(self):
        """A client waiter behind on its reservation is granted before
        an EARLIER-queued background waiter with a huge weight — the
        dmClock R phase outranks both arrival order and weights."""

        async def main():
            s = OpScheduler(
                {
                    "client": QosSpec(reservation=1000.0, weight=0.001),
                    "recovery": QosSpec(reservation=0.0, weight=100.0),
                },
                policy="mclock", slots=1,
            )
            await s.admit("snaptrim")  # occupy the only slot (a class
            # whose tags don't touch the contenders under test)
            order: list[str] = []

            async def taker(klass):
                await s.admit(klass)
                order.append(klass)
                s.complete(klass)

            t1 = asyncio.ensure_future(taker("recovery"))
            await _settle()
            t2 = asyncio.ensure_future(taker("client"))
            await _settle()
            assert order == []
            s.complete("snaptrim")  # free the slot: the pick happens now
            await asyncio.gather(t1, t2)
            assert order == ["client", "recovery"]
            # the bypassed background head is visible as a preemption
            assert s.dump()["classes"]["recovery"]["preempted"] == 1

        run(main())

    def test_wpq_shares_by_weight(self):
        """Weight-only fallback: a 2:1 weight split serves the heavy
        class twice as often (3 of the first 4 grants)."""

        async def main():
            s = OpScheduler(
                {
                    "recovery": QosSpec(weight=2.0),
                    "scrub": QosSpec(weight=1.0),
                },
                policy="wpq", slots=1, cut_off=100,
            )
            await s.admit("client")
            order: list[str] = []

            async def taker(klass):
                await s.admit(klass)
                order.append(klass)
                s.complete(klass)

            tasks = [
                asyncio.ensure_future(taker(k))
                for k in ("recovery", "scrub") for _ in range(3)
            ]
            await _settle()
            s.complete("client")
            await asyncio.gather(*tasks)
            assert order.count("recovery") == 3
            assert order[:4].count("recovery") == 3  # ~2:1 pacing

        run(main())

    def test_fifo_ignores_class(self):
        """osd_op_queue=fifo: pure arrival order — the pre-QoS behavior
        the starvation gate measures against."""

        async def main():
            s = OpScheduler(
                {"client": QosSpec(reservation=1000.0, weight=100.0)},
                policy="fifo", slots=1,
            )
            await s.admit("client")
            order: list[str] = []

            async def taker(klass):
                await s.admit(klass)
                order.append(klass)
                s.complete(klass)

            t1 = asyncio.ensure_future(taker("recovery"))
            await _settle()
            t2 = asyncio.ensure_future(taker("client"))
            await _settle()
            s.complete("client")
            await asyncio.gather(t1, t2)
            assert order == ["recovery", "client"]

        run(main())

    def test_limit_caps_rate_with_timer_wakeup(self):
        """A limited class's second grant waits for real time to catch
        up (the dmClock L tag) even with free slots — and the wakeup
        timer, not an unrelated complete(), delivers it."""

        async def main():
            s = OpScheduler(
                {"scrub": QosSpec(limit=50.0)},  # one per 20ms
                policy="mclock", slots=8, cut_off=100,
            )
            w1 = await s.admit("scrub")
            w2 = await s.admit("scrub")
            assert w1 == 0.0 and w2 >= 0.010
            s.complete("scrub")
            s.complete("scrub")

        run(main())

    def test_live_policy_switch_reorders_waiters(self):
        """config set osd_op_queue fifo on a loaded scheduler: queued
        waiters re-order under the new policy, nothing is dropped."""

        async def main():
            s = OpScheduler(
                {"client": QosSpec(reservation=1000.0)},
                policy="mclock", slots=1,
            )
            await s.admit("client")
            order: list[str] = []

            async def taker(klass):
                await s.admit(klass)
                order.append(klass)
                s.complete(klass)

            t1 = asyncio.ensure_future(taker("recovery"))
            await _settle()
            t2 = asyncio.ensure_future(taker("client"))
            await _settle()
            s.set_policy("fifo")  # mclock would pick client first
            s.complete("client")
            await asyncio.gather(t1, t2)
            assert order == ["recovery", "client"]
            with pytest.raises(ValueError):
                s.set_policy("lifo")

        run(main())


class TestSheddingAndSafety:
    def test_best_effort_sheds_past_cut_off(self):
        async def main():
            s = OpScheduler({}, policy="mclock", slots=1, cut_off=2)
            await s.admit("client")  # saturate
            tasks = [
                asyncio.ensure_future(s.admit("scrub")) for _ in range(2)
            ]
            await _settle()
            assert s.queued("scrub") == 2
            with pytest.raises(QosDeferred):
                await s.admit("scrub")
            d = s.dump()["classes"]["scrub"]
            assert d["deferred"] == 1 and d["queued"] == 2
            # client is NOT best-effort: it queues past any cut-off
            assert "client" not in BEST_EFFORT
            t = asyncio.ensure_future(s.admit("client"))
            await _settle()
            assert s.queued("client") == 1
            s.complete("client")

            async def drain(fut, klass):
                # complete each grant AS IT LANDS (grant order is the
                # policy's business, not this test's)
                await fut
                s.complete(klass)

            await asyncio.gather(
                drain(t, "client"), *[drain(w, "scrub") for w in tasks]
            )

        run(main())

    def test_client_backlog_sheds_best_effort(self):
        """The REAL overload shape: background managers admit serially
        (their own queue is never deep) — it's the client backlog that
        must shed them.  A scrub admit against a client-saturated pool
        defers."""

        async def main():
            s = OpScheduler({}, policy="mclock", slots=1, cut_off=3)
            await s.admit("client")
            waiters = [
                asyncio.ensure_future(s.admit("client"))
                for _ in range(3)
            ]
            await _settle()
            assert s.queued("scrub") == 0  # scrub's own queue is empty
            with pytest.raises(QosDeferred):
                await s.admit("scrub")

            async def drain(fut):
                await fut
                s.complete("client")

            s.complete("client")
            await asyncio.gather(*[drain(w) for w in waiters])

        run(main())

    def test_grant_releases_slot_on_exception(self):
        async def main():
            s = OpScheduler({}, policy="mclock", slots=1)
            with pytest.raises(RuntimeError):
                async with s.grant("client"):
                    raise RuntimeError("op died")
            assert s.inflight == 0
            async with s.grant("recovery"):
                assert s.inflight == 1

        run(main())

    def test_cancelled_waiter_leaves_queue_clean(self):
        async def main():
            s = OpScheduler({}, policy="mclock", slots=1)
            await s.admit("client")
            t = asyncio.ensure_future(s.admit("recovery"))
            await _settle()
            assert s.queued("recovery") == 1
            t.cancel()
            with pytest.raises(asyncio.CancelledError):
                await t
            assert s.queued("recovery") == 0
            s.complete("client")
            assert await s.admit("client") == 0.0  # pool fully free
            s.complete("client")

        run(main())


class TestPacing:
    def test_pace_runs_at_limit_rate(self):
        async def main():
            s = OpScheduler(
                {"ec_background": QosSpec(limit=100.0)},
                policy="mclock", slots=4,
            )
            assert await s.pace("ec_background") == 0.0
            d = await s.pace("ec_background")
            assert 0.005 <= d < 0.5  # ~10ms: 100 units/s token bucket

        run(main())

    def test_pace_squeezes_to_reservation_under_client_backlog(self):
        """While client ops are QUEUED (device bottleneck) background
        stripes fall back to their reservation rate — client stripes
        preempt recovery stripes exactly under contention."""

        async def main():
            s = OpScheduler(
                {"ec_background": QosSpec(reservation=10.0, limit=1000.0)},
                policy="mclock", slots=1,
            )
            await s.admit("recovery")  # hold the slot
            t = asyncio.ensure_future(s.admit("client"))
            await _settle()
            assert s.queued("client") == 1
            await s.pace("ec_background")
            t0 = asyncio.get_running_loop().time()
            d = await s.pace("ec_background")
            assert d >= 0.05  # 10 units/s, not the 1ms the limit allows
            assert asyncio.get_running_loop().time() - t0 >= 0.05
            s.complete("recovery")
            await t
            s.complete("client")

        run(main())

    def test_pace_debt_is_capped(self):
        """One huge paced cost must not bank minutes of debt for the
        NEXT caller to sleep out (it would hold a recovery/scrub grant
        slot hostage): the pacing tag runs at most PACE_DEBT_CAP_S
        ahead of now."""
        from ceph_tpu_torch.osd.scheduler import PACE_DEBT_CAP_S

        async def main():
            s = OpScheduler(
                {"ec_background": QosSpec(limit=10.0)},
                policy="mclock", slots=4,
            )
            # 1000 units at 10/s would be 100s of debt uncapped
            assert await s.pace("ec_background", cost=1000.0) == 0.0
            d = await s.pace("ec_background")
            assert d <= PACE_DEBT_CAP_S + 0.5, d

        run(main())

    def test_pace_is_noop_under_fifo(self):
        async def main():
            s = OpScheduler(
                {"ec_background": QosSpec(reservation=1.0, limit=1.0)},
                policy="fifo", slots=1,
            )
            for _ in range(5):
                assert await s.pace("ec_background") == 0.0

        run(main())


class TestStarvationGate:
    """The acceptance gate: a saturating 4:1 background:client storm
    through one service slot (2ms service time = the saturated device).
    mclock must hold the client's reservation share with every queue
    wait far under the complaint time; fifo — the same storm, scheduler
    disabled — must demonstrably degrade client p99."""

    SERVICE_S = 0.002
    N_CLIENT = 30
    COMPLAINT_S = 1.0

    async def _storm(self, policy: str) -> tuple[list[float], float]:
        sched = OpScheduler(
            {
                "client": QosSpec(reservation=100.0, weight=4.0),
                "recovery": QosSpec(reservation=10.0, weight=1.0),
            },
            policy=policy, slots=1, cut_off=10_000,
        )
        waits: list[float] = []

        async def one(klass: str):
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            async with sched.grant(klass):
                if klass == "client":
                    waits.append(loop.time() - t0)
                await asyncio.sleep(self.SERVICE_S)

        bg = [
            asyncio.ensure_future(one("recovery"))
            for _ in range(4 * self.N_CLIENT)
        ]
        await asyncio.sleep(0)  # storm queues first — worst case
        cl = []
        for _ in range(self.N_CLIENT):
            cl.append(asyncio.ensure_future(one("client")))
            await asyncio.sleep(0.003)
        await asyncio.gather(*cl)
        share = sched.share_attainment("client")
        for t in bg:
            t.cancel()
        await asyncio.gather(*bg, return_exceptions=True)
        return sorted(waits), share

    def test_mclock_holds_reservation_and_slow_ops_stay_quiet(self):
        async def main():
            waits, share = await self._storm("mclock")
            p99 = waits[min(len(waits) - 1, int(len(waits) * 0.99))]
            # share attainment >= the reservation (the class was
            # demanding ~3x its reservation and must attain >= 1x)
            assert share is not None and share >= 1.0, share
            # no client op's queue wait approaches the complaint time:
            # the SLOW_OPS input (op age > osd_op_complaint_time) never
            # fires for a queued-then-served client op
            assert waits[-1] < self.COMPLAINT_S / 2, waits[-1]
            assert p99 < self.COMPLAINT_S / 2
            # (the reference also walks one op through its OpTracker
            # here; the op tracker waits for the port's OSD)

        run(main())

    def test_fifo_same_storm_destroys_client_p99(self):
        async def main():
            mc_waits, _ = await self._storm("mclock")
            ff_waits, _ = await self._storm("fifo")
            mc_p99 = mc_waits[min(len(mc_waits) - 1,
                                  int(len(mc_waits) * 0.99))]
            ff_p99 = ff_waits[min(len(ff_waits) - 1,
                                  int(len(ff_waits) * 0.99))]
            # fifo clients drain behind the whole storm (>= 120 x 2ms
            # of backlog); mclock serves them at their reservation.
            # Generous factors keep this robust on slow CI.
            assert ff_p99 > 0.08, ff_p99
            assert ff_p99 > 3 * mc_p99, (ff_p99, mc_p99)

        run(main())


class TestECDispatchClassLanes:
    def test_classes_never_share_a_batch_and_bytes_are_pinned(
        self, monkeypatch
    ):
        """Client and ec_background encodes submitted in the same tick
        coalesce within their class but never across classes — and
        both lanes stay byte-identical to per-op ec_util.encode."""
        from ceph_tpu_torch.models import registry
        from ceph_tpu_torch.osd import ec_util
        from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
        from ceph_tpu_torch.utils import native

        # force the batching lane: the native C engine takes the
        # per-op direct lane and never batches (by design)
        monkeypatch.setattr(native, "host_engine_active",
                            lambda device=None: False)

        async def main():
            codec = registry.instance().factory(
                "jerasure",
                {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "1"}, device="cpu",
            )
            chunk = codec.get_chunk_size(2 * 1024)
            sinfo = ec_util.StripeInfo(
                stripe_width=chunk * 2, chunk_size=chunk
            )
            disp = ECDispatcher(window=0.01, max_stripes=512)
            rng = np.random.default_rng(5)
            bufs = [
                rng.integers(0, 256, size=(2 * sinfo.stripe_width,),
                             dtype=np.uint8)
                for _ in range(4)
            ]
            outs = await asyncio.gather(
                disp.encode(sinfo, codec, bufs[0], klass="client"),
                disp.encode(sinfo, codec, bufs[1], klass="client"),
                disp.encode(sinfo, codec, bufs[2], klass="ec_background"),
                disp.encode(sinfo, codec, bufs[3], klass="ec_background"),
            )
            for buf, out in zip(bufs, outs):
                ref = ec_util.encode(sinfo, codec, buf)
                for s in ref:
                    assert np.array_equal(
                        np.asarray(out[s]), np.asarray(ref[s])
                    )
            stats = disp.dump()
            # two same-tick pairs -> exactly two batches: one per class
            assert stats["totals"]["batches"] == 2
            assert stats["totals"]["ops"] == 4
            await disp.stop()

        run(main())

    def test_background_stripes_pace_through_scheduler(self, monkeypatch):
        from ceph_tpu_torch.models import registry
        from ceph_tpu_torch.osd import ec_util
        from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
        from ceph_tpu_torch.utils import native

        monkeypatch.setattr(native, "host_engine_active",
                            lambda device=None: False)

        async def main():
            sched = OpScheduler(
                {"ec_background": QosSpec(limit=100.0)},
                policy="mclock", slots=4,
            )
            codec = registry.instance().factory(
                "jerasure",
                {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "1"}, device="cpu",
            )
            chunk = codec.get_chunk_size(2 * 1024)
            sinfo = ec_util.StripeInfo(
                stripe_width=chunk * 2, chunk_size=chunk
            )
            disp = ECDispatcher(window=0.0005, max_stripes=512,
                                scheduler=sched)
            buf = np.arange(
                2 * sinfo.stripe_width, dtype=np.uint8
            ) % 251
            ref = ec_util.encode(sinfo, codec, buf)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            for _ in range(3):  # 2 stripes/call at 100/s: forced waits
                out = await disp.encode(
                    sinfo, codec, buf, klass="ec_background"
                )
            assert loop.time() - t0 >= 0.02
            assert sched.dump()["classes"]["ec_background"]["paced"] >= 1
            for s in ref:
                assert np.array_equal(
                    np.asarray(out[s]), np.asarray(ref[s])
                )
            # client stripes never pace (admitted at the op intake)
            t0 = loop.time()
            await disp.encode(sinfo, codec, buf, klass="client")
            assert loop.time() - t0 < 0.5
            await disp.stop()

        run(main())


class TestConfigSurface:
    def test_bad_policy_rejected_before_commit(self):
        """An invalid osd_op_queue fails at coerce time — BEFORE the
        value commits or observers fire — so `config show` and a live
        scheduler can never diverge on a typo'd policy."""
        cfg = Config()
        fired = []
        cfg.observe("osd_op_queue", lambda _n, v: fired.append(v))
        with pytest.raises(ValueError):
            cfg.set("osd_op_queue", "bogus")
        assert cfg.osd_op_queue == "mclock" and fired == []
        cfg.set("osd_op_queue", "wpq")
        assert cfg.osd_op_queue == "wpq" and fired == ["wpq"]

    def test_scheduler_built_from_config_and_specs_live(self):
        """Every osd_mclock_scheduler_* knob exists, builds the spec
        table, and flows live through set() observers."""
        cfg = Config()
        assert cfg.osd_op_queue == "mclock"
        for k in CLASSES:
            for f in ("res", "wgt", "lim"):
                cfg.get(f"osd_mclock_scheduler_{k}_{f}")

        async def main():
            from ceph_tpu_torch.osd.scheduler import OpScheduler

            s = OpScheduler(
                {
                    k: QosSpec(
                        reservation=cfg.get(
                            f"osd_mclock_scheduler_{k}_res"),
                        weight=cfg.get(f"osd_mclock_scheduler_{k}_wgt"),
                        limit=cfg.get(f"osd_mclock_scheduler_{k}_lim"),
                    )
                    for k in CLASSES
                },
                policy=cfg.osd_op_queue,
                slots=cfg.osd_op_queue_slots,
                cut_off=cfg.osd_op_queue_cut_off,
            )
            d = s.dump()
            assert d["classes"]["client"]["spec"]["weight"] == 4.0
            s.set_spec("client", reservation=123.0)
            assert (s.dump()["classes"]["client"]["spec"]["reservation"]
                    == 123.0)

        run(main())
