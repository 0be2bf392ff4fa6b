"""The port's accelerator fleet against the reference.

The slice's path: accelerator daemons register with a mon
(``MAccelBoot``), the mon publishes them in the AccelMap that rides
every OSDMap push, and an OSD's ``AccelRouter`` (fed ``apply_map`` from
every push) spreads the dispatcher's remote batches over them, prefers
the daemon whose locality matches a decode's surviving shards, and fails
a batch over to the next daemon before the dispatcher sees an error.

- **Twins** of ``tests/test_accel_fleet.py``'s ``TestRouterPolicy``
  (all seven) and ``TestInterAccelFailover`` (all three), with the
  daemons on ``device="cpu"``.
- **The mon-backed fleet:** two port daemons register through a port
  ``Monitor``; a feeder's router learns them from map pushes; one
  daemon crashes and the mon's markdown reaches the router on the next
  push.
- **Cross-package:** a port daemon registers with a reference mon, and
  a reference daemon with a port mon (a port router then learns it from
  the port mon's pushes).
- **The daemon tool:** ``tools/daemon.py mon`` and ``accel --monmap
  FILE --locality L --device cpu`` run as processes, and the daemon
  appears in the mon's AccelMap; ``--watch-parent`` exits when its
  parent is gone.
- The fleet's perf families (``accel``'s client half with the fleet
  keys, ``accel@<id>``) equal the reference's.

The live ``MiniCluster`` cases (``TestLiveFleet``) wait for the port's
OSD.  Every async body runs under ``asyncio.timeout`` (:func:`run`).
"""

import asyncio
import os
import select
import signal
import subprocess
import sys
import time
import types

import numpy as np

from ceph_tpu_torch.accel import AccelDaemon, AccelMap, AccelRouter
from ceph_tpu_torch.accel.client import AccelClient
from ceph_tpu_torch.common import Config
from ceph_tpu_torch.models import registry
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.msg import AsyncMessenger, Dispatcher, messages
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
from ceph_tpu_torch.osd.osdmap import advance_map
from tests.test_torch_mon import MonClient, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _isa_codec(k: int = 2, m: int = 1):
    return registry.instance().factory(
        "isa", {"plugin": "isa", "technique": "reed_sol_van",
                "k": str(k), "m": str(m)}, device="cpu",
    )


def _sinfo(codec, cs: int = 128) -> ec_util.StripeInfo:
    k = codec.get_data_chunk_count()
    return ec_util.StripeInfo(stripe_width=cs * k, chunk_size=cs)


def _assert_shards_equal(got, want, ctx=""):
    assert set(got) == set(want), ctx
    for s in want:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s])), \
            f"{ctx} shard {s}"


def _fleet_map(entries) -> AccelMap:
    """entries: [(name, addr, locality, capacity)] -> a published map."""
    amap = AccelMap()
    for name, addr, locality, capacity in entries:
        amap.note_boot(name, addr, locality, capacity)
    return amap


def _router(entries=(), *, addr="", mode="prefer", **kw) -> AccelRouter:
    r = AccelRouter(AsyncMessenger("osd.t", Dispatcher()),
                    addr=addr, mode=mode, **kw)
    if entries:
        r.apply_map(_fleet_map(entries))
    return r


def _prime(cl: AccelClient, queue: int, capacity: int = 8,
           state: int = 0) -> None:
    """Give a client a FRESH health snapshot (as a beacon would)."""
    cl.remote_queue = queue
    cl.remote_capacity = capacity
    cl.remote_state = state
    cl._state_at = time.monotonic()


def _dec_batch():
    return types.SimpleNamespace(kind="dec")


def _op(locality=None):
    return types.SimpleNamespace(locality=locality)


# -- twins of TestRouterPolicy ---------------------------------------------------


class TestRouterPolicy:
    def test_least_loaded_pick(self):
        r = _router([("a", "127.0.0.1:1", "", 8),
                     ("b", "127.0.0.1:2", "", 8)])
        a, b = r._map_clients[1], r._map_clients[2]
        _prime(a, queue=6)
        _prime(b, queue=1)
        order, _ = r._order(_dec_batch(), [_op()])
        assert order[0] is b  # least loaded first

    def test_hysteresis_keeps_current_within_margin(self):
        r = _router([("a", "127.0.0.1:1", "", 8),
                     ("b", "127.0.0.1:2", "", 8)])
        a, b = r._map_clients[1], r._map_clients[2]
        r._current = 1  # a is the warm target
        _prime(a, queue=1)   # load 0.125
        _prime(b, queue=0)   # load 0.0 — better, but within 0.2
        order, _ = r._order(_dec_batch(), [_op()])
        assert order[0] is a, "near-equal load must not flap the target"
        _prime(a, queue=6)   # load 0.75 — far past the margin
        order, _ = r._order(_dec_batch(), [_op()])
        assert order[0] is b, "a real imbalance rebalances"

    def test_locality_majority_preference_and_tiebreak(self):
        r = _router([("a", "127.0.0.1:1", "host0", 8),
                     ("b", "127.0.0.1:2", "host1", 8)])
        a, b = r._map_clients[1], r._map_clients[2]
        _prime(a, queue=5)  # busier...
        _prime(b, queue=0)
        ops = [_op(["host0", "host0", "host1"])]
        order, label = r._order(_dec_batch(), ops)
        assert label == "host0"
        assert order[0] is a, \
            "majority locality outranks load (the fabric win)"
        # ties break lexicographically — deterministic preference
        ops = [_op(["host1", "host0"])]
        _order, label = r._order(_dec_batch(), ops)
        assert label == "host0"
        # encode batches carry no labels: pure load ordering
        order, label = r._order(types.SimpleNamespace(kind="enc"),
                                [_op()])
        assert label is None and order[0] is b

    def test_map_markdown_drops_target(self):
        amap = _fleet_map([("a", "127.0.0.1:1", "", 8),
                           ("b", "127.0.0.1:2", "", 8)])
        r = _router()
        r.apply_map(amap)
        assert len(r._candidates()) == 2
        amap.mark_down("a")
        r.apply_map(amap)
        cands = r._candidates()
        assert len(cands) == 1 and cands[0].aid == 2
        # stale epochs never regress the fleet view
        r.apply_map(_fleet_map([("a", "127.0.0.1:1", "", 8)]))
        assert len(r._candidates()) == 1

    def test_compat_shim_static_addr(self):
        """osd_ec_accel_addr alone = a single-entry static fleet with
        the single client's semantics (routes gating, sticky
        unreachable, totals, remote_state)."""
        codec = _isa_codec()
        r = _router(addr="127.0.0.1:1")
        assert r.map_epoch == 0 and len(r._candidates()) == 1
        assert r.routes(codec)
        shim = r._shim
        shim.handle(messages.MAccelBeacon(
            name="accel.t", engine_state=2, queue_depth=0, capacity=8))
        assert r.remote_state == 2
        assert not r.routes(codec)
        assert r.totals["routed_away"] == 1
        shim._mark_down()
        assert r.unreachable
        r.set_mode("off")
        assert not r.unreachable  # the off-clears rule, fleet-wide
        # map entries outrank the shim once published
        r.set_mode("prefer")
        r.apply_map(_fleet_map([("a", "127.0.0.1:9", "", 8)]))
        assert [cl.aid for cl in r._candidates()] == [1]

    def test_whole_map_down_reads_unreachable(self):
        """A published fleet whose EVERY member the mon marked down
        reads unreachable: dropping the dead targets must not shrink
        the fleet to 'nothing configured'."""

        class _Sink:
            def __init__(self):
                self.vals = {}

            def inc(self, key, by=1):
                self.vals[key] = self.vals.get(key, 0) + by

            def set(self, key, v):
                self.vals[key] = v

            observe = set

        sink = _Sink()
        amap = _fleet_map([("a", "127.0.0.1:1", "", 8),
                           ("b", "127.0.0.1:2", "", 8)])
        r = AccelRouter(AsyncMessenger("osd.t", Dispatcher()),
                        mode="prefer", perf=sink)
        r.apply_map(amap)
        assert not r.unreachable
        amap.mark_down("a")
        r.apply_map(amap)
        r.refresh_gauges()
        # partial outage: degraded, not unreachable
        assert not r.unreachable
        assert sink.vals["fleet_down"] == 1 and sink.vals["fleet_up"] == 1
        assert sink.vals["remote_unreachable"] == 0
        amap.mark_down("b")
        r.apply_map(amap)
        r.refresh_gauges()
        assert r.unreachable
        assert sink.vals["fleet_size"] == 2
        assert sink.vals["fleet_up"] == 0
        assert sink.vals["remote_unreachable"] == 1
        # a member coming back clears it
        amap.note_boot("a", "127.0.0.1:1", "", 8)
        r.apply_map(amap)
        r.refresh_gauges()
        assert not r.unreachable
        assert sink.vals["remote_unreachable"] == 0

    def test_stale_interval_boundary(self):
        """A TRIPPED snapshot aged exactly T is STALE — it stops gating
        and traffic re-probes; aged T - ε it is still fresh and the
        TRIPPED avoidance holds.  Through the router too: the interval
        it propagates is live on every target."""
        cl = AccelClient(AsyncMessenger("osd.t", Dispatcher()),
                         addr="127.0.0.1:1", mode="prefer",
                         stale_interval=5.0)
        codec = _isa_codec()
        now = time.monotonic()
        cl.remote_state = 2  # TRIPPED per the last word
        cl._state_at = now - 5.0  # aged EXACTLY T
        assert not cl.state_fresh(now)
        assert cl.available(), "stale verdict must not pin TRIPPED"
        assert cl.routes(codec)
        cl._state_at = now - (5.0 - 1e-4)  # T - ε: still fresh
        assert cl.state_fresh(now)
        assert not cl.available()
        assert not cl.routes(codec)
        # the interval is LIVE (the Option's observer writes it)
        cl.stale_interval = 1.0
        cl._state_at = now - 2.0
        assert cl.available()
        r = _router([("a", "127.0.0.1:1", "", 8)], addr="127.0.0.1:2")
        r.stale_interval = 3.5
        assert all(c.stale_interval == 3.5 for c in r._all_clients())


# -- twins of TestInterAccelFailover ---------------------------------------------


class _FleetFeeder(Dispatcher):
    """A simulated OSD whose remote lane is an AccelRouter, over a
    synthetic (mon-less) AccelMap or over the map pushes of a mon
    (:meth:`subscribe`)."""

    def __init__(self, name: str, entries=(), *, mode: str = "prefer",
                 window: float = 0.001):
        self.messenger = AsyncMessenger(name, self)
        self.router = AccelRouter(self.messenger, mode=mode,
                                  deadline=10.0, retry_interval=0.05)
        if entries:
            self.router.apply_map(_fleet_map(entries))
        self.dispatch = ECDispatcher(window=window, remote=self.router)
        self.osdmap = None
        self.pushes: list[int] = []  # accelmap epoch of each push

    async def subscribe(self, mon_addr):
        conn = await self.messenger.connect(mon_addr, "mon")
        conn.send(messages.MMonGetMap(have=0))

    async def ms_dispatch(self, conn, msg):
        if isinstance(msg, messages.MOSDMapMsg):
            m = advance_map(self.osdmap, msg.epoch, msg.osdmap,
                            msg.incrementals)
            if m is None:
                conn.send(messages.MMonGetMap(have=None))
                return
            self.osdmap = m
            self.pushes.append(m.accelmap.epoch)
            self.router.apply_map(m.accelmap)
            return
        self.router.handle(msg, conn)

    def ms_handle_reset(self, conn):
        self.router.on_reset(conn)

    async def stop(self):
        await self.dispatch.stop()
        await self.messenger.shutdown()


class TestInterAccelFailover:
    def test_accel_death_fails_over_to_next_accel(self):
        """Kill the routed-to accelerator with a batch in flight: the
        batch is served by the NEXT accelerator, bit-identically — the
        dispatcher never sees an error and the local fallback never
        runs (zero failed ops without even a local replay)."""
        codec = _isa_codec()
        sinfo = _sinfo(codec)
        rng = np.random.default_rng(31)
        buf = rng.integers(0, 256, size=(5 * sinfo.stripe_width,),
                           dtype=np.uint8)

        async def main():
            acc1 = AccelDaemon("accel.a", device="cpu")
            acc2 = AccelDaemon("accel.b", device="cpu")
            await acc1.start()
            await acc2.start()
            feeder = _FleetFeeder("osd.0", [
                ("accel.a", acc1.addr, "", 8),
                ("accel.b", acc2.addr, "", 8),
            ])
            # equal (unknown) load: the order tie-breaks to aid 1
            t = asyncio.ensure_future(
                feeder.dispatch.encode(sinfo, codec, buf))
            await asyncio.sleep(0)  # batch opens toward accel.a
            await acc1.stop(crash=True)  # SIGKILL analog mid-batch
            out = await t
            _assert_shards_equal(out, ec_util.encode(sinfo, codec, buf))
            totals = feeder.dispatch.dump()["totals"]
            assert totals["failovers"] == 0, \
                "the fleet absorbed the fault — no local replay"
            assert totals["lanes"]["remote"]["ops"] == 1
            assert feeder.router.totals["failover_next"] == 1
            # the survivor served it
            assert "osd.0" in acc2.client_table()
            rec = feeder.dispatch.flight.dump()["launches"][-1]
            assert rec["lane"] == "remote" and rec["served"] == "remote"
            # sticky per-accel state: a is down, b is not; the fleet
            # summary reads degraded, not unreachable
            assert not feeder.router.unreachable
            down = [cl.aid for cl in feeder.router._candidates()
                    if cl.unreachable]
            assert down == [1]
            await feeder.stop()
            await acc2.stop()

        run(main())

    def test_whole_fleet_down_replays_locally(self):
        """Both accelerators dead: only then does the batch replay on
        the LOCAL fallback, and the router reads unreachable."""
        codec = _isa_codec()
        sinfo = _sinfo(codec)
        rng = np.random.default_rng(32)
        buf = rng.integers(0, 256, size=(3 * sinfo.stripe_width,),
                           dtype=np.uint8)

        async def main():
            feeder = _FleetFeeder("osd.0", [
                ("accel.a", "127.0.0.1:1", "", 8),  # nobody listening
                ("accel.b", "127.0.0.1:1", "", 8),
            ])
            feeder.router.deadline = 5.0
            out = await feeder.dispatch.encode(sinfo, codec, buf)
            _assert_shards_equal(out, ec_util.encode(sinfo, codec, buf))
            totals = feeder.dispatch.dump()["totals"]
            assert totals["failovers"] == 1
            assert feeder.router.totals["failover_next"] == 1
            assert feeder.router.unreachable
            rec = feeder.dispatch.flight.dump()["launches"][-1]
            assert rec["served"] == "fallback"
            assert rec["origin"] == "remote"
            await feeder.stop()

        run(main())

    def test_locality_preferred_decode(self):
        """A decode batch whose surviving shards are labeled host1
        routes to the host1 accelerator even when the other is idle;
        the hit is counted."""
        codec = _isa_codec()
        sinfo = _sinfo(codec)
        rng = np.random.default_rng(33)
        buf = rng.integers(0, 256, size=(4 * sinfo.stripe_width,),
                           dtype=np.uint8)
        full = ec_util.encode(sinfo, codec, buf)
        survivors = {s: np.asarray(v) for s, v in full.items() if s != 0}

        async def main():
            acc1 = AccelDaemon("accel.a", device="cpu")
            acc2 = AccelDaemon("accel.b", device="cpu")
            await acc1.start()
            await acc2.start()
            feeder = _FleetFeeder("osd.0", [
                ("accel.a", acc1.addr, "host0", 8),
                ("accel.b", acc2.addr, "host1", 8),
            ])
            got = await feeder.dispatch.decode_concat(
                sinfo, codec, survivors,
                locality=["host1", "host1", "host0"],
            )
            assert bytes(got) == bytes(buf)
            assert feeder.router.totals["locality_hits"] == 1
            assert feeder.router.totals["locality_misses"] == 0
            assert "osd.0" in acc2.client_table()
            assert "osd.0" not in acc1.client_table()
            await feeder.stop()
            await acc1.stop()
            await acc2.stop()

        run(main())


# -- the fleet behind a mon -------------------------------------------------------


def _accel_config(locality: str) -> Config:
    return Config({"accel_locality": locality,
                   "accel_beacon_interval": 0.05}, env="")


async def _wait(pred, timeout=10.0):
    async with asyncio.timeout(timeout):
        while not pred():
            await asyncio.sleep(0.005)


def test_mon_backed_fleet_learns_fails_over_and_drops_on_one_push():
    """Two port daemons register through a port mon; a feeder's router
    learns both from map pushes, its bytes come back equal, a crash of
    the routed-to daemon fails the batch over to the other with no
    local replay, and the mon's markdown reaches the router on the next
    push (one accelmap epoch)."""
    codec = _isa_codec()
    sinfo = _sinfo(codec)
    rng = np.random.default_rng(34)
    buf = rng.integers(0, 256, size=(6 * sinfo.stripe_width,),
                       dtype=np.uint8)
    want = ec_util.encode(sinfo, codec, buf)

    async def main():
        mon = Monitor(max_osds=4)
        mon_addr = await mon.start()
        accs = [AccelDaemon(name, mon_addr=mon_addr,
                            config=_accel_config(loc), device="cpu")
                for name, loc in (("accel.a", "host0"),
                                  ("accel.b", "host1"))]
        for acc in accs:
            await acc.start()
        feeder = _FleetFeeder("osd.0", mode="require")
        await feeder.subscribe(mon_addr)
        await _wait(lambda: len(feeder.router._map_clients) == 2)
        amap = mon.osdmap.accelmap
        assert feeder.router.map_epoch == amap.epoch
        assert {cl.locality for cl in feeder.router._map_clients.values()} \
            == {"host0", "host1"}
        assert all(amap.by_name(a.name).up for a in accs)
        assert all(amap.by_name(a.name).addr == a.addr for a in accs)
        out = await feeder.dispatch.encode(sinfo, codec, buf)
        _assert_shards_equal(out, want, "through the fleet")
        # crash the daemon the next batch goes to, with it in flight
        first = feeder.router._order(
            types.SimpleNamespace(kind="enc"), [])[0][0]
        victim = next(a for a in accs if a.addr == first.addr)
        other = next(a for a in accs if a is not victim)
        before = feeder.router.map_epoch
        t = asyncio.ensure_future(feeder.dispatch.encode(sinfo, codec, buf))
        await asyncio.sleep(0)
        await victim.stop(crash=True)
        _assert_shards_equal(await t, want, "failed over")
        assert feeder.dispatch.dump()["totals"]["failovers"] == 0
        assert feeder.router.totals["failover_next"] == 1
        await _wait(lambda: first.aid not in feeder.router._map_clients)
        assert not mon.osdmap.accelmap.by_name(victim.name).up
        # one push carried the markdown: the next accelmap epoch
        assert feeder.router.map_epoch == before + 1
        assert feeder.pushes[-1] == before + 1
        assert [cl.addr for cl in feeder.router._candidates()] == [other.addr]
        assert not feeder.router.unreachable
        # a graceful stop deregisters: the whole fleet reads down
        await other.stop()
        await _wait(lambda: feeder.router.unreachable)
        assert not mon.osdmap.accelmap.up_entries()
        await feeder.stop()
        await mon.stop()

    run(main())


def test_port_daemon_registers_with_a_reference_mon():
    """A port daemon's ``MAccelBoot`` lands in a reference mon's
    AccelMap (name, address, locality, capacity), and its graceful stop
    marks it down there."""
    from ceph_tpu.mon import Monitor as RefMonitor

    async def main():
        mon = RefMonitor(max_osds=4)
        mon_addr = await mon.start()
        acc = AccelDaemon("accel.p", mon_addr=[mon_addr],
                          config=_accel_config("hostP"), device="cpu")
        await acc.start()
        await _wait(lambda: mon.osdmap.accelmap.by_name("accel.p")
                    is not None)
        e = mon.osdmap.accelmap.by_name("accel.p")
        assert e.up and e.addr == acc.addr and e.locality == "hostP"
        assert e.capacity == acc.config.osd_op_queue_slots
        await _wait(lambda: acc.osdmap is not None
                    and acc.osdmap.accelmap.by_name("accel.p") is not None)
        await acc.stop()
        await _wait(lambda: not mon.osdmap.accelmap.by_name("accel.p").up)
        await mon.stop()

    run(main())


def test_reference_daemon_registers_with_a_port_mon():
    """A reference daemon registers with a port mon, and a port router
    learns it from the port mon's pushes."""
    from ceph_tpu.accel import AccelDaemon as RefAccelDaemon
    from ceph_tpu.common import Config as RefConfig

    async def main():
        mon = Monitor(max_osds=4)
        mon_addr = await mon.start()
        acc = RefAccelDaemon(
            "accel.r", mon_addr=mon_addr,
            config=RefConfig({"accel_locality": "hostR",
                              "accel_beacon_interval": 0.05}, env=""))
        await acc.start()
        feeder = _FleetFeeder("osd.0")
        await feeder.subscribe(mon_addr)
        await _wait(lambda: len(feeder.router._map_clients) == 1)
        (cl,) = feeder.router._map_clients.values()
        assert cl.addr == acc.addr and cl.locality == "hostR"
        assert cl.aid == mon.osdmap.accelmap.by_name("accel.r").aid
        await acc.stop(crash=True)
        await _wait(lambda: not feeder.router._map_clients)
        assert feeder.router.unreachable
        await feeder.stop()
        await mon.stop()

    run(main())


def test_fleet_perf_families_match_reference():
    """The client half of ``accel`` (with the fleet keys) and the
    per-target ``accel@<id>`` family register the reference's keys,
    types and descriptions."""
    from ceph_tpu.common import PerfCountersCollection as RefCollection
    from ceph_tpu.osd import ec_perf as ref_ec_perf
    from ceph_tpu_torch.common import PerfCountersCollection
    from ceph_tpu_torch.osd import ec_perf

    port, ref = PerfCountersCollection(), RefCollection()
    ec_perf.create_accel_client_perf(port)
    ref_ec_perf.create_accel_client_perf(ref)
    ec_perf.create_accel_target_perf(port, 3)
    ref_ec_perf.create_accel_target_perf(ref, 3)
    assert port.schema() == ref.schema()
    assert set(port.dump()) == {"accel", "accel@3"}


# -- the daemon tool ---------------------------------------------------------------


def _spawn(args):
    return subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)


def _first_line(proc, timeout=60):
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, "the daemon printed nothing in time"
    return proc.stdout.readline()


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def test_daemon_tool_runs_a_mon_and_a_registered_accel(tmp_path):
    """``mon`` with a store and ``accel --monmap FILE --locality L
    --device cpu`` as processes: the daemon shows up in the mon's
    AccelMap (``accel ls``), and both stop cleanly on SIGTERM."""
    from ceph_tpu_torch.tools import monmaptool

    procs = []
    try:
        mon = _spawn(["mon", "--rank", "0", "--addr", "127.0.0.1:0",
                      "--monmap", "127.0.0.1:0", "--store",
                      str(tmp_path / "mon.0"), "--watch-parent",
                      str(os.getpid())])
        procs.append(mon)
        line = _first_line(mon)
        assert line.startswith("mon.0 up at 127.0.0.1:"), line
        mon_addr = line.split()[-1]
        monmap = str(tmp_path / "monmap.json")
        assert monmaptool.main(["--create", "--add", "mon.0", mon_addr,
                                "-o", monmap]) == 0
        acc = _spawn(["accel", "--id", "4", "--addr", "127.0.0.1:0",
                      "--monmap", monmap, "--locality", "host4",
                      "--device", "cpu", "--watch-parent",
                      str(os.getpid())])
        procs.append(acc)
        line = _first_line(acc)
        assert line.startswith("accel.4 up at 127.0.0.1:"), line
        acc_addr = line.split()[-1]

        async def main():
            cl = await MonClient([mon_addr]).connect()
            await _wait(lambda: cl.osdmap.accelmap.by_name("accel.4")
                        is not None, 20)
            code, _s, out = await cl.command({"prefix": "accel ls"})
            assert code == 0
            (entry,) = out["accels"].values()
            assert entry["name"] == "accel.4" and entry["up"]
            assert entry["addr"] == acc_addr
            assert entry["locality"] == "host4"
            await cl.shutdown()

        run(main())
        assert _stop(acc) == 0
        assert _stop(mon) == 0
        # the store outlives the process
        assert os.path.isdir(tmp_path / "mon.0")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_daemon_tool_exits_when_its_parent_is_gone():
    """``--watch-parent`` names a process that has already exited: the
    daemon exits at once (0) instead of outliving its spawner."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    proc = _spawn(["accel", "--id", "5", "--addr", "127.0.0.1:0",
                   "--device", "cpu", "--watch-parent", str(dead.pid)])
    try:
        assert proc.wait(timeout=60) == 0
        assert proc.stdout.read() == ""
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
