"""The port's shared EC accelerator service against the reference.

The slice's path: simulated OSDs (each an ``AsyncMessenger``, an
``AccelClient`` and an ``ECDispatcher(remote=client)``) ship coalesced
batches over loopback TCP to one ``AccelDaemon``, whose own dispatcher
runs them through ``ec_util`` and the codecs' kernels and answers with
``MAccelReply`` frames.

- **Twins** of the reference's ``tests/test_accel_service.py``
  (``TestRemoteLaneIdentity``, ``TestRoutingPolicy``,
  ``TestRemoteFailover``, ``TestCrossClientCoalescing``) and
  ``tests/test_accel_fleet.py`` (``TestAccelMap``).  The daemon runs on
  ``device="cpu"`` with the port's ``native.host_engine_active`` patched
  to False in the identity cases, so it takes the batching lane with
  the plain versions of the kernels: the lane a CUDA codec takes on the
  card.  Every byte is held against the REFERENCE's ``ec_util`` on the
  reference's codec (exact bytes).
- **Cross-package live checks**, over loopback in one event loop: a
  port OSD feeder against a reference ``AccelDaemon``, and a reference
  feeder against a port ``AccelDaemon(device="cpu")``.
- The remote lane's flight records carry the daemon's ``served`` and
  ``device_wall_s``: the port's messenger restores the trace id into
  the port's ``current_trace``, which the daemon looks its launch up by.
- A device error inside the daemon's worker reaches the reply as EIO and
  the OSD replays the batch locally; nothing hangs.

The cases that need a ``MiniCluster`` (``TestLiveClusterAccel``) wait
for the port's OSD.  Every async body runs under ``asyncio.wait_for``
(:func:`run`), so a hang fails in seconds.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.accel import AccelClient, AccelDaemon, AccelMap
from ceph_tpu_torch.common import Config
from ceph_tpu_torch.models import registry
from ceph_tpu_torch.msg import AsyncMessenger, Dispatcher, messages
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
from ceph_tpu_torch.utils import native

# every async body's limit: the slowest case takes about a second
ASYNC_LIMIT_S = 30.0

ISA = {"plugin": "isa", "technique": "reed_sol_van", "k": "2", "m": "1"}
W16 = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "2",
       "m": "1", "w": "16"}
CAUCHY = {"plugin": "jerasure", "technique": "cauchy_good", "k": "3",
          "m": "2", "packetsize": "32"}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, ASYNC_LIMIT_S))


def _codec(profile):
    return registry.instance().factory(profile["plugin"], profile,
                                       device="cpu")


def _ref_codec(profile):
    from ceph_tpu.models import registry as ref_registry

    return ref_registry.instance().factory(profile["plugin"], profile)


def _sinfo(codec, cs: int = 128) -> ec_util.StripeInfo:
    k = codec.get_data_chunk_count()
    return ec_util.StripeInfo(stripe_width=cs * k, chunk_size=cs)


def _ref_encode(profile, sinfo, buf):
    """The reference's bytes: its own ec_util on its own codec."""
    from ceph_tpu.osd import ec_util as ref_ec_util

    rs = ref_ec_util.StripeInfo(stripe_width=sinfo.stripe_width,
                                chunk_size=sinfo.chunk_size)
    return ref_ec_util.encode(rs, _ref_codec(profile), buf)


def _assert_shards_equal(got, want, ctx=""):
    assert set(got) == set(want), ctx
    for s in want:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s])), \
            f"{ctx} shard {s}"


def _bufs(seed, sinfo, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(s * sinfo.stripe_width,),
                         dtype=np.uint8) for s in sizes]


@pytest.fixture
def batching_lane(monkeypatch):
    """The daemon's CPU codecs take the batching lane (plain kernels),
    the lane a CUDA codec takes on the card."""
    monkeypatch.setattr(native, "host_engine_active",
                        lambda device=None: False)


class _Feeder(Dispatcher):
    """A simulated OSD: messenger + dispatcher with a remote lane."""

    def __init__(self, name: str, addr: str, *, mode: str = "prefer",
                 deadline: float = 20.0, window: float = 0.001,
                 perf=None, pacc=None):
        self.messenger = AsyncMessenger(name, self)
        self.client = AccelClient(self.messenger, addr=addr, mode=mode,
                                  deadline=deadline,
                                  retry_interval=0.05, perf=pacc)
        self.dispatch = ECDispatcher(perf=perf, window=window,
                                     remote=self.client)

    async def ms_dispatch(self, conn, msg):
        self.client.handle(msg)

    def ms_handle_reset(self, conn):
        self.client.on_reset(conn)

    async def stop(self):
        await self.dispatch.stop()
        await self.messenger.shutdown()


async def _with_service(body, **daemon_kw):
    acc = AccelDaemon("accel.t", device="cpu", **daemon_kw)
    await acc.start()
    feeder = _Feeder("osd.0", acc.addr)
    try:
        await body(acc, feeder)
    finally:
        await feeder.stop()
        await acc.stop()


# -- twins of the reference's TestRemoteLaneIdentity --------------------------


@pytest.mark.usefixtures("batching_lane")
class TestRemoteLaneIdentity:
    def test_encode_identity_mixed_sizes_and_buckets(self):
        """Remote-lane encodes across bucket boundaries match the
        reference's bytes (w=8 matrix codec), and every remote flight
        record carries the daemon's served engine and device wall."""
        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        sizes = [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33]
        bufs = _bufs(5, sinfo, sizes)

        async def body(acc, feeder):
            outs = await asyncio.gather(*[
                feeder.dispatch.encode(sinfo, codec, b) for b in bufs
            ])
            for b, out in zip(bufs, outs):
                _assert_shards_equal(out, _ref_encode(ISA, sinfo, b))
            # the batches actually took the remote lane
            lanes = feeder.dispatch.dump()["totals"]["lanes"]
            assert lanes["remote"]["ops"] == len(bufs)
            assert lanes["device"]["ops"] == 0
            # ...and the accelerator attributed them to this client
            assert "osd.0" in acc.client_table()
            # ...on its batching lane, never the native one
            assert acc.dispatch.dump()["totals"]["native_direct"] == 0
            # reply piggyback: the client-side flight record names the
            # engine the ACCELERATOR served from, and its device_wall_s
            # is the accel's launch time, not the RTT.  Both come back
            # None unless the daemon found its launch by the trace id
            # the port's messenger restored
            recs = [r for r in feeder.dispatch.flight.dump()["launches"]
                    if r.get("lane") == "remote"]
            assert recs
            walls = {r["device_wall_s"] for r in
                     acc.dispatch.flight.dump()["launches"]}
            for r in recs:
                assert r["remote_served"] == "device", r
                assert r["device_wall_s"] in walls, (r, walls)
                assert r["remote_queue_wait_s"] >= 0.0
            traced = [t for r in acc.dispatch.flight.dump()["launches"]
                      for t in [r["slowest_trace"]] if t]
            assert traced and all(t.startswith("osd.0:") for t in traced)

        run(_with_service(body))

    def test_encode_identity_w16(self):
        """w=16 codecs ride the remote lane bit-identically (the u16
        reinterpret path on the accelerator side)."""
        codec = _codec(W16)
        sinfo = _sinfo(codec)
        bufs = _bufs(6, sinfo, (1, 3, 8))

        async def body(acc, feeder):
            outs = await asyncio.gather(*[
                feeder.dispatch.encode(sinfo, codec, b) for b in bufs
            ])
            for b, out in zip(bufs, outs):
                _assert_shards_equal(out, _ref_encode(W16, sinfo, b))

        run(_with_service(body))

    def test_decode_identity_with_erasure(self):
        """Remote reconstructs (one data shard missing) match the
        originals, mixed sizes coalesced into one batch."""
        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        bufs = _bufs(7, sinfo, (2, 5, 8))
        survivors = [{s: np.asarray(v)
                      for s, v in _ref_encode(ISA, sinfo, b).items()
                      if s != 0} for b in bufs]

        async def body(acc, feeder):
            outs = await asyncio.gather(*[
                feeder.dispatch.decode_concat(sinfo, codec, surv)
                for surv in survivors
            ])
            for b, got in zip(bufs, outs):
                assert bytes(got) == bytes(b)
            assert feeder.dispatch.dump()[
                "totals"]["lanes"]["remote"]["ops"] == len(bufs)

        run(_with_service(body))

    def test_bitmatrix_encode_and_multi_erasure_decode(self):
        """A bit-matrix codec (the card's ``bitmatrix_xor`` path) through
        the service: encode, then a two-erasure reconstruct."""
        codec = _codec(CAUCHY)
        sinfo = _sinfo(codec, cs=3 * 8 * 32)
        bufs = _bufs(12, sinfo, (1, 2, 4))

        async def body(acc, feeder):
            outs = await asyncio.gather(*[
                feeder.dispatch.encode(sinfo, codec, b) for b in bufs
            ])
            wants = [_ref_encode(CAUCHY, sinfo, b) for b in bufs]
            for out, want in zip(outs, wants):
                _assert_shards_equal(out, want)
            survivors = [{s: np.asarray(v) for s, v in w.items()
                          if s not in (0, 2)} for w in wants]
            back = await asyncio.gather(*[
                feeder.dispatch.decode_concat(sinfo, codec, surv)
                for surv in survivors
            ])
            for b, got in zip(bufs, back):
                assert bytes(got) == bytes(b)

        run(_with_service(body))

    def test_remote_lane_counters(self):
        """The remote lane feeds the ``ec`` family's ``dispatch_*_remote``
        split and the client half of the ``accel`` family, and leaves
        the local encode gauges alone (the device time is the
        accelerator's)."""
        from ceph_tpu_torch.common import PerfCountersCollection
        from ceph_tpu_torch.osd.ec_perf import (
            create_accel_client_perf,
            create_ec_perf,
        )

        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        bufs = _bufs(14, sinfo, (2, 3, 5))

        async def main():
            acc = AccelDaemon("accel.t", device="cpu")
            await acc.start()
            perf = PerfCountersCollection()
            pec, pacc = create_ec_perf(perf), create_accel_client_perf(perf)
            feeder = _Feeder("osd.0", acc.addr, perf=pec, pacc=pacc)
            await asyncio.gather(*[
                feeder.dispatch.encode(sinfo, codec, b) for b in bufs])
            ec, ac = pec.dump(), pacc.dump()
            lanes = feeder.dispatch.dump()["totals"]["lanes"]["remote"]
            assert ec["dispatch_batches_remote"] == lanes["batches"] >= 1
            assert ec["dispatch_ops_remote"] == len(bufs)
            assert ec["dispatch_batches_device"] == 0
            assert ec["encode_time"]["avgcount"] == 0
            assert ac["remote_ops"] == len(bufs)
            assert ac["remote_bytes"] == sum(b.size for b in bufs)
            assert ac["remote_rtt"]["avgcount"] == lanes["batches"]
            service = acc.perf.get("accel").dump()
            assert service["rpc_encode"] == lanes["batches"]
            assert service["rpc_bytes_in"] == sum(b.size for b in bufs)
            await feeder.stop()
            await acc.stop()

        run(main())

    def test_cancellation_mid_flight(self):
        """A waiter cancelled before its batch flushes is dropped; its
        peers' bytes are untouched (the abort contract, remote lane)."""
        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        bufs = _bufs(8, sinfo, (2, 3, 4))

        async def body(acc, feeder):
            feeder.dispatch.window = 0.05  # hold the batch open
            tasks = [asyncio.ensure_future(
                feeder.dispatch.encode(sinfo, codec, b)) for b in bufs]
            await asyncio.sleep(0)
            tasks[1].cancel()
            done = await asyncio.gather(*tasks, return_exceptions=True)
            assert isinstance(done[1], asyncio.CancelledError)
            for i in (0, 2):
                _assert_shards_equal(
                    done[i], _ref_encode(ISA, sinfo, bufs[i]))
            assert feeder.dispatch.dump()["totals"]["cancelled"] == 1

        run(_with_service(body))


# -- twins of the reference's TestRoutingPolicy -------------------------------


class TestRoutingPolicy:
    def _client(self, mode="prefer", addr="127.0.0.1:1"):
        return AccelClient(AsyncMessenger("osd.t", Dispatcher()),
                           addr=addr, mode=mode)

    def test_off_and_missing_profile_never_route(self):
        codec = _codec(ISA)
        assert not self._client(mode="off").routes(codec)
        assert not self._client(addr="").routes(codec)
        # a hand-built codec has no wire profile to rebuild from
        from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
        from ceph_tpu_torch.ops import matrices as mx

        bare = MatrixErasureCode(2, 1, 8, mx.isa_rs_vandermonde(2, 1),
                                 device="cpu")
        assert not self._client().routes(bare)

    def test_tripped_beacon_routes_away_without_timeout(self):
        """A TRIPPED beacon re-routes instantly (no connection attempt,
        no deadline wait) and the re-route is counted."""
        codec = _codec(ISA)
        cl = self._client()
        assert cl.routes(codec)
        cl.handle(messages.MAccelBeacon(
            name="accel.t", engine_state=2, queue_depth=0, capacity=8))
        assert not cl.routes(codec)
        assert cl.totals["routed_away"] == 1
        # a healthy beacon routes back
        cl.handle(messages.MAccelBeacon(
            name="accel.t", engine_state=0, queue_depth=0, capacity=8))
        assert cl.routes(codec)

    def test_saturated_beacon_routes_away(self):
        codec = _codec(ISA)
        cl = self._client()
        cl.handle(messages.MAccelBeacon(
            name="accel.t", engine_state=0, queue_depth=99, capacity=8))
        assert not cl.routes(codec)

    def test_require_routes_even_when_down(self):
        codec = _codec(ISA)
        cl = self._client(mode="require")
        cl._mark_down()
        assert cl.routes(codec)
        # prefer backs off instead
        cl2 = self._client()
        cl2._mark_down()
        assert not cl2.routes(codec)
        assert cl2.unreachable

    def test_live_retarget_resets_health(self):
        cl = self._client()
        cl._mark_down()
        cl.remote_state = 2
        cl.set_addr("127.0.0.1:2")
        assert not cl.unreachable
        assert cl.remote_state == 0

    def test_unreachable_is_sticky_until_heard_from(self):
        """The backoff expiring does NOT clear unreachable; traffic may
        re-probe, and only an actual beacon/reply clears."""
        cl = self._client()
        cl.retry_interval = 0.0  # backoff expires immediately
        cl._mark_down()
        assert cl.unreachable
        assert cl.available()  # due a re-probe...
        assert cl.unreachable  # ...but still DOWN until heard from
        cl.handle(messages.MAccelBeacon(
            name="accel.t", engine_state=0, queue_depth=0, capacity=8))
        assert not cl.unreachable

    def test_mode_off_clears_unreachable(self):
        cl = self._client()
        cl._mark_down()
        assert cl.unreachable
        cl.set_mode("off")
        assert not cl.unreachable

    def test_stale_connection_health_is_ignored(self):
        """After a live retarget, the OLD accelerator's still-open
        connection keeps beaconing; its healthy beacons must not mark
        the NEW endpoint reachable."""

        class _Conn:
            def __init__(self, peer_addr):
                self.peer_addr = peer_addr

        cl = self._client(addr="127.0.0.1:2")
        cl._mark_down()
        beacon = messages.MAccelBeacon(
            name="accel.old", engine_state=0, queue_depth=0, capacity=8)
        cl.handle(beacon, _Conn("127.0.0.1:1"))  # the OLD endpoint
        assert cl.unreachable  # not fooled
        cl.handle(beacon, _Conn("127.0.0.1:2"))  # the CURRENT one
        assert not cl.unreachable

    @pytest.mark.parametrize("age_off,fresh", [(0.0, False), (-0.05, True)])
    def test_stale_interval_boundary(self, age_off, fresh):
        """A snapshot aged exactly ``stale_interval`` no longer gates
        routing; one just younger still does."""
        import time

        codec = _codec(ISA)
        cl = self._client()
        cl.stale_interval = 1.0
        cl.remote_state = 2  # TRIPPED
        cl._state_at = time.monotonic() - cl.stale_interval - age_off
        assert cl.state_fresh() is fresh
        assert cl.routes(codec) is (not fresh)


# -- twins of the reference's TestRemoteFailover ------------------------------


class TestRemoteFailover:
    def test_accel_death_mid_batch_replays_locally(self):
        """Crash-stop the accelerator with a batch in flight: the
        waiters are served bit-identically by the LOCAL fallback, the
        flight record says served=fallback origin=remote, and the
        LOCAL device breaker never advanced."""
        from ceph_tpu_torch.osd.ec_failover import HEALTHY, EngineSupervisor

        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        buf = _bufs(9, sinfo, (6,))[0]

        async def main():
            acc = AccelDaemon("accel.t", device="cpu")
            await acc.start()
            feeder = _Feeder("osd.0", acc.addr)
            sup = EngineSupervisor(enabled=True, probe_interval=30.0)
            feeder.dispatch._supervisor = sup
            t = asyncio.ensure_future(
                feeder.dispatch.encode(sinfo, codec, buf))
            await asyncio.sleep(0)  # let the batch open
            await acc.stop(crash=True)  # SIGKILL analog: no replies
            out = await t
            _assert_shards_equal(out, _ref_encode(ISA, sinfo, buf))
            totals = feeder.dispatch.dump()["totals"]
            assert totals["failovers"] == 1
            assert totals["replayed_ops"] == 1
            rec = feeder.dispatch.flight.dump()["launches"][-1]
            assert rec["lane"] == "remote"
            assert rec["served"] == "fallback"
            assert rec["origin"] == "remote"
            # the LOCAL breaker never moved
            assert sup.state == HEALTHY
            assert sup.totals["fatal_errors"] == 0
            assert feeder.client.unreachable
            assert feeder.client.totals["failures"] >= 1
            await feeder.stop()

        run(main())

    def test_unreachable_accel_replays_and_backs_off(self):
        """No accelerator listening at all: the first batch replays on
        the local fallback, the client backs off, and (prefer mode)
        the NEXT batch takes the local lanes without an RPC attempt."""
        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        buf = _bufs(10, sinfo, (2,))[0]

        async def main():
            feeder = _Feeder("osd.0", "127.0.0.1:1", deadline=5.0)
            out = await feeder.dispatch.encode(sinfo, codec, buf)
            _assert_shards_equal(out, _ref_encode(ISA, sinfo, buf))
            assert feeder.client.unreachable
            before = feeder.dispatch.dump()["totals"]["lanes"]["remote"]
            out2 = await feeder.dispatch.encode(sinfo, codec, buf)
            _assert_shards_equal(out2, _ref_encode(ISA, sinfo, buf))
            after = feeder.dispatch.dump()["totals"]["lanes"]["remote"]
            assert after["batches"] == before["batches"]
            await feeder.stop()

        run(main())

    @pytest.mark.usefixtures("batching_lane")
    def test_device_error_in_a_worker_is_eio_and_replays_locally(self):
        """A device error raised inside the daemon's worker thread, with
        the daemon's own failover off, reaches the reply as EIO; the OSD
        replays the batch on its local fallback (bit-identical) and its
        local breaker does not move.  With the daemon's failover on, the
        daemon replays on its own host engine and says so."""
        from ceph_tpu_torch.osd.ec_failover import HEALTHY, EngineSupervisor

        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        bufs = _bufs(13, sinfo, (3, 4))

        async def main():
            cfg = Config({"osd_ec_engine_failover": False,
                          "ec_inject_engine_failure": 1}, env="")
            acc = AccelDaemon("accel.t", config=cfg, device="cpu")
            await acc.start()
            feeder = _Feeder("osd.0", acc.addr, mode="require")
            sup = EngineSupervisor(enabled=True, probe_interval=30.0)
            feeder.dispatch._supervisor = sup
            outs = await asyncio.gather(*[
                feeder.dispatch.encode(sinfo, codec, b) for b in bufs])
            for b, out in zip(bufs, outs):
                _assert_shards_equal(out, _ref_encode(ISA, sinfo, b))
            assert acc.perf.get("accel").get("rpc_errors") >= 1
            rec = feeder.dispatch.flight.dump()["launches"][-1]
            assert (rec["served"], rec["origin"]) == ("fallback", "remote")
            assert "could not serve" in rec["error"]
            assert sup.state == HEALTHY
            # the reachable accelerator stays routable
            assert not feeder.client.unreachable
            # failover on: the daemon serves from its own host engine
            cfg.set("osd_ec_engine_failover", True)
            outs = await asyncio.gather(*[
                feeder.dispatch.encode(sinfo, codec, b) for b in bufs])
            for b, out in zip(bufs, outs):
                _assert_shards_equal(out, _ref_encode(ISA, sinfo, b))
            rec = feeder.dispatch.flight.dump()["launches"][-1]
            assert rec["served"] == "remote"
            assert rec["remote_served"] == "fallback"
            assert acc.dispatch.dump()["totals"]["failovers"] >= 1
            await feeder.stop()
            await acc.stop()

        run(main())


# -- twin of the reference's TestCrossClientCoalescing ------------------------


class TestCrossClientCoalescing:
    @pytest.mark.usefixtures("batching_lane")
    def test_two_feeders_share_a_launch(self):
        """Two OSD clients' concurrent batches coalesce into ONE
        accelerator launch (the shared-occupancy win), and the flight
        record names both clients."""
        codec = _codec(ISA)
        sinfo = _sinfo(codec)
        b1, b2 = _bufs(11, sinfo, (3, 4))

        async def main():
            # a generous window so both clients' RPCs land inside one
            # accelerator batch deterministically
            acc = AccelDaemon("accel.t", device="cpu", config=Config(
                {"osd_ec_dispatch_window": 0.05}, env=""))
            await acc.start()
            f1 = _Feeder("osd.1", acc.addr)
            f2 = _Feeder("osd.2", acc.addr)
            o1, o2 = await asyncio.gather(
                f1.dispatch.encode(sinfo, codec, b1),
                f2.dispatch.encode(sinfo, codec, b2),
            )
            _assert_shards_equal(o1, _ref_encode(ISA, sinfo, b1))
            _assert_shards_equal(o2, _ref_encode(ISA, sinfo, b2))
            t = acc.dispatch._totals
            assert t["cross_client_batches"] >= 1
            recs = acc.dispatch.flight.dump()["launches"]
            shared = [r for r in recs if len(r.get("clients") or []) > 1]
            assert shared, recs
            assert set(shared[-1]["clients"]) == {"osd.1", "osd.2"}
            # the service half mirrors the total
            acc._sync_cross_client()
            assert acc.perf.get("accel").get("cross_client_batches") >= 1
            await f1.stop()
            await f2.stop()
            await acc.stop()

        run(main())


# -- cross-package live checks ------------------------------------------------


class _RefFeeder:
    """A reference OSD feeder: its messenger, client and dispatcher."""

    def __init__(self, name: str, addr: str):
        from ceph_tpu.accel import AccelClient as RefClient
        from ceph_tpu.msg import AsyncMessenger as RefMessenger
        from ceph_tpu.msg import Dispatcher as RefDispatcher
        from ceph_tpu.osd.ec_dispatch import ECDispatcher as RefDispatch

        feeder = self

        class _D(RefDispatcher):
            async def ms_dispatch(self, conn, msg):
                feeder.client.handle(msg)

            def ms_handle_reset(self, conn):
                feeder.client.on_reset(conn)

        self.messenger = RefMessenger(name, _D())
        self.client = RefClient(self.messenger, addr=addr,
                                mode="require", deadline=20.0)
        self.dispatch = RefDispatch(window=0.001, remote=self.client)

    async def stop(self):
        await self.dispatch.stop()
        await self.messenger.shutdown()


@pytest.mark.parametrize("profile", [ISA, CAUCHY], ids=["isa", "cauchy"])
def test_port_feeder_against_reference_daemon(profile):
    """A port OSD (messenger + AccelClient + ECDispatcher) against the
    reference's AccelDaemon: encode and a one-erasure decode_concat
    return the reference's ec_util bytes."""
    from ceph_tpu.accel import AccelDaemon as RefDaemon

    codec = _codec(profile)
    cs = 128 if profile is ISA else 3 * 8 * 32
    sinfo = _sinfo(codec, cs=cs)
    bufs = _bufs(21, sinfo, (1, 4, 7))

    async def main():
        acc = RefDaemon("accel.r")
        await acc.start()
        feeder = _Feeder("osd.p", acc.addr, mode="require")
        outs = await asyncio.gather(*[
            feeder.dispatch.encode(sinfo, codec, b) for b in bufs])
        wants = [_ref_encode(profile, sinfo, b) for b in bufs]
        for out, want in zip(outs, wants):
            _assert_shards_equal(out, want)
        survivors = [{s: np.asarray(v) for s, v in w.items() if s != 1}
                     for w in wants]
        back = await asyncio.gather(*[
            feeder.dispatch.decode_concat(sinfo, codec, s)
            for s in survivors])
        for b, got in zip(bufs, back):
            assert bytes(got) == bytes(b)
        lanes = feeder.dispatch.dump()["totals"]["lanes"]
        assert lanes["remote"]["ops"] == 2 * len(bufs)
        assert feeder.dispatch.dump()["totals"]["failovers"] == 0
        assert "osd.p" in acc.client_table()
        await feeder.stop()
        await acc.stop()

    run(main())


@pytest.mark.usefixtures("batching_lane")
@pytest.mark.parametrize("profile", [ISA, W16], ids=["isa", "w16"])
def test_reference_feeder_against_port_daemon(profile):
    """A reference OSD against the port's AccelDaemon(device="cpu") on
    its batching lane: encode and a one-erasure decode_concat return the
    reference's ec_util bytes, and the reference's flight records carry
    the port daemon's served engine and device wall."""
    from ceph_tpu.osd import ec_util as ref_ec_util

    rcodec = _ref_codec(profile)
    k = rcodec.get_data_chunk_count()
    rsinfo = ref_ec_util.StripeInfo(stripe_width=128 * k, chunk_size=128)
    sinfo = _sinfo(_codec(profile))
    bufs = _bufs(22, sinfo, (2, 5, 9))

    async def main():
        acc = AccelDaemon("accel.p", device="cpu")
        await acc.start()
        feeder = _RefFeeder("osd.r", acc.addr)
        outs = await asyncio.gather(*[
            feeder.dispatch.encode(rsinfo, rcodec, b) for b in bufs])
        wants = [ref_ec_util.encode(rsinfo, rcodec, b) for b in bufs]
        for out, want in zip(outs, wants):
            _assert_shards_equal(out, want)
        survivors = [{s: np.asarray(v) for s, v in w.items() if s != 0}
                     for w in wants]
        back = await asyncio.gather(*[
            feeder.dispatch.decode_concat(rsinfo, rcodec, s)
            for s in survivors])
        for b, got in zip(bufs, back):
            assert bytes(got) == bytes(b)
        totals = feeder.dispatch.dump()["totals"]
        assert totals["lanes"]["remote"]["ops"] == 2 * len(bufs)
        assert totals["failovers"] == 0
        recs = [r for r in feeder.dispatch.flight.dump()["launches"]
                if r.get("lane") == "remote"]
        assert recs and all(r["remote_served"] == "device"
                            and r["device_wall_s"] is not None
                            for r in recs), recs
        assert acc.dispatch.dump()["totals"]["native_direct"] == 0
        await feeder.stop()
        await acc.stop()

    run(main())


# -- twins of the reference's TestAccelMap ------------------------------------


class TestAccelMap:
    def test_register_markdown_epochs_and_stable_ids(self):
        amap = AccelMap()
        assert amap.note_boot("accel.a", "127.0.0.1:1", "host0", 8)
        assert amap.epoch == 1
        aid = amap.by_name("accel.a").aid
        # steady-state re-registration beacons cost no epoch churn
        assert not amap.note_boot("accel.a", "127.0.0.1:1", "host0", 8)
        assert amap.epoch == 1
        assert amap.note_boot("accel.b", "127.0.0.1:2", "host1", 8)
        assert amap.epoch == 2
        assert amap.mark_down("accel.a")
        assert amap.epoch == 3
        assert not amap.mark_down("accel.a")  # already down: no churn
        assert [e.name for e in amap.up_entries()] == ["accel.b"]
        # a restarted accelerator keeps its id
        assert amap.note_boot("accel.a", "127.0.0.1:9", "host0", 8)
        assert amap.by_name("accel.a").aid == aid
        assert amap.by_name("accel.a").addr == "127.0.0.1:9"

    def test_rides_osdmap_wire_and_incremental(self):
        import json

        from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap

        m = OSDMap()
        m.set_max_osd(3)
        m.epoch = 1
        before = m.to_dict()
        m.accelmap.note_boot("accel.a", "127.0.0.1:1", "hostX", 4)
        m.epoch = 2
        after = m.to_dict()
        # full-dict round trip
        m2 = OSDMap.from_dict(after)
        e = m2.accelmap.by_name("accel.a")
        assert e is not None and e.up and e.locality == "hostX"
        assert m2.accelmap.epoch == 1
        # the structural delta carries the registration too
        inc = Incremental.diff(before, after)
        patched = json.loads(json.dumps(before))
        inc.apply_to_dict(patched)
        m3 = OSDMap.from_dict(patched)
        assert m3.accelmap.by_name("accel.a") is not None
