"""The port's Monitor against the reference.

- **Twins** of ``tests/test_mon.py`` (all eight: boot/failure
  lifecycle, EC profile commands, pools, operator out, reweight) with
  the port's ``Monitor`` and a port client (:class:`MonClient`: the
  port's messenger, map subscription, mon commands that follow leader
  redirects and hunt live mons).  OSD boots are ``MOSDBoot`` messages
  sent by a client.
- **Twins** of ``tests/test_multimon.py`` whose mutations are mon
  commands (elections, replication, redirects, rejoin, restarts of the
  whole quorum from its stores, the Paxos-lite recovery cases, delta
  proposes, quorum status) on a three-mon quorum (:class:`Quorum`).
  The cases that need RADOS writes wait for the port's OSD (ROADMAP).
- **Cross-package:** a quorum of two reference mons and one port mon
  elects the lowest rank and replicates a command to all three (the
  port mon as leader and as peon), and a mon store written by either
  package restarts a mon of the other.
- ``tools/monmaptool.py`` writes and reads the reference's files.

The quorum runs with a 0.25 s lease and a 1 s election timeout, so an
election settles in about a second.  Every async body runs under
``asyncio.timeout`` (:func:`run`), so a hang fails in seconds.
"""

import asyncio
import json

import pytest

from ceph_tpu_torch.common import Config
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.msg import AsyncMessenger, Dispatcher, messages
from ceph_tpu_torch.osd.osdmap import advance_map

# every async body's limit
ASYNC_LIMIT_S = 30.0
EAGAIN = 11

# the quorum's clocks: leases and elections settle in about a second
QUORUM_OVERRIDES = {"mon_lease_interval": 0.25, "mon_election_timeout": 1.0}


def run(coro):
    async def bounded():
        async with asyncio.timeout(ASYNC_LIMIT_S):
            return await coro

    return asyncio.run(bounded())


async def _wait(pred, timeout=5.0):
    async with asyncio.timeout(timeout):
        while not pred():
            await asyncio.sleep(0.005)


class Client(Dispatcher):
    """Minimal mon client: command round-trips + map collection (the
    twin of ``tests/test_mon.py``'s)."""

    def __init__(self, name: str):
        self.name = name
        self.messenger = AsyncMessenger(name, self)
        self.maps: list[int] = []
        self.osdmap = None
        self.replies: dict[int, messages.MMonCommandReply] = {}
        self._tid = 0

    async def ms_dispatch(self, conn, msg):
        if isinstance(msg, messages.MOSDMapMsg):
            self.maps.append(msg.epoch)
            m = advance_map(
                self.osdmap, msg.epoch, msg.osdmap, msg.incrementals
            )
            if m is None:
                conn.send(messages.MMonGetMap(have=None))
                return
            self.osdmap = m
        elif isinstance(msg, messages.MMonCommandReply):
            self.replies[msg.tid] = msg

    def ms_handle_reset(self, conn):
        pass

    async def command(self, conn, cmd: dict, timeout=5.0):
        self._tid += 1
        tid = self._tid
        conn.send(messages.MMonCommand(tid=tid, cmd=cmd))
        async with asyncio.timeout(timeout):
            while tid not in self.replies:
                await asyncio.sleep(0.005)
        r = self.replies.pop(tid)
        return r.code, r.status, r.out


class MonClient(Dispatcher):
    """A port client of a mon quorum: the reference ``RadosClient``'s
    mon half (map subscription with re-homing, commands that follow
    leader redirects and hunt any live mon)."""

    def __init__(self, monmap, name: str = "client.admin",
                 max_retries: int = 40):
        self.messenger = AsyncMessenger(name, self)
        self.monmap = list(monmap)
        self.max_retries = max_retries
        self.osdmap = None
        self._cmd_addr: str | None = None
        self._futs: dict[int, asyncio.Future] = {}
        self._tid = 0
        self._sub = None

    async def _mon_conn(self, addr=None):
        last = None
        for a in [addr] if addr else self.monmap:
            try:
                conn = await self.messenger.connect(a, f"mon@{a}")
                self._cmd_addr = a
                return conn
            except (ConnectionError, OSError) as e:
                last = e
        raise ConnectionError(f"no mon reachable: {last}")

    async def connect(self):
        self._sub = await self._mon_conn()
        self._sub.send(messages.MMonGetMap(have=0))
        await _wait(lambda: self.osdmap is not None, 10)
        return self

    async def ms_dispatch(self, conn, msg):
        if isinstance(msg, messages.MOSDMapMsg):
            if self.osdmap is None or msg.epoch > self.osdmap.epoch:
                m = advance_map(self.osdmap, msg.epoch, msg.osdmap,
                                msg.incrementals)
                if m is None:
                    conn.send(messages.MMonGetMap(have=None))
                    return
                self.osdmap = m
        elif isinstance(msg, messages.MMonCommandReply):
            fut = self._futs.get(msg.tid)
            if fut is not None and not fut.done():
                fut.set_result(msg)

    def ms_handle_reset(self, conn):
        for tid, fut in list(self._futs.items()):
            if not fut.done():
                fut.set_exception(ConnectionResetError("mon reset"))
        if conn is self._sub:
            # the subscription mon died: re-home the map feed
            async def rehunt():
                for _ in range(50):
                    try:
                        self._sub = await self._mon_conn()
                        self._sub.send(messages.MMonGetMap(
                            have=self.osdmap.epoch if self.osdmap else 0))
                        return
                    except (ConnectionError, OSError):
                        await asyncio.sleep(0.1)

            asyncio.ensure_future(rehunt())

    async def command_on(self, conn, cmd):
        self._tid += 1
        tid = self._tid
        fut = self._futs[tid] = asyncio.get_running_loop().create_future()
        try:
            conn.send(messages.MMonCommand(tid=tid, cmd=cmd))
            async with asyncio.timeout(5.0):
                return await fut
        finally:
            self._futs.pop(tid, None)

    async def command(self, cmd: dict):
        target = self._cmd_addr
        last = None
        for _ in range(self.max_retries):
            try:
                conn = await self._mon_conn(target)
                reply = await self.command_on(conn, cmd)
            except (ConnectionError, OSError, TimeoutError):
                target = None
                await asyncio.sleep(0.1)
                continue
            if reply.code == -EAGAIN and reply.status == "not leader":
                hint = (reply.out or {}).get("addr")
                target = hint
                last = (reply.code, reply.status, reply.out)
                await asyncio.sleep(0.1 if hint is None else 0)
                continue
            return reply.code, reply.status, reply.out
        if last is not None:
            return last
        raise TimeoutError("mon command exhausted retries")

    async def create_pool(self, name, pool_type="replicated", **kw):
        cmd = {"prefix": "osd pool create", "pool": name,
               "pool_type": pool_type, **{k: v for k, v in kw.items()}}
        code, status, out = await self.command(cmd)
        assert code == 0, (code, status)
        await _wait(lambda: self.osdmap is not None
                    and self.osdmap.lookup_pool(name) is not None, 10)
        return out

    async def shutdown(self):
        await self.messenger.shutdown()


def _quorum_config():
    return Config(dict(QUORUM_OVERRIDES), env="")


class Quorum:
    """``n`` mons on loopback (the mon half of the reference's
    MiniCluster): start, leader, kill and restart on the same address,
    each mon built by ``mon_cls[rank]`` (the port's Monitor unless a
    case mixes in the reference's)."""

    def __init__(self, n: int = 3, store_dir=None, mon_cls=None):
        self.n = n
        self.store_dir = store_dir
        self.mon_cls = mon_cls or {}
        self.mons: dict[int, object] = {}
        self.monmap: list[str] = []
        self.clients: list[MonClient] = []

    def _make_mon(self, rank: int):
        cls = self.mon_cls.get(rank, Monitor)
        store = (f"{self.store_dir}/mon.{rank}" if self.store_dir is not None
                 else None)
        if cls is Monitor:
            config = _quorum_config()
        else:
            from ceph_tpu.common import Config as RefConfig

            config = RefConfig(dict(QUORUM_OVERRIDES), env="")
        return cls(name=f"mon.{rank}", rank=rank, store_path=store,
                   config=config)

    async def start(self):
        for r in range(self.n):
            self.mons[r] = self._make_mon(r)
            await self.mons[r].start()
        self.monmap = [self.mons[r].addr for r in range(self.n)]
        for m in self.mons.values():
            m.set_monmap(self.monmap)
        for m in self.mons.values():
            await m.start_quorum()
        if self.n > 1:
            await self.wait_for_leader()
        return self

    @property
    def mon(self):
        for m in self.mons.values():
            if m.is_leader:
                return m
        return next(iter(self.mons.values()))

    async def wait_for_leader(self, timeout: float = 10.0):
        async with asyncio.timeout(timeout):
            while True:
                for m in self.mons.values():
                    if m.is_leader:
                        return m
                await asyncio.sleep(0.01)

    async def kill_mon(self, rank: int):
        await self.mons.pop(rank).stop()

    async def restart_mon(self, rank: int):
        if rank in self.mons:
            await self.kill_mon(rank)
        m = self._make_mon(rank)
        self.mons[rank] = m
        host, port = self.monmap[rank].rsplit(":", 1)
        await m.start(host, int(port))
        m.set_monmap(self.monmap)
        await m.start_quorum()
        return m

    async def client(self):
        cl = await MonClient(self.monmap).connect()
        self.clients.append(cl)
        return cl

    async def stop(self):
        for cl in self.clients:
            await cl.shutdown()
        for r in list(self.mons):
            await self.mons.pop(r).stop()

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.stop()


# -- twins of tests/test_mon.py -----------------------------------------------


def test_boot_marks_up_and_publishes():
    async def main():
        mon = Monitor(max_osds=4)
        addr = await mon.start()
        cl = Client("client.1")
        conn = await cl.messenger.connect(addr)
        conn.send(messages.MMonGetMap(have=0))
        await _wait(lambda: cl.osdmap is not None)
        assert not cl.osdmap.is_up(0)

        osd = Client("osd.0")
        oconn = await osd.messenger.connect(addr)
        oconn.send(messages.MOSDBoot(osd_id=0, addr="127.0.0.1:7000"))
        await _wait(lambda: cl.osdmap is not None and cl.osdmap.is_up(0))
        assert cl.osdmap.get_addr(0) == "127.0.0.1:7000"
        assert cl.osdmap.is_in(0)

        # osd connection reset -> marked down, epoch bumped
        before = cl.osdmap.epoch
        await osd.messenger.shutdown()
        await _wait(lambda: cl.osdmap.epoch > before and cl.osdmap.is_down(0))
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_failure_reports_mark_down():
    async def main():
        mon = Monitor(max_osds=4, failure_min_reporters=2)
        addr = await mon.start()
        osds = []
        for i in range(3):
            c = Client(f"osd.{i}")
            conn = await c.messenger.connect(addr)
            conn.send(messages.MOSDBoot(osd_id=i, addr=f"127.0.0.1:{7000+i}"))
            osds.append((c, conn))
        await _wait(lambda: all(mon.osdmap.is_up(i) for i in range(3)))

        # one reporter is not enough
        osds[1][1].send(messages.MOSDFailure(target_osd=0, reporter=1, epoch=1))
        await asyncio.sleep(0.05)
        assert mon.osdmap.is_up(0)
        # second distinct reporter trips it
        osds[2][1].send(messages.MOSDFailure(target_osd=0, reporter=2, epoch=1))
        await _wait(lambda: mon.osdmap.is_down(0))
        for c, _ in osds:
            await c.messenger.shutdown()
        await mon.stop()

    run(main())


def test_ec_profile_commands():
    async def main():
        mon = Monitor()
        addr = await mon.start()
        cl = Client("client.2")
        conn = await cl.messenger.connect(addr)

        code, _, out = await cl.command(conn, {"prefix": "osd erasure-code-profile ls"})
        assert code == 0 and out == ["default"]

        code, _, _ = await cl.command(conn, {
            "prefix": "osd erasure-code-profile set", "name": "rs83",
            "profile": {"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "8", "m": "3"},
        })
        assert code == 0
        code, _, out = await cl.command(
            conn, {"prefix": "osd erasure-code-profile get", "name": "rs83"})
        assert code == 0 and out["k"] == "8"

        # invalid profile rejected by codec validation
        code, status, _ = await cl.command(conn, {
            "prefix": "osd erasure-code-profile set", "name": "bad",
            "profile": {"plugin": "jerasure", "k": "0", "m": "1"},
        })
        assert code != 0
        # unknown plugin rejected
        code, _, _ = await cl.command(conn, {
            "prefix": "osd erasure-code-profile set", "name": "bad2",
            "profile": {"plugin": "nonexistent"},
        })
        assert code != 0
        # redefinition with different params without force -> EEXIST
        code, _, _ = await cl.command(conn, {
            "prefix": "osd erasure-code-profile set", "name": "rs83",
            "profile": {"plugin": "jerasure", "k": "4", "m": "2"},
        })
        assert code != 0

        code, _, out = await cl.command(conn, {"prefix": "osd erasure-code-profile ls"})
        assert out == ["default", "rs83"]
        code, _, _ = await cl.command(
            conn, {"prefix": "osd erasure-code-profile rm", "name": "rs83"})
        assert code == 0
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_pool_create_and_profile_in_use():
    async def main():
        mon = Monitor(max_osds=8)
        addr = await mon.start()
        cl = Client("client.3")
        conn = await cl.messenger.connect(addr)
        conn.send(messages.MMonGetMap(have=0))

        code, _, out = await cl.command(conn, {
            "prefix": "osd pool create", "pool": "ecpool",
            "pool_type": "erasure", "erasure_code_profile": "default",
            "pg_num": 8,
        })
        assert code == 0
        pool_id = out["pool_id"]
        await _wait(lambda: cl.osdmap is not None
                    and cl.osdmap.lookup_pool("ecpool") is not None)
        pool = cl.osdmap.lookup_pool("ecpool")
        assert pool.id == pool_id and pool.is_erasure()
        assert pool.size == 3  # k=2 m=1 default profile
        assert pool.stripe_width == 2 * 4096

        # profile now in use -> rm refused
        code, status, _ = await cl.command(
            conn, {"prefix": "osd erasure-code-profile rm", "name": "default"})
        assert code != 0 and "in use" in status

        code, _, out = await cl.command(conn, {"prefix": "osd pool ls"})
        assert out == ["ecpool"]

        code, _, out = await cl.command(conn, {"prefix": "status"})
        assert out["pools"] == ["ecpool"]

        code, _, _ = await cl.command(conn, {"prefix": "osd pool rm", "pool": "ecpool"})
        assert code == 0
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_boot_respects_operator_out_and_bad_ids():
    async def main():
        mon = Monitor(max_osds=4)
        addr = await mon.start()
        cl = Client("client.5")
        conn = await cl.messenger.connect(addr)

        osd = Client("osd.0")
        oconn = await osd.messenger.connect(addr)
        oconn.send(messages.MOSDBoot(osd_id=0, addr="127.0.0.1:7000"))
        await _wait(lambda: mon.osdmap.is_up(0))
        assert mon.osdmap.is_in(0)

        # operator outs it; a reboot must NOT mark it back in
        code, _, _ = await cl.command(conn, {"prefix": "osd out", "id": 0})
        assert code == 0
        await osd.messenger.shutdown()
        await _wait(lambda: mon.osdmap.is_down(0))
        osd2 = Client("osd.0")
        oconn2 = await osd2.messenger.connect(addr)
        oconn2.send(messages.MOSDBoot(osd_id=0, addr="127.0.0.1:7000"))
        await _wait(lambda: mon.osdmap.is_up(0))
        assert mon.osdmap.is_out(0)

        # malicious / bogus ids are rejected without corrupting state
        state_before = list(mon.osdmap.osd_state)
        oconn2.send(messages.MOSDBoot(osd_id=-1, addr="x"))
        oconn2.send(messages.MOSDBoot(osd_id=10**9, addr="x"))
        oconn2.send(messages.MOSDFailure(target_osd=-1, reporter=0, epoch=1))
        await asyncio.sleep(0.05)
        assert mon.osdmap.max_osd == 4
        assert list(mon.osdmap.osd_state) == state_before
        code, _, _ = await cl.command(conn, {"prefix": "osd down", "id": -1})
        assert code != 0

        await osd2.messenger.shutdown()
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_profile_set_in_use_refused_and_rm_missing_enoent():
    async def main():
        mon = Monitor(max_osds=4)
        addr = await mon.start()
        cl = Client("client.6")
        conn = await cl.messenger.connect(addr)
        code, _, out = await cl.command(conn, {
            "prefix": "osd pool create", "pool": "p", "pool_type": "erasure"})
        assert code == 0
        # force-overwrite of in-use profile refused
        code, status, _ = await cl.command(conn, {
            "prefix": "osd erasure-code-profile set", "name": "default",
            "force": True,
            "profile": {"plugin": "jerasure", "k": "8", "m": "3"},
        })
        assert code != 0 and "in use" in status
        # idempotent pool create returns the id
        code, _, out2 = await cl.command(conn, {
            "prefix": "osd pool create", "pool": "p", "pool_type": "erasure"})
        assert code == 0 and out2["pool_id"] == out["pool_id"]
        # rm of a missing profile is ENOENT, not silent success
        epoch = mon.osdmap.epoch
        code, _, _ = await cl.command(
            conn, {"prefix": "osd erasure-code-profile rm", "name": "ghost"})
        assert code != 0
        assert mon.osdmap.epoch == epoch  # no spurious publish
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_unknown_command():
    async def main():
        mon = Monitor()
        addr = await mon.start()
        cl = Client("client.4")
        conn = await cl.messenger.connect(addr)
        code, status, _ = await cl.command(conn, {"prefix": "bogus nonsense"})
        assert code != 0 and "unknown command" in status
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_pool_set_get_and_reweight():
    """Operator tuning (reference:OSDMonitor 'osd pool set/get',
    'osd reweight'): validation, epoch bumps, and CRUSH effect."""

    async def main():
        mon = Monitor(max_osds=4)
        addr = await mon.start()
        cl = Client("client.5")
        conn = await cl.messenger.connect(addr)
        await cl.command(conn, {
            "prefix": "osd pool create", "pool": "p",
            "pool_type": "replicated"})
        code, _, out = await cl.command(
            conn, {"prefix": "osd pool get", "pool": "p"})
        assert code == 0 and out["size"] == 3 and out["type"] == "replicated"
        epoch = mon.osdmap.epoch
        code, status, _ = await cl.command(conn, {
            "prefix": "osd pool set", "pool": "p", "var": "size", "val": 2})
        assert code == 0, status
        assert mon.osdmap.epoch > epoch
        pool = mon.osdmap.lookup_pool("p")
        assert pool.size == 2 and pool.min_size <= 2
        # validation
        for bad in (
            {"var": "size", "val": 99},
            {"var": "min_size", "val": 0},
            {"var": "pg_num", "val": 64},
        ):
            code, _s, _ = await cl.command(conn, {
                "prefix": "osd pool set", "pool": "p", **bad})
            assert code != 0, bad
        # EC size is profile-fixed
        await cl.command(conn, {
            "prefix": "osd pool create", "pool": "ec",
            "pool_type": "erasure"})
        code, _s, _ = await cl.command(conn, {
            "prefix": "osd pool set", "pool": "ec", "var": "size", "val": 5})
        assert code != 0
        # reweight changes the crush weight vector
        code, _s, _ = await cl.command(conn, {
            "prefix": "osd reweight", "id": 1, "weight": 0.25})
        assert code == 0
        assert mon.osdmap.osd_weight[1] == int(0.25 * 0x10000)
        code, _s, _ = await cl.command(conn, {
            "prefix": "osd reweight", "id": 99, "weight": 0.5})
        assert code != 0
        await cl.messenger.shutdown()
        await mon.stop()

    run(main())


def test_mon_has_no_card_and_refuses_the_admin_socket():
    """The mon validates an EC profile with a codec built on the host
    (it never encodes), and refuses the admin socket until it is
    ported."""
    from ceph_tpu_torch.models import registry

    built = []
    real = registry.instance().factory

    def spy(plugin, profile, device=None, **kw):
        built.append(device)
        return real(plugin, profile, device=device, **kw)

    async def main():
        mon = Monitor()
        registry.instance().factory = spy
        try:
            code, _, _ = await mon.handle_command_async({
                "prefix": "osd erasure-code-profile set", "name": "isa",
                "profile": {"plugin": "isa", "k": "4", "m": "2"}})
        finally:
            del registry.instance().factory
        assert code == 0 and built == ["cpu"]
        await mon.stop()

    run(main())
    with pytest.raises(NotImplementedError, match="not supported"):
        Monitor(config=Config({"admin_socket": "/tmp/m.asok"}, env=""))


# -- twins of tests/test_multimon.py --------------------------------------------


def test_three_mons_elect_lowest_rank():
    async def main():
        async with Quorum(3) as q:
            leader = await q.wait_for_leader()
            assert leader.rank == 0
            await _wait(lambda: all(m.leader_rank == 0
                                    for m in q.mons.values()))

    run(main())


def test_commands_replicate_to_peons():
    async def main():
        async with Quorum(3) as q:
            client = await q.client()
            await client.create_pool("ecpool", "erasure")
            await _wait(lambda: all(
                m.osdmap.lookup_pool("ecpool") is not None
                for m in q.mons.values()))
            epochs = {m.osdmap.epoch for m in q.mons.values()}
            assert len(epochs) == 1, epochs

    run(main())


def test_command_via_peon_redirects():
    async def main():
        async with Quorum(3) as q:
            await q.wait_for_leader()
            client = await q.client()
            # aim the client's command path at a PEON explicitly
            client._cmd_addr = q.mons[2].addr
            code, _status, out = await client.command(
                {"prefix": "osd pool create", "pool": "p1",
                 "pool_type": "replicated", "size": "2"})
            assert code == 0, (code, out)
            assert q.mons[0].osdmap.lookup_pool("p1") is not None

    run(main())


def test_mon_rejoin_converges():
    async def main():
        async with Quorum(3) as q:
            client = await q.client()
            await q.kill_mon(2)
            await client.create_pool("while-away", "replicated", size=2)
            m2 = await q.restart_mon(2)
            # the rejoined peon catches up (victory/commit carries the map)
            await _wait(lambda: m2.osdmap.lookup_pool("while-away")
                        is not None, 10)
            # counter-elections triggered by the rejoin settle on mon.0
            await _wait(lambda: m2.leader_rank == 0, 10)

    run(main())


def test_mon_state_survives_full_cluster_restart(tmp_path):
    """Pools and profiles come back after all three mons restart from
    their stores."""
    d = str(tmp_path)

    async def phase1():
        async with Quorum(3, store_dir=d) as q:
            client = await q.client()
            code, _s, _o = await client.command({
                "prefix": "osd erasure-code-profile set", "name": "rs32",
                "profile": {"plugin": "isa", "technique": "reed_sol_van",
                            "k": "2", "m": "1"},
            })
            assert code == 0
            await client.create_pool(
                "keeper", "erasure", erasure_code_profile="rs32")
            await _wait(lambda: all(
                m.osdmap.lookup_pool("keeper") is not None
                for m in q.mons.values()))

    async def phase2():
        async with Quorum(3, store_dir=d) as q:
            client = await q.client()
            # NO pool re-creation: the mon store remembered it
            assert client.osdmap.lookup_pool("keeper") is not None
            assert "rs32" in client.osdmap.erasure_code_profiles
            for m in q.mons.values():
                assert m.osdmap.lookup_pool("keeper") is not None

    run(phase1())
    run(phase2())


def _drop_commits(leader):
    real_send = leader._send_peer

    async def drop_commits(r, msg):
        if isinstance(msg, messages.MMonPaxos) and msg.op == "commit":
            return True  # swallowed: the leader died at this instant
        return await real_send(r, msg)

    leader._send_peer = drop_commits


def test_leader_death_between_ack_and_commit_preserves_write():
    """A leader that gets majority acks, applies, replies OK and dies
    BEFORE broadcasting the commit must not lose the mutation: the next
    leader adopts the highest accepted proposal."""

    async def main():
        async with Quorum(3) as q:
            leader = await q.wait_for_leader()
            assert leader.rank == 0
            client = await q.client()
            _drop_commits(leader)
            code, _status, out = await client.command(
                {"prefix": "osd pool create", "pool": "precious",
                 "pool_type": "replicated", "size": "2"})
            assert code == 0, (code, out)  # client saw SUCCESS
            assert leader.osdmap.lookup_pool("precious") is not None
            peons = [m for m in q.mons.values() if m is not leader]
            assert all(m.osdmap.lookup_pool("precious") is None
                       for m in peons)
            await q.kill_mon(leader.rank)
            # the new leader MUST surface the client-acked pool
            await _wait(lambda: any(m.is_leader for m in q.mons.values())
                        and all(m.osdmap.lookup_pool("precious") is not None
                                for m in q.mons.values()), 20)

    run(main())


def test_deposed_leader_racing_across_partition_heal():
    """A deposed leader whose partition heals must not get stale
    proposals accepted by the new quorum, and must converge to the new
    leader's map."""

    async def main():
        async with Quorum(3) as q:
            old = await q.wait_for_leader()
            assert old.rank == 0
            client = await q.client()
            await client.create_pool("before", "replicated", size=2)

            real_send = old._send_peer

            async def blackhole(r, msg):
                return False  # partitioned: nothing gets through

            old._send_peer = blackhole
            await _wait(lambda: q.mons[1].is_leader, 20)
            new_leader = q.mons[1]

            code, _s, _o = await old.handle_command_async(
                {"prefix": "osd pool create", "pool": "stale-write",
                 "pool_type": "replicated", "size": "2"})
            assert code in (0, -11)
            assert all(m.osdmap.lookup_pool("stale-write") is None
                       for m in q.mons.values() if m is not old)

            client._cmd_addr = new_leader.addr
            code, _s, _o = await client.command(
                {"prefix": "osd pool create", "pool": "after",
                 "pool_type": "replicated", "size": "2"})
            assert code == 0

            old._send_peer = real_send

            def healed():
                leaders = [m for m in q.mons.values() if m.is_leader]
                return (len(leaders) == 1 and all(
                    m.osdmap.lookup_pool("after") is not None
                    and m.osdmap.lookup_pool("stale-write") is None
                    for m in q.mons.values())
                    and len({m.leader_rank for m in q.mons.values()}) == 1)

            await _wait(healed, 20)
            client._cmd_addr = q.mon.addr
            code, _s, _o = await client.command(
                {"prefix": "osd pool create", "pool": "healed",
                 "pool_type": "replicated", "size": "2"})
            assert code == 0

    run(main())


def test_stale_exleader_cannot_reassert_over_dead_interim_leader():
    """mon.0 partitioned; mon.1+mon.2 elect mon.1, which commits a
    client-acked write; mon.1 dies; the partition heals.  mon.0 must run
    recovery and surface the write (which lives on mon.2)."""

    async def main():
        async with Quorum(3) as q:
            old = await q.wait_for_leader()
            assert old.rank == 0
            client = await q.client()
            await client.create_pool("before", "replicated", size=2)

            real_send = old._send_peer

            async def blackhole(r, msg):
                return False

            old._send_peer = blackhole
            await _wait(lambda: q.mons[1].is_leader, 20)
            client._cmd_addr = q.mons[1].addr
            code, _s, _o = await client.command(
                {"prefix": "osd pool create", "pool": "durable",
                 "pool_type": "replicated", "size": "2"})
            assert code == 0
            await _wait(lambda: q.mons[2].osdmap.lookup_pool("durable")
                        is not None, 10)
            await q.kill_mon(1)
            old._send_peer = real_send
            await _wait(lambda: any(m.is_leader for m in q.mons.values())
                        and all(m.osdmap.lookup_pool("durable") is not None
                                for m in q.mons.values()), 20)

    run(main())


def test_paxos_proposes_ship_deltas_with_full_fallback():
    """Round-1 proposes carry the epoch delta; a peon that cannot derive
    the base answers need_full and still converges via the snapshot."""

    async def main():
        async with Quorum(3) as q:
            cl = await q.client()
            peons = [m for m in q.mons.values() if not m.is_leader]
            leader = next(m for m in q.mons.values() if m.is_leader)
            seen = []
            p0 = peons[0]
            orig = p0._handle_paxos

            async def spy(msg):
                if msg.op == "propose" and isinstance(msg.value, dict):
                    seen.append("inc" if "inc" in msg.value else "full")
                return await orig(msg)

            p0._handle_paxos = spy
            for i in range(3):
                code, _s, _ = await cl.command(
                    {"prefix": "osd out", "id": 0}
                    if i % 2 == 0 else {"prefix": "osd in", "id": 0})
                assert code == 0
            assert "inc" in seen, f"no delta proposes observed: {seen}"
            assert seen[0] == "inc", seen
            real_decode = p0._paxos_decode_value
            broke = []

            def breaking(msg):
                if not broke and isinstance(msg.value, dict) \
                        and "inc" in msg.value:
                    broke.append(1)
                    return None
                return real_decode(msg)

            p0._paxos_decode_value = breaking
            code, _s, _ = await cl.command({"prefix": "osd out", "id": 1})
            assert code == 0
            await _wait(lambda: all(m.osdmap.epoch == leader.osdmap.epoch
                                    for m in q.mons.values()), 10)
            assert broke, "the break never triggered"
            for m in q.mons.values():
                assert m.osdmap.to_dict() == leader.osdmap.to_dict()

    run(main())


def test_unknown_commit_triggers_leader_catchup():
    """A peon that sees a commit for a version it never accepted pulls
    the map from the leader."""

    async def main():
        async with Quorum(3) as q:
            cl = await q.client()
            peon = next(m for m in q.mons.values() if not m.is_leader)
            leader = next(m for m in q.mons.values() if m.is_leader)
            pulled = []
            orig = peon._send_peer

            async def spy(r, msg):
                if isinstance(msg, messages.MMonGetMap):
                    pulled.append(msg.have)
                return await orig(r, msg)

            peon._send_peer = spy
            await peon._handle_paxos(messages.MMonPaxos(
                op="commit", epoch=peon.election_epoch,
                rank=leader.rank, version=peon.osdmap.epoch + 1,
                value=None))
            assert pulled and pulled[0] == peon.osdmap.epoch
            code, _s, _ = await cl.command({"prefix": "osd out", "id": 2})
            assert code == 0
            await _wait(lambda: all(m.osdmap.epoch == leader.osdmap.epoch
                                    for m in q.mons.values()), 10)

    run(main())


def test_quorum_status_reflects_membership():
    """Full quorum after boot; after the leader dies the new term's
    quorum excludes it."""

    async def main():
        async with Quorum(3) as q:
            cl = await q.client()
            out = None
            async with asyncio.timeout(10):
                while True:
                    code, _s, out = await cl.command({"prefix": "quorum_status"})
                    assert code == 0
                    if out["quorum"] == [0, 1, 2]:
                        break
                    await asyncio.sleep(0.1)
            assert out["quorum_leader_name"] == "mon.0"
            assert len(out["monmap"]["mons"]) == 3
            assert out["monmap"]["epoch"] == 1  # elections don't bump it
            await q.kill_mon(0)
            async with asyncio.timeout(15):
                while True:
                    try:
                        code, _s, out = await cl.command({"prefix": "quorum_status"})
                        if (code == 0 and out["quorum"] == [1, 2]
                                and out["quorum_leader_name"] == "mon.1"):
                            break
                    except (ConnectionError, OSError, TimeoutError):
                        pass
                    await asyncio.sleep(0.1)

    run(main())


def test_mon_restart_rearms_delta_cache(tmp_path):
    """After a mon restart the stored delta chain keeps serving O(churn)
    catch-up pushes (the twin of ``tests/test_osdmap_inc.py``'s, which
    waited for the port's Monitor); a reference mon restarted from the
    same store re-arms the same chain."""
    from ceph_tpu.mon import Monitor as RefMonitor
    from ceph_tpu_torch.osd.osdmap import Incremental

    path = str(tmp_path / "mon.db")
    mon = Monitor(name="mon.0", max_osds=4, store_path=path)
    for i in range(6):
        old = mon.osdmap.to_dict()
        mon.osdmap.mark_down(i % 3) if i % 2 == 0 \
            else mon.osdmap.mark_up(i % 3)
        mon.osdmap.epoch += 1
        inc = Incremental.diff(old, mon.osdmap.to_dict()).to_dict()
        mon._inc_cache[mon.osdmap.epoch] = inc
        mon._last_map_dict = mon.osdmap.to_dict()
        mon._save_store(inc=inc)
    top = mon.osdmap.epoch
    base5 = mon._db_store.get_map(top - 5)
    mon._db_store.close()
    for cls in (Monitor, RefMonitor):
        mon2 = cls(name="mon.0", max_osds=4, store_path=path)
        assert mon2.osdmap.epoch == top
        # the first commit checkpoints as a full map, the rest are
        # deltas: the re-armed cache must serve that whole delta tail
        chain = mon2._collect_incs(top - 5, top)
        assert chain is not None and len(chain) == 5, cls
        rebuilt = dict(base5)
        for inc_d in chain:
            Incremental.from_dict(inc_d).apply_to_dict(rebuilt)
        assert rebuilt == mon2.osdmap.to_dict()
        mon2._db_store.close()


# -- across the packages -------------------------------------------------------


@pytest.mark.parametrize("port_rank", [0, 2])
def test_mixed_quorum_elects_lowest_rank_and_replicates(port_rank):
    """Two reference mons and one port mon (as leader, rank 0, or as a
    peon, rank 2) form one quorum: it elects rank 0 and a command
    replicates to all three."""
    from ceph_tpu.mon import Monitor as RefMonitor

    cls = {r: (Monitor if r == port_rank else RefMonitor) for r in range(3)}

    async def main():
        async with Quorum(3, mon_cls=cls) as q:
            assert isinstance(q.mons[port_rank], Monitor)
            leader = await q.wait_for_leader()
            assert leader.rank == 0
            await _wait(lambda: all(m.leader_rank == 0
                                    for m in q.mons.values()))
            client = await q.client()
            await client.create_pool("mixed", "erasure")
            await _wait(lambda: all(
                m.osdmap.lookup_pool("mixed") is not None
                for m in q.mons.values()), 10)
            dicts = [m.osdmap.to_dict() for m in q.mons.values()]
            assert all(d == dicts[0] for d in dicts)

    run(main())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_restarts_a_mon_of_the_other_package(tmp_path, writer):
    """A mon store written by one package's mon restarts a mon of the
    other with the same map, pools and profiles."""
    from ceph_tpu.mon import Monitor as RefMonitor

    first, second = ((Monitor, RefMonitor) if writer == "port"
                     else (RefMonitor, Monitor))
    store = str(tmp_path / "mon.0")

    async def main():
        mon = first(max_osds=4, store_path=store)
        await mon.start()
        for cmd in (
            {"prefix": "osd erasure-code-profile set", "name": "rs21",
             "profile": {"plugin": "isa", "k": "2", "m": "1"}},
            {"prefix": "osd pool create", "pool": "ec",
             "pool_type": "erasure", "erasure_code_profile": "rs21"},
            {"prefix": "osd pool create", "pool": "rep",
             "pool_type": "replicated", "size": 2},
            {"prefix": "osd out", "id": 3},
        ):
            code, status, _ = await mon.handle_command_async(cmd)
            assert code == 0, status
        before = mon.osdmap.to_dict()
        await mon.stop()
        other = second(max_osds=4, store_path=store)
        await other.start()
        assert other.osdmap.to_dict() == before
        assert other.osdmap.lookup_pool("ec").is_erasure()
        assert "rs21" in other.osdmap.erasure_code_profiles
        # the restarted mon keeps serving: one more commit lands
        code, status, _ = await other.handle_command_async(
            {"prefix": "osd in", "id": 3})
        assert code == 0, status
        assert other.osdmap.epoch == before["epoch"] + 1
        await other.stop()

    run(main())


# -- monmaptool ------------------------------------------------------------------


def test_monmaptool_round_trips_with_the_reference(tmp_path, capsys):
    """The port's monmaptool writes the reference's files and reads
    them back; ``resolve_mon_arg`` takes an address, a list or a file."""
    from ceph_tpu.tools import monmaptool as ref_tool
    from ceph_tpu_torch.tools import monmaptool

    port_path = str(tmp_path / "port.json")
    ref_path = str(tmp_path / "ref.json")
    args = ["--create", "--add", "mon.a", "127.0.0.1:6789",
            "--add", "mon.b", "127.0.0.1:6790"]
    assert monmaptool.main(args + ["-o", port_path]) == 0
    assert ref_tool.main(args + ["-o", ref_path]) == 0
    assert json.load(open(port_path)) == json.load(open(ref_path))
    # each tool edits the other's file the same way
    assert monmaptool.main([ref_path, "--rm", "mon.a"]) == 0
    assert ref_tool.main([port_path, "--rm", "mon.a"]) == 0
    assert json.load(open(port_path)) == json.load(open(ref_path))
    assert monmaptool.monmap_addrs(monmaptool.load_monmap(ref_path)) == \
        ["127.0.0.1:6790"]
    assert monmaptool.main([port_path, "--add", "mon.b", "1.2.3.4:5"]) == 1
    assert monmaptool.main([port_path, "--rm", "ghost"]) == 1
    capsys.readouterr()
    assert monmaptool.main([port_path, "--print"]) == 0
    port_out = capsys.readouterr().out
    assert ref_tool.main([port_path, "--print"]) == 0
    assert capsys.readouterr().out == port_out
    assert "0: 127.0.0.1:6790 mon.b" in port_out
    assert monmaptool.resolve_mon_arg("1.2.3.4:5") == "1.2.3.4:5"
    assert monmaptool.resolve_mon_arg("a:1,b:2") == ["a:1", "b:2"]
    assert monmaptool.resolve_mon_arg(port_path) == ["127.0.0.1:6790"]
    bad = tmp_path / "bad.json"
    bad.write_text('{"foo": 1}')
    assert monmaptool.main([str(bad), "--print"]) == 1
    with pytest.raises(SystemExit):
        monmaptool.resolve_mon_arg(str(bad))
