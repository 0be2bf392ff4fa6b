"""The PG-level helpers beneath the port's OSD against the reference's.

- Twins of the reference's cases that need no ``MiniCluster``, run on
  the port: ``TestFindBestInfo`` of ``tests/test_peering.py``,
  ``TestSnapSet`` of ``tests/test_snaps.py``, every test of
  ``tests/test_client_ledger.py``, ``TestAsyncReserver`` of
  ``tests/test_recovery_throttle.py``, ``TestReserverPreemption`` of
  ``tests/test_qos_scheduler.py`` and ``TestLockdep`` of
  ``tests/test_watchdog.py``.
- Across the packages: ``PGLogEntry`` / ``Eversion`` / ``SnapSet`` /
  ``PastIntervals`` JSON, the ``add_log_entry_to_txn`` transaction op
  for op, ``read_log`` and the stash trim over a store of either
  package, and ``find_best_info`` / ``derive_info`` on seeded shard
  infos.

Tolerance: exact equality throughout.  Every async body runs under
``asyncio.wait_for`` (:func:`run`).
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.common.lockdep import (
    LockdepLock,
    LockOrderViolation,
    lockdep_enable,
    lockdep_reset,
)
from ceph_tpu_torch.osd import peering
from ceph_tpu_torch.osd.client_ledger import ClientLedger
from ceph_tpu_torch.osd.pg_log import Eversion, PGLogEntry
from ceph_tpu_torch.osd.reservations import AsyncReserver
from ceph_tpu_torch.osd.snaps import (
    Clone,
    SnapContext,
    SnapSet,
    clone_name,
    is_clone_name,
    snapdir_name,
)

# every async body's limit: each takes a few event-loop turns
ASYNC_LIMIT_S = 10.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, ASYNC_LIMIT_S))


# -- peering (tests/test_peering.py) --------------------------------------------


class TestFindBestInfo:
    def test_les_dominates_version_numbers(self):
        """A stale-interval shard can NEVER be authoritative, whatever
        its last_update claims — the invariant last-writer-wins lacked."""
        infos = {
            0: peering.PGShardInfo(2, Eversion(5, 99), 10),  # stale les
            1: peering.PGShardInfo(7, Eversion(5, 3), 3),
            2: peering.PGShardInfo(7, Eversion(5, 4), 4),
        }
        assert peering.find_best_info(infos) == 2

    def test_tiebreak_last_update_then_log_len(self):
        infos = {
            0: peering.PGShardInfo(3, Eversion(2, 5), 2),
            1: peering.PGShardInfo(3, Eversion(2, 5), 5),
            2: peering.PGShardInfo(3, Eversion(2, 4), 9),
        }
        assert peering.find_best_info(infos) == 1

    def test_divergent_entries_newest_first(self):
        auth = {"a": Eversion(3, 3), "b": Eversion(3, 4), "c": Eversion(3, 4)}
        log = [
            PGLogEntry("modify", "a", Eversion(3, 3), Eversion()),
            PGLogEntry("modify", "b", Eversion(3, 5), Eversion(3, 3)),
            PGLogEntry("modify", "c", Eversion(3, 6), Eversion(3, 5)),
        ]
        div = peering.divergent_entries_per_object(auth, log)
        assert [e.oid for e in div] == ["c", "b"]  # newest-first rollback

    def test_per_object_divergence_catches_low_version_stale_writes(self):
        """A stale write numerically BELOW the global
        auth head must still be divergent when it exceeds what the auth
        history knows about that object."""
        auth = {"x": Eversion(5, 8), "z": Eversion(6, 1)}
        log = [
            PGLogEntry("modify", "x", Eversion(5, 10), Eversion(5, 8)),  # div
            PGLogEntry("modify", "x", Eversion(5, 7), Eversion(5, 6)),   # ok
            PGLogEntry("modify", "y", Eversion(4, 2), Eversion()),       # div
            PGLogEntry("modify", "z", Eversion(6, 1), Eversion(5, 9)),   # ok
        ]
        div = peering.divergent_entries_per_object(auth, log)
        assert [(e.oid, e.version) for e in div] == [
            ("x", Eversion(5, 10)), ("y", Eversion(4, 2))
        ]

    def test_past_intervals_roundtrip_and_merge(self):
        p = peering.PastIntervals()
        p.note_change(2, 5, [1, 2, 3], 1)
        p.note_change(6, 9, [4, 2, peering.CRUSH_ITEM_NONE], 4)
        p2 = peering.PastIntervals.from_json(p.to_json())
        assert [iv.to_list() for iv in p2.intervals] == [
            [2, 5, [1, 2, 3], 1],
            [6, 9, [4, 2, peering.CRUSH_ITEM_NONE], 4],
        ]
        merged = p2.merged_with(
            peering.PastIntervals([peering.Interval(10, 12, (7,), 7)])
        )
        assert len(merged.intervals) == 3
        # dedup by (first, last)
        again = merged.merged_with(p2)
        assert len(again.intervals) == 3


# -- snapshots (tests/test_snaps.py) ---------------------------------------------


class TestSnapSet:
    def test_clone_on_first_write_after_snap(self):
        ss = SnapSet()
        assert not ss.needs_clone(SnapContext(0, []))
        snapc = SnapContext(1, [1])
        assert ss.needs_clone(snapc)
        c = ss.make_clone(snapc, size=100)
        assert c.cloneid == 1 and c.snaps == [1]
        # second write under the same snapc: no new clone
        assert not ss.needs_clone(snapc)

    def test_clone_covers_all_new_snaps(self):
        ss = SnapSet()
        ss.make_clone(SnapContext(1, [1]), 10)
        # two snaps taken since, one write: ONE clone serves both
        c = ss.make_clone(SnapContext(3, [3, 2, 1]), 20)
        assert c.cloneid == 3 and c.snaps == [2, 3]

    def test_resolution(self):
        ss = SnapSet()
        ss.make_clone(SnapContext(1, [1]), 10)   # clone 1 serves snap 1
        ss.make_clone(SnapContext(3, [3, 2, 1]), 20)  # clone 3 serves 2,3
        assert ss.resolve(1) == 1
        assert ss.resolve(2) == 3
        assert ss.resolve(3) == 3
        assert ss.resolve(4) == SnapSet.HEAD
        ss2 = SnapSet()
        ss2.make_clone(SnapContext(3, [3]), 5)  # created before snap 3 only
        assert ss2.resolve(2) == SnapSet.MISSING  # no state for snap 2

    def test_trim(self):
        ss = SnapSet()
        ss.make_clone(SnapContext(1, [1]), 10)
        ss.make_clone(SnapContext(3, [3, 2]), 20)
        assert ss.trim({2}) == []          # clone 3 still serves snap 3
        assert ss.trim({3}) == [3]         # now it's dead
        assert ss.trim({1}) == [1]
        assert ss.clones == []

    def test_json_roundtrip(self):
        ss = SnapSet()
        ss.make_clone(SnapContext(2, [2, 1]), 42)
        ss2 = SnapSet.from_json(ss.to_json())
        assert ss2.seq == 2
        assert ss2.clones[0].cloneid == 2
        assert ss2.clones[0].snaps == [1, 2]
        assert SnapSet.from_json(None).empty()

    def test_names(self):
        assert is_clone_name(clone_name("obj", 3))
        assert is_clone_name(snapdir_name("obj"))
        assert not is_clone_name("obj@3")  # user names never collide


# -- the client ledger (tests/test_client_ledger.py) ------------------------------


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _mk(topk=8, window=10.0, clock=None):
    return ClientLedger(topk=topk, window=window,
                        clock=clock or _Clock())


class TestAccounting:
    def test_basic_row(self):
        clk = _Clock()
        led = _mk(clock=clk)
        for _ in range(10):
            led.account(42, 3, "client", bytes_in=100, bytes_out=50,
                        lat=0.002)
        clk.t += 2.0
        rows = led.series()
        assert len(rows) == 1
        r = rows[0]
        assert r["client"] == 42 and r["pool"] == 3
        assert r["class"] == "client"
        assert r["ops"] == 10
        assert r["bytes_in"] == 1000 and r["bytes_out"] == 500
        assert r["errs"] == 0
        assert r["ops_per_sec"] > 0
        # 2ms ops -> p99 reads a log2 bucket upper edge near 2ms
        assert 0.001 <= r["p99_s"] <= 0.01

    def test_errors_counted(self):
        led = _mk()
        led.account(1, 0, err=True)
        led.account(1, 0, err=False)
        (r,) = led.series()
        assert r["ops"] == 2 and r["errs"] == 1

    def test_per_pool_and_class_rows(self):
        led = _mk()
        led.account(1, 0, "client")
        led.account(1, 1, "client")
        led.account(1, 0, "recovery")
        assert len(led.series()) == 3

    def test_p99_sees_slow_tail(self):
        led = _mk()
        for _ in range(95):
            led.account(7, 0, lat=0.001)
        for _ in range(5):
            led.account(7, 0, lat=0.5)
        (r,) = led.series()
        # 5% of mass at 500ms: the 99th percentile bucket is deep in
        # the slow tail, far above the 1ms bulk
        assert r["p99_s"] >= 0.1


class TestTopK:
    def test_heavy_hitter_survives_skew(self):
        """4:1 skewed load against a table far smaller than the tenant
        count: the space-saving sketch must keep the true heavy
        hitter while the long tail churns through the other rows."""
        led = _mk(topk=4)
        heavy = 999
        small = 0
        for round_ in range(200):
            for _ in range(4):
                led.account(heavy, 0)
            # fresh small tenant each round — constant eviction churn
            small += 1
            led.account(small, 0)
        top = led.top_client()
        assert top is not None
        client, share = top
        assert client == heavy
        # true share is 4/5; the sketch's error bound keeps the
        # estimate in the neighborhood
        assert share > 0.5

    def test_memory_is_o_topk(self):
        """10k distinct tenants cost at most 2*K entries (current +
        previous half-window)."""
        led = _mk(topk=16)
        for c in range(10_000):
            led.account(c, 0)
        assert led.entry_count() <= 2 * 16
        d = led.dump()
        assert d["entries"] <= 2 * 16
        assert d["evictions"] > 0
        # the evicted mass is visible, not silently dropped
        assert d["other"]["ops"] > 0

    def test_series_includes_other_row(self):
        led = _mk(topk=2)
        for c in range(50):
            led.account(c, 0)
        rows = led.series()
        # bounded: topk rows + the single constant "other" row
        assert len(rows) <= 2 * 2 + 1
        other = [r for r in rows if r["class"] == "other"]
        assert len(other) == 1
        assert other[0]["client"] == "other"
        assert other[0]["ops"] > 0

    def test_set_topk_shrinks_live(self):
        led = _mk(topk=32)
        for c in range(32):
            led.account(c, 0)
        led.set_topk(4)
        assert led.entry_count() <= 2 * 4

    def test_error_bound_reported(self):
        """A newcomer that evicted someone inherits the min count as
        its error bound — the row must carry it so consumers can see
        how much of `ops` is inherited floor, not observed ops."""
        led = _mk(topk=2)
        led.account(1, 0, ops=10)
        led.account(2, 0, ops=10)
        led.account(3, 0)  # evicts one 10-op row, inherits floor 10
        rows = {r["client"]: r for r in led.series()
                if r["class"] != "other"}
        assert rows[3]["error"] >= 1
        assert rows[3]["ops"] > rows[3]["error"] - 1


class TestWindow:
    def test_rotation_expires_old_load(self):
        clk = _Clock()
        led = _mk(window=10.0, clock=clk)
        led.account(1, 0)
        clk.t += 4.0   # still in the current half-window pair
        assert led.top_client() is not None
        clk.t += 20.0  # two full windows later: everything expired
        led.account(2, 0)
        rows = [r["client"] for r in led.series()
                if r["class"] != "other"]
        assert rows == [2]

    def test_half_window_overlap(self):
        """Load accounted just before a half-window boundary stays
        visible after one rotation (prev half still merged in)."""
        clk = _Clock()
        led = _mk(window=10.0, clock=clk)
        led.account(1, 0, ops=5)
        clk.t += 6.0  # crosses one half-window (5s): rotate, keep prev
        led.account(2, 0)
        clients = {r["client"] for r in led.series()
                   if r["class"] != "other"}
        assert clients == {1, 2}


# -- reservations (tests/test_recovery_throttle.py, tests/test_qos_scheduler.py) --


class TestAsyncReserver:
    def test_grants_up_to_capacity_then_queues(self):
        async def main():
            r = AsyncReserver(2)
            f1, f2, f3 = r.request("a"), r.request("b"), r.request("c")
            assert f1.done() and f2.done() and not f3.done()
            assert r.max_granted == 2
            r.cancel("a")
            await asyncio.sleep(0)
            assert f3.done()
            assert r.max_granted == 2  # never exceeded capacity

        run(main())

    def test_priority_beats_fifo(self):
        async def main():
            r = AsyncReserver(1)
            r.request("held")
            flow = r.request("low", prio=0)
            fhigh = r.request("high", prio=5)
            r.cancel("held")
            await asyncio.sleep(0)
            assert fhigh.done() and not flow.done()

        run(main())

    def test_set_max_regrants_waiters(self):
        async def main():
            r = AsyncReserver(1)
            r.request("a")
            fb = r.request("b")
            assert not fb.done()
            r.set_max(2)
            await asyncio.sleep(0)
            assert fb.done()

        run(main())

    def test_cancel_where_frees_queued_and_granted(self):
        """Peer-death cleanup must sweep QUEUED requests too: a request
        granted after its owner died can never be released by it."""

        async def main():
            r = AsyncReserver(1)
            r.request((7, "1.0"))          # granted to osd.7
            fq = r.request((7, "1.1"))     # queued for osd.7
            fo = r.request((8, "1.2"))     # queued for osd.8
            r.cancel_where(lambda k: k[0] == 7)
            await asyncio.sleep(0)
            assert fq.cancelled()
            assert fo.done() and not fo.cancelled()  # slot went to osd.8
            assert r.granted == {(8, "1.2")}

        run(main())

    def test_request_idempotent_and_cancel_queued(self):
        async def main():
            r = AsyncReserver(1)
            fa = r.request("a")
            assert r.request("a") is not None and fa.done()
            fb = r.request("b")
            assert r.request("b") is fb
            r.cancel("b")
            assert fb.cancelled()
            assert "b" not in r.granted


class TestReserverPreemption:
    """AsyncReserver priority preemption (Ceph common/AsyncReserver.h
    parity) + the dump_reservations body."""

    def test_higher_prio_preempts_lowest_revocable_grant(self):
        async def main():
            r = AsyncReserver(2)
            preempted: list[str] = []
            r.request("low", prio=1,
                      on_preempt=lambda: preempted.append("low"))
            r.request("mid", prio=3,
                      on_preempt=lambda: preempted.append("mid"))
            assert r.granted == {"low", "mid"}
            fhigh = r.request("high", prio=5)
            await asyncio.sleep(0)
            # the LOWEST-priority revocable grant lost its slot
            assert fhigh.done() and preempted == ["low"]
            assert r.granted == {"mid", "high"}
            assert r.preemptions == 1

        run(main())

    def test_non_revocable_grants_are_never_preempted(self):
        async def main():
            r = AsyncReserver(1)
            r.request("pinned", prio=0)  # no on_preempt: not revocable
            fhigh = r.request("high", prio=99)
            await asyncio.sleep(0)
            assert not fhigh.done() and r.granted == {"pinned"}
            r.cancel("pinned")
            await asyncio.sleep(0)
            assert fhigh.done()

        run(main())

    def test_rerequest_upgrades_priority_and_preempts(self):
        """Re-requesting a queued key at a higher priority re-sorts it
        AND fires preemption (the reference's update_priority) — a
        stale low prio must not pin the request behind a revocable
        grant it now outranks."""
        async def main():
            r = AsyncReserver(1)
            preempted = []
            r.request("held", prio=3,
                      on_preempt=lambda: preempted.append("held"))
            fk = r.request("k", prio=1)  # queued below the grant
            await asyncio.sleep(0)
            assert not fk.done()
            assert r.request("k", prio=5) is fk  # same future back
            await asyncio.sleep(0)
            assert fk.done() and preempted == ["held"]
            assert r.granted == {"k"}

        run(main())

    def test_equal_priority_never_preempts(self):
        async def main():
            r = AsyncReserver(1)
            r.request("a", prio=5, on_preempt=lambda: None)
            fb = r.request("b", prio=5)
            await asyncio.sleep(0)
            assert not fb.done() and r.granted == {"a"}

        run(main())

    def test_preempted_owner_can_rerequest_and_requeue(self):
        async def main():
            r = AsyncReserver(1)
            regrant: list = []

            def back_in_line():
                regrant.append(r.request("low", prio=1))

            r.request("low", prio=1, on_preempt=back_in_line)
            fhigh = r.request("high", prio=5)
            await asyncio.sleep(0)
            assert fhigh.done() and regrant and not regrant[0].done()
            r.cancel("high")
            await asyncio.sleep(0)
            assert regrant[0].done()  # the victim got back in

        run(main())

    def test_dump_reports_grants_and_queue(self):
        async def main():
            r = AsyncReserver(1)
            r.request("held", prio=7, on_preempt=lambda: None)
            r.request("waiting", prio=2)
            d = r.dump()
            assert d["max_allowed"] == 1
            assert d["granted"] == [
                {"key": "'held'", "prio": 7, "preemptible": True}
            ]
            assert d["queued"] == [{"key": "'waiting'", "prio": 2}]


# -- lockdep (tests/test_watchdog.py) ---------------------------------------------


@pytest.fixture
def lockdep():
    lockdep_enable(True)
    yield
    lockdep_enable(False)


class TestLockdep:
    def test_consistent_order_ok(self, lockdep):
        async def main():
            a, b = LockdepLock("A"), LockdepLock("B")
            for _ in range(3):
                async with a:
                    async with b:
                        pass

        run(main())

    def test_abba_detected_without_deadlock(self, lockdep):
        """The second task takes B->A after A->B was recorded: lockdep
        raises on the ACQUISITION ORDER even though no actual deadlock
        happens (the reference's whole point)."""

        async def main():
            a, b = LockdepLock("A"), LockdepLock("B")
            async with a:
                async with b:
                    pass
            with pytest.raises(LockOrderViolation):
                async with b:
                    async with a:
                        pass

        run(main())

    def test_recursive_lock_detected(self, lockdep):
        async def main():
            a = LockdepLock("A")
            with pytest.raises(LockOrderViolation):
                async with a:
                    await a.acquire()

        run(main())

    def test_disabled_is_plain_lock(self):
        lockdep_enable(False)

        async def main():
            a, b = LockdepLock("A"), LockdepLock("B")
            async with a:
                async with b:
                    pass
            async with b:
                async with a:  # would violate, but lockdep is off
                    pass

        run(main())

    def test_reset_forgets_history(self, lockdep):
        async def main():
            a, b = LockdepLock("A"), LockdepLock("B")
            async with a:
                async with b:
                    pass
            lockdep_reset()
            async with b:
                async with a:
                    pass

        run(main())


# -- across the packages -------------------------------------------------------


def _ref_pg_log():
    from ceph_tpu.osd import pg_log

    return pg_log


def _entries(mod, seed=3, n=24):
    """Seeded log entries built from ``mod``'s own classes."""
    rng = np.random.default_rng(seed)
    out, prior = [], {}
    for i in range(n):
        oid = f"obj{int(rng.integers(5))}"
        v = mod.Eversion(int(rng.integers(1, 4)), i + 1)
        stash = mod.stash_name(oid, v) if rng.integers(2) else None
        out.append(mod.PGLogEntry("delete" if i % 7 == 6 else "modify", oid, v,
                                  prior.get(oid, mod.Eversion()), stash))
        prior[oid] = v
    return out


def test_log_entry_json_equals_the_reference():
    from ceph_tpu_torch.osd import pg_log

    ref = _ref_pg_log()
    for mine, theirs in zip(_entries(pg_log), _entries(ref)):
        assert mine.to_dict() == theirs.to_dict()
        assert mine.version.key() == theirs.version.key()
        assert ref.PGLogEntry.from_dict(mine.to_dict()) == theirs
        assert pg_log.PGLogEntry.from_dict(theirs.to_dict()) == mine
        if mine.stash:
            assert pg_log.is_stash_name(mine.stash) and ref.is_stash_name(mine.stash)
    assert pg_log.meta_oid(3) == pg_log.ObjectId("_pgmeta_", 3)
    assert pg_log.TRIM_MARKER_KEY == ref.TRIM_MARKER_KEY


def test_add_log_entry_txn_equals_the_reference():
    """The transaction op for op: the journal codec of either package
    gives the same bytes for the two packages' transactions."""
    from ceph_tpu.store import CollectionId as RefCid
    from ceph_tpu.store import Transaction as RefTxn
    from ceph_tpu.store.wal import encode_txn as ref_encode
    from ceph_tpu_torch.osd import pg_log
    from ceph_tpu_torch.store import CollectionId, Transaction
    from ceph_tpu_torch.store.wal import encode_txn

    ref = _ref_pg_log()
    mine, theirs = Transaction(), RefTxn()
    for shard, (a, b) in enumerate(zip(_entries(pg_log), _entries(ref))):
        pg_log.add_log_entry_to_txn(mine, CollectionId(f"2.7s{shard % 11}"), shard % 11, a)
        ref.add_log_entry_to_txn(theirs, RefCid(f"2.7s{shard % 11}"), shard % 11, b)
    assert len(mine) == len(theirs) == 24
    assert encode_txn(mine) == ref_encode(theirs)


def test_read_log_and_stash_trim_equal_the_reference():
    """The same entries committed into each package's own store: the two
    ``read_log``s give the same log in version order, and the two
    ``trim_stashes_to_txn``s plan the same removals and marker, which
    leave the two stores equal."""
    import ceph_tpu.store as ref_store
    import ceph_tpu_torch.store as port_store
    from ceph_tpu_torch.osd import pg_log

    got = {}
    for name, lmod, smod in (("port", pg_log, port_store), ("ref", _ref_pg_log(), ref_store)):
        s = smod.MemStore()
        s.mkfs()
        s.mount()
        cid = smod.CollectionId("2.7s4")
        s.apply(smod.Transaction().create_collection(cid))
        entries = _entries(lmod)
        for e in entries:
            t = smod.Transaction()
            if e.stash:
                t.touch(cid, smod.ObjectId(e.stash, 4))
            lmod.add_log_entry_to_txn(t, cid, 4, e)
            s.apply(t)
        log = [e.to_dict() for e in lmod.read_log(s, cid, 4)]
        assert log == [e.to_dict() for e in sorted(entries, key=lambda e: e.version)]
        trim_to = sorted(e.version for e in entries)[12]
        t = smod.Transaction()
        lmod.trim_stashes_to_txn(s, cid, 4, trim_to, t)
        plan = [(op[0],) + tuple(a if isinstance(a, (bytes, dict)) else repr(a)
                                 for a in op[1:]) for op in t.ops]
        assert any(op[0] == "remove" for op in plan)
        s.apply(t)
        again = smod.Transaction()
        lmod.trim_stashes_to_txn(s, cid, 4, trim_to, again)
        assert again.empty()  # the marker bounds the scan
        got[name] = (log, plan, sorted(o.name for o in s.list_objects(cid)),
                     s.omap_get(cid, lmod.meta_oid(4)))
    assert got["port"] == got["ref"]


def test_snapset_json_and_plan_clone_equal_the_reference():
    from ceph_tpu.osd import snaps as ref
    from ceph_tpu_torch.osd import snaps

    rng = np.random.default_rng(5)
    sets = {"port": snaps.SnapSet(), "ref": ref.SnapSet()}
    seq, live = 0, []
    for step in range(40):
        if rng.integers(3) == 0:
            seq += 1
            live.insert(0, seq)
        if live and rng.integers(6) == 0:
            live.pop(int(rng.integers(len(live))))
        names = []
        for pkg, mod in (("port", snaps), ("ref", ref)):
            snapc = mod.SnapContext(seq, list(live))
            names.append(mod.plan_clone(sets[pkg], snapc, bool(step % 5), 100 + step,
                                        "obj"))
        assert names[0] == names[1]
        assert sets["port"].to_json() == sets["ref"].to_json()
    removed = set(range(1, seq + 1, 2))
    assert sets["port"].trim(removed) == sets["ref"].trim(removed)
    assert sets["port"].to_json() == sets["ref"].to_json()
    back = snaps.SnapSet.from_json(sets["ref"].to_json())
    assert back.to_json() == sets["ref"].to_json()
    for s in range(seq + 2):
        assert back.resolve(s) == sets["ref"].resolve(s)
    assert (snaps.SS_KEY, snaps.clone_name("o", 7), snaps.snapdir_name("o")) == (
        ref.SS_KEY, ref.clone_name("o", 7), ref.snapdir_name("o"))
    assert snaps.SnapContext(3, [3, 1]).to_dict() == ref.SnapContext(3, [3, 1]).to_dict()


def test_past_intervals_json_equals_the_reference():
    from ceph_tpu.osd import peering as ref

    rng = np.random.default_rng(9)
    mine, theirs = peering.PastIntervals(), ref.PastIntervals()
    first = 1
    for _ in range(80):  # beyond MAX_INTERVALS: the bound trims both alike
        last = first + int(rng.integers(0, 4))
        acting = [int(a) for a in rng.integers(0, 12, 6)]
        acting[int(rng.integers(6))] = peering.CRUSH_ITEM_NONE
        mine.note_change(first, last, acting, acting[0])
        theirs.note_change(first, last, acting, acting[0])
        first = last + 1
    assert mine.to_json() == theirs.to_json()
    other = ref.PastIntervals.from_json(mine.to_json())
    assert other.merged_with(theirs).to_json() == mine.merged_with(
        peering.PastIntervals.from_json(theirs.to_json())).to_json()
    assert (peering.PAST_INTERVALS_KEY, peering.INFO_KEY, peering.MAX_INTERVALS) == (
        ref.PAST_INTERVALS_KEY, ref.INFO_KEY, ref.MAX_INTERVALS)


def test_find_best_info_and_derive_info_agree_with_the_reference():
    from ceph_tpu.osd import peering as ref
    from ceph_tpu.osd import pg_log as ref_log
    from ceph_tpu_torch.osd import pg_log

    rng = np.random.default_rng(13)
    for case in range(200):
        n = int(rng.integers(1, 12))
        stored, logs = {}, {}
        for shard in range(n):
            if rng.integers(4):
                stored[shard] = {"les": int(rng.integers(0, 4)),
                                 "last_update": [int(rng.integers(0, 3)),
                                                 int(rng.integers(0, 20))],
                                 "log_len": int(rng.integers(0, 9))}
            k = int(rng.integers(0, 5))
            logs[shard] = [(int(rng.integers(1, 4)), int(rng.integers(1, 30)))
                           for _ in range(k)]
        mine = {s: peering.derive_info(
            stored.get(s), [pg_log.PGLogEntry("modify", "o", pg_log.Eversion(*v),
                                              pg_log.Eversion()) for v in logs[s]])
            for s in range(n)}
        theirs = {s: ref.derive_info(
            stored.get(s), [ref_log.PGLogEntry("modify", "o", ref_log.Eversion(*v),
                                               ref_log.Eversion()) for v in logs[s]])
            for s in range(n)}
        assert {s: i.to_dict() for s, i in mine.items()} == {
            s: i.to_dict() for s, i in theirs.items()}
        assert peering.find_best_info(mine) == ref.find_best_info(theirs)
        auth = {"o": pg_log.Eversion(2, int(rng.integers(0, 30)))}
        peer = [pg_log.PGLogEntry("modify", "o", pg_log.Eversion(*v), pg_log.Eversion())
                for v in logs[0]]
        peer_ref = [ref_log.PGLogEntry("modify", "o", ref_log.Eversion(*v),
                                       ref_log.Eversion()) for v in logs[0]]
        got = peering.divergent_entries_per_object(auth, peer)
        want = ref.divergent_entries_per_object(
            {"o": ref_log.Eversion(*auth["o"].to_list())}, peer_ref)
        assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    assert peering.find_best_info({}) is None and ref.find_best_info({}) is None


def test_client_ledger_and_reserver_bodies_equal_the_reference():
    """The same accounting gives the same ``series``/``dump`` bodies; the
    same reservation requests give the same ``dump_reservations``."""
    from ceph_tpu.osd.client_ledger import ClientLedger as RefLedger
    from ceph_tpu.osd.reservations import AsyncReserver as RefReserver

    rng = np.random.default_rng(17)
    clock = _Clock()
    mine = ClientLedger(topk=6, window=10.0, clock=clock)
    theirs = RefLedger(topk=6, window=10.0, clock=clock)
    for i in range(400):
        clock.t += float(rng.random()) * 0.1
        kw = dict(ops=int(rng.integers(1, 4)), bytes_in=int(rng.integers(0, 9000)),
                  bytes_out=int(rng.integers(0, 9000)),
                  lat=float(rng.random()) * 0.05, err=bool(rng.integers(20) == 0))
        client, pool = int(rng.zipf(1.5)) % 40, int(rng.integers(3))
        mine.account(client, pool, "client", **kw)
        theirs.account(client, pool, "client", **kw)
    assert mine.series() == theirs.series()
    assert mine.dump() == theirs.dump()
    assert mine.top_client() == theirs.top_client()

    async def main():
        bodies = []
        for cls in (AsyncReserver, RefReserver):
            r = cls(2)
            r.request("a", prio=3, on_preempt=lambda: None)
            r.request((7, "1.0"), prio=1, on_preempt=lambda: None)
            r.request("b", prio=5)
            r.request("c", prio=0)
            await asyncio.sleep(0)
            bodies.append((r.dump(), r.preemptions, sorted(map(str, r.granted))))
        assert bodies[0] == bodies[1]

    run(main())
