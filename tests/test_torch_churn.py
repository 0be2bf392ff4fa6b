"""The port's churn planner held against the reference, on the CPU.

``ceph_tpu_torch.osd.churn`` (``ChurnPlanner(..., device="cpu")``: the
batched mapper on CPU lanes, the draw's plain torch version) against
``ceph_tpu.osd.churn``: twins of ``tests/test_churn.py``, with each
mapping held against the reference's scalar ``pg_to_up_acting_osds``
and each plan against the reference's ``ChurnPlanner.plan`` with its
device route switched off (``_device_ok`` patched to False here), so
the reference plans through its scalar pipeline; one case, the flat
64-OSD replicated map, also against the reference's JAX route.  Then
the pieces the port computes on the device: the placement seeds' 32-bit
wrap, the up filtering with its stable compaction and first-up primary,
the ``pg_temp`` overlay, and bucket tables that follow a map mutated in
place.  Maps are built in both packages from the same calls.  No
tolerance: equality everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ceph_tpu.osd import churn as ref_churn
from ceph_tpu.osd import osdmap as ref_om
from ceph_tpu_torch.crush.map import CRUSH_BUCKET_STRAW2
from ceph_tpu_torch.osd import churn, osdmap as om
from ceph_tpu_torch.osd.churn import ChurnPlanner, apply_churn, synthetic_map
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, PGid

EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "2", "m": "1"}

_CACHE: dict = {}


def _big_maps():
    """The reference test's 1024-OSD map (64 hosts of 16, an EC k=2 m=1
    pool over hosts), built in both packages."""
    if "big" not in _CACHE:
        _CACHE["big"] = tuple(mod.synthetic_map(1024, 16, replicated=None, ec=(EC_PROFILE, 32))
                              for mod in (ref_churn, churn))
    return _CACHE["big"]


def _small_rep_maps():
    """A flat 64-OSD map with a replicated pool, in both packages."""
    if "rep" not in _CACHE:
        maps = []
        for mod in (ref_om, om):
            m = mod.build_simple(64)
            m.create_replicated_pool("churn-rep", size=3, pg_num=32)
            maps.append(m)
        _CACHE["rep"] = tuple(maps)
    return _CACHE["rep"]


def _planner(m):
    return ChurnPlanner(m, device="cpu")


def _table(mapping):
    return mapping.acting.numpy(), mapping.primary.numpy()


def _assert_scalar_equal(ref_m, mapping):
    """The whole mapping equals the reference's scalar pipeline."""
    pool = ref_m.pools[mapping.pool_id]
    want = ref_churn.ChurnPlanner(ref_m)._map_pool_scalar(ref_m, pool)
    acting, primary = _table(mapping)
    assert np.array_equal(acting, want.acting)
    assert np.array_equal(primary, want.primary)


def _ref_scalar_plan(monkeypatch, ref_m, ref_post, **kw):
    monkeypatch.setattr(ref_churn.ChurnPlanner, "_device_ok",
                        staticmethod(lambda m, pool: False))
    plan = ref_churn.ChurnPlanner(ref_m).plan(ref_post, **kw)
    monkeypatch.undo()
    assert not plan.device
    return plan


def _assert_plans_equal(plan, ref_plan):
    got, want = dataclasses.asdict(plan), dataclasses.asdict(ref_plan)
    assert got.pop("device") and not want.pop("device")
    assert got == want


class TestOraclePin:
    def test_device_mapping_bit_matches_scalar_oracle_at_1k(self):
        ref_m, m = _big_maps()
        pl = _planner(m)
        for pool in m.pools.values():
            mapping = pl.map_pool(m, pool)
            assert mapping.device, pool.name
            _assert_scalar_equal(ref_m, mapping)
        assert pl.verify_oracle(samples=12, rng=np.random.default_rng(42)) == 12
        # the replicated firstn path (row compaction, first-up primaries),
        # also against the reference's JAX route
        ref_rep, rep = _small_rep_maps()
        plr = _planner(rep)
        for pool in rep.pools.values():
            mapping = plr.map_pool(rep, pool)
            assert mapping.device, pool.name
            want = ref_churn.ChurnPlanner(ref_rep).map_pool(ref_rep, ref_rep.pools[pool.id])
            assert want.device
            assert np.array_equal(_table(mapping)[0], want.acting)
            assert np.array_equal(_table(mapping)[1], want.primary)
        assert plr.verify_oracle(samples=16, rng=np.random.default_rng(5)) == 16

    def test_post_churn_map_stays_oracle_exact(self):
        ref_m, m = _big_maps()
        ref_post = ref_churn.apply_churn(ref_m, kill=[3, 100, 500], out=[100])
        post = apply_churn(m, kill=[3, 100, 500], out=[100])
        assert post.to_dict() == ref_post.to_dict()
        pl = _planner(post)
        for pool in post.pools.values():
            _assert_scalar_equal(ref_post, pl.map_pool(post, pool))
        assert pl.verify_oracle(post, samples=8, rng=np.random.default_rng(7)) == 8
        ref_rep, rep = _small_rep_maps()
        rep_post = apply_churn(rep, kill=[5], out=[9])
        ref_rep_post = ref_churn.apply_churn(ref_rep, kill=[5], out=[9])
        for pool in rep_post.pools.values():
            _assert_scalar_equal(ref_rep_post, _planner(rep_post).map_pool(rep_post, pool))
        assert _planner(rep_post).verify_oracle(
            rep_post, samples=8, rng=np.random.default_rng(9)) == 8

    def test_scalar_fallback_matches_on_unsupported_maps(self):
        maps = []
        for mod in (ref_churn, churn):
            m = mod.synthetic_map(32, 8, replicated=(3, 16), ec=None)
            m.osd_primary_affinity = [0x10000] * m.max_osd
            m.osd_primary_affinity[3] = 0x4000
            maps.append(m)
        ref_m, m = maps
        pool = next(iter(m.pools.values()))
        mapping = _planner(m).map_pool(m, pool)
        assert not mapping.device
        for seed in range(pool.pg_num):
            _u, _up, act, prim = m.pg_to_up_acting_osds(PGid(pool.id, seed))
            assert mapping.acting_of(seed)[: len(act)] == list(act)
            assert int(mapping.primary[seed]) == prim
        _assert_scalar_equal(ref_m, mapping)


class TestPlans:
    def test_kill_plan_matches_scalar_live_diff(self, monkeypatch):
        ref_m, m = _big_maps()
        killed = list(range(64))  # four whole hosts
        post = apply_churn(m, kill=killed)
        plan = _planner(m).plan(post)
        assert plan.device
        _assert_plans_equal(plan, _ref_scalar_plan(
            monkeypatch, ref_m, ref_churn.apply_churn(ref_m, kill=killed)))
        predicted = plan.remapped_pgs()
        assert predicted  # a host down MUST remap something
        # a down OSD only drops out of the sets that held it
        pre = _planner(m).map_all()
        held = {str(PGid(pid, s)) for pid, mp in pre.items()
                for s in range(mp.acting.shape[0])
                if set(mp.acting_of(s)) & set(killed)}
        assert predicted == held

    def test_out_plan_counts_movement(self, monkeypatch):
        ref_m, m = _big_maps()
        per_pg = 1 << 20
        plan = _planner(m).plan(apply_churn(m, out=list(range(64))), bytes_per_pg=per_pg)
        _assert_plans_equal(plan, _ref_scalar_plan(
            monkeypatch, ref_m, ref_churn.apply_churn(ref_m, out=list(range(64))),
            bytes_per_pg=per_pg))
        assert plan.moved_shards > 0
        assert plan.movement_bytes == sum(
            len(e["moved"]) * (per_pg // 2)
            for entries in plan.remapped.values() for e in entries)
        ref_rep, rep = _small_rep_maps()
        out = [0, 1, 2, 3, 4, 5, 6, 7]
        rplan = _planner(rep).plan(apply_churn(rep, out=out), bytes_per_pg=per_pg)
        _assert_plans_equal(rplan, _ref_scalar_plan(
            monkeypatch, ref_rep, ref_churn.apply_churn(ref_rep, out=out),
            bytes_per_pg=per_pg))
        assert rplan.moved_shards > 0
        assert rplan.movement_bytes == sum(
            len(e["moved"]) * per_pg for entries in rplan.remapped.values() for e in entries)

    def test_fan_in_and_waves_are_consistent(self):
        _ref_m, m = _big_maps()
        plan = _planner(m).plan(apply_churn(m, kill=list(range(64))))
        n_with_primary = sum(
            1 for entries in plan.remapped.values() for e in entries
            if e["post_primary"] >= 0)
        assert sum(plan.waves.values()) == n_with_primary
        want_fan: dict[int, int] = {}
        for entries in plan.remapped.values():
            for e in entries:
                prim = e["post_primary"]
                if prim < 0:
                    continue
                for o in e["post"]:
                    if o != CRUSH_ITEM_NONE and o != prim:
                        want_fan[o] = want_fan.get(o, 0) + 1
        assert plan.fan_in == want_fan
        assert not set(range(64)) & set(plan.fan_in)

    def test_expansion_plan(self, monkeypatch):
        ref_m, m = _big_maps()
        post = apply_churn(m, add=16)
        ref_post = ref_churn.apply_churn(ref_m, add=16)
        assert post.to_dict() == ref_post.to_dict()
        plan = _planner(m).plan(post)
        _assert_plans_equal(plan, _ref_scalar_plan(monkeypatch, ref_m, ref_post))
        new_ids = set(range(1024, 1040))
        assert any(o in new_ids for entries in plan.remapped.values()
                   for e in entries for o in e["moved"])

    def test_rejoin_restores_mapping(self):
        _ref_m, m = _big_maps()
        healed = apply_churn(apply_churn(m, kill=[7, 300]), rejoin=[7, 300])
        plan = _planner(m).plan(healed)
        assert plan.remapped_pgs() == set()
        assert plan.moved_shards == 0
        assert plan.summary()["pgs_remapped"] == 0


@pytest.mark.slow
class TestScale:
    def test_oracle_pin_at_10k(self):
        m = synthetic_map(10_240, 16, replicated=(3, 512), ec=(EC_PROFILE, 512))
        pl = _planner(m)
        assert pl.verify_oracle(samples=8, rng=np.random.default_rng(3)) == 16
        plan = pl.plan(apply_churn(m, kill=list(range(32))))
        assert plan.device and plan.remapped_pgs()


# -- the pieces the port computes on the device --------------------------------


@pytest.mark.parametrize("flags", [om.FLAG_HASHPSPOOL, 0])
def test_pps_wraps_like_uint32(flags):
    """Placement seeds are uint32 values in int64 lanes: the pool id is
    added or hashed modulo 2^32, as the reference's numpy uint32 does."""
    seeds = np.array([0, 1, 5, 0xFFFF, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                     dtype=np.uint32)
    for pool_id in (1, 7, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF):
        for pg_num in (1, 12, 65536, 1 << 31):
            kw = dict(id=pool_id, name="p", pg_num=pg_num, pgp_num=pg_num, flags=flags)
            want = ref_churn._pps_vec(ref_om.Pool(**kw), seeds)
            got = churn._pps_vec(om.Pool(**kw), torch.from_numpy(seeds.astype(np.int64)))
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), want.astype(np.int64)), (pool_id, pg_num)
            lanes = churn._int32_bits(got)
            assert lanes.dtype == torch.int32
            assert np.array_equal(lanes.numpy().view(np.uint32), want)
            scalar = [om.Pool(**kw).raw_pg_to_pps(om.PGid(pool_id, int(s))) & 0xFFFFFFFF
                      for s in seeds]
            assert scalar == want.tolist()


@pytest.mark.parametrize("replicated", [True, False])
def test_up_filter_compaction_and_primary_match_reference(replicated):
    rng = np.random.default_rng(11)
    maps = [mod.build_simple(40) for mod in (ref_om, om)]
    for m in maps:
        for osd in (3, 9, 17, 18, 33):
            m.mark_down(osd)
        m.osd_state[21] = 0  # does not exist
    width = 5
    raw = rng.integers(0, 48, size=(2000, width)).astype(np.int32)  # ids past max_osd too
    raw[rng.random(raw.shape) < 0.2] = CRUSH_ITEM_NONE
    raw[rng.random(raw.shape) < 0.05] = -3  # a bucket id never maps to an OSD
    raw[:5] = [3, 9, 17, 18, 33]  # a row with every member down
    kind = om.POOL_TYPE_REPLICATED if replicated else om.POOL_TYPE_ERASURE
    pools = [mod.Pool(id=1, name="p", type=kind, size=width) for mod in (ref_om, om)]
    want = ref_churn.ChurnPlanner._raw_to_up_vec(maps[0], pools[0], raw)
    got = churn.ChurnPlanner._raw_to_up_vec(maps[1], pools[1], torch.from_numpy(raw))
    assert got[0].dtype == got[1].dtype == torch.int32
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert (got[1][:5] == -1).all()


def test_temp_overlays_on_the_device_mapping():
    maps = []
    for mod in (ref_churn, churn):
        m = mod.synthetic_map(64, 8, replicated=(3, 32), ec=(EC_PROFILE, 32))
        m.pg_temp[_pgid(m)(1, 4)] = [1, 9, 17]
        m.pg_temp[_pgid(m)(2, 7)] = [2, CRUSH_ITEM_NONE, 30]
        m.primary_temp[_pgid(m)(1, 11)] = 40
        m.primary_temp[_pgid(m)(2, 3)] = 5
        m.mark_down(9)
        maps.append(m)
    ref_m, m = maps
    for pool in m.pools.values():
        mapping = _planner(m).map_pool(m, pool)
        assert mapping.device
        _assert_scalar_equal(ref_m, mapping)


def _pgid(m):
    return ref_om.PGid if isinstance(m, ref_om.OSDMap) else om.PGid


def test_tables_follow_a_map_mutated_in_place():
    """A map mapped once and then given new buckets (a host, device-class
    shadow trees) is mapped again through tables of its new buckets."""
    m = synthetic_map(64, 8, replicated=(3, 32), ec=None)
    pl = _planner(m)
    pl.map_all()
    # a host added in place, as apply_churn adds one to its copy
    new_ids = list(range(64, 72))
    root = m.crush.buckets[m.crush.root_id()]
    hid = m.crush.make_bucket(CRUSH_BUCKET_STRAW2, 1, new_ids, [0x10000] * 8, name="host-new")
    root.items.append(hid)
    root.item_weights.append(m.crush.buckets[hid].weight)
    root.weight += m.crush.buckets[hid].weight
    for osd in new_ids:
        m.mark_up(osd)
        m.mark_in(osd)
    # then a class-tagged EC pool, whose rule takes a shadow root
    for osd in range(72):
        m.crush.set_device_class(osd, "ssd" if osd % 3 else "hdd")
    m.set_erasure_code_profile("cls", {**EC_PROFILE, "crush-device-class": "ssd"})
    m.create_erasure_pool("cls-ec", "cls", pg_num=32, fault_domain_type=1)
    ref_m = ref_om.OSDMap.from_dict(m.to_dict())
    moved = False
    for pool in m.pools.values():
        mapping = pl.map_pool(m, pool)
        assert mapping.device
        _assert_scalar_equal(ref_m, mapping)
        moved |= bool(((mapping.acting >= 64) & (mapping.acting < 72)).any())
    assert moved  # the new host's devices take PGs
