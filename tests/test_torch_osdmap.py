"""The port's cluster map held against the reference, on the CPU.

``ceph_tpu_torch.osd.osdmap`` (``OSDMap``, ``Pool``, ``PGid``,
``Incremental``, ``advance_map``), ``utils/str_hash``,
``accel/accelmap``, ``store/kv``, ``mon/store`` and
``tools/osdmaptool`` against their ``ceph_tpu`` counterparts: twins of
``tests/test_osdmap.py``, of the tests of ``tests/test_osdmap_inc.py``
that need no running cluster, and of ``tests/test_tools.py``'s
osdmaptool round trip; state carried across the packages by the wire
dict, by incrementals and by the mon's store; and every PG of small
maps (flat and a 4-host hierarchy; replicated and EC pools of all five
plugins; ``pg_temp``, ``primary_temp``, primary affinity, reweights and
device classes) through both packages' ``pg_to_up_acting_osds``.  Each
scenario is built in both packages from the same calls.  No tolerance:
equality everywhere.
"""

import json

import pytest

from ceph_tpu.mon import store as ref_store
from ceph_tpu.osd import osdmap as ref_om
from ceph_tpu.store import kv as ref_kv
from ceph_tpu.tools import osdmaptool as ref_osdmaptool
from ceph_tpu.utils import str_hash as ref_str_hash
from ceph_tpu_torch.crush import CRUSH_ITEM_NONE
from ceph_tpu_torch.mon import store as mon_store
from ceph_tpu_torch.osd import osdmap as om
from ceph_tpu_torch.osd.osdmap import OSDMap, PGid, SPGid
from ceph_tpu_torch.store import kv
from ceph_tpu_torch.tools import osdmaptool
from ceph_tpu_torch.utils import str_hash

BOTH = (ref_om, om)


def twin(scenario):
    """Run ``scenario(package)`` in the reference and in the port; the
    results must be equal.  Returns the port's."""
    want = scenario(ref_om)
    got = scenario(om)
    assert got == want
    return got


def _pgid_cls(m):
    return ref_om.PGid if isinstance(m, ref_om.OSDMap) else om.PGid


def pgs_of(m) -> list:
    """(pool, seed, up, up_primary, acting, acting_primary) of every PG."""
    pgid = _pgid_cls(m)
    return [(pid, seed, *m.pg_to_up_acting_osds(pgid(pid, seed)))
            for pid, pool in sorted(m.pools.items()) for seed in range(pool.pg_num)]


# -- twins of tests/test_osdmap.py ---------------------------------------------


class TestStrHash:
    NAMES = ("", "a", "foo", "x" * 11, "x" * 12, "x" * 13, "x" * 25,
             "rbd_data.1234abcd.0000000000000001", b"\x00\xff" * 17)

    def test_rjenkins_known(self):
        vals = {str_hash.ceph_str_hash_rjenkins(s) for s in self.NAMES[:7]}
        assert len(vals) == 7
        assert str_hash.ceph_str_hash_rjenkins("foo") == str_hash.ceph_str_hash_rjenkins(b"foo")
        for s in self.NAMES:
            assert str_hash.ceph_str_hash_rjenkins(s) == ref_str_hash.ceph_str_hash_rjenkins(s)
            for t in (str_hash.CEPH_STR_HASH_LINUX, str_hash.CEPH_STR_HASH_RJENKINS):
                assert str_hash.ceph_str_hash(t, s) == ref_str_hash.ceph_str_hash(t, s)
        with pytest.raises(ValueError):
            str_hash.ceph_str_hash(7, "x")

    def test_linux(self):
        assert str_hash.ceph_str_hash_linux("") == 0
        assert str_hash.ceph_str_hash_linux("a") == ((0 + (97 << 4) + (97 >> 4)) * 11) & 0xFFFFFFFF
        for s in self.NAMES:
            assert str_hash.ceph_str_hash_linux(s) == ref_str_hash.ceph_str_hash_linux(s)


class TestStableMod:
    def test_stable_mod(self):
        for x in range(64):
            assert 0 <= om.ceph_stable_mod(x, 12, 15) < 12
        assert om.ceph_stable_mod(13, 12, 15) == 5
        assert om.ceph_stable_mod(3, 12, 15) == 3
        for b, mask in ((12, 15), (1, 0), (65536, 65535), (3000, 4095)):
            for x in (0, 1, 11, 12, 4095, 65537, 0xFFFFFFFF):
                assert om.ceph_stable_mod(x, b, mask) == ref_om.ceph_stable_mod(x, b, mask)


def make_map(pkg, n=6, pg_num=32):
    m = pkg.build_simple(n)
    m.create_replicated_pool("rbd", size=3, pg_num=pg_num)
    return m


def ec42(pkg, n=8, pg_num=16):
    m = pkg.build_simple(n)
    m.set_erasure_code_profile("ec42", {"plugin": "jerasure", "technique": "reed_sol_van",
                                        "k": "4", "m": "2"})
    return m, m.create_erasure_pool("ecpool", "ec42", pg_num=pg_num)


class TestAddressing:
    def test_object_to_acting_deterministic(self):
        def scenario(pkg):
            m = make_map(pkg)
            pg, acting, primary = m.object_to_acting("object-1", 1)
            assert (pg, acting, primary) == m.object_to_acting("object-1", 1)
            return str(pg), acting, primary

        _pg, acting, primary = twin(scenario)
        assert len(acting) == len(set(acting)) == 3
        assert primary == acting[0]
        assert all(0 <= o < 6 for o in acting)

    def test_distribution_covers_osds(self):
        def scenario(pkg):
            m = make_map(pkg)
            return [m.object_to_acting(f"obj-{i}", 1)[1] for i in range(200)]

        assert {o for acting in twin(scenario) for o in acting} == set(range(6))

    def test_down_osd_replicated_shifts(self):
        def scenario(pkg):
            m = make_map(pkg)
            for i in range(100):
                pg, acting, _ = m.object_to_acting(f"o-{i}", 1)
                if 0 in acting:
                    break
            else:
                pytest.fail("no object mapped to osd 0")
            m.mark_down(0)
            return str(pg), m.pg_to_up_acting_osds(pg)

        _pg, (up2, primary2, _acting, _ap) = twin(scenario)
        assert 0 not in up2
        assert CRUSH_ITEM_NONE not in up2  # replicated: compact, no holes
        assert primary2 == up2[0]

    def test_ec_pool_positional_holes(self):
        def scenario(pkg):
            m, pool = ec42(pkg)
            assert (pool.size, pool.stripe_width) == (6, 4 * 4096)
            pg = pkg.PGid(pool.id, 3)
            before = m.pg_to_up_acting_osds(pg)
            m.mark_down(before[0][2])
            return before, m.pg_to_up_acting_osds(pg)

        (up, *_), (up2, *_) = twin(scenario)
        assert len(up) == 6
        assert up2[2] == CRUSH_ITEM_NONE  # hole stays positional
        assert [up2[i] for i in (0, 1, 3, 4, 5)] == [up[i] for i in (0, 1, 3, 4, 5)]

    def test_out_osd_remapped(self):
        def scenario(pkg):
            m = make_map(pkg)
            pg = pkg.PGid(1, 5)
            up = m.pg_to_up_acting_osds(pg)[0]
            m.mark_out(up[0])
            return up, m.pg_to_up_acting_osds(pg)[0]

        up, up2 = twin(scenario)
        assert up[0] not in up2
        assert len(up2) == 3

    def test_pg_temp_overrides_acting(self):
        def scenario(pkg):
            m = make_map(pkg)
            pg = m.pools[1].raw_pg_to_pg(m.object_locator_to_pg("x", 1))
            before = m.pg_to_up_acting_osds(pg)
            temp = [o for o in range(6) if o not in before[0]][:3]
            m.pg_temp[pg] = temp
            return before, temp, m.pg_to_up_acting_osds(pg)

        (up, *_), temp, (up2, _upp2, acting2, ap2) = twin(scenario)
        assert up2 == up
        assert acting2 == temp
        assert ap2 == temp[0]

    def test_primary_temp(self):
        def scenario(pkg):
            m = make_map(pkg)
            pg = m.pools[1].raw_pg_to_pg(pkg.PGid(1, 7))
            acting = m.pg_to_up_acting_osds(pg)[2]
            m.primary_temp[pg] = acting[1]
            return acting, m.pg_to_up_acting_osds(pg)[3]

        acting, p2 = twin(scenario)
        assert p2 == acting[1]

    def test_primary_affinity_zero_moves_primary(self):
        def scenario(pkg):
            m = make_map(pkg)
            pg = m.pools[1].raw_pg_to_pg(pkg.PGid(1, 2))
            primary = m.pg_to_up_acting_osds(pg)[3]
            m.osd_primary_affinity = [pkg.CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * 6
            m.osd_primary_affinity[primary] = 0
            return primary, m.pg_to_up_acting_osds(pg)

        primary, (_up, _upp, acting2, primary2) = twin(scenario)
        assert primary2 != primary
        assert primary2 in acting2

    def test_hashpspool_separates_pools(self):
        def scenario(pkg):
            m = pkg.build_simple(6)
            m.create_replicated_pool("a", pg_num=16)
            m.create_replicated_pool("b", pg_num=16)
            return pgs_of(m)

        rows = twin(scenario)
        a = [r[4] for r in rows if r[0] == 1]
        b = [r[4] for r in rows if r[0] == 2]
        assert a != b

    def test_nspace_changes_pg(self):
        def scenario(pkg):
            m = make_map(pkg)
            return [str(m.object_locator_to_pg("obj", 1, nspace=ns)) for ns in ("", "ns", "x" * 40)]

        a, b, _c = twin(scenario)
        assert a != b


class TestPGid:
    def test_str_parse_roundtrip(self):
        pg = PGid(3, 0x1A)
        assert str(pg) == "3.1a"
        assert PGid.parse("3.1a") == pg
        spg = SPGid(pg, 4)
        assert str(spg) == "3.1as4"
        assert SPGid.parse("3.1as4") == spg
        assert SPGid.parse("3.1a") == SPGid(pg)
        for s in ("3.1a", "12.ffff", "1.0s3"):
            assert str(SPGid.parse(s)) == str(ref_om.SPGid.parse(s)) == s


class TestWireRoundtrip:
    def test_json_roundtrip_preserves_mapping(self):
        def scenario(pkg):
            m, _pool = ec42(pkg, pg_num=8)
            m.create_replicated_pool("rbd", pg_num=8)
            m.mark_down(3)
            m.pg_temp[pkg.PGid(1, 2)] = [0, 1, 2, 4, 5, 6]
            m2 = pkg.OSDMap.from_dict(json.loads(json.dumps(m.to_dict())))
            assert m2.epoch == m.epoch
            assert m2.erasure_code_profiles == m.erasure_code_profiles
            assert pgs_of(m2) == pgs_of(m)
            return m2.to_dict(), pgs_of(m2)

        twin(scenario)

    def test_ec_profile_validation(self):
        for pkg in BOTH:
            m = pkg.build_simple(4)
            m.set_erasure_code_profile("bad", {"plugin": "jerasure", "k": "0", "m": "1"})
            with pytest.raises(Exception):
                m.create_erasure_pool("p", "bad")
            with pytest.raises(ValueError):
                m.create_erasure_pool("p", "missing-profile")


# -- twins of tests/test_osdmap_inc.py (no running cluster) ---------------------


def _mutations(m, pkg):
    """One mutation per family the mon performs."""
    yield lambda: m.mark_down(1)
    yield lambda: m.mark_up(1, addr="127.0.0.1:7001")
    yield lambda: m.mark_out(2)
    yield lambda: m.mark_in(2)
    yield lambda: m.add_pool(pkg.Pool(id=7, name="p7", pg_num=4, pgp_num=4))
    yield lambda: m.set_erasure_code_profile("ec1", {"k": "2", "m": "1"})
    yield lambda: m.pg_temp.update({pkg.PGid(7, 0): [3, 1, 0]})
    yield lambda: m.pg_temp.pop(pkg.PGid(7, 0))
    yield lambda: setattr(m, "mgr_name", "mgr.x")


def _json(d):
    return json.loads(json.dumps(d))


class TestIncremental:
    def test_diff_apply_roundtrip_every_mutation(self):
        def scenario(pkg):
            m = pkg.build_simple(6)
            incs = []
            for mutate in _mutations(m, pkg):
                old = m.to_dict()
                mutate()
                m.epoch += 1
                new = m.to_dict()
                inc = pkg.Incremental.diff(old, new)
                assert inc.apply_to_dict(_json(old)) == _json(new)
                inc2 = pkg.Incremental.from_dict(_json(inc.to_dict()))
                assert inc2.apply_to_dict(_json(old)) == _json(new)
                incs.append(inc.to_dict())
            return _json(incs)

        twin(scenario)

    def test_delta_is_small(self):
        def scenario(pkg):
            m = pkg.build_simple(16)
            m.add_pool(pkg.Pool(id=1, name="data", pg_num=64, pgp_num=64))
            old = m.to_dict()
            m.mark_down(5)
            m.epoch += 1
            inc = pkg.Incremental.diff(old, m.to_dict())
            return len(json.dumps(inc.to_dict())), len(json.dumps(m.to_dict())), \
                sorted({p[0] for p, _v in inc.sets})

        wire, full, touched = twin(scenario)
        assert wire < full / 10, (wire, full)
        assert "pools" not in touched and "crush" not in touched

    def test_apply_incremental_epoch_gate(self):
        for pkg in BOTH:
            m = pkg.build_simple(4)
            old = m.to_dict()
            m.mark_down(0)
            m.epoch += 2  # skip an epoch
            inc = pkg.Incremental.diff(old, m.to_dict())
            with pytest.raises(ValueError):
                pkg.build_simple(4).apply_incremental(
                    pkg.Incremental(inc.epoch, inc.base_epoch + 1, inc.sets, inc.dels))

    def test_advance_map_chain_and_gap(self):
        def scenario(pkg):
            m0 = pkg.build_simple(4)
            m, incs = m0, []
            for i in range(3):
                d_old = m.to_dict()
                m = pkg.OSDMap.from_dict(d_old)
                m.mark_down(i)
                m.epoch += 1
                incs.append(pkg.Incremental.diff(d_old, m.to_dict()).to_dict())
            got = pkg.advance_map(m0, m.epoch, None, incs)
            assert got is not None and got.to_dict() == m.to_dict()
            assert pkg.advance_map(m0, m.epoch, None, incs[1:]) is None
            full = pkg.advance_map(m0, m.epoch, m.to_dict(), incs[1:])
            assert full is not None and full.epoch == m.epoch
            assert pkg.advance_map(m, m.epoch, None, []) is m
            return _json(incs), got.to_dict()

        twin(scenario)


def _commit_epochs(store, m, n):
    pkg = ref_om if isinstance(m, ref_om.OSDMap) else om
    for i in range(n):
        old = m.to_dict()
        m.mark_down(i % 4) if i % 2 == 0 else m.mark_up(i % 4)
        m.epoch += 1
        inc = pkg.Incremental.diff(old, m.to_dict()).to_dict()
        store.save(m.to_dict(), election_epoch=1, inc=inc)


class TestMonStoreDeltaLog:
    def test_store_grows_by_deltas_with_checkpoints(self, tmp_path):
        store = mon_store.MonitorDBStore(str(tmp_path / "mon.db"))
        m = om.build_simple(4)
        store.save(m.to_dict(), election_epoch=1)  # bootstrap full
        n = 80
        _commit_epochs(store, m, n)
        fulls = store.db.keys("osdmap")
        incs = store.db.keys("osdmap_inc")
        assert len(incs) >= n - len(fulls), (len(incs), len(fulls))
        assert len(fulls) <= n // mon_store.CHECKPOINT_EVERY + 2, len(fulls)
        assert store.get_map() == m.to_dict()
        mid = m.epoch - mon_store.CHECKPOINT_EVERY // 2
        assert store.get_map(mid)["epoch"] == mid
        chain = store.get_incrementals(m.epoch - 5, m.epoch)
        assert chain is not None and len(chain) == 5
        # the reference's store, fed the same epochs, holds the same keys
        ref = ref_store.MonitorDBStore(str(tmp_path / "ref.db"))
        rm = ref_om.build_simple(4)
        ref.save(rm.to_dict(), election_epoch=1)
        _commit_epochs(ref, rm, n)
        for prefix in ("osdmap", "osdmap_inc", "meta"):
            assert list(store.db.iterate(prefix)) == list(ref.db.iterate(prefix))
        store.close()
        ref.close()

    def test_store_reload_after_restart(self, tmp_path):
        path = str(tmp_path / "mon.db")
        store = mon_store.MonitorDBStore(path)
        m = om.build_simple(4)
        store.save(m.to_dict(), election_epoch=3)
        _commit_epochs(store, m, 10)
        store.close()
        store2 = mon_store.MonitorDBStore(path)
        assert store2.get_map() == m.to_dict()
        assert store2.last_committed() == m.epoch
        assert store2.election_epoch() == 1
        store2.close()

    def test_foreign_adoption_writes_full(self, tmp_path):
        store = mon_store.MonitorDBStore(str(tmp_path / "mon.db"))
        m = om.build_simple(4)
        store.save(m.to_dict(), election_epoch=1)
        m.epoch += 7  # jump (foreign map)
        store.save(m.to_dict(), election_epoch=2, inc=None)
        assert store.get_map() == m.to_dict()
        assert store.db.keys("osdmap") == [f"{1:010d}", f"{m.epoch:010d}"]
        store.close()


# -- twin of tests/test_tools.py::test_osdmaptool_roundtrip --------------------


def test_osdmaptool_roundtrip(tmp_path, capsys):
    outputs = {}
    for name, tool, pkg in (("ref", ref_osdmaptool, ref_om), ("port", osdmaptool, om)):
        d = tmp_path / name
        d.mkdir()
        mp, out2 = str(d / "map.json"), str(d / "out.json")
        lines = []

        def run(*argv):
            assert tool.main(list(argv)) == 0
            lines.append(capsys.readouterr().out.replace(str(d), "<dir>"))

        run("--createsimple", "6", "-o", mp)
        run(mp, "--print")
        m = pkg.OSDMap.from_dict(json.load(open(mp)))
        pool = m.create_replicated_pool("data", size=3)
        m.mark_down(4)
        json.dump(m.to_dict(), open(mp, "w"))
        run(mp, "--test-map-pgs", "--pool", str(pool.id))
        run(mp, "--test-map-pgs")
        run(mp, "--test-map-object", "thing", "--pool", str(pool.id))
        run(mp, "--mark-out", "2", "-o", out2)
        run(out2, "--print")
        assert not pkg.OSDMap.from_dict(json.load(open(out2))).is_in(2)
        outputs[name] = (lines, json.load(open(mp)), json.load(open(out2)))
    assert outputs["port"] == outputs["ref"]
    lines = outputs["port"][0]
    assert "max_osd 6" in lines[1]
    assert "pg_count 8" in lines[2]
    assert "primary osd." in lines[4]
    assert tool_errors(tmp_path, capsys) == tool_errors(tmp_path, capsys, ref_osdmaptool)


def tool_errors(tmp_path, capsys, tool=osdmaptool):
    """The tool's refusals: exit codes and messages."""
    mp = str(tmp_path / "port" / "map.json")
    out = []
    for argv in (["--createsimple", "4"], [], [mp, "--test-map-object", "x"],
                 [mp, "--test-map-pgs", "--pool", "9"], [mp, "--mark-out", "1"]):
        rc = tool.main(argv)
        cap = capsys.readouterr()
        out.append((rc, cap.err.replace(str(tmp_path), "<dir>")))
    return out


# -- state carried across the packages -----------------------------------------


def rich_map(pkg, crush_pkg):
    """A map with every kind of state the wire dict carries."""
    hosts = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    m = pkg.build_simple(12, crush=crush_pkg.CrushMap.hierarchical(hosts))
    m.fsid = "6f1c1d3e-0000-4000-8000-000000000001"
    for osd in range(12):
        m.crush.set_device_class(osd, "ssd" if osd % 2 else "hdd")
        m.osd_addrs[osd] = f"10.0.0.{osd}:6800"
    m.create_replicated_pool("rbd", size=3, pg_num=32, fault_domain_type=1)
    m.create_replicated_pool("fast", size=2, pg_num=16, device_class="ssd")
    m.set_erasure_code_profile("lrc", {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
                                       "ruleset-locality": "host",
                                       "ruleset-failure-domain": "osd"})
    m.create_erasure_pool("lrcpool", "lrc", pg_num=16)
    m.set_erasure_code_profile("hdd", {"plugin": "isa", "k": "2", "m": "1",
                                       "crush-device-class": "hdd"})
    m.create_erasure_pool("cold", "hdd", pg_num=16, fault_domain_type=1)
    m.mark_down(4)
    m.mark_out(7)
    m.mark_in(9, weight=0x8000)
    m.osd_primary_affinity = [0x10000] * 12
    m.osd_primary_affinity[1] = 0
    m.osd_primary_affinity[6] = 0x4000
    m.pg_temp[pkg.PGid(1, 3)] = [0, 3, 6]
    m.pg_temp[pkg.PGid(3, 1)] = [0, CRUSH_ITEM_NONE, 4, 6, 9, 10, 11, 2]
    m.primary_temp[pkg.PGid(1, 5)] = 11
    m.pools[1].snaps[4] = "snap-a"
    m.pools[1].snap_seq = 4
    m.mgr_name, m.mgr_addr = "mgr.x", "10.0.0.100:7000"
    m.mds_ranks = [["mds.a", "10.0.0.101:7001"], ["", ""]]
    m.cluster_flags.update({"noout", "noscrub"})
    m.accelmap.note_boot("accel.0", "10.0.0.200:7100", locality="host1", capacity=64)
    m.accelmap.note_boot("accel.1", "10.0.0.201:7100")
    m.accelmap.mark_down("accel.1")
    m.epoch = 42
    return m


def _crush_pkg(pkg):
    if pkg is ref_om:
        from ceph_tpu import crush
    else:
        from ceph_tpu_torch import crush
    return crush


def test_wire_dict_carries_across_both_ways():
    ref_m = rich_map(ref_om, _crush_pkg(ref_om))
    port_m = rich_map(om, _crush_pkg(om))
    wire = _json(ref_m.to_dict())
    assert _json(port_m.to_dict()) == wire  # same calls, same map
    carried = OSDMap.from_dict(_json(ref_m.to_dict()))
    assert _json(carried.to_dict()) == wire
    back = ref_om.OSDMap.from_dict(_json(port_m.to_dict()))
    assert _json(back.to_dict()) == wire
    assert pgs_of(carried) == pgs_of(ref_m) == pgs_of(back) == pgs_of(port_m)
    assert carried.locality_of(3) == ref_m.locality_of(3) == "host1"
    assert carried.mds_rank_table() == ref_m.mds_rank_table()
    assert [e.name for e in carried.accelmap.up_entries()] == ["accel.0"]
    assert carried.pools[1].snaps == {4: "snap-a"}


def test_incremental_applies_across_packages():
    for src, dst in ((ref_om, om), (om, ref_om)):
        m = rich_map(src, _crush_pkg(src))
        old = m.to_dict()
        m.mark_down(2)
        m.pg_temp.pop(src.PGid(1, 3))
        m.accelmap.note_boot("accel.2", "10.0.0.202:7100")
        m.create_replicated_pool("late", size=2, pg_num=8)
        m.epoch += 1
        inc = _json(src.Incremental.diff(old, m.to_dict()).to_dict())
        base = dst.OSDMap.from_dict(_json(old))
        got = base.apply_incremental(dst.Incremental.from_dict(inc))
        assert _json(got.to_dict()) == _json(m.to_dict())
        assert pgs_of(got) == pgs_of(m)
        assert dst.advance_map(base, m.epoch, None, [inc]).to_dict() == got.to_dict()


def test_mon_store_reads_across_packages(tmp_path):
    for name, (src_store, src), (dst_store, _dst) in (
            ("ref-to-port", (ref_store, ref_om), (mon_store, om)),
            ("port-to-ref", (mon_store, om), (ref_store, ref_om))):
        path = str(tmp_path / name)
        store = src_store.MonitorDBStore(path)
        m = rich_map(src, _crush_pkg(src))
        store.save(m.to_dict(), election_epoch=2)
        _commit_epochs(store, m, 40)
        store.set_accepted({"epoch": m.epoch + 1, "value": "x"})
        store.close()
        reader = dst_store.MonitorDBStore(path)
        assert reader.last_committed() == m.epoch
        assert reader.get_map() == _json(m.to_dict())
        assert reader.get_map(m.epoch - 20)["epoch"] == m.epoch - 20
        assert len(reader.get_incrementals(m.epoch - 5, m.epoch)) == 5
        assert reader.accepted() == {"epoch": m.epoch + 1, "value": "x"}
        reader.close()


def test_kv_writes_the_references_on_disk_format(tmp_path):
    dbs = {}
    for name, mod in (("ref", ref_kv), ("port", kv)):
        db = mod.FileKVDB(str(tmp_path / name))
        db.open()
        db.submit(db.transaction().set("a", "k1", b"\x00\x01").set("b", "k2", b"v"))
        db.submit(db.transaction().rmkey("a", "k1").set("a", "k3", b"w" * 100))
        db.submit(db.transaction().rmkeys_by_prefix("b"))
        dbs[name] = db
    journal = [(tmp_path / n / "journal").read_bytes() for n in ("ref", "port")]
    assert journal[0] == journal[1] and journal[0]
    for db in dbs.values():
        db.close()
    cps = [(tmp_path / n / "checkpoint").read_bytes() for n in ("ref", "port")]
    assert cps[0] == cps[1]
    for name, mod in (("ref", kv), ("port", ref_kv)):  # each opens the other's
        db = mod.FileKVDB(str(tmp_path / name))
        db.open()
        assert list(db.iterate("a")) == [("k3", b"w" * 100)]
        assert db.keys("b") == []
        db.crash_close()


# -- every PG of small maps through both packages ------------------------------


PLUGINS = {
    "jerasure": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2"},
    "isa": {"plugin": "isa", "k": "4", "m": "2"},
    "lrc": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "shec": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "example": {"plugin": "example", "k": "3"},
}


def small_map(pkg, topology: str, plugin: str):
    crush = _crush_pkg(pkg)
    if topology == "flat":
        m = pkg.build_simple(12)
        fault_domain = 0
    else:
        hosts = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
        m = pkg.build_simple(12, crush=crush.CrushMap.hierarchical(hosts))
        fault_domain = 1
    m.create_replicated_pool("rep", size=3, pg_num=16, fault_domain_type=fault_domain)
    m.set_erasure_code_profile("prof", PLUGINS[plugin])
    m.create_erasure_pool("ec", "prof", pg_num=12)
    m.create_erasure_pool("ec-domain", "prof", pg_num=6, fault_domain_type=fault_domain)
    return m


@pytest.mark.parametrize("topology", ["flat", "hosts"])
@pytest.mark.parametrize("plugin", sorted(PLUGINS))
def test_every_pg_equal_on_small_maps(topology, plugin):
    maps = [small_map(pkg, topology, plugin) for pkg in BOTH]
    assert _json(maps[1].to_dict()) == _json(maps[0].to_dict())  # same pools and rules
    states = []
    for m, pkg in zip(maps, BOTH):
        rows = [pgs_of(m)]
        m.mark_down(3)
        m.mark_out(8)
        m.mark_in(10, weight=0x6000)
        rows.append(pgs_of(m))
        m.pg_temp[pkg.PGid(1, 4)] = [2, 5, 9]
        m.pg_temp[pkg.PGid(2, 6)] = [11, 10, 9, 3, 1, 0, 2][: m.pools[2].size]
        m.primary_temp[pkg.PGid(1, 9)] = 0
        m.primary_temp[pkg.PGid(2, 1)] = 7
        m.osd_primary_affinity = [0x10000] * 12
        m.osd_primary_affinity[0] = 0
        m.osd_primary_affinity[5] = 0x8000
        rows.append(pgs_of(m))
        states.append(rows)
    assert states[1] == states[0]


def test_every_pg_equal_with_device_classes():
    def scenario(pkg):
        m = rich_map(pkg, _crush_pkg(pkg))
        return _json(m.to_dict()), pgs_of(m)

    wire, _rows = twin(scenario)
    # the class pools took their shadow roots
    rules = wire["crush"]["rules"]
    assert len([r for r in rules if r]) == 4
