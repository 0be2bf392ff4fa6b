"""The port's batched CRUSH mapper held against the reference, on the CPU.

``ceph_tpu_torch.crush.mapper_torch.vec_do_rule`` and ``vec_rule_stats``
(``device="cpu"``: the plain torch versions of the draw) against
``ceph_tpu.crush.mapper.crush_do_rule``, lane by lane, on the shapes
``tests/test_crush_vec.py`` covers, and against the reference's JAX
vector path (``ceph_tpu.crush.mapper_jax.vec_do_rule``) on four of them;
then ``CrushTester`` and ``crushtool --test`` against the reference's.
Maps are built in the reference package and carried across by the wire
form.  No tolerance: equality everywhere.
"""

import json
import re

import numpy as np
import pytest
import torch

from ceph_tpu.crush import encoding as ref_encoding
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu.crush import mapper_jax, mapper_jax_hier
from ceph_tpu.crush.map import (
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_TAKE,
    CrushMap,
    Rule,
    Tunables,
)
from ceph_tpu.crush.tester import CrushTester as RefTester
from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu_torch.crush import encoding, mapper_torch, mapper_torch_hier
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.tools import crushtool

CPU = torch.device("cpu")

# lanes a case; the JAX cases, CrushTester and crushtool share the chooseleaf
# shape (x = 0..N_X-1, numrep 3) so the reference compiles it once a worker
N_X = 64


def carry(ref_cmap):
    return encoding.crush_from_dict(ref_encoding.crush_to_dict(ref_cmap))


def _weights(n):
    w = [0x10000] * n
    w[0] = 0          # out device: always rejected
    w[1] = 0x4000     # reweighted: probabilistically rejected
    if n > 12:
        w[12] = 0x8000
    return w


def _compare(ref, rule, result_max, weights=None, n_x=N_X):
    """Every lane of the port's vec_do_rule equals the reference's scalar
    mapper, padded with NONE (firstn rows are left-packed)."""
    assert mapper_torch.supports(carry(ref), rule)
    xs = np.arange(n_x, dtype=np.uint32)
    vec = mapper_torch.vec_do_rule(carry(ref), rule, xs, result_max, weight=weights,
                                   device="cpu")
    for x in range(n_x):
        scal = ref_mapper.crush_do_rule(ref, rule, x, result_max, weight=weights)
        want = np.full(vec.shape[1], CRUSH_ITEM_NONE, dtype=np.int32)
        want[: len(scal)] = scal
        assert np.array_equal(vec[x], want), f"x={x}: vec {list(vec[x])} != scalar {scal}"
    return vec


@pytest.mark.parametrize("profile", ["bobtail", "firefly", "jewel"])
@pytest.mark.parametrize("n,indep", [(7, False), (24, True), (3, False)])
def test_flat_bit_exact_vs_scalar(profile, n, indep):
    m = CrushMap.flat(n, tunables=getattr(Tunables, profile)())
    rule = m.add_simple_rule(m.root_id(), 0, indep=indep, max_size=10)
    _compare(m, rule, 6, _weights(n), n_x=32 if n == 3 else N_X)


def test_flat_all_weights_in():
    m = CrushMap.flat(16)
    _compare(m, m.add_simple_rule(m.root_id(), 0), 3)


def test_flat_heavily_out():
    """More erasures than survivors exercises the retry/NONE paths."""
    m = CrushMap.flat(6)
    rule = m.add_simple_rule(m.root_id(), 0, indep=True, max_size=10)
    _compare(m, rule, 5, [0, 0, 0x10000, 0x10000, 0, 0x2000], n_x=32)


# -- hierarchical maps ---------------------------------------------------------


def _build_racks(tun=None, seed=7):
    """2 racks x 3 hosts x 2-4 devices, uneven device weights (the map
    of tests/test_crush_vec.py)."""
    m = CrushMap(tun)
    m.type_names.update({1: "host", 2: "rack", 3: "root"})
    rng = np.random.default_rng(seed)
    dev = 0
    rack_ids, rack_ws = [], []
    for rk in range(2):
        host_ids, host_ws = [], []
        for h in range(3):
            n = int(rng.integers(2, 5))
            devs = list(range(dev, dev + n))
            dev += n
            ws = [int(rng.integers(1, 4)) * 0x10000 for _ in devs]
            hid = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, devs, ws, name=f"h{rk}{h}")
            host_ids.append(hid)
            host_ws.append(m.buckets[hid].weight)
        rid = m.make_bucket(CRUSH_BUCKET_STRAW2, 2, host_ids, host_ws, name=f"rack{rk}")
        rack_ids.append(rid)
        rack_ws.append(m.buckets[rid].weight)
    m.make_bucket(CRUSH_BUCKET_STRAW2, 3, rack_ids, rack_ws, name="default")
    return m


@pytest.mark.parametrize("profile", ["bobtail", "firefly", "jewel"])
@pytest.mark.parametrize("indep", [False, True])
def test_hier_chooseleaf_bit_exact(profile, indep):
    """chooseleaf firstn/indep across racks -> hosts -> devices, across
    tunable generations (vary_r=0/1, stable=0/1)."""
    m = _build_racks(getattr(Tunables, profile)())
    _compare(m, m.add_simple_rule(m.root_id(), 1, indep=indep), 4)


def test_hier_chooseleaf_across_racks():
    m = _build_racks()
    _compare(m, m.add_simple_rule(m.root_id(), 2), 2)


def test_hier_out_and_reweighted_devices():
    m = _build_racks()
    r1 = m.add_simple_rule(m.root_id(), 1)
    r2 = m.add_simple_rule(m.root_id(), 1, indep=True)
    wv = m.get_weights(out=[0, 5], reweight={3: 0.33, 7: 0.5})
    _compare(m, r1, 3, wv)
    _compare(m, r2, 4, wv)


@pytest.mark.parametrize("op,want_type,nrep", [
    (CRUSH_RULE_CHOOSE_FIRSTN, 1, 3),
    (CRUSH_RULE_CHOOSE_FIRSTN, 0, 3),
    (CRUSH_RULE_CHOOSE_INDEP, 0, 4),
])
def test_hier_plain_choose_buckets_and_devices(op, want_type, nrep):
    """Non-chooseleaf CHOOSE to an intermediate type (returns bucket ids)
    and type 0 (drills through the hierarchy to devices)."""
    m = _build_racks()
    r = Rule(20 + want_type + op, 1, 1, 10)
    r.step(CRUSH_RULE_TAKE, m.root_id()).step(op, 0, want_type).step(CRUSH_RULE_EMIT)
    _compare(m, m.add_rule(r), nrep)


@pytest.mark.parametrize("indep", [False, True])
def test_hier_exhaustion_more_reps_than_domains(indep):
    """numrep > #racks: firstn returns short, indep leaves holes."""
    m = _build_racks()
    _compare(m, m.add_simple_rule(m.root_id(), 2, indep=indep), 3, n_x=32)


def test_hier_zero_weight_host():
    m = CrushMap()
    m.type_names.update({1: "host", 2: "root"})
    h1 = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, [0, 1], [0, 0], name="dead")
    h2 = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, [2, 3], [0x10000, 0x10000], name="live1")
    h3 = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, [4, 5], [0x10000, 0x8000], name="live2")
    m.make_bucket(CRUSH_BUCKET_STRAW2, 2, [h1, h2, h3],
                  [m.buckets[h].weight for h in (h1, h2, h3)], name="default")
    _compare(m, m.add_simple_rule(m.root_id(), 1), 3)


def test_hier_device_class_rule():
    """A rule that takes a device class's shadow tree."""
    m = _build_racks()
    for d in range(0, 18, 2):
        m.set_device_class(d, "ssd")
    m.populate_classes()
    rule = m.add_simple_rule(m.root_id(), 1, device_class="ssd")
    vec = _compare(m, rule, 3)
    assert set(np.unique(vec)) <= set(range(0, 18, 2)) | {CRUSH_ITEM_NONE}


# -- multi-step (LRC per-layer) chains ---------------------------------------


def _chain_rule(m, n1, n2, *, leaf=True):
    """TAKE root -> CHOOSE_INDEP(n1, rack) -> CHOOSE[LEAF]_INDEP(n2, host
    or device) -> EMIT: the LRC ruleset_steps shape
    (reference:src/erasure-code/lrc/ErasureCodeLrc.cc:44)."""
    rule = Rule(len([r for r in m.rules if r]), 3, 1, n1 * n2)
    rule.step(CRUSH_RULE_TAKE, m.root_id())
    rule.step(CRUSH_RULE_CHOOSE_INDEP, n1, 2)
    rule.step(CRUSH_RULE_CHOOSELEAF_INDEP if leaf else CRUSH_RULE_CHOOSE_INDEP,
              n2, 1 if leaf else 0)
    rule.step(CRUSH_RULE_EMIT)
    return m.add_rule(rule)


@pytest.mark.parametrize("n1,n2,leaf,result_max", [
    (2, 2, True, 4),   # the LRC rule of tests/test_crush_vec.py
    (2, 3, True, 6),   # wider second step: holes where a rack runs out of hosts
    (2, 2, False, 4),  # plain choose of devices in the second step
    (2, 3, True, 5),   # result_max cuts the second rack's region short
    (3, 2, True, 6),   # a third rack that is not there: its slot is skipped
    (3, 2, True, 3),   # ... and result_max cuts after the first region
])
def test_chained_rule_bit_exact(n1, n2, leaf, result_max):
    m = _build_racks()
    _compare(m, _chain_rule(m, n1, n2, leaf=leaf), result_max)


def test_chained_rule_with_weights_and_outs():
    m = _build_racks()
    rule = _chain_rule(m, 2, 2)
    wv = m.get_weights(out=[1, 4], reweight={2: 0.5})
    vec = _compare(m, rule, 4, wv)
    hier = mapper_torch_hier.vec_do_rule_hier(carry(m), rule, np.arange(N_X), 4, weight=wv,
                                              device="cpu")
    assert np.array_equal(hier, vec)


def _zero_weight_rack():
    """The rack map with its second rack weighted 0 in the root: a chain's
    first step leaves a slot NONE, which the second step skips."""
    m = _build_racks()
    m.buckets[m.root_id()].item_weights[1] = 0
    return m


def _racks_8x16x12(seed=3):
    """8 racks x 16 hosts x 12 devices (1536 devices, weights 0.5 to 4):
    the production-sized map of ``gf_matmul_sweep.crush_choose_maps``."""
    m = CrushMap()
    m.type_names.update({1: "host", 2: "rack", 3: "root"})
    rng = np.random.default_rng(seed)
    dev, racks = 0, []
    for rk in range(8):
        hosts = []
        for hs in range(16):
            ws = [int(w) for w in rng.integers(0x8000, 0x40000, size=12)]
            hosts.append(m.make_bucket(CRUSH_BUCKET_STRAW2, 1, list(range(dev, dev + 12)), ws,
                                       name=f"rack{rk}-host{hs}"))
            dev += 12
        racks.append(m.make_bucket(CRUSH_BUCKET_STRAW2, 2, hosts,
                                   [m.buckets[b].weight for b in hosts], name=f"rack{rk}"))
    m.make_bucket(CRUSH_BUCKET_STRAW2, 3, racks, [m.buckets[b].weight for b in racks],
                  name="default")
    return m


def _lrc_racks_rule(m, groups, per_group):
    """The rule ``OSDMap.create_erasure_pool`` builds for an LRC profile
    with ruleset-locality=rack and ruleset-failure-domain=host
    (``_add_steps_rule``, reference:ErasureCodeLrc.cc:44):
    SET_CHOOSELEAF_TRIES 5, TAKE, CHOOSE_INDEP racks, CHOOSELEAF_INDEP
    hosts in each, EMIT."""
    rule = Rule(len([r for r in m.rules if r]), 3, 1, groups * per_group)
    rule.step(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5).step(CRUSH_RULE_TAKE, m.root_id())
    rule.step(CRUSH_RULE_CHOOSE_INDEP, groups, 2).step(CRUSH_RULE_CHOOSELEAF_INDEP, per_group, 1)
    rule.step(CRUSH_RULE_EMIT)
    return m.add_rule(rule)


def _chain_case(make, n1, n2, result_max, outs=False, n_x=N_X):
    def build():
        m = make()
        rule = (_lrc_racks_rule(m, n1, n2) if m.max_devices > 100
                else _chain_rule(m, n1, n2))
        weights = None
        if outs:
            weights = m.get_weights(out=[1, 4, m.max_devices - 3], reweight={2: 0.5, 9: 0.3})
        return m, rule, result_max, weights, n_x
    return build


# name -> () -> (map, rule, result_max, weights, lanes)
CHAIN_ROUTE_CASES = {
    "toy chain": _chain_case(_build_racks, 2, 2, 4),
    "zero-weight rack": _chain_case(_zero_weight_rack, 2, 2, 4),
    "outs and reweights": _chain_case(_build_racks, 2, 2, 4, outs=True),
    "result_max cuts a region": _chain_case(_build_racks, 2, 3, 5, outs=True),
    "racks map, LRC k=8 m=4 l=3": _chain_case(_racks_8x16x12, 4, 4, 16, outs=True, n_x=200),
}


@pytest.mark.parametrize("name", sorted(CHAIN_ROUTE_CASES))
def test_chain_route_equals_scalar_step_engine_and_jax(name):
    """A chain that ``chain_rules`` takes runs one routed choose a step
    (on the CPU the kernel's plain version with per-lane roots): equal
    to the scalar mapper, the step engine and, on the toy map, the
    reference's JAX hierarchical path (its 16-slot LRC rule takes about
    50 s to compile on the CPU, so the racks map's is held against the
    scalar mapper and the step engine only)."""
    ref, rule, result_max, weights, n_x = CHAIN_ROUTE_CASES[name]()
    port = carry(ref)
    assert mapper_torch_hier.chain_rules(port, rule, result_max) is not None
    vec = _compare(ref, rule, result_max, weights, n_x=n_x)
    xs = np.arange(n_x, dtype=np.uint32)
    step = mapper_torch._step_engine(port, rule, mapper_torch_hier.lanes_of(xs, CPU),
                                     result_max, weights)
    assert np.array_equal(step.numpy(), vec)
    if ref.max_devices < 100:
        want = mapper_jax_hier.vec_do_rule_hier(ref, rule, xs, result_max, weight=weights)
        assert np.array_equal(np.asarray(want), vec)
    if name == "zero-weight rack":
        assert (vec[:, 2:] == CRUSH_ITEM_NONE).all()


def test_supports_rejects_unsupported():
    # legacy tunables -> perm-choose fallback paths possible
    m = carry(CrushMap.flat(5, tunables=Tunables.legacy()))
    r = m.add_simple_rule(m.root_id(), 0)
    assert not mapper_torch.supports(m, r)
    with pytest.raises(ValueError):
        mapper_torch.vec_do_rule(m, r, np.arange(4, dtype=np.uint32), 3, device="cpu")
    m2 = carry(CrushMap.hierarchical([[0, 1], [2, 3], [4, 5]]))
    assert mapper_torch.supports(m2, m2.add_simple_rule(m2.root_id("default"), 1))
    m4 = carry(CrushMap.hierarchical([[0, 1], [2, 3]], alg=CRUSH_BUCKET_STRAW))
    assert not mapper_torch.supports(m4, m4.add_simple_rule(m4.root_id("default"), 1))
    m3 = carry(CrushMap.flat(5))
    assert mapper_torch.supports(m3, m3.add_simple_rule(m3.root_id(), 0))
    # weights the kernel's int32 tables cannot hold
    m5 = carry(CrushMap.flat(3, weight=40000.0))
    assert not mapper_torch.supports(m5, m5.add_simple_rule(m5.root_id(), 0))
    # a firstn chain is not supported (as in the reference)
    m6 = carry(_build_racks())
    chain = Rule(9, 1, 1, 10)
    chain.step(CRUSH_RULE_TAKE, m6.root_id()).step(CRUSH_RULE_CHOOSE_FIRSTN, 2, 2)
    chain.step(CRUSH_RULE_CHOOSE_FIRSTN, 2, 0).step(CRUSH_RULE_EMIT)
    assert not mapper_torch.supports(m6, m6.add_rule(chain))


# -- against the reference's JAX vector path -----------------------------------


def _jax_case(kind):
    if kind in ("flat firstn", "flat indep"):
        m = CrushMap.flat(24)
        rule = m.add_simple_rule(m.root_id(), 0, indep=kind.endswith("indep"))
        return m, rule, 5, _weights(24)
    m = _build_racks()
    if kind == "chooseleaf":
        return m, m.add_simple_rule(m.root_id(), 1), 3, m.get_weights(out=[2], reweight={6: 0.4})
    return m, _chain_rule(m, 2, 2), 4, None


@pytest.mark.parametrize("kind", ["flat firstn", "flat indep", "chooseleaf", "chain"])
def test_equals_the_jax_vector_path(kind):
    ref, rule, result_max, weights = _jax_case(kind)
    xs = np.arange(N_X, dtype=np.uint32)
    want = np.asarray(mapper_jax.vec_do_rule(ref, rule, xs, result_max, weight=weights))
    got = mapper_torch.vec_do_rule(carry(ref), rule, xs, result_max, weight=weights,
                                   device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)


# -- counts, CrushTester and crushtool ------------------------------------------


@pytest.mark.parametrize("indep", [False, True])
def test_vec_rule_stats_equal_scalar_counts(indep):
    ref = _build_racks()
    rule = ref.add_simple_rule(ref.root_id(), 1, indep=indep)
    wv = ref.get_weights(out=[3])
    counts, bad = mapper_torch.vec_rule_stats(carry(ref), rule, np.arange(N_X), 4,
                                              weight=wv, device="cpu")
    want, want_bad = {}, 0
    for x in range(N_X):
        res = [d for d in ref_mapper.crush_do_rule(ref, rule, x, 4, weight=wv)
               if d != CRUSH_ITEM_NONE]
        for d in res:
            want[d] = want.get(d, 0) + 1
        want_bad += len(res) < 4
    assert counts == want and bad == want_bad


def test_tester_equals_reference_tester():
    ref = _build_racks()
    rule = ref.add_simple_rule(ref.root_id(), 1)
    reports = []
    for tester in (RefTester(ref), CrushTester(carry(ref), device="cpu")):
        tester.max_x = N_X - 1
        tester.min_rep = tester.max_rep = 3
        tester.weight = ref.get_weights(reweight={4: 0.5})
        (rep,) = [r for r in tester.test() if r.rule == rule]
        reports.append(rep)
    assert reports[0].backend == reports[1].backend == "vectorized"
    assert reports[1].device_counts == reports[0].device_counts
    assert reports[1].bad_mappings == reports[0].bad_mappings
    assert reports[1].expected_per_device == reports[0].expected_per_device


def test_tester_scalar_fallback_matches_vectorized(caplog):
    m = carry(CrushMap.flat(9))
    m.add_simple_rule(m.root_id(), 0, indep=True, max_size=8)
    t = CrushTester(m, device="cpu")
    t.min_x, t.max_x = 0, 300
    t.min_rep = t.max_rep = 4
    (vec_rep,) = t.test()
    t.force_scalar = True
    (scal_rep,) = t.test()
    assert vec_rep.backend == "vectorized" and scal_rep.backend == "scalar"
    assert vec_rep.device_counts == scal_rep.device_counts
    assert vec_rep.bad_mappings == scal_rep.bad_mappings
    legacy = carry(CrushMap.flat(5, tunables=Tunables.legacy()))
    legacy.add_simple_rule(legacy.root_id(), 0)
    t = CrushTester(legacy, device="cpu")
    t.max_x = 20
    t.min_rep = t.max_rep = 2
    with caplog.at_level("WARNING", logger="ceph_tpu_torch.crush"):
        assert [r.backend for r in t.test()] == ["scalar"]
    assert "fell back to the SCALAR mapper" in caplog.text


def test_crushtool_test_output_equals_reference(tmp_path, capsys):
    ref = _build_racks()
    ref.add_simple_rule(ref.root_id(), 1)
    path = tmp_path / "map.json"
    path.write_text(json.dumps(ref_encoding.crush_to_dict(ref)))
    argv = ["-i", str(path), "--tree", "--test", "--num-rep", "3", "--max-x", str(N_X - 1),
            "--show-utilization", "--show-mappings"]
    outs = []
    for main, extra in ((ref_crushtool.main, []), (crushtool.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        # the timing differs from run to run; everything else must not
        outs.append(re.sub(r"inputs in \S+ \([\d,]+ mappings/s", "", capsys.readouterr().out))
    assert "vectorized" in outs[1] and "device 0:" in outs[1]
    assert outs[1] == outs[0]
    assert crushtool.main(["--build", "8", "-o", str(tmp_path / "b.json")]) == 0
    assert ref_crushtool.main(["--build", "8", "-o", str(tmp_path / "a.json")]) == 0
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
