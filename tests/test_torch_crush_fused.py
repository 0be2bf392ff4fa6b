"""The fused CRUSH choose step and the divide by reciprocal, on the CPU.

``crush_torch.div_by_recip_plain`` (the kernels' exact divide: the high
half of ``n * recip``, one correction) against ``//``; ``MapTables``'
reciprocals against ``recip_table``; ``fused_rule`` against the rule
interpreter's own reading of each rule; and ``_emulate_crush_choose``,
which walks the packed tables lane by lane as ``csrc/crush_choose.cu``
does (the take row staged apart, the reciprocal divide, a register
``out``), against the reference's scalar
``ceph_tpu.crush.mapper.crush_do_rule``.  The kernel itself runs only on
the card (``chip_smoke.py`` phase 7).  No tolerance: equality
everywhere.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu.crush.map import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_TAKE,
    CrushMap,
    Rule,
    Tunables,
)
from ceph_tpu_torch.crush import mapper_torch, mapper_torch_hier
from ceph_tpu_torch.crush.hashes import crush_hash32_2, crush_hash32_3
from ceph_tpu_torch.ops import crush_torch, gf_cuda
from tests.test_torch_crush_vec import _build_racks, _chain_rule, _weights, carry

CPU = torch.device("cpu")
U64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
NONE, UNDEF = CRUSH_ITEM_NONE, 0x7FFFFFFE
# lanes a case held against the scalar mapper
N_X = 160


# -- the divide by reciprocal --------------------------------------------------

PRIMES = (65521, 1000003, 2147483629)
EDGE_W = (1, 2, 3, 0xFFFF, 0x10000, 0x10001, (1 << 31) - 1, *PRIMES)


def _div(n, w):
    n, w = np.asarray(n, dtype=np.int64), np.asarray(w, dtype=np.int64)
    recip = torch.from_numpy(crush_torch.recip_table(w))
    return crush_torch.div_by_recip_plain(torch.from_numpy(n), torch.from_numpy(w),
                                          recip).numpy()


@pytest.mark.parametrize("w", EDGE_W)
def test_div_by_recip_equals_floor_division_on_edges(w):
    ns = {0, 1, 1 << 48, (1 << 48) - 1}
    for q in (1, 2, 7, 0xFFFF, (1 << 48) // w):
        ns |= {q * w - 1, q * w, q * w + 1}
    n = sorted(v for v in ns if 0 <= v <= 1 << 48)
    assert np.array_equal(_div(n, [w] * len(n)), np.asarray(n, dtype=np.int64) // w)


@settings(max_examples=200, deadline=None)
@given(n=st.lists(st.integers(0, 1 << 48), min_size=1, max_size=32),
       w=st.integers(1, (1 << 31) - 1))
def test_div_by_recip_equals_floor_division(n, w):
    assert np.array_equal(_div(n, [w] * len(n)), np.asarray(n, dtype=np.int64) // w)


def test_recip_table():
    w = np.array([0, 1, 2, 3, 0x10000, (1 << 31) - 1], dtype=np.int64)
    got = crush_torch.recip_table(w).view(np.uint64)
    assert got.tolist() == [0] + [U64 // int(v) for v in w[1:]]


# -- the maps and rules of tests/test_torch_crush_vec.py ----------------------


def _flat(n, indep, profile="jewel"):
    m = CrushMap.flat(n, tunables=getattr(Tunables, profile)())
    return m, m.add_simple_rule(m.root_id(), 0, indep=indep, max_size=10)


def _racks_rule(want_type, indep, tun=None):
    m = _build_racks(tun)
    return m, m.add_simple_rule(m.root_id(), want_type, indep=indep)


def _plain_choose(op, want_type):
    m = _build_racks()
    r = Rule(20 + want_type + op, 1, 1, 10)
    r.step(CRUSH_RULE_TAKE, m.root_id()).step(op, 0, want_type).step(CRUSH_RULE_EMIT)
    return m, m.add_rule(r)


def _leaf_knobs(vary_r, stable, leaf_tries, tun=None):
    """chooseleaf firstn over hosts with SET_CHOOSELEAF_* steps."""
    m = _build_racks(tun)
    r = Rule(30, 1, 1, 10)
    r.step(CRUSH_RULE_SET_CHOOSELEAF_VARY_R, vary_r)
    r.step(CRUSH_RULE_SET_CHOOSELEAF_STABLE, stable)
    if leaf_tries:
        r.step(CRUSH_RULE_SET_CHOOSELEAF_TRIES, leaf_tries)
    r.step(CRUSH_RULE_TAKE, m.root_id()).step(CRUSH_RULE_CHOOSELEAF_FIRSTN, 0, 1)
    r.step(CRUSH_RULE_EMIT)
    return m, m.add_rule(r)


def _device_class():
    """A rule that takes a device class's shadow tree."""
    m = _build_racks()
    for d in range(0, 18, 2):
        m.set_device_class(d, "ssd")
    m.populate_classes()
    return m, m.add_simple_rule(m.root_id(), 1, device_class="ssd")


def _zero_weight_host():
    m = CrushMap()
    m.type_names.update({1: "host", 2: "root"})
    h1 = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, [0, 1], [0, 0], name="dead")
    h2 = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, [2, 3], [0x10000, 0x10000], name="live1")
    h3 = m.make_bucket(CRUSH_BUCKET_STRAW2, 1, [4, 5], [0x10000, 0x8000], name="live2")
    m.make_bucket(CRUSH_BUCKET_STRAW2, 2, [h1, h2, h3],
                  [m.buckets[h].weight for h in (h1, h2, h3)], name="default")
    return m, m.add_simple_rule(m.root_id(), 1)


# no chooseleaf_descend_once: the leaf step takes the rule's whole tries
# (10 here, to keep the step engine's rounds few)
NO_DESCEND_ONCE = Tunables(0, 0, 9, 0, 1, 0, 1)

# name -> (map and rule, result_max, weights or None[, lanes if not N_X])
CASES = {
    "flat firstn": (lambda: _flat(24, False), 5, _weights(24), 96),
    "flat indep": (lambda: _flat(24, True), 5, _weights(24), 96),
    "flat firstn bobtail": (lambda: _flat(7, False, "bobtail"), 6, _weights(7), 48),
    "flat indep heavily out": (lambda: _flat(6, True), 5, [0, 0, 0x10000, 0x10000, 0, 0x2000],
                               32),
    "chooseleaf firstn across racks": (lambda: _racks_rule(2, False), 2, None),
    "chooseleaf indep hosts": (lambda: _racks_rule(1, True), 4, None),
    "chooseleaf firstn hosts bobtail": (lambda: _racks_rule(1, False, Tunables.bobtail()), 4,
                                        None),
    "chooseleaf firstn hosts firefly": (lambda: _racks_rule(1, False, Tunables.firefly()), 4,
                                        None),
    "chooseleaf firstn reweighted, outs": (lambda: _racks_rule(1, False), 3, "outs"),
    "chooseleaf indep reweighted, outs": (lambda: _racks_rule(1, True), 4, "outs"),
    "vary_r 2, stable 0": (lambda: _leaf_knobs(2, 0, 0), 4, "outs"),
    "vary_r 3, stable 1, leaf tries 3": (lambda: _leaf_knobs(3, 1, 3), 4, "outs"),
    "vary_r 0, no descend_once": (lambda: _leaf_knobs(0, 0, 0, NO_DESCEND_ONCE), 4, "outs"),
    "exhaustion firstn (3 of 2 racks)": (lambda: _racks_rule(2, False), 3, None, 64),
    "exhaustion indep (3 of 2 racks)": (lambda: _racks_rule(2, True), 3, None, 64),
    "choose firstn hosts": (lambda: _plain_choose(CRUSH_RULE_CHOOSE_FIRSTN, 1), 3, None),
    "choose firstn devices through hosts": (lambda: _plain_choose(CRUSH_RULE_CHOOSE_FIRSTN, 0),
                                            3, "outs"),
    "choose indep devices through hosts": (lambda: _plain_choose(CRUSH_RULE_CHOOSE_INDEP, 0),
                                           4, "outs"),
    "zero-weight host": (_zero_weight_host, 3, None),
    "device-class shadow tree": (_device_class, 3, None),
}


def _case(name):
    make, result_max, weights, *n_x = CASES[name]
    ref, rule = make()
    if weights == "outs":
        weights = ref.get_weights(out=[0, 5], reweight={3: 0.33, 7: 0.5})
    elif weights is None:
        weights = ref.get_weights()
    return ref, carry(ref), rule, result_max, list(weights), (n_x or [N_X])[0]


# -- the packed tables and the rule the kernel takes ----------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_map_tables_reciprocals(name):
    _ref, cmap, _rule, _rm, _w, _n = _case(name)
    T = mapper_torch_hier.MapTables(cmap, CPU)
    assert T.rows.recip.dtype == torch.int64 and T.rows.recip.shape == T.rows.items.shape
    assert torch.equal(T.rows.recip, torch.from_numpy(crush_torch.recip_table(T.rows.weights)))
    for bid, b in cmap.buckets.items():
        row = T.row_of[bid]
        want = crush_torch.recip_table(b.item_weights).view(np.uint64).tolist()
        assert T.rows.recip[row, :len(b.items)].numpy().view(np.uint64).tolist() == want
        assert want == [U64 // w if w else 0 for w in b.item_weights]
        assert T.sizes[row] == len(b.items)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_rule_reads_the_rule_as_the_interpreter_does(name):
    _ref, cmap, ruleno, result_max, _w, _n = _case(name)
    rule = mapper_torch_hier.fused_rule(cmap, ruleno, result_max)
    take, chooses, tries, leaf_tries, vary_r, stable = mapper_torch_hier._rule_shape(
        cmap, ruleno)
    (choose,) = chooses
    firstn = choose.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
    numrep = choose.arg1 if choose.arg1 > 0 else choose.arg1 + result_max
    # crush_do_rule's leaf tries (ceph_tpu_torch/crush/mapper.py:558-563, 610)
    if not firstn:
        recurse = leaf_tries or 1
    elif leaf_tries:
        recurse = leaf_tries
    else:
        recurse = 1 if cmap.tunables.chooseleaf_descend_once else tries
    T = mapper_torch_hier.MapTables(cmap, CPU)
    assert rule is not None and rule.take_row == T.row_of[take]
    assert (rule.firstn, rule.numrep, rule.width, rule.tries, rule.recurse_tries,
            rule.want_type, rule.vary_r, rule.stable) == (
        int(firstn), numrep, min(numrep, result_max), tries, recurse, choose.arg2, vary_r,
        stable)
    assert rule.depth == (0 if all(i >= 0 for i in cmap.buckets[take].items) else T.depth)


def test_fused_rule_refuses_chains_legacy_and_wide_rules():
    racks = carry(_build_racks())
    assert mapper_torch_hier.fused_rule(racks, _chain_rule(racks, 2, 2), 4) is None
    legacy = carry(CrushMap.flat(5, tunables=Tunables.legacy()))
    assert mapper_torch_hier.fused_rule(
        legacy, legacy.add_simple_rule(legacy.root_id(), 0), 3) is None
    ref = CrushMap.flat(64)
    ruleno = ref.add_simple_rule(ref.root_id(), 0, max_size=64)
    wide, over = carry(ref), gf_cuda.CHOOSE_MAX_WIDTH + 1
    assert mapper_torch_hier.fused_rule(wide, ruleno, over - 1).width == over - 1
    assert mapper_torch_hier.fused_rule(wide, ruleno, over) is None
    assert mapper_torch_hier.fused_rule(wide, ruleno, 0) is None
    # such a rule takes the step engine
    out = mapper_torch.vec_do_rule(wide, ruleno, np.arange(4), over, device="cpu")
    for x in range(4):
        scal = ref_mapper.crush_do_rule(ref, ruleno, x, over)
        assert out[x].tolist() == scal + [NONE] * (over - len(scal))


# -- the kernel's walk, lane by lane ---------------------------------------------


def _crush_ln(u, ln):
    """crush_draw.cuh's crush_ln: 64-bit wrapping product, low byte."""
    x, iexpon = u + 1, 15
    if not x & 0x18000:
        bits = 16 - x.bit_length()  # __clz(x & 0x1ffff) - 16
        x <<= bits
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = ln[index1 - 256] & U64
    lh = ln[index1 + 1 - 256]
    xl = (((x * rh) & U64) >> 48) & 0xFF
    lh += ln[258 + xl]
    return (iexpon << 44) + (lh >> 4)


def _straw2_slot(items, weights, recip, n, x, r, ln):
    """crush_draw.cuh's straw2_slot: the first smallest quotient."""
    high, high_q = 0, U64
    for i in range(n):
        q = U64
        if weights[i] > 0:
            u = crush_hash32_3(x, items[i] & M32, r & M32) & 0xFFFF
            n_ln = (1 << 48) - _crush_ln(u, ln)
            q = (n_ln * recip[i]) >> 64            # __umul64hi
            if n_ln - q * weights[i] >= weights[i]:
                q += 1
        if q < high_q:
            high, high_q = i, q
    return high


def _emulate_crush_choose(T, rule, xs, reweight):
    """``csrc/crush_choose.cu`` in Python, lane by lane, over the packed
    tables of ``T`` (a CPU ``MapTables``): the take row staged apart,
    the reciprocal divide, ``out``/``out2`` of CHOOSE_MAX_WIDTH slots.
    Returns ([len(xs), width] rows, the draws made)."""
    R = T.rows
    items, weights, crow, ctype = (t.tolist() for t in (R.items, R.weights, R.child_row,
                                                        R.child_type))
    recip = R.recip.numpy().view(np.uint64).tolist()
    sizes, ln, rw = T.sizes, R.ln.tolist(), list(reweight)
    tr, n_root = rule.take_row, T.sizes[rule.take_row]
    staged = tuple(t[tr][:n_root] for t in (items, weights, recip, crow, ctype))
    draws = [0]

    def descend(x, row, r, want_type):
        for _level in range(rule.depth + 1):
            tabs = staged if row == tr else (items[row], weights[row], recip[row], crow[row],
                                            ctype[row])
            n = n_root if row == tr else sizes[row]
            if n == 0:
                return "empty", 0, -1, 0
            s = _straw2_slot(*tabs[:3], n, x, r, ln)
            draws[0] += n
            item, c_row, c_type = tabs[0][s], tabs[3][s], tabs[4][s]
            if c_type == want_type:
                return "hit", item, c_row, c_type
            if item >= 0 or c_row < 0:
                break
            row = c_row
        return "dead", 0, -1, 0

    def is_out(x, item):
        if item < 0 or item >= len(rw):
            return True
        w = rw[item]
        if w >= 0x10000:
            return False
        return w == 0 or (crush_hash32_2(x, item & M32) & 0xFFFF) >= w

    def leaf_firstn(x, row, rep2, sub_r, out2, outpos):
        ftotal = 0
        while True:
            st_, item, _row, typ = descend(x, row, rep2 + sub_r + ftotal, 0)
            if st_ == "dead":
                return None
            reject, collide = st_ == "empty", False
            if not reject:
                collide = item in out2[:outpos]
                if not collide and typ == 0:
                    reject = is_out(x, item)
            if not reject and not collide:
                return item
            ftotal += 1
            if ftotal >= rule.recurse_tries:
                return None

    def choose_firstn(x, out, out2):
        outpos = 0
        for rep in range(rule.numrep):
            if outpos >= rule.width:
                break
            ftotal = 0
            while True:
                r = rep + ftotal
                st_, item, row, typ = descend(x, tr, r, rule.want_type)
                if st_ == "dead":
                    break
                reject, collide = st_ == "empty", False
                if not reject:
                    collide = item in out[:outpos]
                    if not collide and rule.leaf:
                        if item < 0:
                            sub_r = r >> (rule.vary_r - 1) if rule.vary_r else 0
                            leaf = leaf_firstn(x, row, 0 if rule.stable else outpos, sub_r,
                                               out2, outpos)
                            if leaf is None:
                                reject = True
                            else:
                                out2[outpos] = leaf
                        else:
                            out2[outpos] = item
                    if not reject and not collide and typ == 0:
                        reject = is_out(x, item)
                if not reject and not collide:
                    out[outpos] = item
                    outpos += 1
                    break
                ftotal += 1
                if ftotal >= rule.tries:
                    break
        return outpos

    def leaf_indep(x, row, rep, r):
        for ftotal in range(rule.recurse_tries):
            st_, item, _row, typ = descend(x, row, rep + r + rule.numrep * ftotal, 0)
            if st_ == "dead":
                return None
            if st_ == "empty" or (typ == 0 and is_out(x, item)):
                continue
            return item
        return None

    def choose_indep(x, out, out2):
        width = rule.width
        out[:width] = out2[:width] = [UNDEF] * width
        left, ftotal = width, 0
        while left > 0 and ftotal < rule.tries:
            for rep in range(width):
                if out[rep] != UNDEF:
                    continue
                r = rep + rule.numrep * ftotal
                st_, item, row, typ = descend(x, tr, r, rule.want_type)
                if st_ == "empty":
                    continue
                if st_ == "dead":
                    out[rep] = out2[rep] = NONE
                    left -= 1
                    continue
                if item in out[:width]:
                    continue
                if rule.leaf:
                    if item < 0:
                        leaf = leaf_indep(x, row, rep, r)
                        if leaf is None:
                            out2[rep] = NONE
                            continue
                        out2[rep] = leaf
                    else:
                        out2[rep] = item
                if typ == 0 and is_out(x, item):
                    continue
                out[rep] = item
                left -= 1
            ftotal += 1
        for v in (out, out2):
            v[:width] = [NONE if s == UNDEF else s for s in v[:width]]

    rows = []
    for x in xs:
        out, out2 = [0] * gf_cuda.CHOOSE_MAX_WIDTH, [0] * gf_cuda.CHOOSE_MAX_WIDTH
        if rule.firstn:
            placed = choose_firstn(x, out, out2)
            res = out2 if rule.leaf else out
            rows.append([res[i] if i < placed else NONE for i in range(rule.width)])
        else:
            choose_indep(x, out, out2)
            rows.append((out2 if rule.leaf else out)[:rule.width])
    return np.asarray(rows, dtype=np.int64), draws[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_equals_the_scalar_mapper(name):
    ref, cmap, ruleno, result_max, weights, n_x = _case(name)
    rule = mapper_torch_hier.fused_rule(cmap, ruleno, result_max)
    T = mapper_torch_hier.tables_for(cmap, CPU)
    got, draws = _emulate_crush_choose(T, rule, range(n_x), weights)
    assert draws >= n_x
    for x in range(n_x):
        scal = ref_mapper.crush_do_rule(ref, ruleno, x, result_max, weight=weights)
        want = scal + [NONE] * (rule.width - len(scal))
        assert got[x].tolist() == want, f"x={x}: {got[x].tolist()} != scalar {scal}"
    # and the routed CPU path (the kernel's plain version) gives the same
    vec = mapper_torch.vec_do_rule(cmap, ruleno, np.arange(n_x), result_max, weight=weights,
                                   device="cpu")
    assert np.array_equal(vec, got)
