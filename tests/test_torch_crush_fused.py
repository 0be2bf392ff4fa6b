"""The fused CRUSH choose step and the divide by reciprocal, on the CPU.

``crush_torch.div_by_recip_plain`` (the kernels' exact divide: the high
half of ``n * recip``, one correction) against ``//``; ``MapTables``'
reciprocals against ``recip_table``; ``fused_rule`` against the rule
interpreter's own reading of each rule; ``_emulate_crush_choose_tiled``,
which walks the packed tables lane by lane as ``csrc/crush_choose.cu``
does with a tile of G threads a lane (the take row staged apart, the
reciprocal divide, each row's draws split over the tile and reduced
through the packed key q << 15 | slot, the lane's slots in one shared
array with a vote), against the reference's scalar
``ceph_tpu.crush.mapper.crush_do_rule`` for every G; the tile's draw on
ties, zero weights and rows wider than the tile; and the wrapper's
choice of G and its refusals, which run on the host.  The kernel itself
runs only on the card (``chip_smoke.py`` phases 7 and 8).  No
tolerance: equality everywhere.
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
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_TAKE,
    CrushMap,
    Rule,
    Tunables,
)
from ceph_tpu_torch.crush import mapper as port_mapper
from ceph_tpu_torch.crush import mapper_torch, mapper_torch_hier
from ceph_tpu_torch.crush.hashes import crush_hash32_2, crush_hash32_3
from ceph_tpu_torch.ops import crush_cuda, crush_torch, gf_cuda
from tests.test_torch_crush_vec import _build_racks, _chain_rule, _weights, carry

CPU = torch.device("cpu")
U64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
NONE, UNDEF = CRUSH_ITEM_NONE, 0x7FFFFFFE
# the tile's key: q << SLOT_BITS | slot; a weight of 0 draws ZERO_WEIGHT_Q
SLOT_BITS = 15
ZERO_WEIGHT_Q = (1 << 48) + 1
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
    # the rows below the take bucket, by the tables' child rows
    rows, sizes = {T.row_of[take]}, []
    while rows:
        row = rows.pop()
        sizes.append(T.sizes[row])
        rows |= {c for c in T.rows.child_row[row, :T.sizes[row]].tolist() if c >= 0}
    assert (rule.widest, rule.row_gcd) == (max(sizes), np.gcd.reduce(sizes))


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


def _q(x, item, r, w, recip, ln):
    """crush_draw.cuh's straw2_q: the quotient of a positive weight's
    draw, through the reciprocal divide."""
    u = crush_hash32_3(x, item & M32, r & M32) & 0xFFFF
    n_ln = (1 << 48) - _crush_ln(u, ln)
    q = (n_ln * recip) >> 64                     # __umul64hi
    return q + 1 if n_ln - q * w >= w else q


def _straw2_slot(items, weights, recip, n, x, r, ln):
    """crush_draw.cuh's straw2_slot: the first smallest quotient, one
    item after the other."""
    high, high_q = 0, U64
    for i in range(n):
        q = _q(x, items[i], r, weights[i], recip[i], ln) if weights[i] > 0 else U64
        if q < high_q:
            high, high_q = i, q
    return high


def _tile_slot(items, weights, recip, n, x, r, ln, G):
    """``Lane::draw`` of ``csrc/crush_choose.cu`` over a tile of G
    threads: thread t draws slots t, t + G, ... and keeps its least key
    q << 15 | slot (its first strict minimum of q; a weight of 0 is q =
    ZERO_WEIGHT_Q), then each round of the ``__shfl_xor_sync`` butterfly
    takes the least of its key and its partner's.  Returns the slot that
    every thread holds."""
    keys = []
    for t in range(G):
        best = U64
        for i in range(t, n, G):
            q = _q(x, items[i], r, weights[i], recip[i], ln) if weights[i] > 0 else ZERO_WEIGHT_Q
            best = min(best, q << SLOT_BITS | i)
        keys.append(best)
    off = G // 2
    while off:
        keys = [min(keys[t], keys[t ^ off]) for t in range(G)]
        off //= 2
    assert len(set(keys)) == 1, keys
    return keys[0] & ((1 << SLOT_BITS) - 1)


def _emulate_crush_choose_tiled(T, rule, xs, reweight, G, roots=None):
    """``csrc/crush_choose.cu`` in Python, lane by lane, over the packed
    tables of ``T`` (a CPU ``MapTables``) as a tile of G threads walks
    them: the take row staged apart, each row's draw split over the
    tile (:func:`_tile_slot`), ``out``/``out2`` in one shared array of
    the lane's width, a collision test as each thread's own slots t, t +
    G, ... and one vote, each placed slot written once.  With ``roots``
    (a chain's later step, ``crush_choose_roots_kernel``), lane j's
    indep choose starts from row ``roots[j]``, read like a deeper row,
    and a root of -1 gives a row of NONE and no draw.  Returns
    ([len(xs), width] rows, the draws made, each row's items once a
    lane)."""
    R = T.rows
    items, weights, crow, ctype = (t.tolist() for t in (R.items, R.weights, R.child_row,
                                                        R.child_type))
    recip = R.recip.numpy().view(np.uint64).tolist()
    sizes, ln, rw = T.sizes, R.ln.tolist(), list(reweight)
    tr = rule.take_row
    if roots is None:
        n_root = T.sizes[tr]
        staged = tuple(t[tr][:n_root] for t in (items, weights, recip, crow, ctype))
    width = rule.width
    draws = [0]

    def descend(x, row, r, want_type):
        for _level in range(rule.depth + 1):
            stage = roots is None and row == tr
            tabs = staged if stage else (items[row], weights[row], recip[row], crow[row],
                                         ctype[row])
            n = n_root if stage else sizes[row]
            if n == 0:
                return "empty", 0, -1, 0
            s = _tile_slot(*tabs[:3], n, x, r, ln, G)
            draws[0] += n
            item, c_row, c_type = tabs[0][s], tabs[3][s], tabs[4][s]
            if c_type == want_type:
                return "hit", item, c_row, c_type
            if item >= 0 or c_row < 0:
                break
            row = c_row
        return "dead", 0, -1, 0

    def holds(v, n, item):
        return any([any(v[i] == item for i in range(t, n, G)) for t in range(G)])

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
                collide = holds(out2, outpos, item)
                if not collide and typ == 0:
                    reject = is_out(x, item)
            if not reject and not collide:
                return item
            ftotal += 1
            if ftotal >= rule.recurse_tries:
                return None

    def choose_firstn(x, root, out, out2):
        outpos = 0
        for rep in range(rule.numrep):
            if outpos >= width:
                break
            ftotal = 0
            while True:
                r = rep + ftotal
                st_, item, row, typ = descend(x, root, r, rule.want_type)
                if st_ == "dead":
                    break
                reject, collide = st_ == "empty", False
                if not reject:
                    collide = holds(out, outpos, item)
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

    def choose_indep(x, root, out, out2):
        out[:] = out2[:] = [UNDEF] * width
        left, ftotal = width, 0
        while left > 0 and ftotal < rule.tries:
            for rep in range(width):
                if out[rep] != UNDEF:
                    continue
                r = rep + rule.numrep * ftotal
                st_, item, row, typ = descend(x, root, r, rule.want_type)
                if st_ == "empty":
                    continue
                if st_ == "dead":
                    out[rep] = out2[rep] = NONE
                    left -= 1
                    continue
                if holds(out, width, item):
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

    rows = []
    for j, x in enumerate(xs):
        root = tr if roots is None else roots[j]
        if root < 0:
            rows.append([NONE] * width)
            continue
        slots = [0] * (2 * width)  # the tile's out and out2 in shared memory
        out, out2 = slots[:width], slots[width:]
        res = out2 if rule.leaf else out
        if rule.firstn:
            placed = choose_firstn(x, root, out, out2)
            rows.append([res[i] if i < placed else NONE for i in range(width)])
        else:
            choose_indep(x, root, out, out2)
            rows.append([NONE if v == UNDEF else v for v in res])
    return np.asarray(rows, dtype=np.int64).reshape(len(rows), width), draws[0]


def _scalar_rows(name):
    """The reference's scalar mapper on the case's lanes, NONE-padded to
    the rule's width (memoised: every G of a case compares with it)."""
    if name not in _SCALAR:
        ref, cmap, ruleno, result_max, weights, n_x = _case(name)
        width = mapper_torch_hier.fused_rule(cmap, ruleno, result_max).width
        rows = []
        for x in range(n_x):
            scal = ref_mapper.crush_do_rule(ref, ruleno, x, result_max, weight=weights)
            rows.append(scal + [NONE] * (width - len(scal)))
        _SCALAR[name] = rows
    return _SCALAR[name]


_SCALAR: dict[str, list] = {}


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_equals_the_scalar_mapper(name):
    """The walk with the tile the wrapper picks for the rule."""
    _ref, cmap, ruleno, result_max, weights, n_x = _case(name)
    rule = mapper_torch_hier.fused_rule(cmap, ruleno, result_max)
    T = mapper_torch_hier.tables_for(cmap, CPU)
    got, draws = _emulate_crush_choose_tiled(T, rule, range(n_x), weights,
                                             crush_cuda.choose_tile(T, rule))
    assert draws >= n_x
    for x, want in enumerate(_scalar_rows(name)):
        assert got[x].tolist() == want, f"x={x}: {got[x].tolist()} != scalar {want}"
    # and the routed CPU path (the kernel's plain version) gives the same
    vec = mapper_torch.vec_do_rule(cmap, ruleno, np.arange(n_x), result_max, weight=weights,
                                   device="cpu")
    assert np.array_equal(vec, got)


@pytest.mark.parametrize("name,G", [(n, g) for n in sorted(CASES) for g in gf_cuda.CHOOSE_TILES])
def test_tiled_walk_equals_the_scalar_mapper(name, G):
    """Every tile the kernel is built for gives the scalar mapper's rows
    and counts the same draws (each row's items once a lane)."""
    _ref, cmap, ruleno, result_max, weights, n_x = _case(name)
    rule = mapper_torch_hier.fused_rule(cmap, ruleno, result_max)
    T = mapper_torch_hier.tables_for(cmap, CPU)
    got, draws = _emulate_crush_choose_tiled(T, rule, range(n_x), weights, G)
    for x, want in enumerate(_scalar_rows(name)):
        assert got[x].tolist() == want, f"G={G} x={x}: {got[x].tolist()} != scalar {want}"
    assert draws == _DRAWS.setdefault(name, draws)


_DRAWS: dict[str, int] = {}


# -- the tile's draw on ties, zero weights and wide rows ------------------------


def _row(items, weights):
    w = np.asarray(weights, dtype=np.int64)
    return list(items), list(weights), crush_torch.recip_table(w).view(np.uint64).tolist()


def _ranked(x, r, candidates, ln):
    """``candidates`` sorted by their draw's q at weight 0x10000, least
    (the winner) first."""
    recip = U64 // 0x10000
    return sorted(candidates, key=lambda it: _q(x, it, r, 0x10000, recip, ln))


@pytest.mark.parametrize("G", gf_cuda.CHOOSE_TILES)
@pytest.mark.parametrize("x,r", [(0, 0), (7, 3), (123456789, 41)])
def test_tile_draw_ties_go_to_the_first_slot(G, x, r):
    """The same item at two slots draws the same q: the first slot wins,
    whether the two slots fall to two threads (the later slot on the
    lower thread too) or to one thread (slots i and i + G)."""
    ln = crush_torch.ln_table(CPU).tolist()
    best, *rest = _ranked(x, r, range(100, 100 + 4 * G + 8), ln)
    n = 4 * G + 2
    for i, j in ((1, 2), (3, G + 1), (G - 1, 2 * G), (2, 2 + G), (0, 3 * G)):
        if j == i or not 0 <= i < j < n:
            continue
        items = rest[:n]
        items[i] = items[j] = best
        row = _row(items, [0x10000] * n)
        want = _straw2_slot(*row, n, x, r, ln)
        assert want == i
        assert _tile_slot(*row, n, x, r, ln, G) == i, (i, j)


@pytest.mark.parametrize("G", gf_cuda.CHOOSE_TILES)
def test_tile_draw_zero_weights_and_rows_wider_than_the_tile(G):
    """A row of weights 0 takes slot 0, as the scalar draw does; zero
    weights never win over a positive one; rows of 1 to 5 G + 3 items
    give the scalar draw's slot."""
    ln = crush_torch.ln_table(CPU).tolist()
    rng = np.random.default_rng(G)
    for n in (1, 2, G - 1, G, G + 1, 3 * G + 1, 5 * G + 3):
        if n < 1:
            continue
        items = rng.permutation(4096)[:n].tolist()
        zero = _row(items, [0] * n)
        for x, r in ((0, 0), (5, 1), (99, 7)):
            assert _tile_slot(*zero, n, x, r, ln, G) == _straw2_slot(*zero, n, x, r, ln) == 0
        w = rng.integers(1, 1 << 20, size=n)
        w[rng.random(n) < 0.4] = 0
        mixed = _row(items, w.tolist())
        for x in range(24):
            s = _tile_slot(*mixed, n, x, x % 5, ln, G)
            assert s == _straw2_slot(*mixed, n, x, x % 5, ln)
            assert w[s] > 0 or not w.any()


# -- the wrapper's tile, on the host -----------------------------------------------


@pytest.mark.parametrize("rows,want", [
    ([1], 4), ([3], 4), ([5], 4), ([8], 8), ([12], 4), ([16], 8), ([17], 4), ([64], 8),
    ([640], 8), ([16] + [4] * 16, 4), ([6] + [8] * 4 + [16] * 2, 4), ([8] + [8, 16] * 4, 8)])
def test_choose_tile_is_8_when_8_divides_every_row_else_4(rows, want):
    """A flat map of one row, or a root over hosts of the given sizes:
    the tile, 8 or 4, leaves no thread idle in any row's draws."""
    if len(rows) == 1:
        cmap = CrushMap.flat(rows[0])
        ruleno = cmap.add_simple_rule(cmap.root_id(), 0)
    else:
        assert rows[0] == len(rows) - 1
        first = np.cumsum([0] + rows[1:])
        cmap = CrushMap.hierarchical([list(range(a, a + n)) for a, n in zip(first, rows[1:])])
        ruleno = cmap.add_simple_rule(cmap.root_id("default"), 1)
    cmap = carry(cmap)
    rule = mapper_torch_hier.fused_rule(cmap, ruleno, 3)
    assert (rule.widest, rule.row_gcd) == (max(rows), np.gcd.reduce(rows))
    assert crush_cuda.choose_tile(mapper_torch_hier.tables_for(cmap, CPU), rule) == want


def test_choose_tile_refuses_what_the_kernel_does_not_take():
    """A width outside [1, 32] and a row of 2^15 items or more on the
    rule's path raise on the host; ``fused_rule`` leaves a map with such
    a row to the step engine, and takes one a slot narrower."""
    flat = carry(CrushMap.flat(64))
    ruleno = flat.add_simple_rule(flat.root_id(), 0)
    T, rule = mapper_torch_hier.tables_for(flat, CPU), mapper_torch_hier.fused_rule(flat, ruleno, 3)
    for bad in (rule._replace(width=gf_cuda.CHOOSE_MAX_WIDTH + 1), rule._replace(width=0)):
        with pytest.raises(ValueError, match="slots"):
            crush_cuda.choose_tile(T, bad)
    with pytest.raises(ValueError, match="rows of fewer than"):
        crush_cuda.choose_tile(T, rule._replace(widest=gf_cuda.CHOOSE_MAX_SLOTS))
    assert crush_cuda.choose_tile(T, rule._replace(widest=gf_cuda.CHOOSE_MAX_SLOTS - 1)) == 8
    wide = CrushMap.flat(gf_cuda.CHOOSE_MAX_SLOTS)
    assert mapper_torch_hier.fused_rule(wide, wide.add_simple_rule(wide.root_id(), 0), 3) is None
    under = CrushMap.flat(gf_cuda.CHOOSE_MAX_SLOTS - 1)
    rule = mapper_torch_hier.fused_rule(under, under.add_simple_rule(under.root_id(), 0), 3)
    assert (rule.widest, rule.row_gcd) == (gf_cuda.CHOOSE_MAX_SLOTS - 1,) * 2
    assert crush_cuda.choose_tile(mapper_torch_hier.MapTables(under, CPU), rule) == 4


# -- a chain's later step: per-lane roots -------------------------------------------


def _toy_rule(n1, n2, leaf, result_max):
    """The toy rack map, carried, with a chained rule."""
    m = _build_racks()
    ruleno = _chain_rule(m, n1, n2, leaf=leaf)
    return carry(m), ruleno, result_max


def _toy_chain(n1, n2, leaf, result_max):
    """The toy rack map with a chained rule, its step that roots each
    lane at a bucket of the previous step (the width cut to the short
    region when ``result_max`` cuts one), and the rows it may start
    from: the racks (and, for a plain choose of devices, the hosts)."""
    cmap, ruleno, _rm = _toy_rule(n1, n2, leaf, result_max)
    step = mapper_torch_hier.chain_rules(cmap, ruleno, result_max)[1]
    short = result_max % n2
    if short and min(n1, result_max) * n2 > result_max:
        step = step._replace(width=short)
    kinds = (2,) if leaf else (1, 2)
    T = mapper_torch_hier.tables_for(cmap, CPU)
    rows = [T.row_of[b] for b, bk in sorted(cmap.buckets.items()) if bk.type in kinds]
    return cmap, step, rows, cmap.get_weights(out=[1, 4], reweight={2: 0.5})


def _racks_lrc():
    """The 8 x 16 x 12 racks map with the rule ``create_erasure_pool``
    builds for an LRC pool k=8 m=4 l=3 across racks; its second step,
    rooted at the racks."""
    from ceph_tpu_torch.tools.gf_matmul_sweep import SEED, crush_choose_maps, lrc_pool_map

    _name, big, _rule, _numrep, weights = crush_choose_maps(np.random.default_rng(SEED))[3]
    _m, pool, ruleno = lrc_pool_map(big, 8)
    step = mapper_torch_hier.chain_rules(big, ruleno, pool.size)[1]
    T = mapper_torch_hier.tables_for(big, CPU)
    rows = [T.row_of[b] for b, bk in sorted(big.buckets.items()) if bk.type == 2]
    return big, step, rows, weights


# name -> (map, the step, the rows its lanes start from, weights)
ROOT_CASES = {
    "toy chooseleaf hosts below racks": lambda: _toy_chain(2, 2, True, 4),
    "toy choose devices below racks and hosts": lambda: _toy_chain(2, 2, False, 4),
    "toy short region (2 of 3 hosts)": lambda: _toy_chain(2, 3, True, 5),
    "racks LRC k=8 m=4 l=3, 4 hosts a rack": _racks_lrc,
}
N_ROOTS = 48
_ROOTS: dict[str, tuple] = {}


def _roots_case(name):
    """The case's lanes: x = 0..N_ROOTS-1, the roots cycling over its
    rows with every fifth lane -1 (no bucket); and the port's scalar
    ``crush_choose_indep`` run once per lane from its root bucket, as
    ``crush_do_rule`` runs a chain's later step (outpos 0, parent_r 0),
    memoised."""
    if name not in _ROOTS:
        cmap, step, rows, weights = ROOT_CASES[name]()
        roots = [-1 if j % 5 == 4 else rows[(7 * j) % len(rows)] for j in range(N_ROOTS)]
        bids = sorted(cmap.buckets)
        want = []
        for x, root in enumerate(roots):
            if root < 0:
                want.append([NONE] * step.width)
                continue
            out, out2 = [0] * step.width, [0] * step.width
            port_mapper.crush_choose_indep(
                cmap, port_mapper.Workspace(cmap), cmap.buckets[bids[root]], weights, x,
                step.width, step.numrep, step.want_type, out, 0, step.tries,
                step.recurse_tries, bool(step.leaf), out2, 0)
            want.append(out2 if step.leaf else out)
        _ROOTS[name] = (cmap, step, roots, weights, want)
    return _ROOTS[name]


@pytest.mark.parametrize("name,G", [(n, g) for n in ROOT_CASES for g in gf_cuda.CHOOSE_TILES])
def test_tiled_walk_from_roots_equals_scalar_indep_per_bucket(name, G):
    """``crush_choose_roots_kernel``'s walk, every tile, and the kernel's
    plain version with roots give the scalar mapper's rows; a root of -1
    gives NONE and draws nothing; the draws are the same at every G."""
    cmap, step, roots, weights, want = _roots_case(name)
    T = mapper_torch_hier.tables_for(cmap, CPU)
    xs = list(range(N_ROOTS))
    got, draws = _emulate_crush_choose_tiled(T, step, xs, weights, G, roots=roots)
    assert got.tolist() == want
    assert draws == _DRAWS.setdefault(f"roots {name}", draws) > 0
    none, no_draws = _emulate_crush_choose_tiled(T, step, xs[:3], weights, G, roots=[-1] * 3)
    assert no_draws == 0 and none.tolist() == [[NONE] * step.width] * 3
    plain = mapper_torch.crush_choose_plain(
        T, step, torch.tensor(xs, dtype=torch.int32), mapper_torch_hier.reweight_lanes(
            cmap, weights, CPU), torch.tensor(roots, dtype=torch.int32))
    assert plain.tolist() == want


def _lrc_toy_pool():
    """An LRC k=4 m=2 l=3 pool across the toy map's racks, its rule as
    ``create_erasure_pool`` builds it."""
    from ceph_tpu_torch.osd.osdmap import build_simple

    cmap = carry(_build_racks())
    m = build_simple(cmap.max_devices, crush=cmap)
    m.set_erasure_code_profile("lrc", {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
                                       "ruleset-locality": "rack",
                                       "ruleset-failure-domain": "host"})
    pool = m.create_erasure_pool("lrc", "lrc", pg_num=8)
    return cmap, m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size), pool.size


# name -> () -> (map, rule, result_max)
CHAIN_CASES = {
    "toy 2 racks x 2 hosts": lambda: _toy_rule(2, 2, True, 4),
    "toy 2 x 3 cut at 5": lambda: _toy_rule(2, 3, True, 5),
    "toy 3 x 2 devices": lambda: _toy_rule(3, 2, False, 6),
    "toy LRC pool k=4 m=2 l=3": _lrc_toy_pool,
}


@pytest.mark.parametrize("name", CHAIN_CASES)
def test_chain_rules_read_each_step_as_the_interpreter_does(name):
    """``chain_rules`` reads each step as ``crush_do_rule`` runs it: the
    first from the take row with leaf tries 1, each later one from roots
    per lane (take row -1), indep, its own numrep as width and leaf
    tries ``leaf_tries or 1``; the depth is the take bucket's, and a
    later step's widest row and row gcd cover the rows below it."""
    cmap, ruleno, result_max = CHAIN_CASES[name]()
    steps = mapper_torch_hier.chain_rules(cmap, ruleno, result_max)
    take, chooses, tries, leaf_tries, vary_r, stable = mapper_torch_hier._rule_shape(
        cmap, ruleno)
    assert mapper_torch_hier.fused_rule(cmap, ruleno, result_max) is None
    assert len(steps) == len(chooses) >= 2
    T = mapper_torch_hier.MapTables(cmap, CPU)
    below, todo = set(), [T.row_of[take]]
    while todo:
        row = todo.pop()
        for c in T.rows.child_row[row, :T.sizes[row]].tolist():
            if c >= 0 and c not in below:
                below.add(c)
                todo.append(c)
    sizes = [T.sizes[r] for r in below]
    first, *later = steps
    assert first.take_row == T.row_of[take]
    assert (first.firstn, first.leaf, first.numrep, first.width, first.tries,
            first.recurse_tries, first.want_type) == (
        0, 0, chooses[0].arg1, min(chooses[0].arg1, result_max), tries, 1, chooses[0].arg2)
    assert (first.widest, first.row_gcd) == (max(sizes + [T.sizes[first.take_row]]),
                                             np.gcd.reduce(sizes + [T.sizes[first.take_row]]))
    for step, choose in zip(later, chooses[1:]):
        assert (step.take_row, step.firstn, step.leaf, step.numrep, step.width, step.tries,
                step.recurse_tries, step.want_type) == (
            -1, 0, int(choose.op == CRUSH_RULE_CHOOSELEAF_INDEP), choose.arg1, choose.arg1,
            tries, leaf_tries or 1, choose.arg2)
        assert (step.widest, step.row_gcd) == (max(sizes), np.gcd.reduce(sizes))
    assert {s.depth for s in steps} == {T.depth} and {(s.vary_r, s.stable) for s in steps} == {
        (vary_r, stable)}
    if name.startswith("toy LRC"):
        assert leaf_tries == 5 and later[0].recurse_tries == 5


def test_chain_rules_refuse_what_the_kernel_does_not_take():
    """None for a single-step rule, legacy tunables, a step of no slot
    and a step wider than the kernel's 32 slots; such a chain takes the
    step engine and still gives the scalar mapper's rows."""
    ref = _build_racks()
    single = ref.add_simple_rule(ref.root_id(), 1, indep=True)
    chain = _chain_rule(ref, 2, 2)
    wide = _chain_rule(ref, 1, gf_cuda.CHOOSE_MAX_WIDTH + 1)
    racks = carry(ref)
    assert mapper_torch_hier.chain_rules(racks, single, 4) is None
    assert mapper_torch_hier.chain_rules(racks, chain, 0) is None
    assert len(mapper_torch_hier.chain_rules(racks, chain, 4)) == 2
    assert mapper_torch_hier.chain_rules(racks, wide, 40) is None
    legacy = carry(_build_racks(Tunables.legacy()))
    assert mapper_torch_hier.chain_rules(legacy, _chain_rule(legacy, 2, 2), 4) is None
    out = mapper_torch.vec_do_rule(racks, wide, np.arange(6), 40, device="cpu")
    for x in range(6):
        scal = ref_mapper.crush_do_rule(ref, wide, x, 40)
        assert out[x].tolist() == scal + [NONE] * (out.shape[1] - len(scal))
