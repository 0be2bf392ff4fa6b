"""The port's CRUSH basics held against the reference, on the CPU.

``ceph_tpu_torch.crush`` and ``ops/crush_torch.py`` against
``ceph_tpu.crush``: the rjenkins hashes (scalar, numpy and torch lanes),
the ln tables and ``crush_ln`` over every input, the plain straw2 draw
and ``is_out`` on lanes against the scalar ``bucket_straw2_choose`` and
``is_out``, the scalar ``crush_do_rule`` on maps of every bucket
algorithm carried across by the wire form, and the wire and text forms
themselves.  No tolerance: equality everywhere.  Inputs come from numpy
seeds.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import compiler as ref_compiler
from ceph_tpu.crush import encoding as ref_encoding
from ceph_tpu.crush import hashes as ref_hashes
from ceph_tpu.crush import ln_tables as ref_ln
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu.crush import map as ref_map
from ceph_tpu_torch.crush import compiler, encoding, hashes, ln_tables, mapper
from ceph_tpu_torch.crush.mapper_torch_hier import tables_for
from ceph_tpu_torch.ops import crush_torch

CPU = torch.device("cpu")
HASHES = ("crush_hash32", "crush_hash32_2", "crush_hash32_3", "crush_hash32_4",
          "crush_hash32_5")


def carry(ref_cmap):
    """A reference map as the port's, through the wire form."""
    return encoding.crush_from_dict(ref_encoding.crush_to_dict(ref_cmap))


def _operands(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(5)]


@pytest.mark.parametrize("arity", range(1, 6))
def test_hashes_scalar_numpy_and_lanes(arity):
    name = HASHES[arity - 1]
    ops = _operands(arity, 512)[:arity]
    want = getattr(ref_hashes, name)(*ops)
    port = getattr(hashes, name)
    assert np.array_equal(port(*ops), want)
    for dtype in (np.int64, np.int32):  # lanes as int64 values or int32 bits
        lanes = [torch.from_numpy(o.astype(np.int64).astype(dtype)) for o in ops]
        got = port(*lanes)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    for i in range(0, 512, 37):
        args = [int(o[i]) for o in ops]
        assert port(*args) == getattr(ref_hashes, name)(*args) == int(want[i])


def test_lane_hashes_match_scalar_reference():
    a, b, c = _operands(11, 2048)[:3]
    t = [torch.from_numpy(v.view(np.int32)) for v in (a, b, c)]
    h2 = crush_torch.hash32_2(t[0], t[1]).numpy()
    h3 = crush_torch.hash32_3(t[0], t[1], 7).numpy()
    for i in range(0, 2048, 13):
        assert h2[i] == ref_hashes.crush_hash32_2(int(a[i]), int(b[i]))
        assert h3[i] == ref_hashes.crush_hash32_3(int(a[i]), int(b[i]), 7)


def test_tensor_never_reaches_numpy_hashing(monkeypatch):
    def refuse(*args):
        raise AssertionError("a tensor took the numpy branch")

    monkeypatch.setattr(hashes, "_mix_arr", refuse)
    x = torch.arange(8)
    assert isinstance(hashes.crush_hash32_3(x, 5, x), torch.Tensor)


def test_ln_tables_equal_the_reference():
    assert ln_tables.RH_LH_TBL == ref_ln.RH_LH_TBL
    assert ln_tables.LL_TBL == ref_ln.LL_TBL
    assert crush_torch.ln_table(CPU).tolist() == list(ref_ln.RH_LH_TBL + ref_ln.LL_TBL)


def test_crush_ln_over_every_input():
    want = [ref_mapper.crush_ln(u) for u in range(0x10000)]
    assert [mapper.crush_ln(u) for u in range(0x10000)] == want
    got = crush_torch.crush_ln(torch.arange(0x10000, dtype=torch.int32))
    assert got.dtype == torch.int64 and got.tolist() == want
    # the draw negates ln - 2^48 before dividing: it must not be negative
    assert 0 <= min(want) and max(want) <= 1 << 48


def _straw2_map(seed):
    """Reference straw2 buckets of 1..40 items: zero weights, one item,
    weights from 0x100 to 0x100000, equal weights."""
    rng = np.random.default_rng(seed)
    m = ref_map.CrushMap()
    m.type_names[1] = "host"
    dev = 0
    for n in (1, 2, 5, 17, 40):
        for kind in ("equal", "spread", "zeros"):
            items = list(range(dev, dev + n))
            dev += n
            if kind == "equal":
                ws = [0x10000] * n
            elif kind == "spread":
                ws = [int(w) for w in np.exp2(rng.uniform(8, 20, size=n))]
            else:
                ws = [int(w) * 0x10000 for w in rng.integers(0, 2, size=n)]
            m.make_bucket(ref_map.CRUSH_BUCKET_STRAW2, 1, items, ws)
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_straw2_matches_bucket_straw2_choose(seed):
    ref = _straw2_map(seed)
    T = tables_for(carry(ref), CPU)
    bids = sorted(ref.buckets)
    rng = np.random.default_rng(100 + seed)
    X = 800
    x = rng.integers(0, 1 << 32, size=X, dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, len(bids), size=X).astype(np.int32)
    r = rng.integers(0, 1 << 31, size=X).astype(np.int32)
    r[: X // 2] %= 64  # the replica numbers the mappers use
    item, crow, ctype, empty = crush_torch.straw2_plain(
        T.rows, torch.from_numpy(x.view(np.int32)), torch.from_numpy(rows),
        torch.from_numpy(r))
    for i in range(X):
        b = ref.buckets[bids[rows[i]]]
        assert item[i] == ref_mapper.bucket_straw2_choose(b, int(x[i]), int(r[i])), i
    assert not empty.any() and (crow == -1).all() and (ctype == 0).all()


def test_plain_straw2_rows_children_and_empty_bucket():
    ref = ref_map.CrushMap.hierarchical([[0, 1], [2, 3, 4]])
    ref.make_bucket(ref_map.CRUSH_BUCKET_STRAW2, 1, [], [], name="empty")
    port = carry(ref)
    T = tables_for(port, CPU)
    root = T.row_of[ref.root_id("default")]
    empty_row = T.row_of[min(ref.buckets)]
    x = torch.arange(64, dtype=torch.int32)
    rows = torch.tensor([root, empty_row] * 32, dtype=torch.int32)
    item, crow, ctype, empty = crush_torch.straw2_plain(T.rows, x, rows, torch.zeros_like(x))
    assert empty.tolist() == [False, True] * 32
    for i in range(0, 64, 2):
        want = ref_mapper.bucket_straw2_choose(ref.buckets[ref.root_id("default")], i, 0)
        assert item[i] == want and crow[i] == T.row_of[want] and ctype[i] == 1
    assert (item[1::2] == ref_map.CRUSH_ITEM_NONE).all() and (crow[1::2] == -1).all()


def test_is_out_matches_reference():
    rng = np.random.default_rng(5)
    weight = [0x10000, 0, 0x8000, 0x4000, 0x20000, 0x100, 0xFFFF] * 3
    X = 2000
    x = rng.integers(0, 1 << 32, size=X, dtype=np.uint64).astype(np.uint32)
    item = rng.integers(-2, len(weight) + 3, size=X).astype(np.int32)
    got = crush_torch.is_out(torch.from_numpy(x.view(np.int32)),
                             torch.tensor(weight, dtype=torch.int32), torch.from_numpy(item))
    for i in range(X):
        if item[i] >= 0:  # the scalar oracle reads weight[item] for any item
            assert bool(got[i]) == ref_mapper.is_out(weight, int(item[i]), int(x[i])), i
        else:
            assert got[i]


# -- the scalar mapper on maps carried across by the wire form ---------------


def _every_alg_maps():
    maps = []
    for alg in (ref_map.CRUSH_BUCKET_UNIFORM, ref_map.CRUSH_BUCKET_LIST,
                ref_map.CRUSH_BUCKET_TREE, ref_map.CRUSH_BUCKET_STRAW,
                ref_map.CRUSH_BUCKET_STRAW2):
        for tun in (ref_map.Tunables.legacy(), ref_map.Tunables.jewel()):
            flat = ref_map.CrushMap.flat(9, alg=alg, tunables=tun)
            flat.add_simple_rule(flat.root_id(), 0)
            flat.add_simple_rule(flat.root_id(), 0, indep=True)
            maps.append((f"flat alg={alg}", flat))
            hosts = [[0, 1, 2], [3, 4], [5, 6, 7, 8], [9, 10]]
            if alg == ref_map.CRUSH_BUCKET_UNIFORM:  # equal host weights
                hosts = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
            hier = ref_map.CrushMap.hierarchical(hosts, alg=alg, tunables=tun)
            hier.add_simple_rule(hier.root_id("default"), 1)
            hier.add_simple_rule(hier.root_id("default"), 1, indep=True)
            maps.append((f"hier alg={alg}", hier))
    return maps


@pytest.mark.parametrize("name,ref", _every_alg_maps())
def test_crush_do_rule_matches_reference(name, ref):
    port = carry(ref)
    weight = ref.get_weights(out=[1], reweight={3: 0.5})
    for ruleno in range(len(ref.rules)):
        ref_ws, port_ws = ref_mapper.Workspace(ref), mapper.Workspace(port)
        for x in range(24):
            for result_max in (3, 5):
                want = ref_mapper.crush_do_rule(ref, ruleno, x, result_max, weight, ref_ws)
                got = mapper.crush_do_rule(port, ruleno, x, result_max, weight, port_ws)
                assert got == want, (name, ruleno, x, result_max)


# -- wire and text forms -------------------------------------------------------


def test_encoding_round_trip_equals_reference_dicts():
    for _name, ref in _every_alg_maps()[::3]:
        d = ref_encoding.crush_to_dict(ref)
        port = encoding.crush_from_dict(d)
        assert encoding.crush_to_dict(port) == d
        assert ref_encoding.crush_to_dict(ref_encoding.crush_from_dict(
            encoding.crush_to_dict(port))) == d


def test_compiler_round_trip_equals_reference():
    ref = ref_map.CrushMap.hierarchical([[0, 1], [2, 3], [4, 5, 6]])
    ref.add_simple_rule(ref.root_id("default"), 1)
    ref.add_simple_rule(ref.root_id("default"), 0, indep=True)
    ref.set_device_class(0, "ssd")
    ref.set_device_class(4, "ssd")
    ref.populate_classes()
    text = ref_compiler.decompile_crushmap(ref)
    assert compiler.decompile_crushmap(carry(ref)) == text
    ported = compiler.compile_crushmap(text)
    assert encoding.crush_to_dict(ported) == ref_encoding.crush_to_dict(
        ref_compiler.compile_crushmap(text))
    assert compiler.decompile_crushmap(ported) == text
