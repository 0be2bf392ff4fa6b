"""The port's native C straw2 mapper (``ceph_tpu_torch.utils.native_crush``,
built from ``ceph_tpu_torch/csrc/host/crush_cpu.cc``) held against the
reference's and against the port's torch mapper, on the CPU.

On flat straw2 maps (one root of 1..40 devices with seeded weights, some
devices reweighted down or out, bobtail and jewel tunables), the port's
``map_flat`` must place every input exactly as the reference's
``native_crush.map_flat`` does, as the port's batched torch mapper
(``mapper_torch.vec_do_rule`` on the CPU) does, and, on a sample, as the
scalar ``crush_do_rule`` does.  Its tables are generated from the port's
``crush/ln_tables.py``, which equals the reference's.  The shapes it does
not cover (indep rules, hierarchies) raise ``ValueError`` in both.
"""

import numpy as np
import pytest

from ceph_tpu.crush import map as ref_map
from ceph_tpu.utils import native_crush as ref_native_crush
from ceph_tpu_torch.crush import map as port_map
from ceph_tpu_torch.crush import mapper, mapper_torch
from ceph_tpu_torch.utils import native_crush

N_X = 4096


def _flat_maps(seed):
    """The same flat straw2 map built in each package, its firstn rule and
    a reweight vector."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 41))
    weights = [int(w) for w in rng.integers(0x4000, 0x40000, n)]
    tunables = "bobtail" if seed % 2 else "jewel"
    maps = []
    for M in (ref_map, port_map):
        m = M.CrushMap(getattr(M.Tunables, tunables)())
        m.type_names[1] = "root"
        root = m.make_bucket(M.CRUSH_BUCKET_STRAW2, 1, range(n), weights, name="default")
        m.add_simple_rule(root, 0)
        m.add_simple_rule(root, 0, indep=True)
        maps.append(m)
    reweight = np.full(n, 0x10000, dtype=np.uint32)
    reweight[rng.random(n) < 0.2] = 0
    partial = rng.random(n) < 0.2
    reweight[partial] = rng.integers(1, 0x10000, int(partial.sum()))
    numrep = int(rng.integers(1, min(n, 6) + 1))
    return maps, reweight, numrep


@pytest.mark.parametrize("seed", range(6))
def test_map_flat_equals_the_references_and_the_torch_mapper(seed):
    (ref, port), reweight, numrep = _flat_maps(seed)
    xs = np.random.default_rng(100 + seed).integers(0, 1 << 32, N_X, dtype=np.uint32)
    got = native_crush.map_flat(port, 0, xs, numrep, weight=reweight)
    assert got.shape == (N_X, numrep) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_native_crush.map_flat(ref, 0, xs, numrep,
                                                                 weight=reweight))
    vec = mapper_torch.vec_do_rule(port, 0, xs, numrep, weight=reweight, device="cpu")
    for i in range(N_X):
        want = [int(v) for v in vec[i] if v != mapper.CRUSH_ITEM_NONE]
        assert [int(v) for v in got[i] if v != -1] == want, i
    for i in range(0, N_X, 97):
        want = mapper.crush_do_rule(port, 0, int(xs[i]), numrep, weight=list(reweight))
        assert [int(v) for v in got[i] if v != -1] == want, i


def test_unsupported_shapes_raise():
    (ref, port), _reweight, _numrep = _flat_maps(0)
    xs = np.arange(8, dtype=np.uint32)
    for native, m in ((native_crush, port), (ref_native_crush, ref)):
        with pytest.raises(ValueError, match="firstn"):
            native.map_flat(m, 1, xs, 2)
    hier = port_map.CrushMap.hierarchical([[0, 1], [2, 3]])
    hier.add_simple_rule(hier.root_id("default"), 1)
    with pytest.raises(ValueError, match="flat straw2"):
        native_crush.map_flat(hier, 0, xs, 2)


def test_bench_flat_checks_and_times():
    (_ref, port), _reweight, numrep = _flat_maps(2)
    assert native_crush.bench_flat(port, 0, numrep, 2048) > 0
    assert native_crush.build().parent.name == "build"
    assert native_crush.build().parent.parent.name == "ceph_tpu_torch"
