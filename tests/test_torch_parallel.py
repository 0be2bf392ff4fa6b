"""The port's distributed EC pipeline (``ceph_tpu_torch.parallel``)
against the reference's, twin of tests/test_parallel.py.

The reference runs on jax's 8 virtual CPU devices (tests/conftest.py),
the port on 8 CPU lanes (``device="cpu"``).  The same seeded numpy
stripes go through both packages' ``make_ec_step`` on a 2 x 4 mesh; the
full rows and the rebuilt rows must equal each other and the GF oracle,
and ``_recovery_rows`` must equal the reference's.  Mesh shapes,
default shard axes and the refusal of a shard axis that does not divide
the device count are held against ``make_mesh`` of the reference.
Tolerance: none, the bytes are exact.
"""

import numpy as np
import pytest
import torch

import jax

from ceph_tpu.parallel import ec_shard_axis as ref_ec_shard_axis
from ceph_tpu.parallel import make_ec_step as ref_make_ec_step
from ceph_tpu.parallel import make_mesh as ref_make_mesh
from ceph_tpu.parallel.distributed import _recovery_rows as ref_recovery_rows
from ceph_tpu.parallel.distributed import encode_sharding

from ceph_tpu_torch.ops import matrices as mx
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.parallel import ec_shard_axis, make_ec_step, make_mesh
from ceph_tpu_torch.parallel.distributed import _recovery_rows

RNG = np.random.default_rng(77)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh(8, shard_parallelism=4, device="cpu")


def test_mesh_shape(mesh):
    assert mesh.shape == {"pg": 2, "shard": 4}
    ref = ref_make_mesh(8, shard_parallelism=4)
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert list(mesh.devices.flat) == [torch.device("cpu")] * 8
    # the default shard axis and the EC shard axis, device count by count
    for n in (1, 2, 4, 6, 8):
        assert make_mesh(n, device="cpu").shape == dict(ref_make_mesh(n).shape)
        for k in (2, 3, 4, 6, 7, 8, 10):
            assert ec_shard_axis(k, n) == ref_ec_shard_axis(k, n)


@pytest.mark.parametrize("erased", [(1, 9), (0,), (8, 10)])
def test_distributed_encode_and_reconstruct(mesh, erased):
    k, m, w = 8, 3, 8
    P = mx.rs_vandermonde(k, m, w)
    S, C = 4, 256
    data = RNG.integers(0, 256, size=(S, k, C)).astype(np.uint8)
    full, rebuilt = make_ec_step(mesh, P, w, erased=erased)(data)
    ref_mesh = ref_make_mesh(8, shard_parallelism=4)
    ref_full, ref_rebuilt = ref_make_ec_step(ref_mesh, P, w, erased=erased)(
        jax.device_put(data, encode_sharding(ref_mesh)))
    assert np.array_equal(full, np.asarray(ref_full))
    assert np.array_equal(rebuilt, np.asarray(ref_rebuilt))
    present = [r for r in range(k + m) if r not in erased]
    assert np.array_equal(_recovery_rows(P, k, w, present, list(erased)),
                          ref_recovery_rows(P, k, w, present, list(erased)))
    # oracle
    G = gf(w)
    for s in range(S):
        parity = G.matmul_region(P, data[s])
        want_full = np.concatenate([data[s], parity], axis=0)
        assert np.array_equal(full[s], want_full)
        for j, r in enumerate(erased):
            assert np.array_equal(rebuilt[s, j], want_full[r])
    # a tensor in gives host tensors out, with the same bytes
    tfull, trebuilt = make_ec_step(mesh, P, w, erased=erased)(torch.from_numpy(data))
    assert torch.equal(tfull, torch.from_numpy(full))
    assert torch.equal(trebuilt, torch.from_numpy(rebuilt))


def test_shard_axis_must_divide():
    with pytest.raises(ValueError):
        make_mesh(8, shard_parallelism=3, device="cpu")
    with pytest.raises(ValueError):
        ref_make_mesh(8, shard_parallelism=3)
