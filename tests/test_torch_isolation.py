"""The port stands alone and never falls back.

- Every ``ceph_tpu_torch`` module, and ``chip_smoke.py``, imports with
  ``jax``, ``jaxlib`` and ``ceph_tpu`` blocked.  This runs in a
  subprocess, because this suite's conftest imports jax.
- Without CUDA, the default entry points and any request for ``cuda``
  raise; nothing lands on the CPU unless asked to.
- A CPU tensor takes the plain version and leaves the kernels' launch
  counts unchanged; a kernel wrapper refuses a CPU tensor.
"""

import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ceph_tpu_torch.device import DeviceUnavailableError, resolve
from ceph_tpu_torch.models import registry
from ceph_tpu_torch.ops import gf_cuda, gf_torch, matrices as mx

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "ceph_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import ceph_tpu_torch
    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(ceph_tpu_torch.__path__, "ceph_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not leaked, leaked
    print(" ".join(names))
""")

# every module of the OSD EC engine slice, in its two new subpackages too
_SLICE_MODULES = {
    "ceph_tpu_torch.common.perf_counters", "ceph_tpu_torch.common.tracing",
    "ceph_tpu_torch.utils.arch", "ceph_tpu_torch.utils.native",
    "ceph_tpu_torch.utils.buffers", "ceph_tpu_torch.ops.profiler",
    "ceph_tpu_torch.ops.device_trace", "ceph_tpu_torch.models.matrix_codec",
    "ceph_tpu_torch.osd.ec_perf", "ceph_tpu_torch.osd.ec_util",
    "ceph_tpu_torch.osd.ec_transaction", "ceph_tpu_torch.osd.ec_failover",
    "ceph_tpu_torch.osd.ec_dispatch",
}


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_port_imports_without_jax_or_ceph_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 33  # every module of the package
    assert _SLICE_MODULES <= names, _SLICE_MODULES - names


def test_defaults_raise_without_cuda():
    _needs_no_cuda()
    with pytest.raises(DeviceUnavailableError):
        resolve()
    with pytest.raises(DeviceUnavailableError):
        registry.instance().factory("isa", {"k": "4", "m": "2"})
    with pytest.raises(DeviceUnavailableError):
        gf_torch.GFMatmul(mx.rs_vandermonde(4, 2, 8), 8, device="cuda")
    with pytest.raises(DeviceUnavailableError):
        gf_torch.BitmatrixXor(np.eye(8, dtype=np.uint8), device="cuda")
    with pytest.raises(ValueError):
        resolve("meta")


def test_cpu_tensor_takes_plain_version_and_kernel_refuses_it():
    matrix = mx.rs_vandermonde(4, 2, 8)
    d32 = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(4, 256), dtype=np.uint8)
    ).view(torch.int32)
    before = dict(gf_cuda.launches)
    out = gf_torch.GFMatmul(matrix, 8, device="cpu")(d32)
    assert torch.equal(out, gf_torch.gf_matmul_u32(matrix, d32, 8))
    bm = np.eye(4, dtype=np.uint8)
    assert torch.equal(gf_torch.BitmatrixXor(bm, device="cpu")(d32), d32)
    assert gf_cuda.launches == before
    table = gf_cuda.gf_table(matrix, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gf_cuda.gf_matmul(table, d32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gf_cuda.bitmatrix_xor(gf_cuda.bitmatrix_table(bm, torch.device("cpu")), d32)
    assert gf_cuda.launches == before


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    _needs_no_cuda()
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
