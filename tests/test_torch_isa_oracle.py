"""The port's ISA plugin family pinned to the vendored ISA-L reference's
parity bytes, on the CPU: the golden tier of ``tests/test_isa_oracle.py``
against the port's engines, and its live tier against the port's oracle
(``ceph_tpu_torch.utils.isa_oracle``).

The bytes in ``tests/golden/isa_reference/manifest.json`` were produced by
ISA-L's plain-C ``ec_base.c`` compiled unmodified by the oracle.  Every
engine of the port must reproduce them exactly:

* the port's matrix construction (``ops.matrices``), its numpy GF
  (``ops.gf``), its native C++ host engine (``utils.native``), the plain
  torch kernel (``ops.gf_torch.gf_matmul_u32``, which the CUDA kernel is
  held bit-exact against on the card), and the ``isa`` codec on both of
  its CPU lanes: the native lane and the batching lane (the card's lane,
  with ``native.host_engine_active`` patched to False);
* the live tier compiles the reference tree's ``ec_base.c`` with the
  port's own copy of the shim (``csrc/host/isa_oracle_shim.c``) and runs
  when that tree is present, as the reference's live tier does.
"""

from __future__ import annotations

import base64
import json
import pathlib

import numpy as np
import pytest
import torch

import ceph_tpu_torch.utils.native as port_native
from ceph_tpu_torch.models.registry import instance as registry_instance
from ceph_tpu_torch.ops import gf_torch
from ceph_tpu_torch.ops import matrices as mx
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.utils import isa_oracle as O

MANIFEST = pathlib.Path(__file__).parent / "golden" / "isa_reference" / "manifest.json"

_m = json.loads(MANIFEST.read_text())
CASES = _m["cases"]
CASE_IDS = [f"{c['technique']}-k{c['k']}-m{c['m']}-len{c['chunk_len']}" for c in CASES]

_MATRIX_FN = {"reed_sol_van": mx.isa_rs_vandermonde, "cauchy": mx.isa_cauchy}


def _case_data(case) -> np.ndarray:
    rng = np.random.default_rng(case["data_seed"])
    return rng.integers(0, 256, size=(case["k"], case["chunk_len"]), dtype=np.uint8)


def _case_parity(case) -> np.ndarray:
    return np.stack([np.frombuffer(base64.b64decode(p), dtype=np.uint8)
                     for p in case["parity"]])


def test_manifest_generator_is_the_reference():
    gen = _m["generator"]
    assert "ec_base.c" in gen["source"]
    assert len(gen["source_sha256"]) == 64
    assert "NOT by any code in this repo" in gen["note"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_matrix_construction_matches_reference(case):
    ours = _MATRIX_FN[case["technique"]](case["k"], case["m"])
    assert np.array_equal(ours, np.asarray(case["matrix_parity_rows"], dtype=np.int64))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_numpy_engine_matches_reference_bytes(case):
    matrix = _MATRIX_FN[case["technique"]](case["k"], case["m"])
    parity = gf(8).matmul_region(matrix, _case_data(case))
    assert np.array_equal(parity, _case_parity(case))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_native_engine_matches_reference_bytes(case):
    data = _case_data(case)
    if data.shape[1] % 8:  # the host engine takes 8-byte multiples
        pytest.skip("native engine needs len % 8 == 0")
    matrix = _MATRIX_FN[case["technique"]](case["k"], case["m"])
    assert np.array_equal(port_native.encode(matrix, data), _case_parity(case))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_torch_engine_matches_reference_bytes(case):
    data = _case_data(case)
    if data.shape[1] % 4:
        pytest.skip("packed-u32 kernel needs len % 4 == 0")
    matrix = _MATRIX_FN[case["technique"]](case["k"], case["m"])
    parity = gf_torch.gf_matmul_u32(matrix, gf_torch.bytes_to_u32(torch.from_numpy(data)))
    assert np.array_equal(gf_torch.u32_to_bytes(parity).numpy(), _case_parity(case))


@pytest.mark.parametrize("lane", ["native", "batching"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_isa_codec_matches_reference_bytes(case, lane, monkeypatch):
    if lane == "batching":
        monkeypatch.setattr(port_native, "host_engine_active", lambda device=None: False)
    k, m = case["k"], case["m"]
    codec = registry_instance().factory(
        "isa", {"technique": case["technique"], "k": str(k), "m": str(m)}, device="cpu")
    data = _case_data(case)
    chunks = codec.encode(set(range(k + m)), data.tobytes())
    # encode() splits the object into k sequential chunks (padded); the
    # oracle's matrix over the same layout gives the comparable parity
    layout = np.stack([np.frombuffer(bytes(chunks[i]), dtype=np.uint8) for i in range(k)])
    want = gf(8).matmul_region(np.asarray(case["matrix_parity_rows"], dtype=np.int64), layout)
    for i in range(m):
        got = np.frombuffer(bytes(chunks[k + i]), dtype=np.uint8)
        assert np.array_equal(got, want[i]), f"parity chunk {i} diverges"
    if layout.shape[1] == case["chunk_len"]:
        assert np.array_equal(want, _case_parity(case))


def test_oracle_builds_from_the_ports_own_shim():
    assert O._SHIM.is_file() and O._SHIM.parent.name == "host"
    assert O._SHIM.read_text() == (pathlib.Path(__file__).resolve().parent.parent
                                   / "native" / "isa_oracle_shim.c").read_text().replace(
        "The build\n * driver (ceph_tpu/utils/isa_oracle.py)",
        "The loader\n * (ceph_tpu_torch/utils/isa_oracle.py)")
    assert O._BUILD.parent.name == "ceph_tpu_torch"
    if not O.ec_base_path().exists():
        assert O.available() == O._SO.exists()
        with pytest.raises(FileNotFoundError, match="CEPH_TPU_ISA_REFERENCE"):
            O.build(force=True)


# -- the live tier: the reference's ec_base.c through the port's oracle ----------

needs_reference = pytest.mark.skipif(
    not O.ec_base_path().exists(), reason="reference tree not available")


@needs_reference
def test_live_fuzz_encode_against_reference_oracle():
    rng = np.random.default_rng(7)
    G = gf(8)
    for _ in range(20):
        technique = ("reed_sol_van", "cauchy")[int(rng.integers(2))]
        if technique == "reed_sol_van":
            m, k = int(rng.integers(1, 4)), int(rng.integers(2, 12))
        else:
            m, k = int(rng.integers(1, 6)), int(rng.integers(2, 16))
        length = int(rng.integers(1, 300))
        data = rng.integers(0, 256, size=(k, length), dtype=np.uint8)
        ref = O.encode_km(technique, k, m, data)
        assert np.array_equal(ref, G.matmul_region(_MATRIX_FN[technique](k, m), data))


@needs_reference
def test_live_gf_mul_table_identical():
    G = gf(8)
    for b in (1, 2, 3, 0x1D, 0x8E, 255):
        assert [G.mul(x, b) for x in range(256)] == [O.gf_mul(x, b) for x in range(256)]


@needs_reference
def test_live_decode_matrix_inversion_matches_reference():
    rng = np.random.default_rng(11)
    G = gf(8)
    for technique, k, m in [("cauchy", 8, 3), ("cauchy", 10, 4), ("reed_sol_van", 8, 3)]:
        full = O.gen_matrix(technique, k, m)
        for _ in range(5):
            rows = sorted(rng.choice(k + m, size=k, replace=False).tolist())
            sub = np.stack([full[r, :] for r in rows])
            assert np.array_equal(O.invert(sub).astype(np.int64),
                                  G.invert_matrix(sub.astype(np.int64)))


@needs_reference
def test_live_committed_manifest_reproduces():
    for case in CASES:
        parity = O.encode_km(case["technique"], case["k"], case["m"], _case_data(case))
        assert np.array_equal(parity, _case_parity(case))
