"""Builder + ctypes wrapper for the vendored ISA-L C reference oracle.

The reference tree vendors ISA-L's portable C implementation
(reference:src/erasure-code/isa/isa-l/erasure_code/ec_base.c).  This module
compiles that file — read directly from the read-only reference checkout,
never copied — together with ``csrc/host/isa_oracle_shim.c`` into
``ceph_tpu_torch/build/libisa_oracle.so``, and exposes matrix generation,
encode, and matrix inversion from it.

This breaks the self-generated-corpus circularity: parity bytes produced
here come from Intel's code as shipped in the reference, so a golden file
generated by this oracle pins the port's ISA plugin family (numpy, the
native C++ host engine, the plain torch kernels, the CUDA kernel on the
card) to genuine reference output — the
``ceph_erasure_code_non_regression`` contract
(reference:src/test/erasure-code/ceph_erasure_code_non_regression.cc:154,226).

When the reference tree is absent (e.g. the repo checked out standalone),
``available()`` is False and tests fall back to the committed golden bytes
in ``tests/golden/isa_reference/`` (generated by this oracle; the manifest
records the generator).

Counterpart of ``ceph_tpu/utils/isa_oracle.py``, with its own copy of the
shim (``ceph_tpu_torch/csrc/host/isa_oracle_shim.c``) and its own build
directory.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SHIM = _PKG / "csrc" / "host" / "isa_oracle_shim.c"
_BUILD = _PKG / "build"
_SO = _BUILD / "libisa_oracle.so"

# Location of the vendored ISA-L C sources inside the reference checkout
# (by default a ``reference`` checkout, or a link to one, at the root of
# this repository)
REFERENCE_ISA_DIR = pathlib.Path(
    os.environ.get(
        "CEPH_TPU_ISA_REFERENCE",
        _PKG.parent / "reference" / "src" / "erasure-code" / "isa" / "isa-l",
    )
)

TECHNIQUE_IDS = {"reed_sol_van": 0, "cauchy": 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def ec_base_path() -> pathlib.Path:
    return REFERENCE_ISA_DIR / "erasure_code" / "ec_base.c"


def available() -> bool:
    """True if the oracle is usable: already built, or buildable from the
    reference tree."""
    return _SO.exists() or ec_base_path().exists()


def build(force: bool = False) -> pathlib.Path:
    """Compile the oracle .so (reference ec_base.c + shim) if needed."""
    src = ec_base_path()
    if _SO.exists() and not force:
        if not src.exists() or _SO.stat().st_mtime >= max(
            src.stat().st_mtime, _SHIM.stat().st_mtime
        ):
            return _SO
    if not src.exists():
        raise FileNotFoundError(
            f"reference ISA-L source not found at {src}; set "
            "CEPH_TPU_ISA_REFERENCE or rely on the committed golden corpus"
        )
    _BUILD.mkdir(parents=True, exist_ok=True)
    inc_ec = REFERENCE_ISA_DIR / "erasure_code"
    inc_top = REFERENCE_ISA_DIR / "include"
    cmd = [
        "gcc", "-O2", "-shared", "-fPIC",
        f"-I{inc_ec}", f"-I{inc_top}",
        str(_SHIM), str(src),
        "-o", str(_SO),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            L = ctypes.CDLL(str(so))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            L.oracle_gen_matrix.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ]
            L.oracle_gen_matrix.restype = ctypes.c_int
            L.oracle_encode.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                u8p, u8p,
            ]
            L.oracle_encode.restype = ctypes.c_int
            L.oracle_invert.argtypes = [u8p, u8p, ctypes.c_int]
            L.oracle_invert.restype = ctypes.c_int
            L.oracle_gf_mul.argtypes = [ctypes.c_uint8, ctypes.c_uint8]
            L.oracle_gf_mul.restype = ctypes.c_uint8
            L.oracle_gf_inv.argtypes = [ctypes.c_uint8]
            L.oracle_gf_inv.restype = ctypes.c_uint8
            _lib = L
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gen_matrix(technique: str, k: int, m: int) -> np.ndarray:
    """Full (k+m) x k distribution matrix from the reference generator
    (identity on top, parity block below)."""
    out = np.zeros((k + m, k), dtype=np.uint8)
    rc = lib().oracle_gen_matrix(TECHNIQUE_IDS[technique], k, m, _u8ptr(out))
    if rc != 0:
        raise ValueError(f"oracle_gen_matrix({technique},{k},{m}) rc={rc}")
    return out


def parity_matrix(technique: str, k: int, m: int) -> np.ndarray:
    """Just the m x k parity block — comparable to
    ops.matrices.isa_rs_vandermonde / isa_cauchy."""
    return gen_matrix(technique, k, m)[k:, :]


def encode_km(technique: str, k: int, m: int, data: np.ndarray) -> np.ndarray:
    """Reference encode: data [k, len] uint8 -> parity [m, len]."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.shape[0] != k:
        raise ValueError(f"data has {data.shape[0]} rows, expected k={k}")
    length = data.shape[1]
    parity = np.empty((m, length), dtype=np.uint8)
    rc = lib().oracle_encode(
        TECHNIQUE_IDS[technique], k, m, length, _u8ptr(data), _u8ptr(parity)
    )
    if rc != 0:
        raise ValueError(f"oracle_encode({technique},{k},{m}) rc={rc}")
    return parity


def invert(matrix: np.ndarray) -> np.ndarray:
    """Reference GF(2^8) matrix inverse (gf_invert_matrix)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    n = matrix.shape[0]
    if matrix.shape != (n, n):
        raise ValueError("invert needs a square matrix")
    out = np.empty((n, n), dtype=np.uint8)
    rc = lib().oracle_invert(_u8ptr(matrix), _u8ptr(out), n)
    if rc != 0:
        raise ValueError(f"oracle_invert: singular (rc={rc})")
    return out


def gf_mul(a: int, b: int) -> int:
    return int(lib().oracle_gf_mul(a, b))


def gf_inv(a: int) -> int:
    return int(lib().oracle_gf_inv(a))
