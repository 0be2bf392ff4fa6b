"""ctypes loader for the native C straw2 mapper
(``csrc/host/crush_cpu.cc``).

The compiled-C single-thread placement cost is the honest baseline for
a bulk placement benchmark on the card: comparing the device path only
to the *Python* scalar mapper would flatter it by ~300x.  The
fixed-point ln tables are generated into the build dir from
``ceph_tpu_torch/crush/ln_tables.py`` so the C engine and every other
backend share one source of truth.

Counterpart of ``ceph_tpu/utils/native_crush.py``, with its own copy of
the source and its own build directory (``ceph_tpu_torch/build/``); the
flat-shape test is the torch mapper's.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading
import time

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "host" / "crush_cpu.cc"
_BUILD = _PKG / "build"
_SO = _BUILD / "libcrush_cpu.so"
_INC = _BUILD / "crush_ln_tables.inc"

_lock = threading.Lock()
_lib = None


def _write_tables() -> None:
    from ..crush.ln_tables import LL_TBL, RH_LH_TBL

    def fmt(name: str, vals) -> str:
        body = ",\n  ".join(
            ", ".join(f"0x{v:013x}ULL" for v in vals[i : i + 4])
            for i in range(0, len(vals), 4)
        )
        return (
            f"static const uint64_t {name}[{len(vals)}] = {{\n  {body}\n}};\n"
        )

    _INC.write_text(
        "// GENERATED from ceph_tpu_torch/crush/ln_tables.py — do not edit\n"
        + fmt("RH_LH_TBL", RH_LH_TBL)
        + fmt("LL_TBL", LL_TBL)
    )


def build(force: bool = False) -> pathlib.Path:
    if _SO.exists() and not force and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    _BUILD.mkdir(parents=True, exist_ok=True)
    _write_tables()
    from .arch import host_march_flags

    cmd = [
        "g++", "-O3", *host_march_flags(), "-funroll-loops", "-shared",
        "-fPIC", "-std=c++17", f"-I{_BUILD}", str(_SRC), "-o", str(_SO),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            _lib = ctypes.CDLL(str(so))
            _lib.crush_flat_firstn.argtypes = [
                ctypes.POINTER(ctypes.c_int32),   # items
                ctypes.POINTER(ctypes.c_uint32),  # item_weights
                ctypes.c_int,                     # n_items
                ctypes.c_int32,                   # bucket_id
                ctypes.POINTER(ctypes.c_uint32),  # weight
                ctypes.c_int,                     # n_weight
                ctypes.c_int,                     # max_devices
                ctypes.c_int,                     # numrep
                ctypes.c_int,                     # tries
                ctypes.POINTER(ctypes.c_uint32),  # xs
                ctypes.c_int64,                   # n_x
                ctypes.POINTER(ctypes.c_int32),   # out
            ]
            _lib.crush_flat_firstn.restype = None
        return _lib


def map_flat(cmap, ruleno: int, xs: np.ndarray, numrep: int,
             weight=None) -> np.ndarray:
    """Run the C mapper over ``xs``; returns [n_x, numrep] int32."""
    from ..crush.map import CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_TAKE
    from ..crush.mapper_torch import _supports_flat

    if not _supports_flat(cmap, ruleno):
        raise ValueError("native C mapper covers the flat straw2 shape only")
    rule = cmap.rules[ruleno]
    take = next(s.arg1 for s in rule.steps if s.op == CRUSH_RULE_TAKE)
    firstn = any(s.op == CRUSH_RULE_CHOOSE_FIRSTN for s in rule.steps)
    if not firstn:
        raise ValueError("native C mapper implements firstn only")
    bucket = cmap.buckets[take]
    if weight is None:
        weight = cmap.get_weights()
    items = np.asarray(bucket.items, dtype=np.int32)
    iw = np.asarray(bucket.item_weights, dtype=np.uint32)
    wv = np.asarray(weight, dtype=np.uint32)
    xs = np.ascontiguousarray(xs, dtype=np.uint32)
    out = np.empty((len(xs), numrep), dtype=np.int32)
    tries = cmap.tunables.choose_total_tries + 1
    lib().crush_flat_firstn(
        items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        iw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(items), np.int32(bucket.id),
        wv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(wv), cmap.max_devices, numrep, tries,
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(xs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def bench_flat(cmap, ruleno: int, numrep: int, n_x: int) -> float:
    """Seconds per mapping of the C engine; verifies a sample against
    the Python scalar oracle first (bit-exactness gate)."""
    from ..crush import mapper

    xs = np.arange(n_x, dtype=np.uint32)
    sample = np.linspace(0, n_x - 1, 64, dtype=np.uint32)
    rows = map_flat(cmap, ruleno, sample, numrep)
    for i, x in enumerate(sample):
        ref = mapper.crush_do_rule(cmap, ruleno, int(x), numrep)
        got = [v for v in rows[i] if v != -1]
        assert got == ref, (int(x), got, ref)
    t0 = time.perf_counter()
    map_flat(cmap, ruleno, xs, numrep)
    return (time.perf_counter() - t0) / n_x
