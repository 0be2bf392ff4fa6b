"""The port's Hopper kernels: build, binding, launches; and the GF region
kernels' wrappers.

Counterpart of ``ceph_tpu/ops/gf_pallas.py``.  Four kernels, written in
CUDA C++ under ``ceph_tpu_torch/csrc/``:

- ``gf_matmul`` (``csrc/gf_matmul.cu``) replaces
  ``make_gf_matmul_pallas``: GF(2^w) region product by the doubling
  method, w = 8 or 16;
- ``bitmatrix_xor`` (``csrc/bitmatrix_xor.cu``) replaces
  ``make_bitmatrix_matmul_pallas``: packet XOR over a GF(2) bit-matrix;
- ``crush_straw2`` (``csrc/crush_straw2.cu``) replaces the straw2 draw
  of the reference's CRUSH XLA programs, and ``crush_choose``
  (``csrc/crush_choose.cu``) their whole choose step of a single-step
  rule or of one step of a chained rule, a tile of threads a lane; both
  draw through
  ``csrc/crush_draw.cuh``.
  Their wrappers are in ``crush_cuda``, their builds, libraries and
  launch counts here.

Unlike the Pallas kernels, which unroll the matrix at trace time, the
matrix is a runtime argument: each library is built once, and a matrix
is packed once (:func:`gf_table`, :func:`bitmatrix_table`: a plan for
each launch, passed by value) and kept by the caller per matrix.

Each source is compiled by ``nvcc`` into a plain-C shared library under
``ceph_tpu_torch/build/``, at first use, named by a hash of the sources
and flags, so a second process in the same tree loads it without a
rebuild.  The libraries are bound with ``ctypes``.  Nothing here runs at
import: this module imports on hosts without CUDA.

Each wrapper takes CUDA tensors only, launches on the current stream
with the tensor's device current, raises :class:`KernelLaunchError`
when the launch is refused, and adds one to its entry in
:data:`launches` for every launch.  The wrappers are safe to call from
several threads at once (the OSD dispatcher launches from its worker
pool): the counts are updated under a lock, and the device is made
current in the calling thread, because each library caches its grid per
``cudaGetDevice()`` and a fresh thread's current device is device 0.  The routing
(CPU tensor -> plain torch version) lives in ``gf_torch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

SOURCES = {"gf_matmul": "gf_matmul.cu", "bitmatrix_xor": "bitmatrix_xor.cu",
           "crush_straw2": "crush_straw2.cu", "crush_choose": "crush_choose.cu"}
# the kernels of the erasure-code path (the codecs and the OSD engine)
EC_KERNELS = ("gf_matmul", "bitmatrix_xor")
HEADERS = ("async_copy.cuh", "crush_draw.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# gf_matmul's output tiles (csrc/gf_matmul.cu instantiates these): a
# matrix's outputs split into tiles of 16 and one tile of the rest,
# rounded up to the next of these
GF_TILES = (1, 2, 3, 4, 6, 8, 16)
# the plan of one launch, in step with PLAN_ROWS and PLAN_MASKS of
# csrc/gf_matmul.cu: k chain lengths (uint8), then k*w output masks
# (uint16); longer matrices split into chunks of input rows
PLAN_ROWS = 256
PLAN_MASKS = 8 * PLAN_ROWS
PLAN_BYTES = PLAN_ROWS + 2 * PLAN_MASKS
# bitmatrix_xor's output tiles (csrc/bitmatrix_xor.cu instantiates these),
# split as gf_matmul's are
BITMATRIX_TILES = (8, 16, 32)
# its plan, in step with PLAN_ROWS of csrc/bitmatrix_xor.cu: the indices
# of the input rows the tile uses (uint32), then for each block of 32 of
# them and each output a word of the rows it takes; more used rows split
# into chunks
BM_PLAN_ROWS = 512
BM_PLAN_WORDS = 2 * BM_PLAN_ROWS
# the CRUSH kernels' ln tables, in step with kLnEntries of
# csrc/crush_draw.cuh: RH_LH_TBL (258 int64) then LL_TBL (256)
LN_ENTRIES = 514
# crush_choose's slots a lane (kMaxWidth of csrc/crush_choose.cu), its
# rule's ints (kRuleInts), the items a row may hold (kMaxSlots: the
# tile's key keeps a slot in 15 bits) and its tiles (threads a lane)
CHOOSE_MAX_WIDTH = 32
CHOOSE_RULE_INTS = 11
CHOOSE_MAX_SLOTS = 1 << 15
CHOOSE_TILES = (4, 8, 16, 32)

# launches per kernel since the last reset_launches()
launches = {name: 0 for name in SOURCES}
_LAUNCHES_LOCK = threading.Lock()

_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # in (the chunk's first row), out (the tile's first row), plan (host
    # bytes), w, k, rows, mt, n4, accumulate, stream
    "gf_matmul": [_P, _P, _P, _I, _I, _I, _I, _N, _I, _P],
    # in (row 0), out (the tile's first row), plan (host bytes), used
    # input rows, output rows, mt, n4, accumulate, stream
    "bitmatrix_xor": [_P, _P, _P, _I, _I, _I, _N, _I, _P],
    # x, rows, r (int32 lanes), items, weights ([B, I] int32), recip
    # ([B, I] uint64), child_row, child_type ([B, I] int32), size ([B]
    # int32), ln tables (int64), B, I, lanes, out (int32 [3, lanes]),
    # empty (bool [lanes]), stream
    "crush_straw2": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _N, _P, _P, _P],
    # x (int32 lanes), roots (int32 lanes or null), items, weights, recip,
    # child_row, child_type, size, the take row's size (with roots, the
    # widest row below them), ln tables, reweight (int32), its length, I,
    # lanes, rule (host ints), out (int32 [lanes, width]), draws (int64
    # [1]), tile (threads a lane), stream
    "crush_choose": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _N, _P, _P, _P, _I,
                     _P],
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in launches:
            launches[name] = 0


def launch_counts() -> dict[str, int]:
    """A consistent copy of :data:`launches`."""
    with _LAUNCHES_LOCK:
        return dict(launches)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """Build output for kernel ``name``, keyed on its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict[str, float]:
    """Compile each kernel library not built yet, one ``nvcc`` process
    per source, all started together.  Returns the wall seconds per
    library compiled by this call (libraries found built are absent).
    The compiler's output, ``-Xptxas -v`` register counts included, is
    kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    started = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, path, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, path, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]}:\n{out}")
            continue
        path.with_name(path.name + ".log").write_text(out)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise KernelBuildError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler output kept by :func:`build` ('' if none)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIBS_LOCK:
        if name not in _LIBS:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[name]
            if name == "gf_matmul" and lib.gf_matmul_plan_bytes() != PLAN_BYTES:
                raise KernelBuildError("gf_matmul.cu's Plan differs from PLAN_BYTES")
            if (name == "bitmatrix_xor"
                    and lib.bitmatrix_xor_plan_bytes() != 4 * BM_PLAN_WORDS):
                raise KernelBuildError("bitmatrix_xor.cu's Plan differs from BM_PLAN_ROWS")
            if name == "crush_straw2" and lib.crush_straw2_ln_entries() != LN_ENTRIES:
                raise KernelBuildError("crush_straw2.cu's ln tables differ from LN_ENTRIES")
            if name == "crush_choose" and (
                    lib.crush_choose_max_width() != CHOOSE_MAX_WIDTH
                    or lib.crush_choose_rule_ints() != CHOOSE_RULE_INTS
                    or lib.crush_choose_max_slots() != CHOOSE_MAX_SLOTS):
                raise KernelBuildError("crush_choose.cu's slots, rule or row differ from "
                                       "CHOOSE_MAX_WIDTH / CHOOSE_RULE_INTS / "
                                       "CHOOSE_MAX_SLOTS")
            _LIBS[name] = lib
    return _LIBS[name]


def _smallest_tile(rows: int, tiles: tuple[int, ...]) -> int:
    return next((t for t in tiles if t >= rows), tiles[-1])


class GFLaunch(NamedTuple):
    """One ``gf_matmul`` launch: outputs [out_row, out_row + m) as a tile
    of mt, from inputs [in_row, in_row + k).  ``plan`` is its Plan,
    PLAN_BYTES host bytes copied into the launch's parameters: ``nb[j]``
    is the length of input row j's doubling chain that the tile needs (0:
    the tile does not use row j), and bit i of ``masks[j*w + b]`` is bit b
    of coefficient M[out_row + i, in_row + j].  With ``accumulate`` the
    launch XORs its sums into the outputs, else stores them."""

    plan: np.ndarray
    plan_ptr: int
    nb: np.ndarray
    masks: np.ndarray
    in_row: int
    out_row: int
    k: int
    m: int
    mt: int
    accumulate: bool


@dataclass(frozen=True)
class GFTable:
    """An [m, k] GF(2^w) matrix compiled for ``gf_matmul``: the launches
    that compute it, one per output tile and chunk of input rows."""

    launches: tuple[GFLaunch, ...]
    device: torch.device
    w: int
    k: int
    m: int

    @property
    def tiles(self) -> tuple[int, ...]:
        """Each output tile's width, in order."""
        return tuple(g.mt for g in self.launches if not g.accumulate)


class BMLaunch(NamedTuple):
    """One ``bitmatrix_xor`` launch: outputs [out_row, out_row + m) as a
    tile of mt, from the n input rows ``rows`` (indices into all K, in
    order).  ``plan`` is its Plan, BM_PLAN_WORDS uint32 host words copied
    into the launch's parameters: ``rows``, then ``bits`` [n/32 rounded
    up, 32], bit r of bits[b, i] set when output out_row + i takes input
    row rows[32b + r].  With ``accumulate`` the launch XORs its sums into
    the outputs, else stores them."""

    plan: np.ndarray
    plan_ptr: int
    rows: np.ndarray
    bits: np.ndarray
    out_row: int
    m: int
    mt: int
    accumulate: bool


@dataclass(frozen=True)
class BitmatrixTable:
    """An [M, K] GF(2) matrix compiled for ``bitmatrix_xor``: the
    launches that compute it, one per output tile and chunk of the input
    rows that tile uses."""

    launches: tuple[BMLaunch, ...]
    device: torch.device
    K: int
    M: int

    @property
    def tiles(self) -> tuple[int, ...]:
        """Each output tile's width, in order."""
        return tuple(g.mt for g in self.launches if not g.accumulate)


def _table_device(device) -> torch.device:
    """The device a table's launches run on, with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def gf_table(matrix: np.ndarray, w: int, device: torch.device) -> GFTable:
    matrix = np.asarray(matrix, dtype=np.int64)
    m, k = matrix.shape
    if w not in (8, 16):
        raise ValueError(f"gf_matmul is built for w=8 and w=16, got {w}")
    if matrix.size and (matrix.min() < 0 or matrix.max() >= 1 << w):
        raise ValueError(f"matrix entries must lie in GF(2^{w})")
    top, kc = GF_TILES[-1], min(PLAN_ROWS, PLAN_MASKS // w)
    launches = []
    for r0 in range(0, m, top):
        rows = min(top, m - r0)
        mt = _smallest_tile(rows, GF_TILES)
        for j0 in range(0, max(k, 1), kc):
            coef = matrix[r0:r0 + rows, j0:j0 + kc]                          # [i, j]
            bits = (coef[..., None] >> np.arange(w)) & 1                    # [i, j, b]
            masks = (bits << np.arange(rows)[:, None, None]).sum(axis=0)    # [j, b]
            used = masks != 0
            nb = np.where(used.any(axis=1), w - np.argmax(used[:, ::-1], axis=1), 0)
            kr = coef.shape[1]
            plan = np.zeros(PLAN_BYTES, dtype=np.uint8)
            plan[:kr] = nb
            plan[PLAN_ROWS:PLAN_ROWS + 2 * kr * w].view(np.uint16)[:] = masks.reshape(-1)
            launches.append(GFLaunch(
                plan, plan.ctypes.data, plan[:kr],
                plan[PLAN_ROWS:PLAN_ROWS + 2 * kr * w].view(np.uint16),
                j0, r0, kr, rows, mt, j0 > 0,
            ))
    return GFTable(tuple(launches), _table_device(device), w, k, m)


def bitmatrix_table(bitmatrix: np.ndarray, device: torch.device) -> BitmatrixTable:
    bits = np.asarray(bitmatrix) != 0
    M, K = bits.shape
    top = BITMATRIX_TILES[-1]
    shifts = np.arange(32, dtype=np.uint32)
    launches = []
    for r0 in range(0, M, top):
        tile = bits[r0:r0 + top]                                             # [i, j]
        used = np.flatnonzero(tile.any(axis=0))  # a row no output takes is never read
        for c0 in range(0, max(used.size, 1), BM_PLAN_ROWS):
            rows = used[c0:c0 + BM_PLAN_ROWS]
            n = rows.size
            took = np.zeros((top, -(-n // 32) * 32), dtype=np.uint32)        # [i, r]
            took[:tile.shape[0], :n] = tile[:, rows]
            words = (took.reshape(top, -1, 32) << shifts).sum(axis=2, dtype=np.uint32)
            plan = np.zeros(BM_PLAN_WORDS, dtype=np.uint32)
            plan[:n] = rows
            plan[BM_PLAN_ROWS:BM_PLAN_ROWS + words.size] = words.T.reshape(-1)  # [b][i]
            launches.append(BMLaunch(
                plan, plan.ctypes.data, plan[:n],
                plan[BM_PLAN_ROWS:BM_PLAN_ROWS + words.size].reshape(-1, 32),
                r0, tile.shape[0], _smallest_tile(tile.shape[0], BITMATRIX_TILES), c0 > 0,
            ))
    return BitmatrixTable(tuple(launches), _table_device(device), K, M)


def _check_lanes(x: torch.Tensor, rows: int, table_device: torch.device) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    if x.device != table_device:
        raise ValueError(f"lanes on {x.device}, matrix on {table_device}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(
            f"expected int32 lanes [{rows}, N4], got {x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("lanes must be contiguous")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        what = "not built for this tile" if rc == -1 else f"cudaError_t {rc}"
        raise KernelLaunchError(f"{name} launch failed: {what}")
    with _LAUNCHES_LOCK:
        launches[name] += 1


def gf_matmul(table: GFTable, d32: torch.Tensor) -> torch.Tensor:
    """data [k, N4] int32 lanes -> parity [m, N4] on the card."""
    _check_lanes(d32, table.k, table.device)
    n4 = d32.shape[1]
    out = torch.empty((table.m, n4), dtype=torch.int32, device=d32.device)
    if n4 == 0 or table.m == 0:
        return out
    stream = torch.cuda.current_stream(d32.device).cuda_stream
    launch = _lib("gf_matmul").gf_matmul_launch
    row_bytes = 4 * n4
    with torch.cuda.device(d32.device):
        for g in table.launches:
            rc = launch(
                d32.data_ptr() + g.in_row * row_bytes, out.data_ptr() + g.out_row * row_bytes,
                g.plan_ptr, table.w, g.k, g.m, g.mt, n4, g.accumulate, stream,
            )
            _launched("gf_matmul", rc)
    return out


def bitmatrix_xor(table: BitmatrixTable, p32: torch.Tensor) -> torch.Tensor:
    """packets [K, N4] int32 lanes -> [M, N4] on the card."""
    _check_lanes(p32, table.K, table.device)
    n4 = p32.shape[1]
    out = torch.empty((table.M, n4), dtype=torch.int32, device=p32.device)
    if n4 == 0 or table.M == 0:
        return out
    stream = torch.cuda.current_stream(p32.device).cuda_stream
    launch = _lib("bitmatrix_xor").bitmatrix_xor_launch
    row_bytes = 4 * n4
    with torch.cuda.device(p32.device):
        for g in table.launches:
            rc = launch(
                p32.data_ptr(), out.data_ptr() + g.out_row * row_bytes, g.plan_ptr,
                len(g.rows), g.m, g.mt, n4, g.accumulate, stream,
            )
            _launched("bitmatrix_xor", rc)
    return out
