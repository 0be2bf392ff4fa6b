"""ctypes loader and wrappers for the port's host engine
(``ceph_tpu_torch/csrc/host/ec_cpu.cc``).

Counterpart of ``ceph_tpu/utils/native.py``, cut to what the OSD EC
stack and the messenger call: :func:`encode` (GF matmul of flat rows),
:func:`encode_stripes` (the fused stripe-layout encode), :func:`crc32c`
and :func:`crc32c_view` (the per-frame crc of ``msg.message``).  The library is built with ``g++`` at first
use into ``ceph_tpu_torch/build/``, named by a hash of the source and the
flags, so a second process in the same tree loads it without a rebuild.
Nothing here runs at import.

The engine serves two roles, as in the reference: the native C lane of a
codec that lives on the CPU (:func:`host_engine_active`), and the host
replay engine of a failover (``MatrixErasureCode._host_matmul``) for a
codec on any device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "ec_cpu.cc"
BUILD_DIR = _PKG / "build"

# gf8_encode keeps k data and m parity row pointers on its stack
MAX_ROWS = 32

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_error: BaseException | None = None


def _flags() -> tuple[str, ...]:
    from .arch import host_march_flags

    return ("-O3", *host_march_flags(), "-funroll-loops", "-shared",
            "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Build output, keyed on the source, the flags and what they
    compile for on this host."""
    from .arch import host_target

    flags = _flags()
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(host_target().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libec_cpu-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this tree has not built it yet; returns
    its path."""
    import subprocess

    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    subprocess.run(["g++", *_flags(), str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def lib() -> ctypes.CDLL:
    """The loaded library; builds it on first use.  A failed build is
    remembered and raised again, so callers probing for the engine pay
    for one ``g++`` run, not one per call."""
    global _lib, _lib_error
    with _lock:
        if _lib is None:
            if _lib_error is not None:
                raise _lib_error
            try:
                so = build()
                L = ctypes.CDLL(str(so))
            except Exception as e:
                _lib_error = e
                raise
            _P = ctypes.POINTER
            enc = [_P(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                   _P(ctypes.c_uint8), _P(ctypes.c_uint8), ctypes.c_int64]
            L.gf8_encode_flat.argtypes = enc
            L.gf8_encode_flat.restype = None
            L.gf16_encode_flat.argtypes = enc
            L.gf16_encode_flat.restype = None
            L.gf8_encode_stripes.argtypes = [
                _P(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64,
                _P(ctypes.c_uint8), _P(ctypes.c_uint8),
            ]
            L.gf8_encode_stripes.restype = None
            for fn in (L.crc32c_sw, L.crc32c_table):
                fn.argtypes = [ctypes.c_uint32, _P(ctypes.c_uint8),
                               ctypes.c_int64]
                fn.restype = ctypes.c_uint32
            _lib = L
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def fits(m: int, k: int) -> bool:
    """Does an [m, k] matrix fit the engine's row-pointer arrays?"""
    return k <= MAX_ROWS and m <= MAX_ROWS


def _matrix(matrix: np.ndarray) -> np.ndarray:
    matrix = np.ascontiguousarray(matrix, dtype=np.int32)
    m, k = matrix.shape
    if not fits(m, k):
        raise ValueError(f"native engine takes k, m <= {MAX_ROWS}, got {k}, {m}")
    return matrix


def encode(matrix: np.ndarray, data: np.ndarray, w: int = 8) -> np.ndarray:
    """GF(2^w) matmul on the host: data [k, n] uint8 -> parity [m, n],
    n % 8 == 0."""
    L = lib()
    matrix = _matrix(matrix)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = matrix.shape
    if data.shape[0] != k or data.shape[1] % 8:
        raise ValueError(f"data {data.shape} for a [{m}, {k}] matrix "
                         "(rows must match, length a multiple of 8)")
    parity = np.empty((m, data.shape[1]), dtype=np.uint8)
    fn = L.gf8_encode_flat if w == 8 else L.gf16_encode_flat
    fn(matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), k, m,
       _u8ptr(data), _u8ptr(parity), data.shape[1])
    return parity


_HOST_ACTIVE: bool | None = None


def host_engine_active(device) -> bool:
    """True when ``device`` (a codec's torch device) is the CPU and this
    native engine is loadable: the ONE routing gate shared by the encode
    stack (``osd.ec_util``), the codec decode path
    (``models.matrix_codec``) and the dispatcher's direct lane.  The
    reference keys the same gate on jax's default backend; here it is the
    codec's own device, so a CUDA codec never takes the native lane."""
    global _HOST_ACTIVE
    if device is None or torch.device(device).type != "cpu":
        return False
    if _HOST_ACTIVE is None:
        try:
            lib()
            _HOST_ACTIVE = True
        except Exception:
            _HOST_ACTIVE = False
    return _HOST_ACTIVE


def encode_stripes(
    matrix: np.ndarray, buf: np.ndarray, S: int, cs: int
) -> np.ndarray:
    """Fused stripe-layout encode: ``buf`` is the client's [S*k*cs] byte
    stream; returns [k+m, S*cs] whose rows are the per-shard buffers
    (data rows laid out + parity), produced in ONE pass over the input."""
    L = lib()
    matrix = _matrix(matrix)
    m, k = matrix.shape
    buf = np.ascontiguousarray(buf.reshape(-1))
    if buf.size != S * k * cs or cs % 8:
        raise ValueError(f"{buf.size} bytes for {S} stripes of {k} x {cs} "
                         "(chunk size a multiple of 8)")
    out = np.empty((k + m, S * cs), dtype=np.uint8)
    L.gf8_encode_stripes(matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                         k, m, S, cs, _u8ptr(buf), _u8ptr(out))
    return out


def crc32c(crc: int, data) -> int:
    """crc32c (Castagnoli) with ceph_crc32c semantics: seed used raw, no
    pre/post inversion, so crcs compose across appends."""
    from .buffers import as_u8

    buf = as_u8(data)
    if buf.size == 0:
        return crc & 0xFFFFFFFF
    return int(lib().crc32c_sw(crc & 0xFFFFFFFF, _u8ptr(buf), buf.size))


# lean per-frame crc entry (msg/message.py hot path): the generic
# crc32c above pays call scaffolding per invocation — as_u8 conversion,
# the lib() lock, and numpy's .ctypes pointer build — which dwarfs the
# actual crc of a sub-KiB header.  This binding passes c_void_p, so
# bytes go pointer-direct and writable buffers resolve via a
# zero-length from_buffer cast.
_crc_raw = None
_U8_0 = ctypes.c_uint8 * 0


def _crc_fn():
    global _crc_raw
    if _crc_raw is None:  # benign race: both winners bind the same fn
        L = lib()
        _crc_raw = ctypes.CFUNCTYPE(
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_int64,
        )(("crc32c_sw", L))
    return _crc_raw


def crc32c_view(crc: int, buf, n: int | None = None) -> int:
    """crc32c over any bytes-like without conversion scaffolding:
    ``bytes`` pass their pointer directly, writable buffers
    (bytearray / slab memoryview) via ``from_buffer``, read-only
    views through a numpy pointer.  ``n`` overrides the length (crc a
    strict prefix of ``buf`` without slicing it — the decode path's
    body-minus-trailer case).  Bit-identical to :func:`crc32c`."""
    fn = _crc_fn()
    crc &= 0xFFFFFFFF
    if type(buf) is bytes:
        ln = len(buf) if n is None else n
        return fn(crc, buf, ln) if ln else crc
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    ln = mv.nbytes if n is None else n
    if not ln:
        return crc
    try:
        base = _U8_0.from_buffer(mv)
        return fn(crc, ctypes.addressof(base), ln)
    except TypeError:  # read-only view: numpy exposes the pointer
        a = np.frombuffer(mv, np.uint8)
        return fn(crc, a.__array_interface__["data"][0], ln)


def crc32c_table(crc: int, data) -> int:
    """The table-path crc32c, for cross-checking :func:`crc32c` (which
    takes the SSE4.2 instruction where the host has it)."""
    from .buffers import as_u8

    buf = as_u8(data)
    if buf.size == 0:
        return crc & 0xFFFFFFFF
    return int(lib().crc32c_table(crc & 0xFFFFFFFF, _u8ptr(buf), buf.size))
