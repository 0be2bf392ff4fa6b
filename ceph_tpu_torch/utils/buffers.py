"""Byte-buffer coercion for the codec layer.

Counterpart of ``ceph_tpu/utils/buffers.py``; only :func:`as_u8`, which
``models.base.encode_prepare`` needs, is ported so far.  ``BufferList``
and the copy accounting come with the OSD data path.
"""

from __future__ import annotations

import numpy as np


def as_u8(data, *, writable: bool = False) -> np.ndarray:
    """Coerce bytes-like or array-like to a contiguous flat uint8 array
    without copying when the input already owns suitable bytes.

    ``np.frombuffer`` accepts the buffer protocol directly, so bytes,
    bytearray and memoryview wrap for free (the array aliases the
    source).  The only copy left is the one that is required:
    ``writable=True`` over a read-only source.
    """
    if isinstance(data, np.ndarray):
        out = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    elif isinstance(data, (bytes, bytearray, memoryview)):
        mv = memoryview(data)
        if mv.ndim != 1 or not mv.contiguous or mv.itemsize != 1:
            mv = memoryview(mv.tobytes())
        out = np.frombuffer(mv, dtype=np.uint8)
    else:
        return np.ascontiguousarray(np.asarray(data, dtype=np.uint8)).reshape(-1)
    if writable and not out.flags.writeable:
        out = out.copy()
    return out
