"""Carry a codec's state across from ``ceph_tpu``.

A codec is fully defined by a few numpy values: ``k``, ``m``, ``w``, the
GF(2^w) ``matrix`` or the GF(2) ``bitmatrix``, the ``packetsize`` of a
bit-matrix code, and the ``chunk_mapping``.  :func:`codec_from_arrays`
takes those values, as read off a reference codec, and returns the
equivalent port codec on the given device, without going through a
profile.  Nothing here imports ``ceph_tpu``: the caller hands over the
arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .base import ErasureCode
from .interface import ErasureCodeValidationError
from .matrix_codec import BitmatrixErasureCode, MatrixErasureCode


def codec_from_arrays(
    k: int,
    m: int,
    w: int,
    *,
    matrix: np.ndarray | None = None,
    bitmatrix: np.ndarray | None = None,
    packetsize: int | None = None,
    chunk_mapping: Sequence[int] = (),
    device=None,
) -> ErasureCode:
    """A :class:`MatrixErasureCode` from ``matrix`` alone, or a
    :class:`BitmatrixErasureCode` from ``bitmatrix`` (``matrix`` may
    ride along) and ``packetsize``."""
    if bitmatrix is not None:
        if packetsize is None:
            raise ErasureCodeValidationError("a bitmatrix codec needs its packetsize")
        codec = BitmatrixErasureCode(
            k, m, w, matrix, packetsize, bitmatrix=bitmatrix, device=device
        )
    elif matrix is not None:
        codec = MatrixErasureCode(k, m, w, matrix, device)
    else:
        raise ErasureCodeValidationError("need a matrix or a bitmatrix")
    codec.chunk_mapping = [int(i) for i in chunk_mapping]
    return codec
