"""Minimal XOR example codec (k data + 1 parity).

Counterpart of ``ceph_tpu/models/example.py``.

The reference ships ErasureCodeExample (k=2, m=1 XOR,
reference:src/test/erasure-code/ErasureCodeExample.h) as the smallest
conforming plugin; this is its analog, with configurable k.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .base import ErasureCode
from .matrix_codec import MatrixErasureCode
from .registry import ErasureCodePlugin, PLUGIN_VERSION

__erasure_code_version__ = PLUGIN_VERSION


class ErasureCodePluginExample(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], device):
        k = ErasureCode.to_int("k", profile, 2, minimum=2)
        codec = MatrixErasureCode(k, 1, 8, np.ones((1, k), dtype=np.int64), device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name: str, registry) -> None:
    registry.add(name, ErasureCodePluginExample())
