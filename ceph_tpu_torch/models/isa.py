"""ISA-L-equivalent plugin.

Counterpart of ``ceph_tpu/models/isa.py``; codecs run on the device the
registry hands to the factory.

Mirrors reference:src/erasure-code/isa/ErasureCodeIsa.{h,cc}: w=8 matrix
codes with technique ``reed_sol_van`` (gf_gen_rs_matrix, :409) or ``cauchy``
(gf_gen_cauchy1_matrix, :412); the m=1 single-parity fast path is a raw XOR
(:152, xor_op.h:42-82) — here that's the packed-lane XOR program the
matrix codec selects automatically for an all-ones 1-row matrix.  Decode
matrices are LRU-cached per erasure signature like
ErasureCodeIsaTableCache (:278-331).
"""

from __future__ import annotations

from typing import Mapping

from ..ops import matrices as mx
from .base import ErasureCode
from .interface import ErasureCodeValidationError
from .matrix_codec import MatrixErasureCode
from .registry import ErasureCodePlugin, PLUGIN_VERSION

__erasure_code_version__ = PLUGIN_VERSION

DEFAULT_K = 7
DEFAULT_M = 3


class ErasureCodePluginIsa(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], device):
        technique = profile.get("technique", "reed_sol_van")
        k = ErasureCode.to_int("k", profile, DEFAULT_K, minimum=1)
        m = ErasureCode.to_int("m", profile, DEFAULT_M, minimum=1)
        if k + m > 256:
            raise ErasureCodeValidationError(f"k+m={k+m} exceeds GF(2^8)")
        if technique == "reed_sol_van":
            matrix = mx.isa_rs_vandermonde(k, m)
        elif technique == "cauchy":
            matrix = mx.isa_cauchy(k, m)
        else:
            raise ErasureCodeValidationError(
                f"isa technique must be reed_sol_van or cauchy, got {technique!r}"
            )
        codec = MatrixErasureCode(k, m, 8, matrix, device)
        codec.init(profile)
        codec.parse_chunk_mapping(profile)
        return codec


def __erasure_code_init__(name: str, registry) -> None:
    registry.add(name, ErasureCodePluginIsa())
