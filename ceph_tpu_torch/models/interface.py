"""Abstract erasure-codec contract.

Counterpart of ``ceph_tpu/models/interface.py``, the re-expression of
``ErasureCodeInterface`` (reference:src/erasure-code/
ErasureCodeInterface.h:171): systematic codes over k data + m coding
chunks, with the chunk/stripe model documented at
reference:ErasureCodeInterface.h:39-140.  Differences by design:

- chunks are numpy ``uint8`` arrays on the host, or ``uint8`` torch
  tensors on the codec's device; the batched calls return the kind
  they were given;
- a first-class *batched* API (`encode_chunks` over ``[k, N]`` with N
  spanning many stripes), because filling the device is the point;
- profiles are ``dict[str, str]`` exactly like the reference's
  ErasureCodeProfile.
"""

from __future__ import annotations

import abc
from typing import Mapping, Sequence

import numpy as np


class ErasureCodeValidationError(ValueError):
    """Profile/parameter validation failure (reference returns -EINVAL)."""


class ErasureCodeInterface(abc.ABC):
    """Systematic erasure codec: chunks 0..k-1 data, k..k+m-1 coding.

    reference:ErasureCodeInterface.h:189 (init), :228 (get_chunk_count),
    :269 (get_chunk_size), :287 (minimum_to_decode), :354 (encode),
    :395 (decode), :436 (get_chunk_mapping), :448 (decode_concat).
    """

    @abc.abstractmethod
    def init(self, profile: Mapping[str, str]) -> None:
        """Validate + apply profile; raise ErasureCodeValidationError on bad input."""

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    @abc.abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size (bytes) for an object of ``stripe_width`` bytes.

        chunk_size * k >= stripe_width, aligned per codec requirements
        (reference:ErasureCodeInterface.h:269).
        """

    @abc.abstractmethod
    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> list[int]:
        """Smallest chunk set sufficient to decode ``want_to_read``.

        Raises IOError if impossible (reference :287 returns -EIO).
        """

    def minimum_to_decode_with_cost(
        self, want_to_read: Sequence[int], available: Mapping[int, int]
    ) -> list[int]:
        """Cost-aware variant; default ignores costs (reference :315)."""
        return self.minimum_to_decode(want_to_read, list(available))

    def get_ruleset_steps(self) -> "list[tuple[str, str, int]] | None":
        """Placement steps for this codec's crush rule, or None for the
        default simple rule (reference:ErasureCodeInterface.h:213
        create_ruleset; LRC's layered placement,
        reference:src/erasure-code/lrc/ErasureCodeLrc.cc:44).

        Each step is (op, type_name, n) with op "choose"|"chooseleaf" —
        e.g. LRC's [("choose", "rack", groups), ("chooseleaf", "host",
        l+1)] places each local-parity group in its own rack.
        """
        return None

    @abc.abstractmethod
    def encode(
        self, want_to_encode: Sequence[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        """Pad+split ``data`` into k chunks, compute m parity, return wanted."""

    @abc.abstractmethod
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """Batched core: [k, C] uint8 -> [m, C] parity (C may span stripes)."""

    @abc.abstractmethod
    def decode(
        self, want_to_read: Sequence[int], chunks: Mapping[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        """Recover ``want_to_read`` chunks from available ``chunks``."""

    @abc.abstractmethod
    def decode_chunks(
        self, present: Sequence[int], chunks: np.ndarray, missing: Sequence[int]
    ) -> np.ndarray:
        """Batched core: rebuild ``missing`` chunk rows from ``present`` rows."""

    def get_chunk_mapping(self) -> list[int]:
        """Chunk index remapping; empty = identity (reference :436)."""
        return []

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        """Decode then concatenate data chunks in order (reference :448)."""
        k = self.get_data_chunk_count()
        decoded = self.decode(list(range(k)), chunks)
        return b"".join(bytes(decoded[i]) for i in range(k))
