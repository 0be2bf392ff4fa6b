"""Shared codec behavior: padding, chunking, defaults, profile coercion.

Counterpart of ``ceph_tpu/models/base.py``, the analog of the reference
base class (reference:src/erasure-code/ErasureCode.{h,cc}):
``encode_prepare`` splits + zero-pads input into k aligned chunks
(reference:ErasureCode.cc:75), the default ``minimum_to_decode`` takes
the first k available chunks (reference:ErasureCode.cc:44), ``decode``
allocates missing chunks and defers to ``decode_chunks``
(reference:ErasureCode.cc:136), and the to_int/to_bool profile coercers
mirror reference:ErasureCode.cc:209-257.

Alignment: chunks are padded to TPU_ALIGN=128 bytes, as in ``ceph_tpu``.
Chunk sizes, and with them the parity bytes of the committed corpus,
depend on it, so the port keeps the value and the name.

Device: every codec is bound to one torch device, CUDA unless the caller
asks for the CPU (``device="cpu"``).  Its batched calls take numpy
arrays (copied to the device and back) or uint8 tensors already on that
device (kept there).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..device import resolve
from .interface import ErasureCodeInterface, ErasureCodeValidationError

TPU_ALIGN = 128


def device_bytes(x, device: torch.device) -> tuple[torch.Tensor, bool]:
    """uint8 chunks -> (uint8 tensor on ``device``, whether the caller
    gave host memory).  A tensor must already lie on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"chunks must be uint8, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"chunks on {x.device}, codec on {device}")
        return x, False
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint8))
    if not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy wants writable memory
    return torch.from_numpy(arr).to(device), True


def like_input(t: torch.Tensor, host: bool):
    """The result in the kind the caller gave: numpy for host input."""
    return t.cpu().numpy() if host else t


class ErasureCode(ErasureCodeInterface):
    """Base implementation; subclasses set self.k / self.m and kernels."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self.k = 0
        self.m = 0
        self.chunk_mapping: list[int] = []
        self._profile: dict[str, str] = {}

    # -- profile helpers ----------------------------------------------------

    @staticmethod
    def to_int(
        name: str,
        profile: Mapping[str, str],
        default: int,
        minimum: int | None = None,
        maximum: int | None = None,
    ) -> int:
        raw = profile.get(name)
        if raw is None or raw == "":
            value = default
        else:
            try:
                value = int(str(raw))
            except ValueError:
                raise ErasureCodeValidationError(
                    f"{name}={raw!r} is not a valid integer"
                )
        if minimum is not None and value < minimum:
            raise ErasureCodeValidationError(f"{name}={value} is below {minimum}")
        if maximum is not None and value > maximum:
            raise ErasureCodeValidationError(f"{name}={value} is above {maximum}")
        return value

    @staticmethod
    def to_bool(name: str, profile: Mapping[str, str], default: bool) -> bool:
        raw = profile.get(name)
        if raw is None or raw == "":
            return default
        return str(raw).lower() in ("true", "1", "yes", "on")

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        """Per-chunk byte alignment; subclasses may tighten (e.g. packets)."""
        return TPU_ALIGN

    def batch_alignment(self) -> int:
        """Chunk-size granularity at which batching many stripes into one
        [k, S*chunk] call is byte-identical to a per-stripe loop.

        1 for columnwise (matrix) codecs; packetized codecs override with
        w*packetsize so packets never span stripe boundaries.
        """
        return 1

    def get_chunk_size(self, stripe_width: int) -> int:
        align = self.get_alignment()
        per = (stripe_width + self.k - 1) // self.k
        return (per + align - 1) // align * align

    # -- chunk mapping (reference:ErasureCode.cc:188) ------------------------

    def parse_chunk_mapping(self, profile: Mapping[str, str]) -> None:
        raw = profile.get("mapping")
        if not raw:
            self.chunk_mapping = []
            return
        mapping = []
        position = 0
        for c in raw:
            if c == "D":
                mapping.append(position)
            position += 1
        if len(mapping) != self.k:
            # full remap string: digits not supported in reference either;
            # only D/_ patterns here
            raise ErasureCodeValidationError(
                f"mapping {raw!r} has {len(mapping)} data positions, expected k={self.k}"
            )
        self.chunk_mapping = mapping

    def get_chunk_mapping(self) -> list[int]:
        return list(self.chunk_mapping)

    # -- default decode policy ----------------------------------------------

    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> list[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return sorted(want)
        if len(avail) < self.k:
            raise IOError(
                f"cannot decode: {len(avail)} chunks available, need {self.k}"
            )
        return sorted(avail)[: self.k]

    # -- encode/decode plumbing ----------------------------------------------

    def encode_prepare(self, data: bytes | np.ndarray) -> np.ndarray:
        """Zero-pad + split object bytes into a [k, chunk_size] uint8 array."""
        from ..utils.buffers import as_u8

        buf = as_u8(data)
        chunk = self.get_chunk_size(buf.size)
        padded = np.zeros(self.k * chunk, dtype=np.uint8)
        padded[: buf.size] = buf
        return padded.reshape(self.k, chunk)

    def encode(
        self, want_to_encode: Sequence[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        chunks = self.encode_prepare(data)
        parity = np.asarray(self.encode_chunks(chunks))
        out: dict[int, np.ndarray] = {}
        for i in want_to_encode:
            out[i] = chunks[i] if i < self.k else parity[i - self.k]
        return out

    def decode(
        self, want_to_read: Sequence[int], chunks: Mapping[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        available = sorted(chunks)
        want = list(want_to_read)
        if set(want) <= set(available):
            return {i: np.asarray(chunks[i]) for i in want}
        need = self.minimum_to_decode(want, available)
        present = sorted(need)
        missing = sorted(set(want) - set(available))
        stacked = np.stack([np.asarray(chunks[i], dtype=np.uint8) for i in present])
        rebuilt = np.asarray(self.decode_chunks(present, stacked, missing))
        out: dict[int, np.ndarray] = {}
        for i in want:
            if i in chunks:
                out[i] = np.asarray(chunks[i])
            else:
                out[i] = rebuilt[missing.index(i)]
        return out
