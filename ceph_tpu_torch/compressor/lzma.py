"""lzma/xz compressor plugin (high-ratio stdlib backend)."""

from __future__ import annotations

import lzma as _lzma
from typing import Mapping

from . import PLUGIN_VERSION, CompressionPlugin, Compressor

__compressor_version__ = PLUGIN_VERSION


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return _lzma.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return _lzma.decompress(bytes(data))


class _Plugin(CompressionPlugin):
    def factory(self, options: Mapping[str, str]) -> Compressor:
        return LzmaCompressor()


def __compressor_init__(name: str, registry) -> None:
    registry.add(name, _Plugin())
