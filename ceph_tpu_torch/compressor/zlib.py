"""zlib compressor plugin (reference:src/compressor/zlib/)."""

from __future__ import annotations

import zlib as _zlib
from typing import Mapping

from . import PLUGIN_VERSION, CompressionPlugin, Compressor

__compressor_version__ = PLUGIN_VERSION


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return _zlib.compress(bytes(data), self.level)

    def decompress(self, data: bytes) -> bytes:
        return _zlib.decompress(bytes(data))


class _Plugin(CompressionPlugin):
    def factory(self, options: Mapping[str, str]) -> Compressor:
        return ZlibCompressor(int(options.get("compression_zlib_level", 5)))


def __compressor_init__(name: str, registry) -> None:
    registry.add(name, _Plugin())
