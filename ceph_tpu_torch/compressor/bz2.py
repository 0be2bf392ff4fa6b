"""bz2 compressor plugin (high-ratio stdlib backend)."""

from __future__ import annotations

import bz2 as _bz2
from typing import Mapping

from . import PLUGIN_VERSION, CompressionPlugin, Compressor

__compressor_version__ = PLUGIN_VERSION


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return _bz2.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return _bz2.decompress(bytes(data))


class _Plugin(CompressionPlugin):
    def factory(self, options: Mapping[str, str]) -> Compressor:
        return Bz2Compressor()


def __compressor_init__(name: str, registry) -> None:
    registry.add(name, _Plugin())
