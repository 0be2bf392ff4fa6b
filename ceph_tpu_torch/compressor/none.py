"""Passthrough compressor (compression_mode=none analog)."""

from __future__ import annotations

from typing import Mapping

from . import PLUGIN_VERSION, CompressionPlugin, Compressor

__compressor_version__ = PLUGIN_VERSION


class NoneCompressor(Compressor):
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes) -> bytes:
        return bytes(data)


class _Plugin(CompressionPlugin):
    def factory(self, options: Mapping[str, str]) -> Compressor:
        return NoneCompressor()


def __compressor_init__(name: str, registry) -> None:
    registry.add(name, _Plugin())
