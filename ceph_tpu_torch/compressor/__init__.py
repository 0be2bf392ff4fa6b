"""Compression plugin family (reference:src/compressor/).

The reference loads compressors through the same dlopen plugin pattern
as erasure codes (reference:src/compressor/CompressionPlugin.h, registry
mirroring ErasureCodePlugin.cc) with snappy/zlib/zstd implementations.
Same shape here: a registry that imports ``ceph_tpu_torch.compressor.<name>``
on demand, checks its version symbol, and runs its registration hook;
plugins expose ``Compressor`` instances with compress/decompress.

In-tree plugins: ``zlib``, ``bz2``, ``lzma`` (stdlib-backed), ``none``
(passthrough).  ``snappy``/``zstd`` exist as load-gated stubs: their
native libraries are not in this build, so loading them raises the
plugin error the reference raises on a failed dlopen.

Counterpart of ``ceph_tpu/compressor``, whole: the same plugins, the
same options and the same compressed bytes, so a checkpoint or blob
compressed by one package decompresses in the other.
"""

from __future__ import annotations

import abc
import importlib
import threading
from typing import Mapping

PLUGIN_VERSION = "2.0.0"
DEFAULT_DIRECTORY = "ceph_tpu_torch.compressor"


class CompressorError(Exception):
    pass


class CompressorPluginError(CompressorError):
    pass


class Compressor(abc.ABC):
    """reference:src/compressor/Compressor.h contract."""

    name: str = "?"

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, data: bytes) -> bytes: ...


class CompressionPlugin(abc.ABC):
    @abc.abstractmethod
    def factory(self, options: Mapping[str, str]) -> Compressor: ...


class CompressionPluginRegistry:
    """reference:src/compressor/CompressionPlugin.h registry (the
    ErasureCodePluginRegistry pattern)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plugins: dict[str, CompressionPlugin] = {}

    def add(self, name: str, plugin: CompressionPlugin) -> None:
        if name in self._plugins:
            raise CompressorPluginError(f"plugin {name} already registered")
        self._plugins[name] = plugin

    def load(self, name: str, directory: str = DEFAULT_DIRECTORY
             ) -> CompressionPlugin:
        modname = f"{directory}.{name}"
        try:
            module = importlib.import_module(modname)
        except ImportError as e:
            raise CompressorPluginError(f"load dlopen({modname}): {e}") from e
        version = getattr(module, "__compressor_version__", None)
        if version != PLUGIN_VERSION:
            raise CompressorPluginError(
                f"load: {modname} version {version} != {PLUGIN_VERSION}"
            )
        init = getattr(module, "__compressor_init__", None)
        if init is None:
            raise CompressorPluginError(
                f"load: {modname} has no __compressor_init__ entry point"
            )
        try:
            init(name, self)
        except CompressorPluginError:
            raise
        except Exception as e:
            raise CompressorPluginError(
                f"load: {modname} __compressor_init__ failed: {e}"
            ) from e
        plugin = self._plugins.get(name)
        if plugin is None:
            raise CompressorPluginError(
                f"load: {modname} did not register plugin {name}"
            )
        return plugin

    def factory(self, name: str, options: Mapping[str, str] | None = None,
                directory: str = DEFAULT_DIRECTORY) -> Compressor:
        with self._lock:
            plugin = self._plugins.get(name)
            if plugin is None:
                plugin = self.load(name, directory)
        return plugin.factory(options or {})


_instance: CompressionPluginRegistry | None = None
_instance_lock = threading.Lock()


def instance() -> CompressionPluginRegistry:
    global _instance
    with _instance_lock:
        if _instance is None:
            _instance = CompressionPluginRegistry()
        return _instance


def create(name: str, options: Mapping[str, str] | None = None) -> Compressor:
    """Compressor::create analog."""
    return instance().factory(name, options)
