"""zstd compressor plugin — load-gated stub.

The reference builds this against libzstd
(reference:src/compressor/zstd/); that native library is not in this
build, so loading the plugin fails the way a missing .so fails dlopen.
"""

from __future__ import annotations

from . import PLUGIN_VERSION, CompressorPluginError

__compressor_version__ = PLUGIN_VERSION


def __compressor_init__(name: str, registry) -> None:
    raise CompressorPluginError(
        "zstd: libzstd is not available in this build"
    )
