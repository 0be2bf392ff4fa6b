"""Erasure-code plugin registry.

Counterpart of ``ceph_tpu/models/registry.py``, with a singleton of its
own: nothing is registered into ``ceph_tpu``'s registry, and the
default directory is this package's ``models``.  ``factory`` takes the
device the codec runs on and hands it to the plugin.

Python-module analog of the dlopen registry
(reference:src/erasure-code/ErasureCodePlugin.{h,cc}): a process singleton
(:35) whose ``factory()`` (:90) loads plugins on demand under a mutex, then
instantiates a codec.  ``load()`` (:124) imports ``<prefix><name>`` (the
``libec_<name>.so`` analog is ``ceph_tpu_torch.models.<name>`` or any dotted path
via ``directory``), checks ``__erasure_code_version__`` against ours (:142),
and calls ``__erasure_code_init__(name)`` (:149), which must register a
plugin object.  ``preload()`` (:184) loads a config-provided list at
startup, as every daemon does via global init
(reference:src/global/global_init.cc:522).

The deliberately-broken-plugin error paths (fail to initialize / fail to
register / missing entry point / missing version) match the reference's
test fixtures (reference:src/test/erasure-code/ErasureCodePlugin*.cc).
"""

from __future__ import annotations

import importlib
import threading
from typing import Mapping

import torch

from ..device import resolve
from .interface import ErasureCodeInterface

# bumped together with any change that would alter parity bytes or the
# plugin contract; differs from ceph_tpu's because a port plugin's
# factory also takes the device
PLUGIN_VERSION = "ceph-tpu-torch-ec-1"

DEFAULT_DIRECTORY = "ceph_tpu_torch.models"


class ErasureCodePluginError(RuntimeError):
    pass


class ErasureCodePlugin:
    """Base plugin: subclass and implement factory(profile, device) -> codec."""

    def __init__(self):
        self.version = PLUGIN_VERSION

    def factory(
        self, profile: Mapping[str, str], device: torch.device
    ) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self.disable_dlclose = False  # parity flag; modules are never unloaded

    # -- registration (called by plugin modules' init hooks) ----------------

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        if name in self._plugins:
            raise ErasureCodePluginError(f"plugin {name} already registered")
        self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        return self._plugins.get(name)

    def remove(self, name: str) -> None:
        self._plugins.pop(name, None)

    # -- loading ------------------------------------------------------------

    def load(self, name: str, directory: str = DEFAULT_DIRECTORY) -> ErasureCodePlugin:
        """Import the plugin module and run its registration hook."""
        modname = f"{directory}.{name}"
        try:
            module = importlib.import_module(modname)
        except ImportError as e:
            raise ErasureCodePluginError(
                f"load dlopen({modname}): {e}"
            ) from e
        version = getattr(module, "__erasure_code_version__", None)
        if version is None:
            raise ErasureCodePluginError(
                f"load: {modname} has no __erasure_code_version__ symbol"
            )
        if version != PLUGIN_VERSION:
            raise ErasureCodePluginError(
                f"load: {modname} version {version} != expected {PLUGIN_VERSION}"
            )
        init = getattr(module, "__erasure_code_init__", None)
        if init is None:
            raise ErasureCodePluginError(
                f"load: {modname} has no __erasure_code_init__ entry point"
            )
        try:
            ret = init(name, self)
        except Exception as e:
            raise ErasureCodePluginError(
                f"load: {modname} __erasure_code_init__ failed: {e}"
            ) from e
        if ret not in (None, 0):
            raise ErasureCodePluginError(
                f"load: {modname} __erasure_code_init__ returned {ret}"
            )
        plugin = self._plugins.get(name)
        if plugin is None:
            raise ErasureCodePluginError(
                f"load: {modname} initialized but did not register plugin {name}"
            )
        return plugin

    def factory(
        self,
        name: str,
        profile: Mapping[str, str],
        directory: str = DEFAULT_DIRECTORY,
        device: str | torch.device | None = None,
    ) -> ErasureCodeInterface:
        """Load-on-demand then instantiate (reference:ErasureCodePlugin.cc:90)
        on ``device``: CUDA when None (raises if CUDA is absent), or the
        CPU only when asked for."""
        device = resolve(device)
        with self._lock:
            plugin = self._plugins.get(name)
            if plugin is None:
                plugin = self.load(name, directory)
        codec = plugin.factory(profile, device)
        if codec is None:
            raise ErasureCodePluginError(f"plugin {name} factory returned None")
        return codec

    def preload(self, names: str, directory: str = DEFAULT_DIRECTORY) -> None:
        """Space-separated plugin list, as osd_erasure_code_plugins
        (reference:src/common/config_opts.h:684 default "jerasure lrc isa")."""
        with self._lock:
            for name in names.split():
                if name not in self._plugins:
                    self.load(name, directory)


_instance = ErasureCodePluginRegistry()


def instance() -> ErasureCodePluginRegistry:
    return _instance
