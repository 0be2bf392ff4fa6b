"""Codec "model families": erasure-code interface, registry, and plugins.

Counterpart of ``ceph_tpu/models``, the analog of
reference:src/erasure-code/ — plugins are Python modules
(`ceph_tpu_torch.models.<name>` or external, loaded by dotted path) that
register factories with
:class:`ceph_tpu_torch.models.registry.ErasureCodePluginRegistry`,
mirroring the dlopen registry contract
(reference:src/erasure-code/ErasureCodePlugin.cc:26-149).
"""

from .interface import ErasureCodeInterface
from .base import ErasureCode
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry, instance

__all__ = [
    "ErasureCodeInterface",
    "ErasureCode",
    "ErasureCodePlugin",
    "ErasureCodePluginRegistry",
    "instance",
]
