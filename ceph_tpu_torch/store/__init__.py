"""Local object stores, and the key-value layer under them and under the
monitor's store.

Counterpart of ``ceph_tpu/store``: the ObjectStore contract
(reference:src/os/ObjectStore.h) with its three stores — ``MemStore``,
the journalled ``WalStore`` and ``BlueStore`` over a block file and
``FileKVDB`` — each with the reference's on-disk format, so a store
written by one package mounts in the other.
"""

from .kv import FileKVDB, KeyValueDB
from .objectstore import (
    NO_SHARD,
    CollectionId,
    NeedsMkfs,
    ObjectId,
    ObjectStore,
    Transaction,
)
from .memstore import MemStore
from .wal import CrashPoint, WalStore
from .blue import BitrotError, BlueStore

__all__ = [
    "ObjectId",
    "CollectionId",
    "ObjectStore",
    "Transaction",
    "MemStore",
    "WalStore",
    "BlueStore",
    "BitrotError",
    "CrashPoint",
    "NeedsMkfs",
    "FileKVDB",
    "KeyValueDB",
    "NO_SHARD",
]
