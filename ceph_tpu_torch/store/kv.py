"""KeyValueDB: the framework's KV abstraction (reference:src/kv/).

The port's own copy of ``ceph_tpu/store/kv.py``, with the same on-disk
format, so a store written by one package opens in the other.

The reference routes all metadata persistence through ``KeyValueDB``
(reference:src/kv/KeyValueDB.h) with RocksDB/LevelDB/memdb backends:
namespaced (prefix, key) -> value pairs, atomic batched transactions,
ordered iteration.  Consumers here: the monitor's store
(MonitorDBStore analog) and the offline tools.

Backends:
- :class:`MemDB` — dict-backed (memdb analog, tests).
- :class:`FileKVDB` — durable: a checkpoint snapshot plus an
  append-only batch journal with crc framing, replayed on open (the
  same WAL discipline as the object-store's WalStore; RocksDB's
  memtable+WAL collapsed to its essentials).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator

_HDR = struct.Struct("<II")  # payload_len, crc32(payload)


class KVTransaction:
    """Atomic batch (KeyValueDB::Transaction analog)."""

    def __init__(self):
        self.ops: list[tuple] = []  # ("set", p, k, v) | ("rm", p, k)
                                    # | ("rm_prefix", p)

    def set(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rm_prefix", prefix))
        return self

    def empty(self) -> bool:
        return not self.ops


class KeyValueDB:
    """Namespaced ordered KV store with atomic batches."""

    def open(self) -> None: ...

    def close(self) -> None: ...

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        raise NotImplementedError

    def get(self, prefix: str, key: str) -> bytes | None:
        raise NotImplementedError

    def iterate(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        """Sorted (key, value) pairs under a prefix."""
        raise NotImplementedError

    # -- conveniences
    def set_one(self, prefix: str, key: str, value: bytes,
                sync: bool = True) -> None:
        self.submit(self.transaction().set(prefix, key, value), sync=sync)

    def keys(self, prefix: str) -> list[str]:
        return [k for k, _v in self.iterate(prefix)]


class MemDB(KeyValueDB):
    def __init__(self):
        self._data: dict[str, dict[str, bytes]] = {}

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        for op in txn.ops:
            self._apply(op)

    def _apply(self, op: tuple) -> None:
        if op[0] == "set":
            _, p, k, v = op
            self._data.setdefault(p, {})[k] = v
        elif op[0] == "rm":
            _, p, k = op
            self._data.get(p, {}).pop(k, None)
        elif op[0] == "rm_prefix":
            self._data.pop(op[1], None)

    def get(self, prefix: str, key: str) -> bytes | None:
        return self._data.get(prefix, {}).get(key)

    def iterate(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        yield from sorted(self._data.get(prefix, {}).items())


class FileKVDB(MemDB):
    """Checkpoint + crc-framed batch journal under ``path``/ :
    ``checkpoint`` (atomic-rename full snapshot) and ``journal``
    (appended batches since).  ``open()`` loads the checkpoint and
    replays the journal, truncating at the first torn record — the
    FileJournal/RocksDB-WAL recovery contract."""

    CHECKPOINT_EVERY = 4 << 20  # journal bytes before a new snapshot

    def __init__(self, path: str, sync: str = "fsync"):
        super().__init__()
        self.path = path
        self.sync = sync
        self._journal = None
        self._journal_bytes = 0

    # -- lifecycle
    def open(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        cp = os.path.join(self.path, "checkpoint")
        try:
            with open(cp) as f:
                snap = json.load(f)
            self._data = {
                p: {k: bytes.fromhex(v) for k, v in kv.items()}
                for p, kv in snap.items()
            }
        except FileNotFoundError:
            self._data = {}
        jpath = os.path.join(self.path, "journal")
        good = 0
        try:
            with open(jpath, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    ln, crc = _HDR.unpack(hdr)
                    payload = f.read(ln)
                    if len(payload) < ln or zlib.crc32(payload) != crc:
                        break  # torn tail: recovery stops here
                    for op in json.loads(payload):
                        self._apply(self._decode_op(op))
                    good = f.tell()
        except FileNotFoundError:
            pass
        # reopen for append, truncated at the last good record
        self._journal = open(jpath, "ab")
        self._journal.truncate(good)
        self._journal.seek(good)
        self._journal_bytes = good

    def close(self) -> None:
        if self._journal is not None:
            self._checkpoint()
            self._journal.close()
            self._journal = None

    def crash_close(self) -> None:
        """Free the journal fd WITHOUT checkpointing — simulated process
        death; a fresh open() replays the journal from disk."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # -- write path
    @staticmethod
    def _encode_op(op: tuple) -> list:
        if op[0] == "set":
            return ["set", op[1], op[2], op[3].hex()]
        return list(op)

    @staticmethod
    def _decode_op(op: list) -> tuple:
        if op[0] == "set":
            return ("set", op[1], op[2], bytes.fromhex(op[3]))
        return tuple(op)

    def submit(self, txn: KVTransaction, sync: bool = True) -> None:
        if self._journal is None:
            raise RuntimeError("FileKVDB not open")
        payload = json.dumps(
            [self._encode_op(op) for op in txn.ops]
        ).encode()
        self._journal.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._journal.write(payload)
        self._journal.flush()
        if sync and self.sync == "fsync":
            os.fsync(self._journal.fileno())
        super().submit(txn)
        self._journal_bytes += _HDR.size + len(payload)
        if self._journal_bytes >= self.CHECKPOINT_EVERY:
            self._checkpoint()

    def _checkpoint(self) -> None:
        cp = os.path.join(self.path, "checkpoint")
        tmp = cp + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    p: {k: v.hex() for k, v in kv.items()}
                    for p, kv in self._data.items()
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cp)
        self._journal.truncate(0)
        self._journal.seek(0)
        self._journal_bytes = 0
