"""The port's compressor plugins against the reference's.

- Twins of every test of the reference's ``tests/test_compressor.py``,
  run on ``ceph_tpu_torch.compressor`` and the port's ``WalStore``:
  ``zlib``, ``bz2``, ``lzma`` and ``none`` round-trip, ``snappy`` and
  ``zstd`` fail to load as in the reference, options reach the factory.
- Across the packages: each plugin compresses the same payload to the
  same bytes, and each package decompresses the other's.

Tolerance: exact equality throughout.
"""

import os

import pytest

from ceph_tpu_torch import compressor
from ceph_tpu_torch.compressor import (
    CompressionPluginRegistry,
    CompressorPluginError,
)
from ceph_tpu_torch.store import CollectionId, ObjectId, Transaction, WalStore

PAYLOADS = [
    b"",
    b"x",
    b"hello world " * 500,
    bytes(range(256)) * 64,
]


@pytest.mark.parametrize("name", ["zlib", "bz2", "lzma", "none"])
def test_round_trip(name):
    c = compressor.create(name)
    for blob in PAYLOADS:
        z = c.compress(blob)
        assert c.decompress(z) == blob
    # compressible data actually shrinks (except passthrough)
    big = b"a" * 100_000
    if name != "none":
        assert len(c.compress(big)) < len(big) // 10


@pytest.mark.parametrize("name", ["snappy", "zstd"])
def test_unavailable_backends_fail_load(name):
    """The native-lib-backed plugins fail the way a missing .so fails
    dlopen — a clear plugin error, not an ImportError at call time."""
    reg = CompressionPluginRegistry()
    with pytest.raises(CompressorPluginError):
        reg.factory(name)


def test_unknown_plugin():
    reg = CompressionPluginRegistry()
    with pytest.raises(CompressorPluginError):
        reg.factory("no_such_algo")


def test_options_reach_factory():
    c = compressor.create("zlib", {"compression_zlib_level": "9"})
    assert c.level == 9


def test_walstore_compressed_checkpoint(tmp_path):
    """WalStore checkpoints ride the compressor plugins; the algorithm is
    recorded in the header, so a store written with compression mounts
    fine with a different setting."""
    cid = CollectionId("1.0s0")
    s = WalStore(str(tmp_path / "a"), sync="none", compression="zlib",
                 checkpoint_bytes=1 << 30)
    s.mkfs()
    s.mount()
    s.apply(Transaction().create_collection(cid))
    payload = b"compress me " * 4096
    for i in range(8):
        s.apply(Transaction().write(cid, ObjectId(f"o{i}", 0), 0, payload))
    s.umount()  # checkpoints compressed
    ck = os.path.getsize(str(tmp_path / "a" / "checkpoint"))
    assert ck < 8 * len(payload) // 10  # really compressed
    # remount with compression off: header-driven decompression
    s2 = WalStore(str(tmp_path / "a"), sync="none")
    s2.mount()
    for i in range(8):
        assert s2.read(cid, ObjectId(f"o{i}", 0)) == payload


def test_walstore_rejects_unknown_compression(tmp_path):
    with pytest.raises(CompressorPluginError):
        WalStore(str(tmp_path / "a"), compression="snappy")


@pytest.mark.parametrize("name", ["zlib", "bz2", "lzma", "none"])
def test_compressed_bytes_equal_the_reference(name):
    from ceph_tpu import compressor as ref

    for opts in ({}, {"compression_zlib_level": "9"}):
        mine, theirs = compressor.create(name, opts), ref.create(name, opts)
        for blob in PAYLOADS + [b"a" * 100_000]:
            z = mine.compress(blob)
            assert z == theirs.compress(blob)
            assert theirs.decompress(z) == blob
            assert mine.decompress(theirs.compress(blob)) == blob


def test_the_registry_loads_the_ports_own_plugins():
    """The default directory is the port's: a plugin the registry loads
    is the port's module, never the reference's."""
    reg = CompressionPluginRegistry()
    c = reg.factory("zlib")
    assert type(c).__module__ == "ceph_tpu_torch.compressor.zlib"
