"""The port's LRC and SHEC plugins against the reference (layered +
shingled codes).

Twins of ``tests/test_lrc_shec.py``, every test, with the port's
registry on ``device="cpu"`` (the plain versions of the kernels).  Each
encode is also held against the reference's codec built from the same
profile: the chunks must be equal byte for byte.  The reference follows
reference:src/test/erasure-code/TestErasureCodeLrc.cc and
TestErasureCodeShec*.cc semantics: layer generation from k/m/l, local
-repair read sets, multi-failure decode, unrecoverable-pattern errors.
"""

import itertools
import json

import numpy as np
import pytest

from ceph_tpu_torch.models import instance
from ceph_tpu_torch.models.interface import ErasureCodeValidationError
from ceph_tpu_torch.models.shec import shec_matrix

RNG = np.random.default_rng(31)


def make(plugin, profile):
    return instance().factory(plugin, profile, device="cpu")


def _ref_encode(plugin, profile, payload):
    from ceph_tpu.models import instance as ref_instance

    ref = ref_instance().factory(plugin, dict(profile))
    return ref.encode(range(ref.get_chunk_count()), payload)


def _same_as_reference(plugin, profile, enc, payload):
    ref = _ref_encode(plugin, profile, payload)
    assert set(ref) == set(enc)
    for i in ref:
        assert np.array_equal(np.asarray(enc[i]), np.asarray(ref[i])), i


class TestLrc:
    def test_kml_generation(self):
        codec = make("lrc", {"k": "4", "m": "2", "l": "3"})
        # groups = (4+2)/3 = 2 -> group width l+1 = 4, 2 data + 2 parity each
        assert codec.get_chunk_count() == 8
        assert codec.get_data_chunk_count() == 4
        assert codec.mapping == "DD__DD__"
        # layer 0 global (DDc_DDc_), layers 1..2 local (DDDc / ____DDDc)
        assert len(codec.layers) == 3
        assert codec.layers[0].chunks_map == "DDc_DDc_"
        assert codec.layers[1].chunks_map == "DDDc____"
        assert codec.layers[2].chunks_map == "____DDDc"

    def test_kml_validation(self):
        with pytest.raises(ErasureCodeValidationError):
            make("lrc", {"k": "8", "m": "4", "l": "4"})  # k % groups != 0
        with pytest.raises(ErasureCodeValidationError):
            make("lrc", {"k": "4", "m": "2", "l": "5"})  # (k+m) % l != 0
        with pytest.raises(ErasureCodeValidationError):
            make("lrc", {"k": "4", "m": "2", "l": "3", "mapping": "x"})

    def test_roundtrip_and_local_repair(self):
        codec = make("lrc", {"k": "4", "m": "2", "l": "3"})
        n = codec.get_chunk_count()
        payload = RNG.integers(0, 256, size=5000, dtype=np.uint8).tobytes()
        enc = codec.encode(range(n), payload)
        _same_as_reference("lrc", {"k": "4", "m": "2", "l": "3"}, enc, payload)
        assert codec.decode_concat(enc)[: len(payload)] == payload

        # single data-chunk loss: the read set stays inside one local layer
        data_pos = codec.chunk_mapping[0]
        avail = [i for i in range(n) if i != data_pos]
        minimum = codec.minimum_to_decode([data_pos], avail)
        local = next(
            layer for layer in codec.layers[1:] if data_pos in layer.chunks_as_set
        )
        assert set(minimum) <= local.chunks_as_set
        assert len(minimum) == len(local.chunks) - 1

        dec = codec.decode([data_pos], {i: enc[i] for i in avail})
        assert np.array_equal(dec[data_pos], enc[data_pos])

    def test_multi_failure_via_layers(self):
        codec = make("lrc", {"k": "4", "m": "2", "l": "3"})
        n = codec.get_chunk_count()
        payload = RNG.integers(0, 256, size=1 << 14, dtype=np.uint8).tobytes()
        enc = codec.encode(range(n), payload)
        # lose one chunk from each local group + a global parity
        lost = [codec.layers[1].chunks[0], codec.layers[2].chunks[0]]
        avail = {i: c for i, c in enc.items() if i not in lost}
        dec = codec.decode(lost, avail)
        for i in lost:
            assert np.array_equal(dec[i], enc[i])

    def test_explicit_layers(self):
        # one explicit layer covering every position: k=4 m=4 inner code
        profile = {
            "mapping": "DD__DD__",
            "layers": json.dumps([["DDccDDcc", ""]]),
        }
        # mapping has 4 D, layer covers all positions: k=4 m=4 inner
        codec = make("lrc", profile)
        assert codec.get_data_chunk_count() == 4
        payload = b"hello lrc" * 100
        enc = codec.encode(range(8), payload)
        _same_as_reference("lrc", profile, enc, payload)
        assert codec.decode_concat(enc)[: len(payload)] == payload

    def test_uncovered_position_rejected(self):
        with pytest.raises(ErasureCodeValidationError):
            make(
                "lrc",
                {"mapping": "DD__", "layers": json.dumps([["DDc_", ""]])},
            )

    def test_minimum_to_decode_iterates_layers(self):
        """Patterns needing global-then-local recovery must not raise.

        Losing a data chunk plus its group's local parity ({0, 3}) defeats
        the local layer alone (2 erasures > its m=1), but the global layer
        recovers chunk 0 and then the local layer rebuilds parity 3 —
        minimum_to_decode must iterate to that fixed point like decode().
        """
        codec = make("lrc", {"k": "4", "m": "2", "l": "3"})
        n = codec.get_chunk_count()
        payload = RNG.integers(0, 256, size=4096, dtype=np.uint8).tobytes()
        enc = codec.encode(range(n), payload)
        for lost in itertools.combinations(range(n), 2):
            avail = [i for i in range(n) if i not in lost]
            try:
                dec = codec.decode(list(lost), {i: enc[i] for i in avail})
            except IOError:
                with pytest.raises(IOError):
                    codec.minimum_to_decode(list(lost), avail)
                continue
            # recoverable => minimum_to_decode agrees and its read set
            # really is sufficient
            minimum = codec.minimum_to_decode(list(lost), avail)
            assert set(minimum) <= set(avail), lost
            dec2 = codec.decode(list(lost), {i: enc[i] for i in minimum})
            for i in lost:
                assert np.array_equal(dec2[i], enc[i]), lost

    def test_unrecoverable(self):
        codec = make("lrc", {"k": "4", "m": "2", "l": "3"})
        n = codec.get_chunk_count()
        payload = b"x" * 4096
        enc = codec.encode(range(n), payload)
        # kill an entire local group plus its chunks' recovery paths:
        # losing 4 chunks of one group (l+1=4) is beyond m=... the global
        # layer can absorb 2, local 1 -> 4 from one group is fatal
        group = codec.layers[1].chunks
        lost = group[:4]
        avail = {i: c for i, c in enc.items() if i not in lost}
        with pytest.raises(IOError):
            codec.decode(lost, avail)


class TestShec:
    def test_matrix_shape_and_shingles(self):
        from ceph_tpu.models.shec import shec_matrix as ref_shec_matrix

        M = shec_matrix(8, 4, 3, 8)
        assert np.array_equal(M, ref_shec_matrix(8, 4, 3, 8))
        assert M.shape == (4, 8)
        # shingling must zero something overall (it's not plain RS) ...
        assert (M == 0).sum() > 0
        # ... and every column must be covered by at least one row
        assert all((M[:, j] != 0).any() for j in range(8))

    def test_single_erasures(self):
        codec = make("shec", {"k": "8", "m": "4", "c": "3"})
        n = codec.get_chunk_count()
        payload = RNG.integers(0, 256, size=1 << 14, dtype=np.uint8).tobytes()
        enc = codec.encode(range(n), payload)
        _same_as_reference("shec", {"k": "8", "m": "4", "c": "3"}, enc, payload)
        assert codec.decode_concat(enc)[: len(payload)] == payload
        for lost in range(n):
            avail = {i: c for i, c in enc.items() if i != lost}
            dec = codec.decode([lost], avail)
            assert np.array_equal(dec[lost], enc[lost])

    def test_minimum_reads_fewer_than_k(self):
        """Shingling means single-failure repair reads < k chunks."""
        codec = make("shec", {"k": "8", "m": "4", "c": "3"})
        n = codec.get_chunk_count()
        sizes = []
        for lost in range(codec.get_data_chunk_count()):
            avail = [i for i in range(n) if i != lost]
            sizes.append(len(codec.minimum_to_decode([lost], avail)))
        assert min(sizes) < codec.get_data_chunk_count()

    def test_multi_erasure_consistency(self):
        """Patterns the solver accepts decode exactly; rejected ones raise."""
        codec = make("shec", {"k": "4", "m": "3", "c": "2"})
        n = codec.get_chunk_count()
        payload = RNG.integers(0, 256, size=4096, dtype=np.uint8).tobytes()
        enc = codec.encode(range(n), payload)
        recovered = failed = 0
        for nlost in (2, 3):
            for lost in itertools.combinations(range(n), nlost):
                avail = {i: c for i, c in enc.items() if i not in lost}
                try:
                    dec = codec.decode(list(lost), avail)
                except IOError:
                    failed += 1
                    continue
                recovered += 1
                for i in lost:
                    assert np.array_equal(dec[i], enc[i]), lost
        # c=2 guarantees all double failures are recoverable
        assert recovered >= 21  # all C(7,2) pairs
        assert failed > 0  # some triples must be unrecoverable (non-MDS)

    def test_profile_validation(self):
        with pytest.raises(ErasureCodeValidationError):
            make("shec", {"k": "4", "m": "2", "c": "3"})  # c > m
        with pytest.raises(ErasureCodeValidationError):
            make("shec", {"k": "4", "m": "2", "c": "2", "w": "9"})
