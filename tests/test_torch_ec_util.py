"""The port's OSD stripe math (ceph_tpu_torch.osd.ec_util) against
ceph_tpu.osd.ec_util, on device="cpu".

The same seeded numpy inputs go through both packages; the tolerance is
byte equality.  Each configuration runs on both of the port's lanes: the
native C lane (the real ``host_engine_active`` gate, which a CPU codec
passes) and the device lane (the gate patched off, so a CPU codec takes
the plain torch version of the kernels).  The reference runs as its own
tests run it on the CPU.
"""

import json

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.utils import native as ref_native

from ceph_tpu_torch.models import registry
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_util import HashInfo, StripeHashes, StripeInfo
from ceph_tpu_torch.utils import buffers, native

# name -> (plugin, profile, shards to lose)
CONFIGS = {
    "isa RS(8,3)": ("isa", {"k": "8", "m": "3"}, (1, 5, 9)),
    "jerasure reed_sol_van k=2 m=1": (
        "jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1"}, (0,)),
    "jerasure cauchy_good k=4 m=2 ps=32": (
        "jerasure", {"technique": "cauchy_good", "k": "4", "m": "2",
                     "packetsize": "32"}, (0, 4)),
    "lrc k=8 m=4 l=3": ("lrc", {"k": "8", "m": "4", "l": "3"}, (0,)),
    "shec k=8 m=4 c=3": ("shec", {"k": "8", "m": "4", "c": "3"}, (0, 2)),
}
STRIPES = 5
LANES = ("native", "device")


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for s in want:
        assert np.array_equal(np.asarray(got[s]), np.asarray(want[s])), f"shard {s}"


@pytest.fixture(params=LANES)
def lane(request, monkeypatch):
    """The port's routing gate: the real one (a CPU codec takes the
    native C lane), or forced off (the device lane, plain torch on the
    CPU).  The reference's gate is left as it is."""
    if request.param == "device":
        monkeypatch.setattr(native, "host_engine_active", lambda device=None: False)
    return request.param


@pytest.fixture(scope="module")
def reference():
    """Per configuration: the codecs of both packages, a StripeInfo,
    the seeded data, and the reference's bytes for every call."""
    out = {}
    for i, (name, (plugin, profile, lost)) in enumerate(CONFIGS.items()):
        ref = ref_registry.instance().factory(plugin, dict(profile))
        k = ref.get_data_chunk_count()
        cs = ref.get_chunk_size(k * 512)
        ref_sinfo = ref_ec_util.StripeInfo(k * cs, cs)
        data = np.random.default_rng(100 + i).integers(
            0, 256, size=STRIPES * k * cs, dtype=np.uint8)
        shards = ref_ec_util.encode(ref_sinfo, ref, data)
        survivors = {s: v for s, v in shards.items() if s not in lost}
        out[name] = {
            "data": data, "lost": lost, "k": k, "cs": cs,
            "shards": shards, "survivors": survivors,
            "decode": ref_ec_util.decode(ref_sinfo, ref, survivors),
            "concat": bytes(ref_ec_util.decode_concat(ref_sinfo, ref, survivors)),
        }
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_decode_match_reference(name, lane, reference):
    """encode / decode / decode_concat and the *_fallback host lane give
    the reference's bytes."""
    plugin, profile, _ = CONFIGS[name]
    r = reference[name]
    codec = registry.instance().factory(plugin, dict(profile), device="cpu")
    sinfo = StripeInfo(r["k"] * r["cs"], r["cs"])
    _same(ec_util.encode(sinfo, codec, r["data"]), r["shards"])
    _same(ec_util.encode_fallback(sinfo, codec, r["data"]), r["shards"])
    _same(ec_util.decode(sinfo, codec, r["survivors"]), r["decode"])
    _same(ec_util.decode_fallback(sinfo, codec, r["survivors"]), r["decode"])
    assert bytes(ec_util.decode_concat(sinfo, codec, r["survivors"])) == r["concat"]
    assert bytes(ec_util.decode_concat_fallback(sinfo, codec, r["survivors"])) == r["concat"]
    if plugin != "lrc":
        assert r["concat"] == r["data"].tobytes()


def test_lrc_shard_numbering_differs_from_its_chunk_mapping():
    """Both packages' ``ec_util.encode`` key LRC shards as data 0..k-1
    then parity, while ``LrcErasureCode.decode`` reads the keys as chunk
    positions of its mapping (data at 0, 1, 4, 5, ...): a decode_concat
    that must rebuild shard 0 returns other bytes in both packages,
    alike.  The port keeps the reference's bytes; the fault is the
    reference's (ROADMAP Queue C)."""
    port = registry.instance().factory("lrc", {"k": "8", "m": "4", "l": "3"}, device="cpu")
    assert port.get_chunk_mapping() == [0, 1, 4, 5, 8, 9, 12, 13]
    cs = port.get_chunk_size(8 * 512)
    sinfo = StripeInfo(8 * cs, cs)
    data = np.random.default_rng(0).integers(0, 256, size=2 * 8 * cs, dtype=np.uint8)
    shards = ec_util.encode(sinfo, port, data)
    intact = {s: v for s, v in shards.items() if s != 15}
    assert bytes(ec_util.decode_concat(sinfo, port, intact)) == data.tobytes()
    lost0 = {s: v for s, v in shards.items() if s != 0}
    assert bytes(ec_util.decode_concat(sinfo, port, lost0)) != data.tobytes()


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_matches_per_stripe_loop(name, lane, reference):
    """The batched call equals the reference's stripe-by-stripe codec
    loop (reference:ECUtil.cc:113-120), run through the port's codec."""
    plugin, profile, _ = CONFIGS[name]
    r = reference[name]
    codec = registry.instance().factory(plugin, dict(profile), device="cpu")
    k, cs = r["k"], r["cs"]
    sinfo = StripeInfo(k * cs, cs)
    n = codec.get_chunk_count()
    batched = ec_util.encode(sinfo, codec, r["data"].tobytes())
    for s in range(STRIPES):
        stripe = r["data"][s * k * cs:(s + 1) * k * cs]
        chunks = codec.encode_prepare(stripe)
        parity = np.asarray(codec.encode_chunks(chunks))
        for i in range(n):
            want = chunks[i] if i < k else parity[i - k]
            assert np.array_equal(batched[i][s * cs:(s + 1) * cs], want), (s, i)


def test_lanes_route_as_the_gate_says(lane):
    """The native lane runs the C engine for a plain w=8 matrix codec on
    the CPU; the device lane takes the shard entry; a CUDA-free gate
    never admits a codec off the CPU."""
    codec = registry.instance().factory("isa", {"k": "4", "m": "2"}, device="cpu")
    sinfo = StripeInfo(4 * 512, 512)
    assert ec_util.native_encode_path(sinfo, codec) == (lane == "native")
    assert ec_util.native_decode_path(codec, 1024) == (lane == "native")
    assert not ec_util.native_decode_path(codec, 1028)
    assert native.host_engine_active(None) is False


def test_gate_keys_on_the_codec_device():
    assert native.host_engine_active("cpu") is True
    assert native.host_engine_active(None) is False
    assert native.host_engine_active("cuda") is False
    assert native.host_engine_active("cuda:0") is False


class TestStripeInfo:
    OFFSETS = (0, 1, 100, 1023, 1024, 4095, 4096, 4097, 8191, 8192, 12345)

    @pytest.mark.parametrize("sw,cs", [(4096, 1024), (32768, 4096), (12, 4)])
    def test_algebra_matches_reference(self, sw, cs):
        port, ref = StripeInfo(sw, cs), ref_ec_util.StripeInfo(sw, cs)
        assert port.k == ref.k
        for off in self.OFFSETS:
            for fn in ("logical_to_prev_chunk_offset", "logical_to_next_chunk_offset",
                       "logical_to_prev_stripe_offset", "logical_to_next_stripe_offset"):
                assert getattr(port, fn)(off) == getattr(ref, fn)(off), (fn, off)
            for length in (0, 1, 3900, 4000, 4097):
                assert (port.offset_len_to_stripe_bounds(off, length)
                        == ref.offset_len_to_stripe_bounds(off, length))
        for n in (0, 1, 2, 7):
            assert port.aligned_logical_offset_to_chunk_offset(n * sw) == n * cs
            assert port.aligned_chunk_offset_to_logical_offset(n * cs) == n * sw

    def test_bad_width(self):
        with pytest.raises(ValueError):
            StripeInfo(stripe_width=4100, chunk_size=1024)

    def test_pad(self):
        s = StripeInfo(4096, 1024)
        before = buffers.copied_bytes("ec_gather")
        assert bytes(s.pad_to_stripe(b"x" * 100)) == b"x" * 100 + bytes(3996)
        assert buffers.copied_bytes("ec_gather") == before + 100
        data = b"x" * 4096
        assert s.pad_to_stripe(data) is data


def test_bad_shapes_rejected_like_the_reference():
    codec = registry.instance().factory("isa", {"k": "4", "m": "2"}, device="cpu")
    sinfo = StripeInfo(4 * 512, 512)
    for fn in (ec_util.encode, ec_util.encode_fallback):
        with pytest.raises(ValueError):
            fn(sinfo, codec, b"x" * 100)
    with pytest.raises(ValueError):
        ec_util.decode(sinfo, codec, {0: np.zeros(512, np.uint8),
                                      1: np.zeros(1024, np.uint8)})
    with pytest.raises(ValueError):
        ec_util.encode(StripeInfo(2 * 512, 512), codec, bytes(1024))  # k mismatch
    bm = registry.instance().factory(
        "jerasure", {"technique": "cauchy_good", "k": "2", "m": "1",
                     "packetsize": "32"}, device="cpu")
    with pytest.raises(ValueError, match="batch alignment"):
        ec_util.encode(StripeInfo(2 * 128, 128), bm, bytes(256))


def test_shards_to_logical_inverts_encode():
    codec = registry.instance().factory("isa", {"k": "3", "m": "2"}, device="cpu")
    sinfo = StripeInfo(3 * 256, 256)
    data = np.random.default_rng(7).integers(0, 256, size=4 * 768, dtype=np.uint8)
    shards = ec_util.encode(sinfo, codec, data)
    assert bytes(ec_util.shards_to_logical([shards[i] for i in range(3)], 256)) \
        == data.tobytes()


class TestCrc32c:
    @pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 200, 4096, 100003])
    def test_matches_reference(self, n):
        buf = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
        for seed in (0xFFFFFFFF, 0, 123456789):
            want = ref_native.crc32c(seed, buf)
            assert native.crc32c(seed, buf) == want
            assert native.crc32c_table(seed, buf) == want
            assert native.crc32c(seed, buf.tobytes()) == want

    def test_known_vector_and_composition(self):
        assert (~native.crc32c(0xFFFFFFFF, b"123456789")) & 0xFFFFFFFF == 0xE3069283
        whole = native.crc32c(0xFFFFFFFF, b"hello world")
        assert whole == native.crc32c(native.crc32c(0xFFFFFFFF, b"hello "), b"world")
        assert native.crc32c(123, b"") == 123

    def test_bufferlist_crc_chains_segments(self):
        bl = buffers.BufferList(b"hello ").append(bytearray(b"world"))
        assert bl.nseg == 2
        assert bl.crc32c(0xFFFFFFFF) == ref_native.crc32c(0xFFFFFFFF, b"hello world")


def test_native_encode_matches_reference_engine():
    """The port's copy of the C engine against the reference's, on both
    widths and on the fused stripe-layout entry."""
    rng = np.random.default_rng(11)
    for w in (8, 16):
        matrix = rng.integers(0, 1 << w, size=(3, 5))
        data = rng.integers(0, 256, size=(5, 1024), dtype=np.uint8)
        assert np.array_equal(native.encode(matrix, data, w),
                              ref_native.encode(matrix, data, w))
    matrix = rng.integers(0, 256, size=(3, 4))
    buf = rng.integers(0, 256, size=6 * 4 * 64, dtype=np.uint8)
    assert np.array_equal(native.encode_stripes(matrix, buf, 6, 64),
                          ref_native.encode_stripes(matrix, buf, 6, 64))
    with pytest.raises(ValueError):
        native.encode(rng.integers(0, 256, size=(2, 33)),
                      np.zeros((33, 64), np.uint8))


class TestHashesCrossPackage:
    """The persisted xattr state (``to_dict``) crosses between packages
    both ways and keeps verifying."""

    def _shards(self, n, size, seed):
        rng = np.random.default_rng(seed)
        return {i: rng.integers(0, 256, size=size, dtype=np.uint8) for i in range(n)}

    def test_stripe_hashes_both_ways(self):
        a, b = self._shards(3, 64, 1), self._shards(3, 32, 2)
        port, ref = StripeHashes(3, 16), ref_ec_util.StripeHashes(3, 16)
        for sh in (port, ref):
            sh.set_range(0, a)
            sh.set_range(5, b)  # a hole: stripes 4
        assert port.to_dict() == ref.to_dict()
        from_ref = StripeHashes.from_dict(json.loads(json.dumps(ref.to_dict())))
        from_port = ref_ec_util.StripeHashes.from_dict(port.to_dict())
        assert from_ref.to_dict() == ref.to_dict()
        assert from_port.to_dict() == port.to_dict()
        for i in range(3):
            assert from_ref.verify(i, 0, a[i]) and from_port.verify(i, 5, b[i])
            assert from_ref.verify(i, 4, np.zeros(16, np.uint8))
        from_ref.truncate_stripes(2)
        ref.truncate_stripes(2)
        assert from_ref.to_dict() == ref.to_dict()

    def test_hash_info_both_ways(self):
        port, ref = HashInfo(3), ref_ec_util.HashInfo(3)
        a, b = self._shards(3, 64, 3), self._shards(3, 32, 4)
        for hi in (port, ref):
            hi.append(0, a)
            hi.append(64, b)
        assert port.to_dict() == ref.to_dict()
        assert HashInfo.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
        assert ref_ec_util.HashInfo.from_dict(port.to_dict()).to_dict() == port.to_dict()
        for s in range(3):
            whole = np.concatenate([a[s], b[s]])
            assert port.get_chunk_hash(s) == ref_native.crc32c(0xFFFFFFFF, whole)

    def test_hash_info_rejects_gaps_and_clears(self):
        hi = HashInfo(2)
        with pytest.raises(ValueError):
            hi.append(10, {0: np.zeros(4, np.uint8), 1: np.zeros(4, np.uint8)})
        hi.append(0, {0: np.ones(8, np.uint8), 1: np.ones(8, np.uint8)})
        hi.clear()
        assert hi.get_total_chunk_size() == 0
        assert hi.get_chunk_hash(0) == 0xFFFFFFFF


@pytest.mark.parametrize("m,S,cs", [(3, 96, 4096), (4, 13, 32768), (12, 5, 64)])
def test_encode_stripes_matches_the_reference(m, S, cs):
    """The fused stripe encode over OSD-sized batches (3 MiB of ISA
    stripes, a cauchy-sized chunk) and a matrix too tall for the GFNI
    body: the reference engine's bytes, and the flat encode's parity."""
    rng = np.random.default_rng(13 + m)
    k = 8
    matrix = rng.integers(0, 256, size=(m, k))
    buf = rng.integers(0, 256, size=S * k * cs, dtype=np.uint8)
    out = native.encode_stripes(matrix, buf, S, cs)
    assert np.array_equal(out, ref_native.encode_stripes(matrix, buf, S, cs))
    data = buf.reshape(S, k, cs).transpose(1, 0, 2).reshape(k, S * cs)
    assert np.array_equal(out[:k], data)
    assert np.array_equal(out[k:], native.encode(matrix, data))
