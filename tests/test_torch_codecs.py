"""The port's codec layer (ceph_tpu_torch.models) against ceph_tpu's and
the committed corpus, on device="cpu".

Every comparison is bit-exact.  Inputs are the corpus payloads or come
from ``np.random.default_rng(seed)``.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.models.interface import (
    ErasureCodeValidationError as RefValidationError,
)
from ceph_tpu.tools.ec_non_regression import payload as ref_payload

from ceph_tpu_torch.models import registry
from ceph_tpu_torch.models.interface import ErasureCodeValidationError
from ceph_tpu_torch.models.matrix_codec import (
    BitmatrixErasureCode,
    MatrixErasureCode,
    classify_engine_error,
)
from ceph_tpu_torch.models.state import codec_from_arrays
from ceph_tpu_torch.ops.gf_cuda import KernelLaunchError
from ceph_tpu_torch.tools import bench_sweep, ec_benchmark, ec_non_regression

CORPUS = pathlib.Path(__file__).parent / "golden" / "ec_corpus"
CORPUS_DIRS = sorted(p.name for p in CORPUS.iterdir() if p.is_dir())


def _port(plugin, profile):
    return registry.instance().factory(plugin, dict(profile), device="cpu")


def _ref(plugin, profile):
    return ref_registry.instance().factory(plugin, dict(profile))


def test_corpus_has_thirteen_directories():
    assert len(CORPUS_DIRS) == 13


@pytest.mark.parametrize("name", CORPUS_DIRS)
def test_corpus_check(name):
    """The port's ec_non_regression --check: stored bytes re-encode
    identically, and every 1- and 2-erasure decode round-trips."""
    ec_non_regression.check(CORPUS / name, device="cpu")


@pytest.mark.parametrize("name", CORPUS_DIRS)
def test_port_matches_reference_codec(name):
    """Encode, and decode for one and for m erasures, equal ceph_tpu's."""
    manifest = json.loads((CORPUS / name / "manifest.json").read_text())
    plugin, profile = manifest["plugin"], manifest["profile"]
    port, ref = _port(plugin, profile), _ref(plugin, profile)
    n, k = ref.get_chunk_count(), ref.get_data_chunk_count()
    assert (port.get_chunk_count(), port.get_data_chunk_count()) == (n, k)
    data = ref_payload(3 * manifest["size"] + 5)  # a ragged object size
    want = ref.encode(list(range(n)), data)
    got = port.encode(list(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), f"chunk {i}"
    for erased in ([0], list(range(n - k))):
        avail = {i: want[i] for i in range(n) if i not in erased}
        try:
            ref_out = ref.decode(erased, avail)
        except IOError:
            with pytest.raises(IOError):
                port.decode(erased, avail)
            continue
        port_out = port.decode(erased, avail)
        for e in erased:
            assert np.array_equal(port_out[e], ref_out[e]), f"erased {erased} at {e}"


def test_batched_encode_and_tensor_input_match_reference():
    """encode_chunks over many stripes, numpy in and tensor in, and the
    lane paths equal the reference's."""
    profile = {"k": "8", "m": "3"}
    port, ref = _port("isa", profile), _ref("isa", profile)
    data = np.random.default_rng(11).integers(0, 256, size=(8, 4096), dtype=np.uint8)
    want = np.asarray(ref.encode_chunks(data))
    assert np.array_equal(port.encode_chunks(data), want)
    got_t = port.encode_chunks(torch.from_numpy(data))
    assert isinstance(got_t, torch.Tensor) and np.array_equal(got_t.numpy(), want)
    d32 = data.view(np.uint32)
    assert np.array_equal(port.encode_chunks_u32(d32), np.asarray(ref.encode_chunks_u32(d32)))
    d3 = np.ascontiguousarray(data.reshape(8, 4, 1024).transpose(1, 0, 2)).view(np.uint32)
    assert np.array_equal(
        port.encode_shards_u32(d3), np.asarray(ref.encode_shards_u32(d3))
    )
    # not a whole number of lanes: ceph_tpu's device path refuses it, the
    # port pads it; both equal the reference's host oracle
    ragged = data[:, :1001]
    assert np.array_equal(port.encode_chunks(ragged), ref.encode_chunks_host(ragged))


def test_lrc_encode_keeps_tensors_on_the_device():
    codec = _port("lrc", {"k": "8", "m": "4", "l": "3"})
    data = np.random.default_rng(13).integers(0, 256, size=(8, 1024), dtype=np.uint8)
    got = codec.encode_chunks(torch.from_numpy(data))
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), codec.encode_chunks(data))
    assert np.array_equal(got.numpy(), codec.encode_chunks_host(data))


@pytest.mark.parametrize("missing", [[0], [0, 1, 4]])
def test_lrc_decode_keeps_tensors_on_the_device(missing):
    codec = _port("lrc", {"k": "8", "m": "4", "l": "3"})
    data = np.random.default_rng(14).integers(0, 256, size=(8, 1024), dtype=np.uint8)
    parity = codec.encode_chunks(data)
    mapping = codec.get_chunk_mapping()
    coding = [i for i in range(codec.get_chunk_count()) if i not in mapping]
    full = np.zeros((codec.get_chunk_count(), data.shape[1]), dtype=np.uint8)
    full[mapping], full[coding] = data, parity
    present = [i for i in range(codec.get_chunk_count()) if i not in missing]
    want = codec.decode_chunks(present, full[present], missing)
    assert np.array_equal(want, full[missing])
    got = codec.decode_chunks(present, torch.from_numpy(full[present]), missing)
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), want)
    # a dict of host and device chunks decodes on the device
    mixed = {i: (torch.from_numpy(full[i]) if i % 2 else full[i]) for i in present}
    out = codec.decode(missing, mixed)
    assert all(isinstance(out[i], torch.Tensor) for i in missing)
    assert np.array_equal(np.stack([out[i].numpy() for i in missing]), want)


def test_host_engines_match_device_engines():
    rng = np.random.default_rng(12)
    for plugin, profile in (
        ("isa", {"k": "4", "m": "2"}),
        ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "16"}),
        ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2", "packetsize": "16"}),
        ("shec", {"k": "6", "m": "3", "c": "2"}),
        ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ):
        codec = _port(plugin, profile)
        k = codec.get_data_chunk_count()
        C = codec.get_chunk_size(3000)
        data = rng.integers(0, 256, size=(k, 2 * C), dtype=np.uint8)
        parity = codec.encode_chunks(data)
        assert np.array_equal(parity, codec.encode_chunks_host(data)), plugin
        if plugin == "lrc":
            continue
        chunks = np.concatenate([data, parity])
        present = list(range(1, codec.get_chunk_count()))
        dev = codec.decode_chunks(present, chunks[present], [0])
        host = codec.decode_chunks_host(present, chunks[present], [0])
        assert np.array_equal(dev, host) and np.array_equal(dev[0], data[0]), plugin


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"k": "8", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "16"}),
    ("jerasure", {"technique": "cauchy_good", "k": "6", "m": "3", "packetsize": "32"}),
    ("jerasure", {"technique": "liberation", "k": "5", "m": "2", "w": "7", "packetsize": "16"}),
])
def test_codec_from_arrays(plugin, profile):
    """A reference codec's numpy state alone rebuilds the same bytes."""
    ref = _ref(plugin, profile)
    port = codec_from_arrays(
        ref.k, ref.m, ref.w,
        matrix=getattr(ref, "matrix", None),
        bitmatrix=getattr(ref, "bitmatrix", None),
        packetsize=getattr(ref, "packetsize", None),
        chunk_mapping=ref.get_chunk_mapping(),
        device="cpu",
    )
    kind = BitmatrixErasureCode if hasattr(ref, "bitmatrix") else MatrixErasureCode
    assert isinstance(port, kind)
    data = ref_payload(20000)
    n = ref.get_chunk_count()
    want, got = ref.encode(list(range(n)), data), port.encode(list(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i])


BAD_PROFILES = [
    ("jerasure", {"technique": "no_such"}),
    ("jerasure", {"technique": "reed_sol_van", "w": "7"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "m": "3"}),
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2", "w": "8"}),
    ("jerasure", {"technique": "liber8tion", "k": "9", "m": "2"}),
    ("jerasure", {"k": "x"}),
    ("isa", {"technique": "bogus"}),
    ("isa", {"k": "250", "m": "10"}),
    ("lrc", {"k": "8", "m": "4", "l": "4"}),
    ("lrc", {"mapping": "DD_"}),
    ("shec", {"k": "4", "m": "2", "c": "3"}),
    ("shec", {"w": "32"}),
]


@pytest.mark.parametrize("plugin,profile", BAD_PROFILES)
def test_bad_profiles_raise_validation_error(plugin, profile):
    with pytest.raises(RefValidationError):
        _ref(plugin, profile)
    with pytest.raises(ErasureCodeValidationError):
        _port(plugin, profile)


def test_registry_is_the_ports_own():
    reg = registry.instance()
    assert registry.DEFAULT_DIRECTORY == "ceph_tpu_torch.models"
    assert reg is not ref_registry.instance()
    lrc = reg.factory("lrc", {"k": "4", "m": "2", "l": "3"}, device="cpu")
    assert all(layer.erasure_code.device == torch.device("cpu") for layer in lrc.layers)
    assert type(reg.get("jerasure")).__module__ == "ceph_tpu_torch.models.jerasure"
    with pytest.raises(registry.ErasureCodePluginError):
        reg.factory("no_such_plugin", {}, device="cpu")


BROKEN_PLUGINS = {
    # name: (module body after the version line, expected error)
    "fail_to_initialize": ("def __erasure_code_init__(name, registry):\n"
                           "    raise RuntimeError('cannot initialize')\n", "failed"),
    "fail_to_register": ("def __erasure_code_init__(name, registry):\n"
                         "    return None\n", "did not register"),
    "missing_entry_point": ("", "entry point"),
    "missing_version": (None, "__erasure_code_version__"),
    "bad_version": ("__erasure_code_version__ = 'another-version'\n", "!= expected"),
}


@pytest.fixture(scope="module")
def port_broken_plugins(tmp_path_factory):
    """The broken-plugin fixtures of tests/broken_plugins, rewritten
    against the port's plugin version (those import ceph_tpu's)."""
    root = tmp_path_factory.mktemp("port_plugins")
    pkg = root / "port_broken_plugins"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    for name, (body, _) in BROKEN_PLUGINS.items():
        head = "" if body is None else f"__erasure_code_version__ = {registry.PLUGIN_VERSION!r}\n"
        (pkg / f"{name}.py").write_text(head + (body or ""))
    sys.path.insert(0, str(root))
    yield "port_broken_plugins"
    sys.path.remove(str(root))


@pytest.mark.parametrize("name", sorted(BROKEN_PLUGINS))
def test_broken_plugins(port_broken_plugins, name):
    reg = registry.ErasureCodePluginRegistry()
    with pytest.raises(registry.ErasureCodePluginError, match=BROKEN_PLUGINS[name][1]):
        reg.factory(name, {}, directory=port_broken_plugins, device="cpu")


def test_classify_engine_error():
    assert classify_engine_error(KernelLaunchError("launch")) == "fatal"
    assert classify_engine_error(torch.OutOfMemoryError("oom")) == "fatal"
    assert classify_engine_error(RuntimeError("unknown")) == "fatal"
    assert classify_engine_error(ValueError("shape")) == "data"
    assert classify_engine_error(IOError("cannot decode")) == "data"
    assert classify_engine_error(ErasureCodeValidationError("bad")) == "data"


def test_ec_benchmark_cli(capsys):
    for workload in ("encode", "decode"):
        assert ec_benchmark.main([
            "--plugin", "isa", "-p", "k=4", "-p", "m=2", "--workload", workload,
            "--size", "65536", "--iterations", "2", "--device", "cpu",
        ]) == 0
        seconds, kib = capsys.readouterr().out.strip().split("\t")
        assert float(seconds) > 0 and int(kib) == 128


def test_bench_sweep_quick_cells(capsys):
    """``bench_sweep --quick`` (the reference's ``test_tools.py``
    ``TestSweep``) on the CPU: one line a cell, each with a rate."""
    bench_sweep.main(["--quick", "--size", "2048", "--workloads", "encode", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    # 2 plugins x 2 techniques x 2 k-values x 1 workload
    assert len(lines) == 8
    for cell in lines:
        assert "error" not in cell, cell
        assert cell["gbps"] > 0
    assert [(c["plugin"], c["technique"], c["k"], c["m"]) for c in lines] == [
        (plugin, tech, k, m) for plugin, techs in bench_sweep.PLUGINS.items()
        for tech in techs for k, m in ((2, 1), (4, 2))]
