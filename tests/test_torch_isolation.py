"""The port stands alone and never falls back.

- Every ``ceph_tpu_torch`` module, ``chip_smoke.py`` and
  ``trace_windows.py`` import with ``jax``, ``jaxlib`` and ``ceph_tpu``
  blocked.  This runs in a subprocess, because this suite's conftest
  imports jax.
- Without CUDA, the default entry points and any request for ``cuda``
  raise; nothing lands on the CPU unless asked to.
- A CPU tensor takes the plain version and leaves the kernels' launch
  counts unchanged; a kernel wrapper refuses a CPU tensor.  This holds
  for the CRUSH draw (``crush_straw2``) and its entry points
  (``vec_do_rule``, ``CrushTester``, ``crushtool --test``) too, and for
  the churn planner (``ChurnPlanner``), whose device path raises on a
  fault instead of falling back to the scalar walk.
- The accelerator daemon owns the card: ``AccelDaemon()`` and the
  ``accel`` role of ``tools.daemon`` raise without CUDA unless given the
  CPU, with a mon (``mon_addr``, ``--monmap``) or an admin socket too;
  with ``osd_ec_mesh`` on, with or without a mon or a socket, it builds
  the mesh lane on CPU lanes when given the CPU, and without CUDA the
  mesh of the cards raises at its first use.  The ``osd`` role of
  ``tools.daemon`` raises without CUDA unless given the CPU too, before
  it makes its store.
- The mesh engine (``ceph_tpu_torch.parallel``) is among the modules
  that import with jax and ceph_tpu blocked, and an OSD built with
  ``osd_ec_mesh`` on serves EC writes and degraded reads through its
  mesh lane with nothing of them loaded.
- An external object class file (``cls_<name>.py`` under
  ``osd_class_dir``, importing ``ceph_tpu_torch.cls``) served by the
  port's OSD brings in nothing of ``jax`` or ``ceph_tpu``.
- The daemon processes a ``ProcCluster`` spawns (the mon and the OSDs),
  and a ``vstart --rgw`` process serving S3, import nothing of ``jax`` or
  ``ceph_tpu``: a ``sitecustomize`` on their path blocks and records any
  such import.  ``ProcCluster()`` and
  ``vstart`` (in process and ``--multiprocess``) raise without CUDA
  unless given the CPU.
"""

import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import mapper_torch
from ceph_tpu_torch.crush.map import CrushMap
from ceph_tpu_torch.crush.mapper_torch_hier import fused_rule, reweight_lanes, tables_for
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.device import DeviceUnavailableError, resolve
from ceph_tpu_torch.models import registry
from ceph_tpu_torch.osd.churn import ChurnPlanner, apply_churn, synthetic_map
from ceph_tpu_torch.ops import crush_cuda, crush_torch, gf_cuda, gf_torch, matrices as mx
from ceph_tpu_torch.tools import crushtool

REPO = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "ceph_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import ceph_tpu_torch
    names = ["chip_smoke", "trace_windows"] + [
        m.name for m in pkgutil.walk_packages(ceph_tpu_torch.__path__, "ceph_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not leaked, leaked
    print(" ".join(names))
""")

# every module of the OSD EC engine slice, in its two new subpackages too,
# and of the CRUSH slice
_SLICE_MODULES = {
    "ceph_tpu_torch.common.perf_counters", "ceph_tpu_torch.common.tracing",
    "ceph_tpu_torch.utils.arch", "ceph_tpu_torch.utils.native",
    "ceph_tpu_torch.utils.buffers", "ceph_tpu_torch.ops.profiler",
    "ceph_tpu_torch.ops.device_trace", "ceph_tpu_torch.models.matrix_codec",
    "ceph_tpu_torch.osd.ec_perf", "ceph_tpu_torch.osd.ec_util",
    "ceph_tpu_torch.osd.ec_transaction", "ceph_tpu_torch.osd.ec_failover",
    "ceph_tpu_torch.osd.ec_dispatch",
    "ceph_tpu_torch.crush", "ceph_tpu_torch.crush.ln_tables",
    "ceph_tpu_torch.crush.hashes", "ceph_tpu_torch.crush.map",
    "ceph_tpu_torch.crush.mapper", "ceph_tpu_torch.crush.encoding",
    "ceph_tpu_torch.crush.compiler", "ceph_tpu_torch.crush.mapper_torch",
    "ceph_tpu_torch.crush.mapper_torch_hier", "ceph_tpu_torch.crush.tester",
    "ceph_tpu_torch.ops.crush_torch", "ceph_tpu_torch.ops.crush_cuda",
    "ceph_tpu_torch.tools.crushtool",
    # the cluster map slice
    "ceph_tpu_torch.utils.str_hash", "ceph_tpu_torch.accel",
    "ceph_tpu_torch.accel.accelmap", "ceph_tpu_torch.osd.osdmap",
    "ceph_tpu_torch.store", "ceph_tpu_torch.store.kv", "ceph_tpu_torch.mon",
    "ceph_tpu_torch.mon.store", "ceph_tpu_torch.tools.osdmaptool",
    "ceph_tpu_torch.osd.churn",
    # the messenger and the shared accelerator service
    "ceph_tpu_torch.common.config", "ceph_tpu_torch.common.throttle",
    "ceph_tpu_torch.common.slab", "ceph_tpu_torch.common.recv_pool",
    "ceph_tpu_torch.common.clocksync", "ceph_tpu_torch.common.stack_ledger",
    "ceph_tpu_torch.common.heartbeat_map", "ceph_tpu_torch.common.log",
    "ceph_tpu_torch.auth", "ceph_tpu_torch.store.objectstore",
    "ceph_tpu_torch.msg", "ceph_tpu_torch.msg.message",
    "ceph_tpu_torch.msg.messages", "ceph_tpu_torch.msg.messenger",
    "ceph_tpu_torch.osd.scheduler", "ceph_tpu_torch.accel.client",
    "ceph_tpu_torch.accel.daemon", "ceph_tpu_torch.tools.daemon",
    "ceph_tpu_torch.tools.wire_profile",
    # the Monitor and the accelerator fleet
    "ceph_tpu_torch.mon.monitor", "ceph_tpu_torch.accel.router",
    "ceph_tpu_torch.tools.monmaptool",
    # the admin socket, kernel trace windows and the mgr
    "ceph_tpu_torch.common.admin_socket", "ceph_tpu_torch.common.op_tracker",
    "ceph_tpu_torch.mgr", "ceph_tpu_torch.mgr.daemon",
    "ceph_tpu_torch.mgr.modules", "ceph_tpu_torch.mgr.tsdb",
    "ceph_tpu_torch.mgr.trace_store",
    # the stores and the PG-level helpers beneath the OSD
    "ceph_tpu_torch.store.memstore", "ceph_tpu_torch.store.wal",
    "ceph_tpu_torch.store.blue", "ceph_tpu_torch.compressor",
    "ceph_tpu_torch.compressor.none", "ceph_tpu_torch.compressor.zlib",
    "ceph_tpu_torch.compressor.bz2", "ceph_tpu_torch.compressor.lzma",
    "ceph_tpu_torch.compressor.snappy", "ceph_tpu_torch.compressor.zstd",
    "ceph_tpu_torch.osd.pg_log", "ceph_tpu_torch.osd.snaps",
    "ceph_tpu_torch.osd.peering", "ceph_tpu_torch.osd.reservations",
    "ceph_tpu_torch.osd.client_ledger", "ceph_tpu_torch.common.lockdep",
    # the OSD daemon, its recovery, the client and MiniCluster
    "ceph_tpu_torch.osd", "ceph_tpu_torch.osd.daemon",
    "ceph_tpu_torch.osd.recovery", "ceph_tpu_torch.rados",
    "ceph_tpu_torch.rados.client", "ceph_tpu_torch.rados.cluster",
    "ceph_tpu_torch.rados.striper",
    # scrub and repair, cache tiering and object classes
    "ceph_tpu_torch.cls", "ceph_tpu_torch.cls.lock", "ceph_tpu_torch.cls.refcount",
    "ceph_tpu_torch.cls.version", "ceph_tpu_torch.cls.log", "ceph_tpu_torch.cls.numops",
    "ceph_tpu_torch.cls.rgw_index", "ceph_tpu_torch.cls.rbd_cls",
    "ceph_tpu_torch.osd.scrub", "ceph_tpu_torch.osd.tiering",
    # the process cluster, the storm driver and the client tools
    "ceph_tpu_torch.rados.proc_cluster", "ceph_tpu_torch.rados.storm",
    "ceph_tpu_torch.rados.object_cacher", "ceph_tpu_torch.tools.rados_cli",
    "ceph_tpu_torch.tools.ceph_cli", "ceph_tpu_torch.tools.vstart",
    "ceph_tpu_torch.tools.objectstore_tool", "ceph_tpu_torch.tools.monstore_tool",
    # the multi-device EC engine
    "ceph_tpu_torch.parallel", "ceph_tpu_torch.parallel.mesh",
    "ceph_tpu_torch.parallel.distributed", "ceph_tpu_torch.parallel.engine",
    # the RGW gateway and its admin tool
    "ceph_tpu_torch.rgw", "ceph_tpu_torch.rgw.store", "ceph_tpu_torch.rgw.http",
    "ceph_tpu_torch.rgw.sync", "ceph_tpu_torch.tools.rgw_admin",
    # CephFS, RBD and the last tools
    "ceph_tpu_torch.mds", "ceph_tpu_torch.mds.daemon", "ceph_tpu_torch.mds.fsclient",
    "ceph_tpu_torch.tools.cephfs_cli", "ceph_tpu_torch.rbd", "ceph_tpu_torch.rbd.image",
    "ceph_tpu_torch.rbd.journal", "ceph_tpu_torch.rbd.mirror", "ceph_tpu_torch.tools.rbd_cli",
    "ceph_tpu_torch.utils.isa_oracle", "ceph_tpu_torch.utils.native_crush",
    "ceph_tpu_torch.tools.bench_sweep",
}

# an external class file served by the port's OSD, with jax and ceph_tpu
# blocked: nothing of them may load on the way
_EXTERNAL_CLASS = textwrap.dedent("""
    import asyncio, sys, tempfile, pathlib
    sys.meta_path.insert(0, Block())
    from ceph_tpu_torch.rados import MiniCluster

    CLASS = (
        "from ceph_tpu_torch.cls import CLS_METHOD_RD, register_class\\n"
        "register_class('ext').method('hi', CLS_METHOD_RD)(lambda ctx, inp: {'hi': inp['n']})\\n"
    )

    async def main(d):
        async with MiniCluster(n_osds=3, device="cpu",
                               config_overrides={"osd_class_dir": d}) as cluster:
            cl = await cluster.client()
            await cl.create_pool("p", "replicated", size=3)
            io = cl.io_ctx("p")
            await io.write_full("obj", b"x")
            return await io.exec("obj", "ext", "hi", {"n": 7})

    with tempfile.TemporaryDirectory() as d:
        (pathlib.Path(d) / "cls_ext.py").write_text(CLASS)
        out = asyncio.run(asyncio.wait_for(main(d), 60))
    assert out == {"hi": 7}, out
    leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not leaked, leaked
    print("served", out)
""")


# an OSD with the mesh lane on, with jax and ceph_tpu blocked: an EC write
# and a degraded read go through the mesh, and nothing of them loads
_MESH_OSD = textwrap.dedent("""
    import asyncio, sys
    sys.meta_path.insert(0, Block())
    from ceph_tpu_torch.rados import MiniCluster

    async def main():
        async with MiniCluster(n_osds=4, device="cpu",
                               config_overrides={"osd_ec_mesh": True}) as cluster:
            cl = await cluster.client()
            await cl.create_pool("ec", "erasure")
            io = cl.io_ctx("ec")
            await io.write_full("obj", bytes(range(256)) * 16)
            enc = sum(o.perf.get("ec").get("mesh_encode_calls")
                      for o in cluster.osds.values())
            pool = cl.osdmap.lookup_pool("ec")
            _pg, acting, _p = cl.osdmap.object_to_acting("obj", pool.id)
            await cluster.kill_osd(acting[0])
            await cluster.wait_for_osd_down(acting[0])
            got = await io.read("obj")
            return (got == bytes(range(256)) * 16, enc,
                    sum(o.perf.get("ec").get("mesh_decode_calls")
                        for o in cluster.osds.values()))

    same, enc, dec = asyncio.run(asyncio.wait_for(main(), 60))
    assert same and enc > 0 and dec > 0, (same, enc, dec)
    leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not leaked, leaked
    assert "ceph_tpu_torch.parallel.engine" in sys.modules
    print("mesh lane served", enc, dec)
""")


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_port_imports_without_jax_or_ceph_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 80  # every module of the package
    assert _SLICE_MODULES <= names, _SLICE_MODULES - names


def test_an_osd_with_the_mesh_lane_brings_in_no_ceph_tpu():
    block = _BLOCKED_IMPORT.split("sys.meta_path.insert")[0]
    out = subprocess.run(
        [sys.executable, "-c", block + _MESH_OSD], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "mesh lane served" in out.stdout


def test_an_external_class_loaded_by_the_port_osd_brings_in_no_ceph_tpu():
    block = _BLOCKED_IMPORT.split("sys.meta_path.insert")[0]
    out = subprocess.run(
        [sys.executable, "-c", block + _EXTERNAL_CLASS], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "served {'hi': 7}" in out.stdout


def test_defaults_raise_without_cuda():
    _needs_no_cuda()
    with pytest.raises(DeviceUnavailableError):
        resolve()
    with pytest.raises(DeviceUnavailableError):
        registry.instance().factory("isa", {"k": "4", "m": "2"})
    with pytest.raises(DeviceUnavailableError):
        gf_torch.GFMatmul(mx.rs_vandermonde(4, 2, 8), 8, device="cuda")
    with pytest.raises(DeviceUnavailableError):
        gf_torch.BitmatrixXor(np.eye(8, dtype=np.uint8), device="cuda")
    with pytest.raises(ValueError):
        resolve("meta")


def test_cpu_tensor_takes_plain_version_and_kernel_refuses_it():
    matrix = mx.rs_vandermonde(4, 2, 8)
    d32 = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(4, 256), dtype=np.uint8)
    ).view(torch.int32)
    before = dict(gf_cuda.launches)
    out = gf_torch.GFMatmul(matrix, 8, device="cpu")(d32)
    assert torch.equal(out, gf_torch.gf_matmul_u32(matrix, d32, 8))
    bm = np.eye(4, dtype=np.uint8)
    assert torch.equal(gf_torch.BitmatrixXor(bm, device="cpu")(d32), d32)
    assert gf_cuda.launches == before
    table = gf_cuda.gf_table(matrix, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gf_cuda.gf_matmul(table, d32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gf_cuda.bitmatrix_xor(gf_cuda.bitmatrix_table(bm, torch.device("cpu")), d32)
    assert gf_cuda.launches == before


def test_crush_entry_points_raise_without_cuda_unless_asked_for_the_cpu(tmp_path, capsys):
    _needs_no_cuda()
    cmap = CrushMap.flat(8)
    rule = cmap.add_simple_rule(cmap.root_id(), 0)
    xs = np.arange(16, dtype=np.uint32)
    with pytest.raises(DeviceUnavailableError):
        mapper_torch.vec_do_rule(cmap, rule, xs, 3)
    with pytest.raises(DeviceUnavailableError):
        mapper_torch.vec_rule_stats(cmap, rule, xs, 3, device="cuda")
    with pytest.raises(DeviceUnavailableError):
        CrushTester(cmap)
    path = tmp_path / "map.json"
    assert crushtool.main(["--build", "8", "-o", str(path)]) == 0
    argv = ["-i", str(path), "--test", "--num-rep", "3", "--max-x", "15"]
    with pytest.raises(DeviceUnavailableError):
        crushtool.main(argv)
    assert mapper_torch.vec_do_rule(cmap, rule, xs, 3, device="cpu").shape == (16, 3)
    assert CrushTester(cmap, device="cpu").device.type == "cpu"
    assert crushtool.main(argv + ["--device", "cpu"]) == 0
    assert "vectorized" in capsys.readouterr().out


def test_crush_cpu_lanes_take_plain_version_and_kernel_refuses_them():
    cmap = CrushMap.flat(8)
    T = tables_for(cmap, torch.device("cpu")).rows
    x = torch.arange(64, dtype=torch.int32)
    rows, r = torch.zeros_like(x), torch.ones_like(x)
    before = dict(gf_cuda.launches)
    for got, want in zip(crush_torch.straw2(T, x, rows, r),
                         crush_torch.straw2_plain(T, x, rows, r)):
        assert torch.equal(got, want)
    rule = cmap.add_simple_rule(cmap.root_id(), 0)
    mapper_torch.vec_rule_stats(cmap, rule, np.arange(64), 3, device="cpu")
    assert gf_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        crush_cuda.crush_straw2(T, x, rows, r)
    assert gf_cuda.launches == before


def test_crush_choose_refuses_cpu_tensors_and_cpu_rules_launch_nothing():
    """The fused choose step: CPU lanes take its plain version (the step
    engine), a CPU ``vec_do_rule`` or ``vec_rule_stats`` launches no
    kernel, and the ``crush_choose`` wrapper refuses CPU tensors."""
    cpu = torch.device("cpu")
    flat = CrushMap.flat(8)
    flat_rule = flat.add_simple_rule(flat.root_id(), 0)
    h = CrushMap.hierarchical([list(range(4 * i, 4 * i + 4)) for i in range(4)])
    leaf_rule = h.add_simple_rule(h.root_id("default"), 1, indep=True)
    x = torch.arange(64, dtype=torch.int32)
    before = dict(gf_cuda.launches)
    for cmap, ruleno in ((flat, flat_rule), (h, leaf_rule)):
        T, rule = tables_for(cmap, cpu), fused_rule(cmap, ruleno, 3)
        rw = reweight_lanes(cmap, None, cpu)
        assert rule is not None
        assert torch.equal(mapper_torch.choose(T, rule, x, rw),
                           mapper_torch.crush_choose_plain(T, rule, x, rw))
        assert torch.equal(torch.from_numpy(mapper_torch.vec_do_rule(
            cmap, ruleno, np.arange(64), 3, device="cpu")),
            mapper_torch._step_engine(cmap, ruleno, x, 3, None))
        mapper_torch.vec_rule_stats(cmap, ruleno, np.arange(64), 3, device="cpu")
        assert gf_cuda.launches == before
        with pytest.raises(ValueError, match="CUDA tensors"):
            crush_cuda.crush_choose(T, rule, x, rw)
    assert gf_cuda.launches == before


def test_churn_planner_raises_without_cuda_unless_asked_for_the_cpu():
    _needs_no_cuda()
    m = synthetic_map(32, 8, replicated=(3, 16), ec=None)
    with pytest.raises(DeviceUnavailableError):
        ChurnPlanner(m)
    with pytest.raises(DeviceUnavailableError):
        ChurnPlanner(m, device="cuda")
    assert ChurnPlanner(m, device="cpu").device.type == "cpu"


def test_cpu_churn_plan_leaves_the_kernel_count_unchanged():
    m = synthetic_map(64, 8, replicated=(3, 32), ec=({"plugin": "isa", "k": "2", "m": "1"}, 32))
    before = dict(gf_cuda.launches)
    plan = ChurnPlanner(m, device="cpu").plan(apply_churn(m, kill=range(8)))
    assert plan.device and plan.remapped
    assert gf_cuda.launches == before


def test_a_fault_in_the_device_path_raises(monkeypatch):
    """No silent fallback: an error inside ``supports`` or the batched
    mapper reaches the caller of ``map_pool``, ``plan`` and
    ``verify_oracle``; it never turns into the scalar walk."""
    m = synthetic_map(32, 8, replicated=(3, 16), ec=None)
    pool = next(iter(m.pools.values()))
    planner = ChurnPlanner(m, device="cpu")

    def broken(*_args, **_kw):
        raise RuntimeError("injected fault")

    monkeypatch.setattr(mapper_torch, "supports", broken)
    for call in (lambda: planner.map_pool(m, pool), lambda: planner.plan(m),
                 lambda: planner.verify_oracle()):
        with pytest.raises(RuntimeError, match="injected fault"):
            call()
    monkeypatch.undo()
    monkeypatch.setattr(mapper_torch, "_engine", broken)
    with pytest.raises(RuntimeError, match="injected fault"):
        planner.map_pool(m, pool)
    monkeypatch.undo()
    assert planner.map_pool(m, pool).device


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    _needs_no_cuda()
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_accel_daemon_raises_without_cuda_unless_asked_for_the_cpu():
    _needs_no_cuda()
    from ceph_tpu_torch.accel import AccelDaemon

    with pytest.raises(DeviceUnavailableError):
        AccelDaemon()
    with pytest.raises(DeviceUnavailableError):
        AccelDaemon("accel.1", device="cuda")
    acc = AccelDaemon("accel.2", device="cpu")
    assert acc.device.type == "cpu"


def test_accel_role_of_the_daemon_tool_raises_without_cuda(tmp_path):
    _needs_no_cuda()
    from ceph_tpu_torch.tools import daemon

    with pytest.raises(DeviceUnavailableError):
        daemon.main(["accel", "--id", "0", "--addr", "127.0.0.1:0"])
    # a mon does not move the daemon off the card
    with pytest.raises(DeviceUnavailableError):
        daemon.main(["accel", "--id", "0", "--addr", "127.0.0.1:0",
                     "--monmap", "127.0.0.1:1", "--locality", "host0"])
    # so does the osd role, before it makes its store
    store = tmp_path / "osd.0"
    with pytest.raises(DeviceUnavailableError):
        daemon.main(["osd", "--id", "0", "--monmap", "127.0.0.1:1",
                     "--store", str(store)])
    assert not store.exists()
    # the mon role is ported: its arguments are checked, not refused
    with pytest.raises(SystemExit):
        daemon.main(["mon", "--rank", "0"])


def test_accel_role_serves_on_the_cpu_when_asked():
    """``--device cpu`` starts the daemon: it prints its address and
    stops cleanly on SIGTERM.  Every wait on the child is bounded."""
    import select
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon", "accel",
         "--id", "3", "--addr", "127.0.0.1:0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "the daemon printed nothing within 60 s"
        line = proc.stdout.readline()
        assert line.startswith("accel.3 up at 127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("what", ["mon_addr", "admin_socket", "osd_ec_mesh"])
def test_accel_daemon_refuses_what_is_not_ported(what, tmp_path):
    """Every option is ported: the daemon takes ``mon_addr`` and
    ``admin_socket``, and with each of them, or alone, ``osd_ec_mesh``
    builds the mesh lane on the CPU lanes of a ``device="cpu"`` daemon.
    Without CUDA, the mesh of the cards raises at its first use, not at
    construction."""
    from ceph_tpu_torch.accel import AccelDaemon
    from ceph_tpu_torch.common import Config
    from ceph_tpu_torch.parallel.engine import MeshEcEngine

    if what == "mon_addr":
        acc = AccelDaemon("accel.9", device="cpu", mon_addr="127.0.0.1:1")
        assert acc.mon_addr == "127.0.0.1:1" and acc.device.type == "cpu"
        assert acc.ec_mesh is None and not acc.dispatch.dump()["mesh_lane"]
        kw = {"mon_addr": ["127.0.0.1:1"],
              "config": Config({"osd_ec_mesh": True}, env="")}
    elif what == "admin_socket":
        path = str(tmp_path / "x.asok")
        acc = AccelDaemon("accel.9", device="cpu",
                          config=Config({what: path}, env=""))
        assert acc.config.admin_socket == path and acc.device.type == "cpu"
        assert acc.ec_mesh is None
        kw = {"config": Config({what: path, "osd_ec_mesh": True}, env="")}
    else:
        kw = {"config": Config({what: True}, env="")}
    acc = AccelDaemon("accel.9", device="cpu", **kw)
    assert acc.ec_mesh is not None and acc.dispatch.dump()["mesh_lane"]
    assert acc.ec_mesh.devices == [torch.device("cpu")] * 8
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            MeshEcEngine().mesh_for(8)


def test_dispatcher_accepts_a_remote_and_still_refuses_a_mesh():
    """The dispatcher takes a remote-lane client and a mesh engine, and
    refuses an object that is neither."""
    from ceph_tpu_torch.accel import AccelClient
    from ceph_tpu_torch.msg import AsyncMessenger, Dispatcher
    from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
    from ceph_tpu_torch.parallel.engine import MeshEcEngine

    client = AccelClient(AsyncMessenger("osd.0", Dispatcher()),
                         addr="127.0.0.1:1", mode="require")
    assert ECDispatcher(remote=client).dump()["remote"]["mode"] == "require"
    assert ECDispatcher(mesh_engine=MeshEcEngine(device="cpu"),
                        remote=client).dump()["mesh_lane"] is True
    with pytest.raises(ValueError, match="a mesh engine"):
        ECDispatcher(mesh_engine=object())


# a sitecustomize for a ProcCluster's children: blocks jax, jaxlib and
# ceph_tpu, and records its own loading and any blocked import
_CHILD_PROBE = textwrap.dedent("""
    import os, sys

    BLOCKED = ("jax", "jaxlib", "ceph_tpu")
    LOG = os.environ["PORT_PROBE_LOG"]

    def _note(line):
        with open(LOG, "a") as f:
            f.write(line + "\\n")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                _note(f"blocked {name} in {os.getpid()}")
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    _note(f"loaded {os.getpid()}")
""")


def test_proc_cluster_children_import_no_jax_or_ceph_tpu(tmp_path, monkeypatch):
    import asyncio
    import os

    from ceph_tpu_torch.rados import ProcCluster

    probe = tmp_path / "probe"
    probe.mkdir()
    (probe / "sitecustomize.py").write_text(_CHILD_PROBE)
    log = tmp_path / "probe.log"
    monkeypatch.setenv("PORT_PROBE_LOG", str(log))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(probe), os.environ.get("PYTHONPATH", "")) if p))

    async def main():
        pc = ProcCluster(str(tmp_path / "c"), n_osds=2, log_dir=str(tmp_path / "logs"),
                         device="cpu")
        try:
            async with asyncio.timeout(180):
                await pc.start(timeout=120)
                cl = await pc.client()
                await cl.create_pool("p", "replicated", size=2, pg_num=1)
                io = cl.io_ctx("p")
                await io.write_full("o", b"served by the port's daemons")
                assert await io.read("o") == b"served by the port's daemons"
                for proc in [*pc.osd_procs.values(), *pc.mon_procs.values()]:
                    assert proc.args[1:3] == ["-m", "ceph_tpu_torch.tools.daemon"]
                return {p.pid for p in [*pc.osd_procs.values(), *pc.mon_procs.values()]}
        finally:
            await pc.stop()

    pids = asyncio.run(main())
    lines = log.read_text().splitlines()
    assert not [ln for ln in lines if ln.startswith("blocked")], lines
    assert pids <= {int(ln.split()[1]) for ln in lines if ln.startswith("loaded")}, lines


def test_vstart_rgw_child_imports_no_jax_or_ceph_tpu(tmp_path, monkeypatch):
    """``vstart --rgw --device cpu`` in its own process, with the probe on
    its path: a signed PUT and GET through its gateway, and no blocked
    import in that process."""
    import asyncio
    import os

    from ceph_tpu_torch.rados import RadosClient
    from ceph_tpu_torch.rgw import RGWStore
    from tests.test_torch_rgw import PORT, http
    from tests.test_torch_tools_cli import _start_vstart, _stop_vstart

    probe = tmp_path / "probe"
    probe.mkdir()
    (probe / "sitecustomize.py").write_text(_CHILD_PROBE)
    log = tmp_path / "probe.log"
    monkeypatch.setenv("PORT_PROBE_LOG", str(log))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(probe), os.environ.get("PYTHONPATH", "")) if p))
    proc, lines = _start_vstart("--osds", "3", "--rgw", "--device", "cpu")
    try:
        addr = lines["rgw"].split()[0].removeprefix("http://")

        async def main():
            cl = await RadosClient(lines["mon"]).connect()
            try:
                user = await RGWStore(cl).get_user("admin")
            finally:
                await cl.shutdown()
            assert (await http(PORT, addr, "PUT", "/iso", creds=user))[0] == 200
            assert (await http(PORT, addr, "PUT", "/iso/o", body=b"x" * 5000,
                               creds=user))[0] == 200
            return await http(PORT, addr, "GET", "/iso/o", creds=user)

        st, _h, body = asyncio.run(asyncio.wait_for(main(), 60))
        assert st == 200 and body == b"x" * 5000
    finally:
        _stop_vstart(proc)
    probe_lines = log.read_text().splitlines()
    assert not [ln for ln in probe_lines if ln.startswith("blocked")], probe_lines
    assert f"loaded {proc.pid}" in probe_lines, probe_lines


def test_proc_cluster_and_vstart_raise_without_cuda(tmp_path):
    _needs_no_cuda()
    from ceph_tpu_torch.rados import ProcCluster
    from ceph_tpu_torch.tools import vstart

    with pytest.raises(DeviceUnavailableError):
        ProcCluster(str(tmp_path / "c"))
    with pytest.raises(DeviceUnavailableError):
        vstart.main(["--osds", "1"])
    with pytest.raises(DeviceUnavailableError):
        vstart.main(["--multiprocess", "--osds", "1", "--store-dir", str(tmp_path / "s")])
    assert not (tmp_path / "c").exists() and not (tmp_path / "s").exists()
