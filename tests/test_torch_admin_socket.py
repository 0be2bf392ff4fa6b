"""The port's admin socket, op tracker and tracepoints against the
reference's.

- A port and a reference ``AdminSocket``, each with ``register_common``
  over equal perf families and equal configs, answer ``help``,
  ``perf dump`` / ``schema`` / ``reset``, ``config show|diff|set`` and
  ``log dump`` with equal bodies (``help`` key for key: the
  descriptions name each package's own profiler).
- ``admin_command`` of either package reaches the other's socket.
- ``kernel trace start|stop|status|dump`` over the port's socket: one
  window at a time, structured refusals, never an exception.
- A port ``Monitor`` and a port ``AccelDaemon(device="cpu")`` start,
  serve and remove their sockets; the daemon's bodies equal its
  in-process objects; ``tools/daemon.py``'s ``mon`` and ``accel`` roles
  take ``admin_socket`` from ``CEPH_TPU_ARGS``.
- The tracepoint rings, ``op_waterfall`` and the op tracker give the
  reference's bodies for the same calls, and the hop manifest is the
  reference's list.

Every socket round trip runs under ``asyncio.wait_for``; tolerances are
exact, with timestamps masked where the two packages stamp their own.
"""

import asyncio
import json
import logging
import os
import select
import signal
import subprocess
import sys
import pathlib
import time

import pytest

from ceph_tpu.common import admin_socket as ref_asok
from ceph_tpu.common import op_tracker as ref_op_tracker
from ceph_tpu.common import tracing as ref_tracing
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu.common.log import install as ref_log_install
from ceph_tpu.common.perf_counters import PerfCountersCollection as RefCollection
from ceph_tpu.osd.ec_perf import create_ec_perf as ref_create_ec_perf

from ceph_tpu_torch.common import (
    AdminSocket,
    Config,
    OpTracker,
    PerfCountersCollection,
    admin_command,
    register_common,
)
from ceph_tpu_torch.common import op_tracker, tracing
from ceph_tpu_torch.common.log import install as log_install
from ceph_tpu_torch.osd.ec_perf import create_ec_perf

REPO = pathlib.Path(__file__).resolve().parent.parent
ASYNC_LIMIT_S = 30.0
OVERRIDES = {"osd_ec_dispatch_window": 0.004, "trace_ring_capacity": 128}


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, ASYNC_LIMIT_S)

    return asyncio.run(bounded())


async def cmd(path, prefix, via=admin_command, **kw):
    return await asyncio.wait_for(via(str(path), prefix, **kw), 10.0)


def _perf(collection_cls, create):
    perf = collection_cls()
    ec = create(perf)
    ec.inc("encode_calls", 7)
    ec.inc("encode_bytes", 4096)
    fam = perf.create("unit")
    fam.add_counter("events", "events seen")
    fam.add_gauge("depth", "queue depth")
    fam.add_time_avg("lat", "latency")
    fam.inc("events", 3)
    fam.set("depth", 2)
    fam.observe("lat", 0.25)
    fam.observe("lat", 0.75)
    return perf


def _pair():
    """A port and a reference socket with the same families and configs."""
    port = AdminSocket("unused")
    register_common(port, perf=_perf(PerfCountersCollection, create_ec_perf),
                    config=Config(OVERRIDES, env=""), device="cpu")
    ref = ref_asok.AdminSocket("unused")
    ref_asok.register_common(ref, perf=_perf(RefCollection, ref_create_ec_perf),
                             config=RefConfig(OVERRIDES, env=""))
    return port, ref


async def _serve(port, ref, tmp_path, body):
    port.path = str(tmp_path / "port.asok")
    ref.path = str(tmp_path / "ref.asok")
    await port.start()
    await ref.start()
    try:
        return await body(port.path, ref.path)
    finally:
        await port.stop()
        await ref.stop()


# -- bodies equal the reference's ---------------------------------------------


@pytest.mark.parametrize("prefix,kw", [
    ("perf dump", {}),
    ("perf schema", {}),
    ("config show", {}),
    ("config diff", {}),
    ("config set", {"name": "osd_ec_dispatch_max_stripes", "value": "64"}),
    ("perf reset", {"name": "unit"}),
    ("unknown command", {}),
])
def test_common_bodies_equal_the_references(tmp_path, prefix, kw):
    port, ref = _pair()

    async def body(p, r):
        got = await cmd(p, prefix, **kw)
        want = await cmd(r, prefix, via=ref_asok.admin_command, **kw)
        if prefix == "unknown command":
            assert set(got["commands"]) == set(want["commands"])
            got.pop("commands"), want.pop("commands")
        assert got == want
        if prefix in ("config set", "perf reset"):
            # the change shows in the next dump alike
            follow = "config diff" if prefix == "config set" else "perf dump"
            assert await cmd(p, follow) == await cmd(
                r, follow, via=ref_asok.admin_command)

    run(_serve(port, ref, tmp_path, body))


def test_help_lists_the_same_commands(tmp_path):
    port, ref = _pair()

    async def body(p, r):
        got = await cmd(p, "help")
        want = await cmd(r, "help", via=ref_asok.admin_command)
        assert list(got) == list(want)
        assert "kernel trace start" in got and "dump_op_waterfall" in got

    run(_serve(port, ref, tmp_path, body))


def test_log_dump_bodies_equal(tmp_path):
    port, ref = _pair()
    rec = logging.LogRecord("ceph_tpu.osd", logging.WARNING, __file__, 1,
                            "slow op %d", (7,), None)
    for ml in (log_install(), ref_log_install()):
        ml.clear()
        ml.emit(rec)

    async def body(p, r):
        got = await cmd(p, "log dump", num=5)
        want = await cmd(r, "log dump", via=ref_asok.admin_command, num=5)
        assert got == want and got["entries"][-1]["msg"] == "slow op 7"
        bad = await cmd(p, "log dump", num=-1)
        assert bad == await cmd(r, "log dump", via=ref_asok.admin_command, num=-1)

    run(_serve(port, ref, tmp_path, body))


def test_admin_command_crosses_packages(tmp_path):
    port, ref = _pair()

    async def body(p, r):
        # each client reaches the other package's socket
        assert await cmd(r, "config show") == await cmd(
            p, "config show", via=ref_asok.admin_command)
        assert await cmd(p, "perf schema", via=ref_asok.admin_command) == \
            await cmd(r, "perf schema")
        assert list(await cmd(r, "help")) == list(await cmd(
            p, "help", via=ref_asok.admin_command))

    run(_serve(port, ref, tmp_path, body))


# -- kernel trace windows over the socket ---------------------------------------


def test_kernel_trace_commands_refuse_in_structure(tmp_path):
    sock = AdminSocket(str(tmp_path / "k.asok"))
    register_common(sock, config=Config({"kernel_trace_max_duration": 5.0}, env=""),
                    device="cpu")

    async def body():
        await sock.start()
        try:
            p = sock.path
            stopped = await cmd(p, "kernel trace stop")
            assert stopped.get("no_window") is True and "unavailable" in stopped
            opened = await cmd(p, "kernel trace start", duration=600, label="asok")
            assert opened.get("success") and opened["duration_s"] == 5.0
            busy = await cmd(p, "kernel trace start", duration=1)
            assert busy.get("busy") is True and "already open" in busy["error"]
            st = await cmd(p, "kernel trace status")
            assert st["active"] is True and st["label"] == "asok"
            still = await cmd(p, "kernel trace dump")
            assert "still open" in still["unavailable"]
            closed = await cmd(p, "kernel trace stop")
            assert closed["label"] == "asok" and "unavailable" not in closed
            assert await cmd(p, "kernel trace dump") == closed
            assert (await cmd(p, "kernel trace status"))["active"] is False
        finally:
            await sock.stop()
        assert not os.path.exists(sock.path)

    run(body())


# -- the daemons' sockets --------------------------------------------------------


def test_monitor_serves_and_removes_its_socket(tmp_path):
    from ceph_tpu_torch.mon import Monitor

    path = str(tmp_path / "{name}.asok")

    async def body():
        mon = Monitor("mon.3", config=Config({"admin_socket": path}, env=""))
        await mon.start()
        sock = path.replace("{name}", "mon.3")
        try:
            st = await cmd(sock, "status")
            assert st == {"name": "mon.3", "addr": mon.addr, "rank": 0,
                          "epoch": mon.osdmap.epoch, "leader": mon.is_leader}
            assert (await cmd(sock, "quorum_status")) == mon._cmd_quorum_status({})[2]
            assert (await cmd(sock, "perf dump"))["mon"] == mon.perf.dump()["mon"]
            assert (await cmd(sock, "config show"))["admin_socket"] == path
        finally:
            await mon.stop()
        assert not os.path.exists(sock)

    run(body())


def _paths(body, at=()):
    body = json.loads(json.dumps(body))
    if isinstance(body, dict):
        return {p for k, v in body.items() for p in _paths(v, at + (k,))} or {at}
    return {at}


ACCEL_COMMANDS = ("dump_ec_dispatch", "dump_launch_history", "dump_engine_health",
                  "dump_op_pq_state", "dump_watchdog", "status")


def test_accel_daemon_serves_and_removes_its_socket(tmp_path):
    from ceph_tpu_torch.accel import AccelDaemon

    path = str(tmp_path / "{name}.asok")

    async def body():
        acc = AccelDaemon("accel.4", device="cpu",
                          config=Config({"admin_socket": path}, env=""))
        await acc.start()
        sock = path.replace("{name}", "accel.4")
        try:
            ref = ref_asok.AdminSocket("unused")
            ref_asok.register_common(ref, perf=RefCollection(), config=RefConfig(env=""))
            listed = await cmd(sock, "help")
            assert set(listed) == set(ref._handlers) | set(ACCEL_COMMANDS)
            assert await cmd(sock, "dump_launch_history") == \
                json.loads(json.dumps(acc.dispatch.flight.dump()))
            # since_s is the clock since the last transition: the socket's
            # reading lies between two local ones, the rest is equal
            before = json.loads(json.dumps(acc.dispatch.engine_health()))
            health = await cmd(sock, "dump_engine_health")
            after = json.loads(json.dumps(acc.dispatch.engine_health()))
            assert before["since_s"] <= health["since_s"] <= after["since_s"]
            assert {**health, "since_s": None} == {**after, "since_s": None}
            # the dmClock tags move with the clock: the same fields
            assert _paths(await cmd(sock, "dump_op_pq_state")) == \
                _paths(acc.scheduler.dump())
            st = await cmd(sock, "status")
            assert st == {"name": "accel.4", "addr": acc.addr, "clients": {},
                          "queue_depth": 0, "engine_state": acc.supervisor.state}
            assert set(await cmd(sock, "perf dump")) == set(acc.perf.dump())
            assert "ec_device_launch" in json.dumps(await cmd(sock, "dump_watchdog"))
            assert "batches" in json.dumps(await cmd(sock, "dump_ec_dispatch"))
        finally:
            await acc.stop()
        assert not os.path.exists(sock)

    run(body())


def test_accel_daemon_still_refuses_the_mesh_lane(tmp_path):
    """An accelerator daemon with ``osd_ec_mesh`` on and an admin socket
    serves the mesh lane in ``dump_ec_dispatch``, as its dispatcher
    dumps it."""
    from ceph_tpu_torch.accel import AccelDaemon

    sock = str(tmp_path / "a.asok")
    acc = AccelDaemon("accel.5", device="cpu", config=Config(
        {"admin_socket": sock, "osd_ec_mesh": True}, env=""))

    async def body():
        await acc.start()
        try:
            got = await cmd(sock, "dump_ec_dispatch")
            assert got["mesh_lane"] is True
            assert got["mesh_lane"] == acc.dispatch.dump()["mesh_lane"]
        finally:
            await acc.stop()

    run(body())


@pytest.mark.parametrize("role", ["mon", "accel"])
def test_daemon_tool_roles_take_the_socket_from_the_environment(tmp_path, role):
    """``CEPH_TPU_ARGS='--admin_socket DIR/{name}.asok'`` reaches the role's
    daemon with no flag of its own; SIGTERM removes the socket.  Every
    wait on the child is bounded."""
    argv = {"mon": ["mon", "--rank", "0", "--addr", "127.0.0.1:0", "--monmap",
                    "127.0.0.1:0", "--store", str(tmp_path / "store")],
            "accel": ["accel", "--id", "6", "--addr", "127.0.0.1:0",
                      "--device", "cpu"]}[role]
    name = {"mon": "mon.0", "accel": "accel.6"}[role]
    sock = tmp_path / f"{name}.asok"
    env = dict(os.environ, CEPH_TPU_ARGS=f"--admin_socket {tmp_path}/{{name}}.asok",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "the daemon printed nothing within 60 s"
        line = proc.stdout.readline()
        assert line.startswith(f"{name} up at "), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        st = run(cmd(sock, "status"))
        assert st["name"] == name and st["addr"] == line.split()[-1]
        assert run(cmd(sock, "config show"))["admin_socket"] == \
            f"{tmp_path}/{{name}}.asok"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not sock.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- tracepoints, the waterfall, the op tracker ---------------------------------


def _spans(mod, trace):
    mod.record_span("wire", 10.0, 0.002, trace=trace, entity="osd.0")
    mod.record_span("execute", 10.002, 0.005, trace=trace, entity="osd.0",
                    client=4)
    mod.record_span("device_wall", 10.003, 0.003, trace=trace, entity="osd.0",
                    parent=mod.span_id_for(trace, "osd.0", "execute"))
    # the same hop aligned from another process, with more uncertainty
    mod.record_span("wire", 10.0001, 0.0021, trace=trace, entity="osd.0",
                    uncertainty=0.0004)


def test_op_waterfall_equals_the_references():
    trace = "client.4:t99"
    for mod in (tracing, ref_tracing):
        _spans(mod, trace)
    assert tracing.has_spans(trace) and ref_tracing.has_spans(trace)
    got, want = tracing.op_waterfall(trace), ref_tracing.op_waterfall(trace)
    assert got == want
    assert got["client"] == 4 and got["dominant_hop"] == "execute"
    assert tracing.op_waterfall("nobody") == ref_tracing.op_waterfall("nobody")


def test_tracepoint_rings_equal_the_references():
    def drive(mod, name):
        p = mod.tracepoint_provider(name)
        p.clear()
        p.set_capacity(3)
        tok = mod.current_trace.set("client.1:t1")
        try:
            p.point("submit", oid="o1")
            with p.span("encode", oid="o1"):
                p.point("inner")
        finally:
            mod.current_trace.reset(tok)
        p.point("untraced")
        merged = [e["event"] for e in mod.events_for_trace("client.1:t1")
                  if e["provider"] == name]
        d = json.loads(json.dumps(p.dump()))
        for e in d["events"]:
            e.pop("ts")
            e.pop("elapsed", None)
            if "span_id" in e:
                e["span_id"] = e["span_id"].split(":")[0]
        return d, merged

    got = drive(tracing, "unit_twin")
    want = drive(ref_tracing, "unit_twin")
    assert got == want
    assert got[0]["dropped"] == 2 and got[0]["dropped_since_dump"] == 2
    tracing.set_ring_capacity(tracing._default_capacity)


def test_hop_manifest_is_the_references():
    assert tracing.hop_manifest() == ref_tracing.hop_manifest()


class _FixedClock:
    """The ``time`` module with ``monotonic`` stopped at one instant."""

    NOW = 1000.0

    def monotonic(self):
        return self.NOW

    def __getattr__(self, name):
        return getattr(time, name)


def test_op_tracker_bodies_equal_the_references(monkeypatch):
    # both trackers read one stopped clock, so every duration and age is
    # computed from the same instants and compares exactly
    monkeypatch.setattr(op_tracker, "time", _FixedClock())
    monkeypatch.setattr(ref_op_tracker, "time", _FixedClock())

    def drive(cls):
        t = cls(history_size=2)
        ops = [t.create(trace=f"c:t{i}", tid=i, oid=f"o{i}") for i in range(4)]
        t.mark_by_trace("c:t1", "sub_op_sent")
        t.mark(ops[2], "dequeued")
        for i, op in enumerate(ops[:3]):
            op.initiated_at -= 0.1 * (i + 1)  # durations 0.1, 0.2, 0.3 s
            t.finish(op, completed=i != 1)
        slow = t.slow_ops(0.05)

        def mask(body):
            for o in body["ops"]:
                o["events"] = [e["event"] for e in o["events"]]
                o["state_durations"] = sorted(o["state_durations"])
            return body

        return (mask(t.dump_ops_in_flight()), mask(t.dump_historic_ops()),
                mask(t.dump_historic_ops_by_duration()), len(slow))

    assert drive(OpTracker) == drive(ref_op_tracker.OpTracker)
