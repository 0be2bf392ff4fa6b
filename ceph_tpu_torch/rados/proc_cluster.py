"""ProcCluster: a REAL multi-process mini cluster on loopback.

Each mon and OSD is its own OS process (``python -m
ceph_tpu_torch.tools.daemon``) with a durable store — the reference's
tier-2 testing model (reference:src/test/erasure-code/test-erasure-code.sh
boots a mon + 11 real OSDs via run_mon/run_osd;
reference:qa/workunits/ceph-helpers.sh).  Unlike the in-process
MiniCluster:

- ``kill9_osd`` is a true ``SIGKILL`` of a separate process: no Python
  state survives, the store's crash-replay path (WalStore journal /
  BlueStore KV) is exercised exactly as a host power-off would,
- daemon isolation bugs (accidentally shared mutable state) are
  structurally impossible to paper over,
- op execution is genuinely parallel across daemons (one interpreter
  each).

The controlling program stays in-process: it talks to the cluster only
through RadosClient over TCP, like any client.

Counterpart of ``ceph_tpu/rados/proc_cluster.py``.  ``device`` is
resolved here, at construction, as ``MiniCluster`` resolves it: None is
the card (``DeviceUnavailableError`` without CUDA), ``"cpu"`` is for
tests and reaches every OSD process as ``--device cpu``.  Each OSD
process opens the card itself; the mon has no card.  ``wait_healthy``
fails as soon as a daemon process has exited, naming it and, with
``log_dir``, the tail of its log.  Admin sockets need no argument: the
children inherit the environment, so ``CEPH_TPU_ARGS='--admin_socket
DIR/{name}.asok'`` gives every daemon its socket.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

from ..device import resolve

LOG_TAIL_BYTES = 4096


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# every daemon ever spawned by this interpreter: the atexit sweep
# SIGKILLs whatever is still alive, so a run that dies mid-cluster
# (assertion, ^C, harness bug) cannot leak daemons.  The daemons also
# watch our pid (--watch-parent + PDEATHSIG), which covers the one case
# atexit cannot: this interpreter being SIGKILLed.
_ALL_PROCS: list[subprocess.Popen] = []


def _reap_all() -> None:
    for proc in _ALL_PROCS:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


atexit.register(_reap_all)


class ProcCluster:
    def __init__(self, store_dir: str, n_osds: int = 3, n_mons: int = 1,
                 store_kind: str = "wal", heartbeat_interval: float = 2.0,
                 log_dir: str | None = None,
                 osd_config: "dict | None" = None,
                 device=None):
        # resolved once, before anything is spawned: without CUDA the
        # default raises here, not after a wait_healthy timeout
        self.device = resolve(device)
        self.store_dir = store_dir
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.store_kind = store_kind
        self.heartbeat_interval = heartbeat_interval
        self.log_dir = log_dir  # per-daemon log files (None = discard)
        # per-OSD config overrides forwarded as --config key=val (the
        # MiniCluster config_overrides analog for real processes)
        self.osd_config = dict(osd_config or {})
        self.monmap = [f"127.0.0.1:{_free_port()}" for _ in range(n_mons)]
        self.mon_procs: dict[int, subprocess.Popen] = {}
        self.osd_procs: dict[int, subprocess.Popen] = {}
        self._clients: list = []

    # -- spawning -------------------------------------------------------------
    def _log_path(self, name: str) -> str:
        return os.path.join(self.log_dir, f"{name}.log")

    def _spawn(self, argv: list[str]) -> subprocess.Popen:
        env = dict(os.environ)
        # the repo root must be importable in the child (the framework
        # is run from a checkout, not an installed package)
        root = str(pathlib.Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p
        )
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            name = f"{argv[0]}.{argv[2]}"  # role.(rank|id)
            out = open(self._log_path(name), "ab")
        else:
            out = subprocess.DEVNULL
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ceph_tpu_torch.tools.daemon", *argv,
                 "--watch-parent", str(os.getpid()),
                 *([] if not self.log_dir else ["--verbose"])],
                stdout=out, stderr=subprocess.STDOUT,
                env=env, start_new_session=True,
            )
            _ALL_PROCS.append(proc)
            return proc
        finally:
            if out is not subprocess.DEVNULL:
                out.close()  # the child holds its own inherited copy

    def spawn_mon(self, rank: int) -> None:
        self.mon_procs[rank] = self._spawn([
            "mon", "--rank", str(rank), "--addr", self.monmap[rank],
            "--monmap", ",".join(self.monmap),
            "--store", os.path.join(self.store_dir, f"mon.{rank}.db"),
            "--max-osds", str(self.n_osds),
        ])

    def spawn_osd(self, osd_id: int) -> None:
        cfg_args = []
        for k, v in self.osd_config.items():
            cfg_args += ["--config", f"{k}={v}"]
        self.osd_procs[osd_id] = self._spawn([
            "osd", "--id", str(osd_id),
            "--monmap", ",".join(self.monmap),
            "--store", os.path.join(self.store_dir, f"osd.{osd_id}"),
            "--store-kind", self.store_kind,
            "--heartbeat-interval", str(self.heartbeat_interval),
            "--device", str(self.device),
            *cfg_args,
        ])

    async def start(self, timeout: float = 60.0) -> None:
        """The mons first, then, once they listen, the OSDs: an OSD
        gives up booting when no mon answers within a second or so,
        and a mon process on a loaded host takes longer to start."""
        os.makedirs(self.store_dir, exist_ok=True)
        deadline = time.monotonic() + timeout
        for r in range(self.n_mons):
            self.spawn_mon(r)
        await self._wait_mons(deadline)
        for i in range(self.n_osds):
            self.spawn_osd(i)
        await self.wait_healthy(max(0.0, deadline - time.monotonic()))

    async def _wait_mons(self, deadline: float) -> None:
        """Until every mon accepts a connection; fails at once when a
        mon process has exited."""
        for addr in self.monmap:
            host, port = addr.rsplit(":", 1)
            while True:
                dead = self._exited()
                if dead is not None:
                    raise RuntimeError(f"cluster not healthy: {dead}")
                try:
                    _reader, writer = await asyncio.open_connection(host, int(port))
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"cluster not healthy: no mon at {addr}") from None
                    await asyncio.sleep(0.1)
                    continue
                writer.close()
                await writer.wait_closed()
                break

    def _exited(self) -> "str | None":
        """The first daemon process that has exited, with its exit code
        and the tail of its log, or None while all run."""
        for role, procs in (("mon", self.mon_procs), ("osd", self.osd_procs)):
            for n, proc in sorted(procs.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                what = f"{role}.{n} exited with code {rc}"
                if self.log_dir:
                    try:
                        with open(self._log_path(f"{role}.{n}"), "rb") as f:
                            f.seek(0, os.SEEK_END)
                            f.seek(max(0, f.tell() - LOG_TAIL_BYTES))
                            tail = f.read().decode(errors="replace")
                    except OSError as e:
                        tail = f"(no log: {e})"
                    what += f"; the tail of its log:\n{tail}"
                return what
        return None

    async def wait_healthy(self, timeout: float = 60.0) -> None:
        """Until every OSD is up in the map (client-visible health).
        Fails at once when a daemon process has exited."""
        from .client import RadosClient

        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            dead = self._exited()
            if dead is not None:
                raise RuntimeError(f"cluster not healthy: {dead}")
            try:
                cl = RadosClient(self.monmap)
                await cl.connect()
                up = [
                    i for i in range(self.n_osds)
                    if cl.osdmap.is_up(i)
                ]
                await cl.shutdown()
                if len(up) == self.n_osds:
                    return
                last = f"{len(up)}/{self.n_osds} osds up"
            except Exception as e:
                last = repr(e)
            await asyncio.sleep(0.3)
        raise TimeoutError(f"cluster not healthy: {last}")

    async def client(self, **kw):
        from .client import RadosClient

        cl = RadosClient(self.monmap, **kw)
        await cl.connect()
        self._clients.append(cl)
        return cl

    # -- fault injection ------------------------------------------------------
    def kill9_osd(self, osd_id: int) -> None:
        """True SIGKILL: the process dies NOW, mid-whatever-it-was-doing.
        No umount, no flush beyond what already hit the page cache."""
        proc = self.osd_procs.pop(osd_id)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)

    async def restart_osd(self, osd_id: int) -> None:
        """Remount the dead OSD's store from disk in a fresh process."""
        self.spawn_osd(osd_id)

    async def wait_osd_state(self, cl, osd_id: int, up: bool,
                             timeout: float = 60.0) -> None:
        async with asyncio.timeout(timeout):
            while cl.osdmap is None or cl.osdmap.is_up(osd_id) != up:
                await asyncio.sleep(0.2)

    # -- teardown -------------------------------------------------------------
    async def stop(self) -> None:
        for cl in self._clients:
            try:
                await cl.shutdown()
            except Exception:  # swallow-ok: a client of a dying cluster may already be gone
                pass
        self._clients.clear()
        for procs in (self.osd_procs, self.mon_procs):
            for proc in procs.values():
                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + 10
        for procs in (self.osd_procs, self.mon_procs):
            for proc in procs.values():
                try:
                    proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=5)
        self.osd_procs.clear()
        self.mon_procs.clear()

    async def __aenter__(self) -> "ProcCluster":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()
