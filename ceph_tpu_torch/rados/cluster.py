"""MiniCluster: in-process mon + N OSDs on loopback.

The vstart / ceph-helpers analog (reference:src/vstart.sh,
reference:qa/workunits/ceph-helpers.sh run_mon/run_osd): every daemon is
an asyncio entity in this process, network is real loopback TCP.  Stores
are per-OSD MemStores by default (kill_osd keeps the store object so
restart_osd replays the restart-and-rejoin flow); pass ``store_dir`` to
run on durable WalStores instead, where ``remount_osd`` re-opens the
store from disk through journal replay — true process-death durability,
not the kept-alive-object simulation.

Counterpart of ``ceph_tpu/rados/cluster.py``.  ``MiniCluster(...,
device=None)`` hands ``device`` to every OSD and accelerator daemon it
starts: None is the card (``DeviceUnavailableError`` without CUDA),
``"cpu"`` is for tests.  The mons, the client and the MDS have no card:
``start_mds`` starts this package's ``MDSDaemon``, whose data pool's
erasure code the OSDs run.  The RGW gateway (``ceph_tpu_torch.rgw``)
runs over this cluster's client.
"""

from __future__ import annotations

import asyncio
import os

from ..device import resolve
from ..mon import Monitor
from ..osd.daemon import OSD
from ..store import MemStore, ObjectStore, WalStore
from .client import RadosClient


class MiniCluster:
    def __init__(
        self,
        n_osds: int = 3,
        heartbeat_interval: float = 0.0,
        failure_min_reporters: int = 1,
        store_dir: str | None = None,
        store_kind: str = "wal",
        n_mons: int = 1,
        mon_config=None,
        crush_hosts: "list[list[int]] | None" = None,
        auth: bool = False,
        config_overrides: "dict | None" = None,
        device=None,
    ):
        # resolved once, before anything is built: without CUDA the
        # default raises here, not at the first OSD's start
        self.device = resolve(device)
        self.n_osds = n_osds
        # extra daemon config (e.g. ms_inject_socket_failures for the
        # msgr-failure thrash variant) merged into every OSD's Config
        self.config_overrides = dict(config_overrides or {})
        # cephx: one generated keyring shared by all daemons + the admin
        # client (the vstart --cephx flow)
        self.auth = auth
        self.keyring = None
        self._keyring_path = None
        if auth:
            import tempfile

            from ..auth import Keyring

            self.keyring = Keyring.generate(["client.admin"])
            fd, self._keyring_path = tempfile.mkstemp(suffix=".keyring")
            os.close(fd)
            self.keyring.save(self._keyring_path)
        self.heartbeat_interval = heartbeat_interval
        self.mons: dict[int, Monitor] = {}
        self.crush_hosts = crush_hosts
        self._mon_args = dict(
            max_osds=n_osds, failure_min_reporters=failure_min_reporters,
            config=mon_config,
        )
        if auth and mon_config is not None:
            raise ValueError(
                "auth=True manages the mon config itself; a custom "
                "mon_config would leave the mons un-keyringed while "
                "every other daemon enforces cephx"
            )
        if auth:
            self._mon_args["config"] = self._daemon_config()
        self.n_mons = n_mons
        self.store_dir = store_dir
        self.store_kind = store_kind
        for rank in range(n_mons):
            self.mons[rank] = self._make_mon(rank)
        self.monmap: list[str] = []
        self.stores: list[ObjectStore] = [
            self._make_store(i) for i in range(n_osds)
        ]
        if store_dir is not None:
            for s in self.stores:
                # format only never-formatted stores: reconstructing a
                # MiniCluster over an existing store_dir must RECOVER the
                # data (the durability contract), not wipe it
                if not s.formatted():
                    s.mkfs()
        self.osds: dict[int, OSD] = {}
        self.mgrs: dict[str, "object"] = {}  # name -> MgrDaemon
        self._mgr_seq = 0  # monotonic: killed mgrs' names never recycle
        self.mdss: dict[str, "object"] = {}  # name -> MDSDaemon
        self._mds_seq = 0
        self.accels: dict[str, "object"] = {}  # name -> AccelDaemon
        self._accel_seq = 0
        self._clients: list[RadosClient] = []

    def _daemon_config(self):
        """A fresh Config carrying the cephx knobs plus any test-driven
        overrides (None when nothing is set, so daemons keep their own
        defaults)."""
        overrides = dict(self.config_overrides)
        if self.auth:
            overrides.update({
                "auth_supported": "cephx", "keyring": self._keyring_path,
            })
        if not overrides:
            return None
        from ..common import Config

        return Config(overrides=overrides)

    def _make_store(self, osd_id: int) -> ObjectStore:
        if self.store_dir is None:
            return MemStore()
        # "flush" = survives process death (the failure mode the harness
        # injects); per-write fsync would only add host-power-loss coverage
        path = os.path.join(self.store_dir, f"osd.{osd_id}")
        if self.store_kind == "blue":
            from ..store.blue import BlueStore

            return BlueStore(path, sync="flush")
        if self.store_kind != "wal":
            raise ValueError(
                f"unknown store_kind {self.store_kind!r} (wal|blue)"
            )
        return WalStore(path, sync="flush")

    def _make_mon(self, rank: int) -> Monitor:
        store_path = (
            os.path.join(self.store_dir, f"mon.{rank}.json")
            if self.store_dir is not None else None
        )
        crush = None
        if self.crush_hosts is not None:
            # a FRESH map per mon: mons mutate their own copy on pool
            # creation, a shared object would alias across daemons
            from ..crush.map import CrushMap

            crush = CrushMap.hierarchical(self.crush_hosts)
        return Monitor(
            name=f"mon.{rank}", rank=rank, store_path=store_path,
            crush=crush, **self._mon_args,
        )

    @property
    def mon(self) -> Monitor:
        """The current quorum leader (mons[0] before quorum forms) —
        single-mon clusters behave exactly as before."""
        for m in self.mons.values():
            if m.is_leader:
                return m
        return next(iter(self.mons.values()))

    async def start(self) -> "MiniCluster":
        for rank in sorted(self.mons):
            await self.mons[rank].start()
        self.monmap = [self.mons[r].addr for r in sorted(self.mons)]
        for m in self.mons.values():
            m.set_monmap(self.monmap)
        for m in self.mons.values():
            await m.start_quorum()
        if self.n_mons > 1:
            await self.wait_for_leader()
        for i in range(self.n_osds):
            await self.start_osd(i)
        return self

    async def wait_for_leader(self, timeout: float = 10.0) -> Monitor:
        async with asyncio.timeout(timeout):
            while True:
                for m in self.mons.values():
                    if m.is_leader:
                        return m
                await asyncio.sleep(0.01)

    async def kill_mon(self, rank: int) -> None:
        await self.mons.pop(rank).stop()

    async def restart_mon(self, rank: int) -> Monitor:
        if rank in self.mons:
            await self.kill_mon(rank)
        m = self._make_mon(rank)
        self.mons[rank] = m
        # rebind on the SAME address so the monmap stays valid
        host, port = self.monmap[rank].rsplit(":", 1)
        await m.start(host, int(port))
        m.set_monmap(self.monmap)
        await m.start_quorum()
        return m

    async def start_osd(self, osd_id: int) -> OSD:
        if osd_id in self.osds:
            raise RuntimeError(f"osd.{osd_id} already running")
        store = self.stores[osd_id]
        osd = OSD(
            osd_id, self.monmap or self.mon.addr, store=store,
            heartbeat_interval=self.heartbeat_interval,
            config=self._daemon_config(),
            device=self.device,
        )
        await osd.start()
        self.osds[osd_id] = osd
        return osd

    async def kill_osd(self, osd_id: int, crash: bool = False) -> None:
        """Hard-stop a daemon (store survives for restart_osd).
        ``crash=True`` skips the store umount — no checkpoint, no clean
        shutdown — so a later remount must recover from the journal."""
        osd = self.osds.pop(osd_id)
        await osd.stop(umount=not crash)

    async def restart_osd(self, osd_id: int) -> OSD:
        if osd_id in self.osds:
            await self.kill_osd(osd_id)
        return await self.start_osd(osd_id)

    async def remount_osd(self, osd_id: int) -> OSD:
        """Simulate full process death: crash-kill the daemon (no store
        umount, so no checkpoint), abandon the live store object, and
        re-open a fresh durable store (WalStore journal replay /
        BlueStore KV + block) from disk alone.  Requires ``store_dir``."""
        if self.store_dir is None:
            raise RuntimeError("remount_osd requires store_dir (durable)")
        if osd_id in self.osds:
            await self.kill_osd(osd_id, crash=True)
        # free the old instance's fds without a checkpoint; the store
        # owns the knowledge of which fds exist
        self.stores[osd_id].crash_close()
        self.stores[osd_id] = self._make_store(osd_id)
        return await self.start_osd(osd_id)

    async def wait_for_osd_down(self, osd_id: int, timeout: float = 10.0) -> None:
        async with asyncio.timeout(timeout):
            while self.mon.osdmap.is_up(osd_id):
                await asyncio.sleep(0.005)

    async def wait_for_osd_up(self, osd_id: int, timeout: float = 10.0) -> None:
        async with asyncio.timeout(timeout):
            while not self.mon.osdmap.is_up(osd_id):
                await asyncio.sleep(0.005)

    async def client(self, **kw) -> RadosClient:
        if self.auth and "auth_secret" not in kw:
            kw.setdefault("auth_entity", "client.admin")
            kw.setdefault(
                "auth_secret", self.keyring.get("client.admin")
            )
        cl = await RadosClient(
            self.monmap or self.mon.addr, **kw
        ).connect()
        self._clients.append(cl)
        return cl

    # -- mgr (reference:src/mgr; vstart's MGR_COUNT) ------------------------
    async def start_mgr(self, name: str | None = None, config=None):
        from ..mgr import MgrDaemon

        self._mgr_seq += 1
        name = name or f"mgr.{self._mgr_seq}"
        mgr = MgrDaemon(name, self.monmap or self.mon.addr,
                        config=config or self._daemon_config())
        await mgr.start()
        self.mgrs[name] = mgr
        return mgr

    async def kill_mgr(self, name: str) -> None:
        await self.mgrs.pop(name).stop()

    async def wait_for_active_mgr(self, timeout: float = 10.0) -> str:
        """Until the map names an active mgr that is actually running."""
        async with asyncio.timeout(timeout):
            while True:
                active = self.mon.osdmap.mgr_name
                if active in self.mgrs and self.mgrs[active].active:
                    return active
                await asyncio.sleep(0.01)

    # -- shared EC accelerator fleet (accel/) --------------------------------
    async def start_accel(self, name: str | None = None, config=None,
                          locality: str = "", register: bool = True):
        """One shared accelerator daemon on loopback.  With
        ``register`` (default) it registers into the mon-published
        AccelMap and every OSD's router picks it up from the next map
        push — :meth:`route_osds_to_accel` only needs to set the mode.
        ``register=False`` keeps the static topology (no mon:
        wire OSDs via ``osd_ec_accel_addr``).  ``locality`` is the
        AccelMap locality label (match a crush host name so decode
        batches prefer this accelerator for shards homed there)."""
        from ..accel import AccelDaemon

        self._accel_seq += 1
        name = name or f"accel.{self._accel_seq}"
        if locality and config is not None:
            # setting it on the caller's object would cross-contaminate
            # accels sharing one Config (the registration beacon
            # re-reads accel_locality live)
            raise ValueError(
                "pass accel_locality inside config= OR use locality=, "
                "not both"
            )
        cfg = config or self._daemon_config()
        if locality:
            if cfg is None:
                from ..common import Config

                cfg = Config()
            cfg.set("accel_locality", locality)
        acc = AccelDaemon(
            name,
            mon_addr=(self.monmap or self.mon.addr) if register else None,
            config=cfg,
            device=self.device,
        )
        await acc.start()
        self.accels[name] = acc
        return acc

    def set_accel_mode(self, mode: str = "prefer") -> None:
        """Arm every running OSD's remote EC lane for the mon-published
        fleet (the addr comes from the AccelMap, not static config)."""
        for osd in self.osds.values():
            osd.config.set("osd_ec_accel_mode", mode)

    async def kill_accel(self, name: str, crash: bool = False) -> None:
        """``crash=True`` models SIGKILL mid-batch: connections die
        without replies, and the OSDs must replay in-flight batches on
        their local fallback engines (zero failed client ops)."""
        await self.accels.pop(name).stop(crash=crash)

    def route_osds_to_accel(self, addr: str, mode: str = "prefer") -> None:
        """Point every running OSD's remote EC lane at ``addr`` (live
        config — takes effect on the next batch)."""
        for osd in self.osds.values():
            osd.config.set("osd_ec_accel_addr", addr)
            osd.config.set("osd_ec_accel_mode", mode)

    # -- mds (reference:src/mds; vstart's MDS_COUNT) ------------------------
    async def start_mds(self, name: str | None = None, config=None, **kw):
        from ..mds import MDSDaemon

        self._mds_seq += 1
        name = name or f"mds.{self._mds_seq}"
        mds = MDSDaemon(name, self.monmap or self.mon.addr,
                        config=config or self._daemon_config(), **kw)
        await mds.start()
        self.mdss[name] = mds
        return mds

    async def kill_mds(self, name: str) -> None:
        await self.mdss.pop(name).stop()

    async def wait_for_active_mds(self, timeout: float = 10.0) -> str:
        async with asyncio.timeout(timeout):
            while True:
                active = self.mon.osdmap.mds_name
                if active in self.mdss and self.mdss[active].active:
                    return active
                await asyncio.sleep(0.01)

    async def stop(self) -> None:
        for cl in self._clients:
            await cl.shutdown()
        self._clients.clear()
        for name in list(self.mdss):
            await self.kill_mds(name)
        for name in list(self.mgrs):
            await self.kill_mgr(name)
        for name in list(self.accels):
            await self.kill_accel(name)
        for osd_id in list(self.osds):
            await self.kill_osd(osd_id)
        for rank in list(self.mons):
            await self.mons.pop(rank).stop()
        if self._keyring_path is not None:
            try:
                os.unlink(self._keyring_path)  # secret-bearing tmp file
            except OSError:
                pass
            self._keyring_path = None

    async def __aenter__(self) -> "MiniCluster":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()
