"""Control plane: the monitor (``monitor.Monitor``: the OSDMap and
AccelMap authority, single mon or a Paxos-lite quorum) and its durable
map store (``store.MonitorDBStore``: the OSDMap's incrementals with
periodic full checkpoints).  Counterpart of ``ceph_tpu/mon``."""

from .monitor import Monitor
from .store import MonitorDBStore

__all__ = ["Monitor", "MonitorDBStore"]
