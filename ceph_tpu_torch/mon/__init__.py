"""The monitor's durable map store (``store.MonitorDBStore``: the
OSDMap's incrementals with periodic full checkpoints).  Counterpart of
``ceph_tpu/mon``, of which only the store is in this package."""

from .store import MonitorDBStore

__all__ = ["MonitorDBStore"]
