"""Manager daemon (reference:src/mgr/).

Counterpart of ``ceph_tpu/mgr``, whole.  The reference mgr receives
PG/OSD statistics from every OSD (``MPGStats``), hosts Python modules
over them (dashboard, prometheus, balancer...), and answers the stats
half of the ``ceph`` CLI (status/df/pg dump).  Same shape here: the
active mgr beacons to the mon (active/standby failover lives in the
mon's MgrMonitor analog), daemons report to whichever mgr the map names,
and pluggable :class:`MgrModule` subclasses serve commands over the
aggregated state.
"""

from .daemon import MgrDaemon, MgrModule  # noqa: F401
from .modules import DfModule, PrometheusModule, StatusModule  # noqa: F401

__all__ = [
    "MgrDaemon",
    "MgrModule",
    "StatusModule",
    "DfModule",
    "PrometheusModule",
]
