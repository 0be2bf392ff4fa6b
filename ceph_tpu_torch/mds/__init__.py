"""CephFS: a journaled metadata server + POSIX-ish client
(reference:src/mds/ + src/client/).

The reference MDS keeps the namespace in RADOS (directories as omap
objects in a metadata pool, file data striped into a data pool), logs
every metadata mutation to a journal in RADOS first, and replays that
journal on restart/failover — the MDS daemon itself is stateless
modulo cache.  Clients do metadata ops through the MDS and file I/O
DIRECTLY against the data pool (the MDS is not on the data path).

Same architecture here:

- pool ``.cephfs.meta``: ``dir.<ino>`` omap objects (entry name ->
  embedded inode json, the reference's primary-dentry embedding),
  ``mds_journal`` omap (seq -> event), ``mds_meta`` omap (ino
  allocator, journal trim point)
- pool ``.cephfs.data``: file content as striped ``data.<ino>``
- active/standby MDS via the mon's beacon machinery (MDSMonitor
  analog); a standby replays the RADOS journal and takes over

Counterpart of ``ceph_tpu/mds/``, whole: the same pools, objects, omap
keys, journal events and replies, so a namespace written through one
package reads back through the other.  The MDS runs no kernel and takes
no device: on an erasure-coded data pool (``data_pool_type="erasure"``)
the OSDs encode each file write and rebuild each degraded read, on the
card for OSDs that run there.
"""

from .daemon import MDSDaemon  # noqa: F401
from .fsclient import CephFSClient, FSError  # noqa: F401

__all__ = ["MDSDaemon", "CephFSClient", "FSError"]
