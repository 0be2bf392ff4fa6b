"""Client object API + mini-cluster harness.

Counterpart of ``ceph_tpu/rados/__init__.py``, exporting the same
names.  The librados subset (reference:src/librados/ RadosClient/
IoCtxImpl + reference:src/osdc/Objecter.cc op targeting/resend) and a
vstart-style in-process cluster (reference:src/vstart.sh,
reference:src/test/erasure-code/test-erasure-code.sh run_mon/run_osd)
whose OSDs run their erasure code on the card (``device="cpu"`` for
tests); the same cluster with each daemon in its own process
(``ProcCluster``), the storm driver over either, and the client-side
object cache.
"""

from .client import IoCtx, RadosClient, RadosError
from .cluster import MiniCluster
from .object_cacher import ObjectCacher
from .proc_cluster import ProcCluster
from .storm import ClientLoad, StormDriver
from .striper import StripedLayout, StripedObject

__all__ = [
    "RadosClient", "IoCtx", "RadosError", "MiniCluster",
    "StripedLayout", "StripedObject",
    "ProcCluster", "ClientLoad", "StormDriver", "ObjectCacher",
]
