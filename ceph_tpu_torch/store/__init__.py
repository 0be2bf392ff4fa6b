"""Key-value persistence (``kv``), the layer under the monitor's store,
and the object-store types the messages carry (``objectstore``).
Counterpart of ``ceph_tpu/store``, of which only these are in this
package."""

from .kv import FileKVDB, KeyValueDB
from .objectstore import NO_SHARD, CollectionId, ObjectId, Transaction

__all__ = ["FileKVDB", "KeyValueDB", "NO_SHARD", "CollectionId",
           "ObjectId", "Transaction"]
