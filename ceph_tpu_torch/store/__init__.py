"""Key-value persistence (``kv``), the layer under the monitor's store.
Counterpart of ``ceph_tpu/store``, of which only the KV layer is in this
package."""

from .kv import FileKVDB, KeyValueDB

__all__ = ["FileKVDB", "KeyValueDB"]
