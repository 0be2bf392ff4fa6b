"""The accelerator fleet map (``accelmap``), which the OSDMap carries in
its wire dict.  Counterpart of ``ceph_tpu/accel``, of which only the map
is in this package."""

from .accelmap import AccelEntry, AccelMap

__all__ = ["AccelEntry", "AccelMap"]
