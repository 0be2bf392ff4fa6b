"""The shared EC accelerator service: the fleet map the OSDMap carries
(``accelmap``), the OSD-side client of the remote dispatcher lane
(``client``) and the daemon that owns the card (``daemon``).
Counterpart of ``ceph_tpu/accel``; the fleet router (``router``) is not
ported yet."""

from .accelmap import AccelEntry, AccelMap
from .client import (
    AccelClient,
    AccelDataError,
    AccelServiceError,
    AccelUnavailable,
)
from .daemon import AccelDaemon

__all__ = ["AccelEntry", "AccelMap", "AccelClient", "AccelDataError",
           "AccelServiceError", "AccelUnavailable", "AccelDaemon"]
