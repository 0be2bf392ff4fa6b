"""The shared EC accelerator service: the fleet map the OSDMap carries
(``accelmap``), the OSD-side client of the remote dispatcher lane
(``client``), the fleet router over the mon-published map
(``router``) and the daemon that owns the card (``daemon``).
Counterpart of ``ceph_tpu/accel``."""

from .accelmap import AccelEntry, AccelMap
from .client import (
    AccelClient,
    AccelDataError,
    AccelServiceError,
    AccelUnavailable,
)
from .daemon import AccelDaemon
from .router import AccelRouter

__all__ = ["AccelEntry", "AccelMap", "AccelClient", "AccelDataError",
           "AccelServiceError", "AccelUnavailable", "AccelDaemon",
           "AccelRouter"]
