"""RBD: block images over RADOS objects (reference:src/librbd/).

Layout mirrors rbd image format 2 (reference:src/librbd/ImageCtx.cc,
cls_rbd):

- ``rbd_directory``            — pool-wide omap: image name <-> id
- ``rbd_header.<id>``          — per-image metadata in omap (size,
  object order, snapshot table) + the exclusive-lock lock class target
  + the watch/notify channel for header changes
- ``rbd_data.<id>.<objno:016x>`` — data, one object per ``object_size``
  chunk (order 22 = 4 MiB default)

Snapshots are RADOS self-managed snaps (reference:librbd::snap_create →
selfmanaged_snap_create + per-object clones); rollback replays the
object-level rollback op across the image's data objects; reads of a
snapshot ride the IoCtx read-snap. Multi-client coherence uses the
reference's two primitives: the ``lock`` object class for exclusive
write ownership and header watch/notify for cache invalidation.

Counterpart of ``ceph_tpu/rbd/``, whole: the same objects, omap keys and
journal frames, so an image written through one package opens, replays
and mirrors through the other.  An image keeps its directory and header
in omap, so its pool is replicated and RBD runs no kernel.
"""

from .image import RBD, Image, RbdError  # noqa: F401
from .mirror import ImageMirrorer  # noqa: F401

__all__ = ["RBD", "Image", "ImageMirrorer", "RbdError"]
