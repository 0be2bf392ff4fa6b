"""RGW: S3-style object gateway over RADOS (reference:src/rgw/).

The reference gateway maps S3/Swift semantics onto rados pools:
users and buckets as metadata objects, a per-bucket omap index, object
data striped into rados objects, multipart uploads assembled from part
objects.  Same layout here:

- pool ``.rgw.meta``: ``users`` omap (uid -> user record including
  access keys), ``buckets`` omap (bucket -> owner/ctime)
- pool ``.rgw.buckets``: per-bucket index ``.index.<bucket>`` omap
  (key -> size/etag/mtime), data as striped objects
  ``<bucket>/<key>``, multipart parts ``<bucket>/<key>.<upload>.<n>``

Surfaces: :class:`RGWStore` (the programmatic S3 API),
:class:`~ceph_tpu_torch.rgw.http.S3Server` (REST gateway), and the
``rgw_admin`` CLI (radosgw-admin analog).

Counterpart of ``ceph_tpu/rgw/``, whole.  On an erasure-coded data pool
the OSDs encode and rebuild the objects' data, on the card when they run
there; the gateway runs no kernel of its own.
"""

from .store import RGWError, RGWStore  # noqa: F401
from .sync import ZoneSyncer  # noqa: F401

__all__ = ["RGWStore", "RGWError", "ZoneSyncer"]
