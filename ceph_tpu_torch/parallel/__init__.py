"""Device-mesh parallelism for the EC engine.

Counterpart of ``ceph_tpu/parallel``: Ceph's parallelism axes
re-expressed as a [pg, shard] grid of ``torch.device`` lanes driven by
one process:

- ``pg``    — placement-group/data parallelism: different stripes
  (objects) on different lanes; encode is embarrassingly parallel here
  (the analog of objects→PGs→OSDs placement sharding).
- ``shard`` — code sharding: the k+m chunk rows of a stripe distributed
  across lanes with positionally-distinct roles (the analog of
  crush_choose_indep + shard_id_t); reconstruction gathers surviving
  rows onto the lane that rebuilds them.

The bulk data moves by copies between the process's own devices (peer
copies across cards, device-to-device copies on one); control-plane
traffic uses :mod:`ceph_tpu_torch.msg`'s TCP messenger.
"""

from .distributed import make_ec_step
from .mesh import ec_shard_axis, make_mesh

__all__ = ["ec_shard_axis", "make_mesh", "make_ec_step"]
