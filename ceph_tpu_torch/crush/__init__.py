"""CRUSH — deterministic placement (reference:src/crush/), on torch.

Counterpart of ``ceph_tpu/crush``:

- :mod:`.hashes`    — rjenkins1 integer hash (scalar / numpy / torch).
- :mod:`.ln_tables` — straw2's fixed-point log2 protocol constants.
- :mod:`.map`       — map model + builder (buckets, rules, tunables).
- :mod:`.mapper`    — scalar rule interpreter, bit-exact vs reference.
- :mod:`.encoding`, :mod:`.compiler` — the JSON wire form and the text
  grammar.
- :mod:`.mapper_torch`, :mod:`.mapper_torch_hier` — bulk placement over
  batches of x on torch lanes (on the card, the ``crush_choose`` kernel
  for a single-step rule, the step engine on ``crush_straw2`` for the
  rest).
- :mod:`.tester`    — ``CrushTester``, the ``crushtool --test`` engine.
"""

from .hashes import (
    crush_hash32,
    crush_hash32_2,
    crush_hash32_3,
    crush_hash32_4,
    crush_hash32_5,
)
from .map import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_TAKE,
    RULE_TYPE_ERASURE,
    RULE_TYPE_REPLICATED,
    CrushMap,
    Rule,
    Tunables,
)
from .mapper import Workspace, crush_do_rule, crush_ln

__all__ = [n for n in dir() if not n.startswith("_")]
