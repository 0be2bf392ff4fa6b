"""CrushMap ⇄ plain-dict encoding.

The port's own copy of ``ceph_tpu/crush/encoding.py``: the same data and code,
so a map carried across by the wire form (``encoding``) maps identically
in both packages.

The reference ships binary encode/decode on ``CrushWrapper``
(reference:src/crush/CrushWrapper.h encode/decode) so maps travel inside
OSDMap epochs and crushtool files.  Here the wire form is a JSON-able
dict (the messenger layer does the byte framing); the shape is stable and
covers every bucket variant, rules, tunables, and name tables.
"""

from __future__ import annotations

import dataclasses

from .map import (
    Bucket,
    CrushMap,
    ListBucket,
    Rule,
    RuleStep,
    StrawBucket,
    Straw2Bucket,
    TreeBucket,
    Tunables,
    UniformBucket,
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
)

_BUCKET_CLASSES = {
    CRUSH_BUCKET_UNIFORM: UniformBucket,
    CRUSH_BUCKET_LIST: ListBucket,
    CRUSH_BUCKET_TREE: TreeBucket,
    CRUSH_BUCKET_STRAW: StrawBucket,
    CRUSH_BUCKET_STRAW2: Straw2Bucket,
}


def crush_to_dict(cmap: CrushMap) -> dict:
    return {
        "tunables": dataclasses.asdict(cmap.tunables),
        "buckets": [dataclasses.asdict(b) for b in cmap.buckets.values()],
        "rules": [
            None if r is None else {
                "ruleset": r.ruleset,
                "type": r.type,
                "min_size": r.min_size,
                "max_size": r.max_size,
                "steps": [[s.op, s.arg1, s.arg2] for s in r.steps],
            }
            for r in cmap.rules
        ],
        "type_names": {str(k): v for k, v in cmap.type_names.items()},
        "item_names": {str(k): v for k, v in cmap.item_names.items()},
        "rule_names": {
            str(k): v for k, v in getattr(cmap, "rule_names", {}).items()
        },
        # device classes (reference encodes class_map/class_name/
        # class_bucket the same way; shadow buckets travel in "buckets")
        "class_names": {str(k): v for k, v in cmap.class_names.items()},
        "class_map": {str(k): v for k, v in cmap.class_map.items()},
        "class_bucket": {
            str(b): {str(c): s for c, s in by_class.items()}
            for b, by_class in cmap.class_bucket.items()
        },
        # id reservations must survive the wire: a rebuild on the far
        # side may never hand a rule-held shadow id to a different
        # (bucket, class)
        "shadow_ids": [
            [b, c, s] for (b, c), s in cmap._shadow_ids.items()
        ],
    }


def crush_from_dict(d: dict) -> CrushMap:
    cmap = CrushMap(Tunables(**d["tunables"]))
    for bd in d["buckets"]:
        cls = _BUCKET_CLASSES.get(bd["alg"], Bucket)
        fields = {f.name for f in dataclasses.fields(cls)}
        bucket = cls(**{k: v for k, v in bd.items() if k in fields})
        cmap.buckets[bucket.id] = bucket
    for rd in d["rules"]:
        if rd is None:
            cmap.rules.append(None)
            continue
        rule = Rule(
            ruleset=rd["ruleset"], type=rd["type"],
            min_size=rd["min_size"], max_size=rd["max_size"],
            steps=[RuleStep(*s) for s in rd["steps"]],
        )
        cmap.rules.append(rule)
    cmap.type_names = {int(k): v for k, v in d["type_names"].items()}
    cmap.item_names = {int(k): v for k, v in d["item_names"].items()}
    cmap.rule_names = {
        int(k): v for k, v in d.get("rule_names", {}).items()
    }
    cmap.class_names = {
        int(k): v for k, v in d.get("class_names", {}).items()
    }
    cmap.class_map = {int(k): v for k, v in d.get("class_map", {}).items()}
    cmap.class_bucket = {
        int(b): {int(c): s for c, s in by_class.items()}
        for b, by_class in d.get("class_bucket", {}).items()
    }
    cmap._shadow_owner = {
        sid: (bid, cid)
        for bid, by_class in cmap.class_bucket.items()
        for cid, sid in by_class.items()
    }
    cmap._shadow_ids = {
        (bid, cid): sid for bid, cid, sid in d.get("shadow_ids", [])
    }
    # older encodings: derive the reservations from the live shadows
    for sid, (bid, cid) in cmap._shadow_owner.items():
        cmap._shadow_ids.setdefault((bid, cid), sid)
    return cmap
