"""CRUSH map model + builder (CrushWrapper / builder.c analog).

The port's own copy of ``ceph_tpu/crush/map.py``: the same data and code,
so a map carried across by the wire form (``encoding``) maps identically
in both packages.

Pure-Python description of the placement hierarchy: devices (ids >= 0),
buckets (ids < 0) of five algorithms, rules of interpreted steps, and the
tunables that version the mapping behavior
(reference:src/crush/crush.h:229-370, builder reference:src/crush/
builder.c, C++ wrapper reference:src/crush/CrushWrapper.h).

Derived bucket state (list cumulative sums, tree node weights, straw
lengths) is computed at construction exactly as ``crush_make_bucket``
does, so a map built here maps bit-identically to one built by the
reference builder — verified against golden fixtures in
tests/golden/crush_golden.json.

All weights are 16.16 fixed point (0x10000 == 1.0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence

# bucket algorithms (reference:crush.h:140-190)
CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

# rule step opcodes (reference:crush.h:55-69)
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

# sentinel outputs (reference:crush.h:33-37)
CRUSH_ITEM_UNDEF = 0x7FFFFFFE
CRUSH_ITEM_NONE = 0x7FFFFFFF

# rule types (pool replication strategy; reference:osd/osd_types.h pg_pool_t)
RULE_TYPE_REPLICATED = 1
RULE_TYPE_ERASURE = 3


@dataclass
class Bucket:
    """Common bucket header (reference:crush.h:229)."""

    id: int  # negative
    type: int  # user-defined level (host/rack/root...)
    alg: int
    items: list[int]
    weight: int = 0  # 16.16 total
    hash: int = 0  # CRUSH_HASH_RJENKINS1

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class UniformBucket(Bucket):
    """All items share one weight; O(1) perm choose (reference:crush.h:243)."""

    item_weight: int = 0


@dataclass
class ListBucket(Bucket):
    """Linear scan with cumulative sums (reference:crush.h:252)."""

    item_weights: list[int] = field(default_factory=list)
    sum_weights: list[int] = field(default_factory=list)  # cumulative 0..i


@dataclass
class TreeBucket(Bucket):
    """Binary weight tree; items at odd nodes (reference:crush.h:261)."""

    num_nodes: int = 0
    node_weights: list[int] = field(default_factory=list)


@dataclass
class StrawBucket(Bucket):
    """Legacy straw: precomputed straw lengths (reference:crush.h:271)."""

    item_weights: list[int] = field(default_factory=list)
    straws: list[int] = field(default_factory=list)  # 16.16


@dataclass
class Straw2Bucket(Bucket):
    """straw2: ln-draw selection, weights used directly (crush.h:280)."""

    item_weights: list[int] = field(default_factory=list)


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    """A placement rule (reference:crush.h:91): mask + step program."""

    ruleset: int
    type: int = RULE_TYPE_REPLICATED
    min_size: int = 1
    max_size: int = 10
    steps: list[RuleStep] = field(default_factory=list)

    def step(self, op: int, arg1: int = 0, arg2: int = 0) -> "Rule":
        self.steps.append(RuleStep(op, arg1, arg2))
        return self


@dataclass
class Tunables:
    """Mapping-behavior knobs (reference:crush.h:319-370).

    Defaults are the legacy (argonaut) values ``crush_create`` sets
    (reference:builder.c:25-35); use the profile constructors for the
    modern ones.
    """

    choose_local_tries: int = 2
    choose_local_fallback_tries: int = 5
    choose_total_tries: int = 19
    chooseleaf_descend_once: int = 0
    chooseleaf_vary_r: int = 0
    chooseleaf_stable: int = 0
    straw_calc_version: int = 0

    @classmethod
    def legacy(cls) -> "Tunables":
        return cls()

    @classmethod
    def bobtail(cls) -> "Tunables":
        return cls(0, 0, 50, 1, 0, 0, 0)

    @classmethod
    def firefly(cls) -> "Tunables":
        return cls(0, 0, 50, 1, 1, 0, 1)

    @classmethod
    def jewel(cls) -> "Tunables":
        """aka "optimal" at the reference version."""
        return cls(0, 0, 50, 1, 1, 1, 1)


class CrushMap:
    """The placement map: buckets + rules + tunables + name tables.

    Combines ``crush_map`` (reference:crush.h:299) with the builder and
    the name/type bookkeeping of ``CrushWrapper``
    (reference:src/crush/CrushWrapper.h).
    """

    def __init__(self, tunables: Tunables | None = None):
        self.buckets: dict[int, Bucket] = {}  # id (negative) -> bucket
        self.rules: list[Rule | None] = []
        self.tunables = tunables or Tunables.jewel()
        self.type_names: dict[int, str] = {0: "osd"}
        self.item_names: dict[int, str] = {}
        # device classes (reference:src/crush/CrushWrapper.h class_map /
        # class_name / class_bucket): tags on devices plus per-class
        # shadow hierarchies so `step take <root> class <c>` can place
        # onto hdd-only / ssd-only subtrees
        self.class_names: dict[int, str] = {}     # class id -> name
        self.class_map: dict[int, int] = {}       # device id -> class id
        # original bucket id -> {class id -> shadow bucket id}
        self.class_bucket: dict[int, dict[int, int]] = {}
        # shadow bucket id -> (original bucket id, class id)
        self._shadow_owner: dict[int, tuple[int, int]] = {}
        # (original id, class id) -> shadow id, RETAINED across rebuilds:
        # rules hold shadow ids in their TAKE steps, so an id assigned
        # once may never be recycled for a different (bucket, class) —
        # the reference reuses old class_bucket ids for the same reason
        self._shadow_ids: dict[tuple[int, int], int] = {}

    # -- structure queries -------------------------------------------------
    @property
    def max_buckets(self) -> int:
        return max((-b for b in self.buckets), default=0)

    @property
    def max_devices(self) -> int:
        md = 0
        for b in self.buckets.values():
            for i in b.items:
                if i >= 0:
                    md = max(md, i + 1)
        return md

    @property
    def max_rules(self) -> int:
        return len(self.rules)

    def devices(self) -> list[int]:
        out = set()
        for b in self.buckets.values():
            out.update(i for i in b.items if i >= 0)
        return sorted(out)

    # -- builder -----------------------------------------------------------
    def _next_bucket_id(self) -> int:
        i = -1
        while i in self.buckets:
            i -= 1
        return i

    def make_bucket(
        self,
        alg: int,
        type: int,
        items: Sequence[int],
        weights: Sequence[int],
        bucket_id: int | None = None,
        name: str | None = None,
    ) -> int:
        """Create a bucket with derived state, add it, return its id.

        Mirrors crush_make_bucket + crush_add_bucket
        (reference:builder.c:368,595,833,1070).
        """
        if bucket_id is None:
            bucket_id = self._next_bucket_id()
        if bucket_id >= 0 or bucket_id in self.buckets:
            raise ValueError(f"bad bucket id {bucket_id}")
        items = list(items)
        weights = list(weights)
        if len(items) != len(weights):
            raise ValueError("items/weights length mismatch")

        if alg == CRUSH_BUCKET_UNIFORM:
            iw = weights[0] if weights else 0
            if any(w != iw for w in weights):
                raise ValueError("uniform bucket requires equal weights")
            b: Bucket = UniformBucket(
                bucket_id, type, alg, items, iw * len(items), item_weight=iw
            )
        elif alg == CRUSH_BUCKET_LIST:
            sums, acc = [], 0
            for w in weights:
                acc += w
                sums.append(acc)
            b = ListBucket(
                bucket_id, type, alg, items, acc,
                item_weights=weights, sum_weights=sums,
            )
        elif alg == CRUSH_BUCKET_TREE:
            b = self._make_tree(bucket_id, type, items, weights)
        elif alg == CRUSH_BUCKET_STRAW:
            straws = calc_straws(weights, self.tunables.straw_calc_version)
            b = StrawBucket(
                bucket_id, type, alg, items, sum(weights),
                item_weights=weights, straws=straws,
            )
        elif alg == CRUSH_BUCKET_STRAW2:
            b = Straw2Bucket(
                bucket_id, type, alg, items, sum(weights),
                item_weights=weights,
            )
        else:
            raise ValueError(f"unknown bucket alg {alg}")

        self.buckets[bucket_id] = b
        if name:
            self.item_names[bucket_id] = name
        return bucket_id

    @staticmethod
    def _make_tree(bucket_id, type, items, weights) -> TreeBucket:
        """Binary tree layout: item i at node 2i+1, internal nodes sum
        children (reference:builder.c:320 calc_depth, :368)."""
        size = len(items)
        if size == 0:
            return TreeBucket(bucket_id, type, CRUSH_BUCKET_TREE, [], 0)
        depth = 1
        t = size - 1
        while t:
            t >>= 1
            depth += 1
        num_nodes = 1 << depth
        node_weights = [0] * num_nodes

        def fill(n: int) -> int:
            if n & 1:  # terminal
                i = n >> 1
                node_weights[n] = weights[i] if i < size else 0
            else:
                h = 0
                m = n
                while (m & 1) == 0:
                    h += 1
                    m >>= 1
                node_weights[n] = fill(n - (1 << (h - 1))) + fill(
                    n + (1 << (h - 1))
                )
            return node_weights[n]

        total = fill(num_nodes >> 1)
        return TreeBucket(
            bucket_id, type, CRUSH_BUCKET_TREE, list(items), total,
            num_nodes=num_nodes, node_weights=node_weights,
        )

    def add_rule(self, rule: Rule, ruleno: int | None = None) -> int:
        if ruleno is None:
            ruleno = len(self.rules)
        while len(self.rules) <= ruleno:
            self.rules.append(None)
        self.rules[ruleno] = rule
        return ruleno

    def find_rule(self, ruleset: int, type: int, size: int) -> int:
        """reference:mapper.c:41."""
        for i, r in enumerate(self.rules):
            if (r and r.ruleset == ruleset and r.type == type
                    and r.min_size <= size <= r.max_size):
                return i
        return -1

    def add_simple_rule(
        self,
        root_id: int,
        fault_domain_type: int,
        rule_type: int = RULE_TYPE_REPLICATED,
        ruleset: int | None = None,
        indep: bool = False,
        max_size: int = 10,
        device_class: str | None = None,
    ) -> int:
        """CrushWrapper::add_simple_ruleset analog: take root, chooseleaf
        across ``fault_domain_type``, emit.  With ``device_class`` the
        take step targets the class's shadow tree of ``root_id`` (the
        `create-replicated <name> <root> <type> <class>` path)."""
        if device_class is not None:
            root_id = self.class_shadow(root_id, device_class)
        if ruleset is None:
            used = {r.ruleset for r in self.rules if r}
            ruleset = 0
            while ruleset in used:
                ruleset += 1
        op = CRUSH_RULE_CHOOSELEAF_INDEP if indep else CRUSH_RULE_CHOOSELEAF_FIRSTN
        if fault_domain_type == 0:
            op = CRUSH_RULE_CHOOSE_INDEP if indep else CRUSH_RULE_CHOOSE_FIRSTN
        r = Rule(ruleset, rule_type, 1, max_size)
        if indep:
            r.step(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5)
        r.step(CRUSH_RULE_TAKE, root_id)
        r.step(op, 0, fault_domain_type)
        r.step(CRUSH_RULE_EMIT)
        return self.add_rule(r)

    # -- convenience constructors -----------------------------------------
    @classmethod
    def flat(
        cls,
        n_devices: int,
        weight: float = 1.0,
        alg: int = CRUSH_BUCKET_STRAW2,
        tunables: Tunables | None = None,
    ) -> "CrushMap":
        """One root bucket holding n devices — the vstart dev-cluster shape."""
        m = cls(tunables)
        w = int(weight * 0x10000)
        m.type_names[1] = "root"
        m.make_bucket(alg, 1, range(n_devices), [w] * n_devices,
                      name="default")
        return m

    @classmethod
    def hierarchical(
        cls,
        hosts: "list[Sequence[int]] | dict[str, Sequence[int]]",
        alg: int = CRUSH_BUCKET_STRAW2,
        tunables: Tunables | None = None,
    ) -> "CrushMap":
        """hosts: list of device-id lists (or dict name -> list). Builds
        host buckets under one straw2 root, types osd=0/host=1/root=2."""
        m = cls(tunables)
        m.type_names.update({1: "host", 2: "root"})
        if isinstance(hosts, dict):
            named = list(hosts.items())
        else:
            named = [(f"host{i}", devs) for i, devs in enumerate(hosts)]
        host_ids, host_weights = [], []
        for name, devs in named:
            w = [0x10000] * len(devs)
            hid = m.make_bucket(alg, 1, devs, w, name=name)
            host_ids.append(hid)
            host_weights.append(m.buckets[hid].weight)
        m.make_bucket(alg, 2, host_ids, host_weights, name="default")
        return m

    def tree_roots(self) -> list[int]:
        """Bucket ids that are nobody's child, shadow (device-class)
        hierarchies excluded — the single source of the roots rule
        (used by root_id, `ceph osd tree`, and the tester)."""
        children = {i for b in self.buckets.values() for i in b.items}
        return [
            bid for bid in self.buckets
            if bid not in children and bid not in self._shadow_owner
        ]

    def root_id(self, name: str = "default") -> int:
        for bid, n in self.item_names.items():
            if n == name:
                return bid
        # fall back: the bucket that is nobody's child (shadow roots
        # excluded — they mirror an original root, they don't add one)
        roots = self.tree_roots()
        if len(roots) == 1:
            return roots[0]
        raise KeyError(name)

    # -- device classes ----------------------------------------------------
    def class_id(self, name: str, create: bool = False) -> int:
        """reference:CrushWrapper.h get_class_id / get_or_create_class_id."""
        for cid, n in self.class_names.items():
            if n == name:
                return cid
        if not create:
            raise KeyError(f"unknown device class {name!r}")
        cid = max(self.class_names, default=-1) + 1
        self.class_names[cid] = name
        return cid

    def set_device_class(self, dev: int, name: str) -> int:
        """Tag device ``dev`` with class ``name`` (the `ceph osd crush
        set-device-class` mutation).  Shadow trees are NOT rebuilt here;
        call :meth:`populate_classes` once after a batch of tags."""
        if dev < 0:
            raise ValueError("device classes apply to devices, not buckets")
        cid = self.class_id(name, create=True)
        self.class_map[dev] = cid
        return cid

    def remove_device_class(self, dev: int) -> None:
        self.class_map.pop(dev, None)

    def device_class(self, dev: int) -> str | None:
        cid = self.class_map.get(dev)
        return None if cid is None else self.class_names.get(cid)

    def class_shadow(self, bucket_id: int, class_name: str) -> int:
        """The shadow bucket mirroring ``bucket_id`` restricted to
        ``class_name`` devices (reference:CrushWrapper.h
        get_item_id("<name>~<class>"))."""
        cid = self.class_id(class_name)
        try:
            return self.class_bucket[bucket_id][cid]
        except KeyError:
            raise KeyError(
                f"no shadow tree for bucket {bucket_id} class "
                f"{class_name!r}; call populate_classes()"
            ) from None

    def shadow_parent(self, bucket_id: int) -> tuple[int, int] | None:
        """(original id, class id) when ``bucket_id`` is a shadow, else
        None — the decompiler and OSDMap dumps use it to hide shadows."""
        return self._shadow_owner.get(bucket_id)

    def populate_classes(self) -> None:
        """(Re)build one shadow hierarchy per class in use
        (reference:CrushWrapper.cc populate_classes /
        device_class_clone): every original bucket gets a clone per
        class holding only that class's devices (and the clones of its
        child buckets), weights re-derived through the normal builder so
        straw lengths / tree nodes / list sums regenerate for the
        filtered membership.

        Shadow ids are STABLE: a (bucket, class) pair keeps its id
        across rebuilds — rules hold these ids in TAKE steps — and a
        class that lost all its devices keeps (empty) shadows rather
        than freeing ids another class could silently inherit.  The
        rebuild is exception-safe: on any error the previous shadow
        forest is restored before the error propagates.
        """
        saved_buckets = {
            sid: self.buckets.get(sid) for sid in self._shadow_owner
        }
        saved_names = {
            sid: self.item_names.get(sid) for sid in self._shadow_owner
        }
        saved_cb = {b: dict(v) for b, v in self.class_bucket.items()}
        saved_owner = dict(self._shadow_owner)
        for sid in list(self._shadow_owner):
            self.buckets.pop(sid, None)
            self.item_names.pop(sid, None)
        self.class_bucket.clear()
        self._shadow_owner.clear()
        try:
            self._rebuild_shadows()
        except Exception:
            for sid in list(self._shadow_owner):  # discard partial work
                self.buckets.pop(sid, None)
                self.item_names.pop(sid, None)
            for sid, b in saved_buckets.items():
                if b is not None:
                    self.buckets[sid] = b
            for sid, n in saved_names.items():
                if n is not None:
                    self.item_names[sid] = n
            self.class_bucket = saved_cb
            self._shadow_owner = saved_owner
            raise

    def _rebuild_shadows(self) -> None:
        # classes currently tagged PLUS classes that ever had shadows:
        # an id once handed to a rule must stay pinned to its
        # (bucket, class), even while the class is temporarily empty
        used = sorted(
            set(self.class_map.values())
            | {cid for _b, cid in self._shadow_ids}
        )
        if not used:
            return
        originals = sorted(
            (b for b in self.buckets if b not in self._shadow_owner),
            reverse=True,
        )

        def alloc(bid: int, cid: int) -> int:
            sid = self._shadow_ids.get((bid, cid))
            if sid is None:
                sid = -1
                taken = set(self._shadow_ids.values())
                while sid in self.buckets or sid in taken:
                    sid -= 1
                self._shadow_ids[(bid, cid)] = sid
            return sid

        for cid in used:
            cname = self.class_names[cid]
            done: dict[int, int] = {}

            def clone(bid: int, cid=cid, cname=cname, done=done) -> int:
                if bid in done:
                    return done[bid]
                b = self.buckets[bid]
                items: list[int] = []
                weights: list[int] = []
                for j, item in enumerate(b.items):
                    if item >= 0:
                        if self.class_map.get(item) != cid:
                            continue
                        items.append(item)
                        weights.append(_item_weight_of(b, j))
                    else:
                        sub = clone(item)
                        items.append(sub)
                        weights.append(self.buckets[sub].weight)
                alg = b.alg
                if alg == CRUSH_BUCKET_UNIFORM and len(set(weights)) > 1:
                    # a filtered uniform bucket can hold unequal child
                    # weights the uniform layout cannot express; straw2
                    # preserves the weight semantics for the shadow
                    alg = CRUSH_BUCKET_STRAW2
                name = self.item_names.get(bid, f"bucket{-1 - bid}")
                sid = self.make_bucket(
                    alg, b.type, items, weights,
                    bucket_id=alloc(bid, cid), name=f"{name}~{cname}",
                )
                self.buckets[sid].hash = b.hash
                done[bid] = sid
                self.class_bucket.setdefault(bid, {})[cid] = sid
                self._shadow_owner[sid] = (bid, cid)
                return sid

            for bid in originals:
                clone(bid)

    def get_weights(self, out: Iterable[int] = (), reweight: dict[int, float] | None = None) -> list[int]:
        """Device in/out weight vector for do_rule (OSDMap osd_weight analog).

        Full-in (0x10000) for every device, 0 for ``out`` ones, scaled by
        ``reweight`` fractions.
        """
        w = [0x10000] * self.max_devices
        for d in out:
            w[d] = 0
        for d, f in (reweight or {}).items():
            w[d] = int(f * 0x10000)
        return w


def _item_weight_of(b: Bucket, j: int) -> int:
    """Weight of item slot ``j`` across the bucket variants."""
    if b.alg == CRUSH_BUCKET_UNIFORM:
        return b.item_weight
    if b.alg == CRUSH_BUCKET_TREE:
        return b.node_weights[2 * j + 1]
    return b.item_weights[j]


def calc_straws(weights: Sequence[int], version: int = 0) -> list[int]:
    """Straw lengths for legacy straw buckets (reference:builder.c:440).

    Reverse-sorts by weight then scales each straw so that draw
    probabilities match the weight ratios; version 1 fixes the
    equal-weight/zero-weight accounting (straw_calc_version tunable).
    """
    size = len(weights)
    straws = [0] * size
    # insertion sort producing the reference's exact order for ties
    reverse = [0] * size
    if size:
        reverse[0] = 0
    for i in range(1, size):
        j = 0
        while j < i:
            if weights[i] < weights[reverse[j]]:
                for k in range(i, j, -1):
                    reverse[k] = reverse[k - 1]
                reverse[j] = i
                break
            j += 1
        if j == i:
            reverse[i] = i

    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[reverse[i]] == 0:
            straws[reverse[i]] = 0
            i += 1
            if version >= 1:
                numleft -= 1
            continue
        straws[reverse[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        if version == 0 and weights[reverse[i]] == weights[reverse[i - 1]]:
            continue
        wbelow += (weights[reverse[i - 1]] - lastw) * numleft
        if version == 0:
            j = i
            while j < size and weights[reverse[j]] == weights[reverse[i]]:
                numleft -= 1
                j += 1
        else:
            numleft -= 1
        wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
        lastw = weights[reverse[i - 1]]
    return straws
