"""Epoch-versioned cluster map: pools, devices, EC profiles, PG addressing.

The port's own copy of ``ceph_tpu/osd/osdmap.py``, built on the port's
``crush`` package and its own plugin registry.  Its wire dict
(``to_dict``/``from_dict``) and its ``Incremental`` are the same as the
reference's, so a map or a delta written by one package loads in the
other.

A re-expression of ``OSDMap`` (reference:src/osd/OSDMap.{h,cc}) and
``pg_pool_t`` (reference:src/osd/osd_types.{h,cc}).  The addressing
pipeline is bit-identical to the reference:

  object name ──rjenkins──▶ ps ──stable_mod──▶ pg ──pps──▶ crush ──▶ osds
  (hash_key, osd_types.cc:1325)   (raw_pg_to_pg :1348)
  (raw_pg_to_pps :1357)           (_pg_to_raw_osds OSDMap.cc:1555)

then `_raw_to_up_osds` (down/dne filtering — EC pools keep positional
CRUSH_ITEM_NONE holes), `_apply_primary_affinity`, and pg_temp /
primary_temp overrides compose `pg_to_up_acting_osds`
(reference:OSDMap.h:693).

Maps are plain picklable/JSON-able state so the MON can publish them over
the wire; epochs only ever grow.
"""

from __future__ import annotations

import logging
from dataclasses import asdict, dataclass, field
from typing import Mapping, Sequence

from ..accel.accelmap import AccelMap
from ..crush import (
    CRUSH_ITEM_NONE,
    RULE_TYPE_ERASURE,
    RULE_TYPE_REPLICATED,
    CrushMap,
)
from ..crush.encoding import crush_from_dict, crush_to_dict
from ..crush.hashes import crush_hash32_2
from ..crush.map import (
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_TAKE,
    Rule,
)
from ..crush.mapper import crush_do_rule
from ..models import registry
from ..utils.str_hash import CEPH_STR_HASH_RJENKINS, ceph_str_hash

# pool types (reference:osd/osd_types.h pg_pool_t TYPE_*)
POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

# osd state bits (reference:include/rados.h CEPH_OSD_*)
CEPH_OSD_UP = 1
CEPH_OSD_EXISTS = 2

# in-weight fixed point (reference:include/rados.h CEPH_OSD_IN/OUT)
CEPH_OSD_IN = 0x10000
CEPH_OSD_OUT = 0

# primary affinity fixed point (reference:include/rados.h)
CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000

FLAG_HASHPSPOOL = 1  # reference:pg_pool_t::FLAG_HASHPSPOOL
FLAG_FULL_QUOTA = 1 << 10  # reference:pg_pool_t::FLAG_FULL_QUOTA


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """reference:include/rados.h:84 — stable hash bucketing under pg_num
    growth (splitting only remaps children, never reshuffles)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _cbits(x: int) -> int:
    return x.bit_length()


@dataclass(frozen=True)
class PGid:
    """pg_t: (pool, seed) (reference:osd/osd_types.h)."""

    pool: int
    seed: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.seed:x}"

    @classmethod
    def parse(cls, s: str) -> "PGid":
        pool, seed = s.split(".")
        return cls(int(pool), int(seed, 16))


@dataclass(frozen=True)
class SPGid:
    """spg_t: shard-qualified pg for EC (reference:osd/osd_types.h)."""

    pgid: PGid
    shard: int = -1  # NO_SHARD for replicated

    def __str__(self) -> str:
        if self.shard < 0:
            return str(self.pgid)
        return f"{self.pgid}s{self.shard}"

    @classmethod
    def parse(cls, s: str) -> "SPGid":
        if "s" in s.split(".", 1)[1]:
            pg, shard = s.rsplit("s", 1)
            return cls(PGid.parse(pg), int(shard))
        return cls(PGid.parse(s))


@dataclass
class Pool:
    """pg_pool_t subset the data path needs (reference:osd_types.h:1225+)."""

    id: int
    name: str
    type: int = POOL_TYPE_REPLICATED
    size: int = 3  # k+m for EC
    min_size: int = 2
    pg_num: int = 8
    pgp_num: int = 8
    crush_ruleset: int = 0
    object_hash: int = CEPH_STR_HASH_RJENKINS
    flags: int = FLAG_HASHPSPOOL
    erasure_code_profile: str = ""
    stripe_width: int = 0
    # quotas (reference:pg_pool_t quota_max_bytes/objects): 0 = none.
    # The mgr compares the primaries' usage reports against these and
    # flips FLAG_FULL_QUOTA through the mon; enforcement is at the
    # OSD's write admission (approximate, like the reference — stats
    # lag the writes)
    quota_max_bytes: int = 0
    quota_max_objects: int = 0
    # snapshots (reference:osd_types.h pg_pool_t snap_seq/snaps/
    # removed_snaps): pool snaps are named and cluster-managed;
    # self-managed snaps only consume ids from the same sequence
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)  # snapid -> name
    removed_snaps: list = field(default_factory=list)
    # cache tiering (reference:osd_types.h pg_pool_t:1283-1292):
    # tier_of >= 0 makes this pool a cache TIER of that base pool;
    # read_tier/write_tier on the BASE redirect client ops to the cache
    # (the overlay); cache_mode drives the OSD's promote/flush behavior
    tier_of: int = -1
    tiers: list = field(default_factory=list)
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = "none"  # none | writeback
    hit_set_count: int = 4
    hit_set_period: float = 60.0
    cache_target_full_ratio: float = 0.8
    cache_target_dirty_ratio: float = 0.4
    cache_min_flush_age: float = 0.0
    cache_min_evict_age: float = 0.0
    target_max_objects: int = 0  # 0 = no cap; agent evicts toward
    target_max_bytes: int = 0    # full_ratio * target when set

    @property
    def pg_num_mask(self) -> int:
        return (1 << _cbits(self.pg_num - 1)) - 1

    @property
    def pgp_num_mask(self) -> int:
        return (1 << _cbits(self.pgp_num - 1)) - 1

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def can_shift_osds(self) -> bool:
        """Replicated sets compact; EC sets are positional
        (reference:osd_types.h:1460)."""
        return self.type == POOL_TYPE_REPLICATED

    def hash_key(self, key: str | bytes, nspace: str = "") -> int:
        """reference:osd_types.cc:1325."""
        if isinstance(key, str):
            key = key.encode()
        if nspace:
            key = nspace.encode() + b"\x1f" + key
        return ceph_str_hash(self.object_hash, key)

    def raw_pg_to_pg(self, pg: PGid) -> PGid:
        """reference:osd_types.cc:1348."""
        return PGid(pg.pool, ceph_stable_mod(pg.seed, self.pg_num, self.pg_num_mask))

    def raw_pg_to_pps(self, pg: PGid) -> int:
        """Placement seed fed to crush (reference:osd_types.cc:1357)."""
        if self.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2(
                ceph_stable_mod(pg.seed, self.pgp_num, self.pgp_num_mask),
                pg.pool,
            )
        return ceph_stable_mod(pg.seed, self.pgp_num, self.pgp_num_mask) + pg.pool


def build_simple(n_osds: int, crush: CrushMap | None = None) -> "OSDMap":
    """Dev-cluster map: flat crush, all osds existing+up+in
    (OSDMap::build_simple analog)."""
    m = OSDMap(crush or CrushMap.flat(n_osds))
    m.epoch = 1
    m.set_max_osd(n_osds)
    for osd in range(n_osds):
        m.mark_up(osd)
        m.mark_in(osd)
    return m


class OSDMap:
    """The cluster map (reference:src/osd/OSDMap.h)."""

    def __init__(self, crush: CrushMap | None = None):
        self.epoch = 0
        self.fsid = ""
        self.crush = crush or CrushMap()
        self.max_osd = 0
        self.osd_state: list[int] = []  # CEPH_OSD_UP|EXISTS bits
        self.osd_weight: list[int] = []  # in-weight, 0..0x10000
        self.osd_primary_affinity: list[int] | None = None
        self.osd_addrs: dict[int, str] = {}  # osd id -> "host:port"
        self.pools: dict[int, Pool] = {}
        self.pool_name: dict[str, int] = {}
        # cluster-wide flags (reference:OSDMap CEPH_OSDMAP_PAUSERD/WR,
        # NOSCRUB, NORECOVER, NOBACKFILL, NOOUT — `ceph osd set/unset`)
        self.cluster_flags: set[str] = set()
        self.erasure_code_profiles: dict[str, dict[str, str]] = {}
        self.pg_temp: dict[PGid, list[int]] = {}
        self.primary_temp: dict[PGid, int] = {}
        # MgrMap/MDSMap essentials, piggybacked on the OSDMap (the
        # reference versions separate maps; one versioned map is the
        # same contract at this scale — reference:src/mon/MgrMap.h,
        # src/mds/MDSMap.h)
        self.mgr_name = ""
        self.mgr_addr = ""
        self.mgr_standbys: list[tuple[str, str]] = []  # (name, addr)
        self.mds_name = ""
        self.mds_addr = ""
        self.mds_standbys: list[tuple[str, str]] = []
        # multi-active MDS (reference:src/mds/MDSMap.h in/up rank maps):
        # rank -> [name, addr] ("" = vacant/failed rank awaiting a
        # standby); mds_name/mds_addr mirror rank 0 for older callers
        self.mds_ranks: list[list[str]] = []
        self.mds_max = 1
        # the accelerator fleet map (accel/accelmap.py): owned by the mon
        # alongside this map and carried inside its wire dict, so Paxos
        # replication, persistence, incremental diffs and subscriber
        # pushes all reuse the OSDMap machinery
        self.accelmap = AccelMap()
        self._locality_cache: dict[int, str] | None = None

    # -- device lifecycle ----------------------------------------------------

    def set_max_osd(self, n: int) -> None:
        self.max_osd = n
        while len(self.osd_state) < n:
            self.osd_state.append(0)
            self.osd_weight.append(CEPH_OSD_OUT)

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(
            self.osd_state[osd] & CEPH_OSD_EXISTS
        )

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state[osd] & CEPH_OSD_UP)

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_in(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_weight[osd] > 0

    def is_out(self, osd: int) -> bool:
        return not self.is_in(osd)

    def create_osd(self, osd: int, addr: str = "") -> None:
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
        self.osd_state[osd] |= CEPH_OSD_EXISTS
        if addr:
            self.osd_addrs[osd] = addr

    def mark_up(self, osd: int, addr: str = "") -> None:
        self.create_osd(osd, addr)
        self.osd_state[osd] |= CEPH_OSD_UP

    def mark_down(self, osd: int) -> None:
        if 0 <= osd < self.max_osd:
            self.osd_state[osd] &= ~CEPH_OSD_UP

    def mark_in(self, osd: int, weight: int = CEPH_OSD_IN) -> None:
        self.create_osd(osd)
        self.osd_weight[osd] = weight

    def mark_out(self, osd: int) -> None:
        if 0 <= osd < self.max_osd:
            self.osd_weight[osd] = CEPH_OSD_OUT

    def get_addr(self, osd: int) -> str | None:
        return self.osd_addrs.get(osd)

    # -- pools / EC profiles -------------------------------------------------

    def add_pool(self, pool: Pool) -> None:
        self.pools[pool.id] = pool
        self.pool_name[pool.name] = pool.id

    def lookup_pool(self, name: str) -> Pool | None:
        pid = self.pool_name.get(name)
        return None if pid is None else self.pools[pid]

    def set_erasure_code_profile(self, name: str, profile: Mapping[str, str]) -> None:
        self.erasure_code_profiles[name] = dict(profile)

    def get_erasure_code_profile(self, name: str) -> dict[str, str]:
        return dict(self.erasure_code_profiles.get(name, {}))

    # -- addressing pipeline -------------------------------------------------

    def object_locator_to_pg(self, name: str, pool_id: int,
                             nspace: str = "") -> PGid:
        """Raw pg (un-modded seed) for an object (reference:OSDMap.cc:1506)."""
        pool = self.pools[pool_id]
        ps = pool.hash_key(name, nspace)
        return PGid(pool_id, ps)

    def _pg_to_raw_osds(self, pool: Pool, pg: PGid) -> list[int]:
        """reference:OSDMap.cc:1555 — crush placement with pps seed."""
        ruleno = self.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        if ruleno < 0:
            return []
        pps = pool.raw_pg_to_pps(pg)
        # the weight vector is the OSDMap's in/out weights, not crush
        # weights — out devices get probabilistically rejected in is_out
        # (reference passes osd_weight into do_rule, OSDMap.cc:1567)
        return crush_do_rule(
            self.crush, ruleno, pps, pool.size, list(self.osd_weight)
        )

    def _raw_to_up_osds(self, pool: Pool, raw: Sequence[int]) -> tuple[list[int], int]:
        """Down/dne filtering (reference:OSDMap.cc _raw_to_up_osds)."""
        if pool.can_shift_osds():
            up = [o for o in raw if o != CRUSH_ITEM_NONE and self.is_up(o)]
            return up, (up[0] if up else -1)
        up = []
        primary = -1
        for o in raw:
            if o == CRUSH_ITEM_NONE or not self.is_up(o):
                up.append(CRUSH_ITEM_NONE)
            else:
                up.append(o)
        for o in up:
            if o != CRUSH_ITEM_NONE:
                primary = o
                break
        return up, primary

    def _apply_primary_affinity(self, seed: int, pool: Pool,
                                osds: list[int], primary: int) -> tuple[list[int], int]:
        """reference:OSDMap.cc _apply_primary_affinity."""
        pa = self.osd_primary_affinity
        if pa is None:
            return osds, primary
        if not any(
            o != CRUSH_ITEM_NONE and pa[o] != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
            for o in osds
        ):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = pa[o]
            if a < CEPH_OSD_MAX_PRIMARY_AFFINITY and (
                crush_hash32_2(seed, o) >> 16
            ) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [primary] + osds[:pos] + osds[pos + 1 :]
        return osds, primary

    def _get_temp_osds(self, pool: Pool, pg: PGid) -> tuple[list[int], int]:
        """pg_temp / primary_temp overrides (reference:OSDMap.cc)."""
        temp = self.pg_temp.get(pg, [])
        temp_pg = [o for o in temp if pool.can_shift_osds() and self.is_up(o)] \
            if pool.can_shift_osds() else [
                o if (o == CRUSH_ITEM_NONE or self.is_up(o)) else CRUSH_ITEM_NONE
                for o in temp
            ]
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary < 0 and temp_pg:
            temp_primary = next(
                (o for o in temp_pg if o != CRUSH_ITEM_NONE), -1
            )
        return temp_pg, temp_primary

    def pg_to_up_acting_osds(
        self, pg: PGid
    ) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary) — reference:OSDMap.h:693."""
        pool = self.pools.get(pg.pool)
        if pool is None:
            return [], -1, [], -1
        mpg = pool.raw_pg_to_pg(pg)
        raw = self._pg_to_raw_osds(pool, mpg)
        up, up_primary = self._raw_to_up_osds(pool, raw)
        up, up_primary = self._apply_primary_affinity(
            pool.raw_pg_to_pps(mpg) & 0xFFFFFFFF, pool, up, up_primary
        )
        temp_pg, temp_primary = self._get_temp_osds(pool, mpg)
        acting = temp_pg if temp_pg else list(up)
        acting_primary = temp_primary if temp_primary >= 0 else up_primary
        if self.primary_temp.get(mpg, -1) >= 0:
            acting_primary = self.primary_temp[mpg]
        return list(up), up_primary, acting, acting_primary

    def object_to_acting(
        self, name: str, pool_id: int, nspace: str = ""
    ) -> tuple[PGid, list[int], int]:
        """Convenience: name -> (pg, acting set, primary)."""
        raw = self.object_locator_to_pg(name, pool_id, nspace)
        pool = self.pools[pool_id]
        pg = pool.raw_pg_to_pg(raw)
        _, _, acting, primary = self.pg_to_up_acting_osds(raw)
        return pg, acting, primary

    def pgs_of_pool(self, pool_id: int) -> list[PGid]:
        pool = self.pools[pool_id]
        return [PGid(pool_id, s) for s in range(pool.pg_num)]

    # -- pool creation (reference: mon/OSDMonitor.cc prepare_new_pool) -------

    def _next_pool_id(self) -> int:
        return max(self.pools, default=0) + 1

    def _ensure_shadow_trees(self) -> None:
        """Classes may be tagged without a populate (e.g. a compiled map
        with class tags but no class rules): build the shadow forest
        before a pool rule needs it, like the compiler's lazy path."""
        if self.crush.class_map and not self.crush.class_bucket:
            self.crush.populate_classes()

    def create_replicated_pool(
        self, name: str, size: int = 3, pg_num: int = 8,
        fault_domain_type: int = 0, device_class: str | None = None,
    ) -> Pool:
        if device_class:
            self._ensure_shadow_trees()
        root = self.crush.root_id()
        ruleset = len([r for r in self.crush.rules if r])
        self.crush.add_simple_rule(
            root, fault_domain_type, RULE_TYPE_REPLICATED, ruleset=ruleset,
            device_class=device_class,
        )
        pool = Pool(
            id=self._next_pool_id(), name=name, type=POOL_TYPE_REPLICATED,
            size=size, min_size=max(1, size - 1), pg_num=pg_num,
            pgp_num=pg_num, crush_ruleset=ruleset,
        )
        self.add_pool(pool)
        return pool

    def create_erasure_pool(
        self, name: str, profile_name: str, pg_num: int = 8,
        fault_domain_type: int = 0, stripe_unit: int = 4096,
    ) -> Pool:
        """Create an EC pool from a stored profile.

        Validates the profile by instantiating the plugin — exactly what the
        MON does before accepting a profile
        (reference:mon/OSDMonitor.cc:4590-4600) — and derives size=k+m and
        stripe_width=k*stripe_unit.
        """
        profile = self.get_erasure_code_profile(profile_name)
        if not profile:
            raise ValueError(f"no erasure-code profile named {profile_name!r}")
        plugin = profile.get("plugin", "jerasure")
        # the map reads only k, k+m and the placement steps and never
        # encodes, so the codec is built on the host, never on the card
        codec = registry.instance().factory(plugin, profile, device="cpu")
        k = codec.get_data_chunk_count()
        km = codec.get_chunk_count()
        root = self.crush.root_id(profile.get("ruleset-root", "default"))
        # profile-directed class placement (the reference's
        # crush-device-class EC-profile key): take the class's shadow
        # tree of the profile root
        device_class = profile.get("crush-device-class")
        if device_class:
            self._ensure_shadow_trees()
            root = self.crush.class_shadow(root, device_class)
        ruleset = len([r for r in self.crush.rules if r])
        steps = codec.get_ruleset_steps()
        added = False
        if steps:
            try:
                # codec-directed placement (LRC's per-layer steps,
                # reference:src/erasure-code/lrc/ErasureCodeLrc.cc:44)
                self._add_steps_rule(root, steps, ruleset, km)
                added = True
            except ValueError as e:
                # flat dev maps have no host/rack types: degrade to the
                # simple rule instead of refusing the pool (the locality
                # the steps encode needs a topology that does not exist)
                logging.getLogger("ceph_tpu_torch.osd").warning(
                    "pool %s: %s; using a simple rule", name, e
                )
        if not added:
            self.crush.add_simple_rule(
                root, fault_domain_type, RULE_TYPE_ERASURE, ruleset=ruleset,
                indep=True, max_size=km,
            )
        pool = Pool(
            id=self._next_pool_id(), name=name, type=POOL_TYPE_ERASURE,
            size=km, min_size=k + 1 if km > k + 1 else k, pg_num=pg_num,
            pgp_num=pg_num, crush_ruleset=ruleset,
            erasure_code_profile=profile_name,
            stripe_width=k * stripe_unit,
        )
        self.add_pool(pool)
        return pool

    def _add_steps_rule(
        self, root: int, steps, ruleset: int, max_size: int
    ) -> int:
        """Build a multi-step INDEP crush rule from codec placement steps
        [(op, type_name, n), ...] (reference:ErasureCodeLrc.cc:44
        create_ruleset: SET_CHOOSELEAF_TRIES 5, TAKE root, then one
        CHOOSE(LEAF)_INDEP per step, EMIT)."""
        type_of = {name: tid for tid, name in self.crush.type_names.items()}
        type_of.setdefault("osd", 0)
        rule = Rule(ruleset, RULE_TYPE_ERASURE, 1, max_size)
        rule.step(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5)
        rule.step(CRUSH_RULE_TAKE, root)
        for op, type_name, n in steps:
            if type_name not in type_of:
                raise ValueError(
                    f"placement step type {type_name!r} not in the crush "
                    f"map (types: {sorted(type_of)})"
                )
            step_op = (
                CRUSH_RULE_CHOOSELEAF_INDEP if op == "chooseleaf"
                else CRUSH_RULE_CHOOSE_INDEP
            )
            rule.step(step_op, int(n), type_of[type_name])
        rule.step(CRUSH_RULE_EMIT)
        return self.crush.add_rule(rule)

    def mds_rank_table(self) -> list[list[str]]:
        """The active-MDS rank table ([name, addr] per rank; "" pairs =
        vacant/failed slots awaiting a standby), with the legacy
        single-active fields as the upgrade fallback — the ONE place
        this fallback lives (mon, mds, and mgr all read it here)."""
        if self.mds_ranks:
            return [list(r) for r in self.mds_ranks]
        if self.mds_name:
            return [[self.mds_name, self.mds_addr]]
        return []

    def apply_incremental(self, inc: "Incremental") -> "OSDMap":
        """Return the successor map this delta produces (reference:
        src/osd/OSDMap.cc apply_incremental).  Raises ValueError on an
        epoch gap — the caller must fetch a full map instead."""
        if inc.base_epoch != self.epoch:
            raise ValueError(
                f"incremental for base epoch {inc.base_epoch} cannot "
                f"apply to map epoch {self.epoch}"
            )
        d = self.to_dict()
        inc.apply_to_dict(d)
        return OSDMap.from_dict(d)

    def locality_of(self, osd: int) -> str:
        """The locality label of ``osd``: the name of the crush HOST
        bucket holding it ("" when the topology is flat or the osd is
        unplaced).  This is the label decode batches carry so the
        accel router can prefer the accelerator co-located with the
        surviving shards (shard-locality decode); accel
        daemons advertise the matching label via ``accel_locality``."""
        table = self._locality_cache
        if table is None:
            host_types = {
                t for t, n in self.crush.type_names.items() if n == "host"
            }
            table = {}
            for bid, b in self.crush.buckets.items():
                if b.type not in host_types:
                    continue
                if bid in getattr(self.crush, "_shadow_owner", {}):
                    continue  # device-class shadow copies alias the host
                name = self.crush.item_names.get(bid, str(bid))
                for child in b.items:
                    if child >= 0:
                        table[child] = name
            self._locality_cache = table
        return table.get(osd, "")

    # -- wire form (reference: OSDMap::encode/decode) ------------------------

    def to_dict(self) -> dict:
        # every container is COPIED: the dict must be a snapshot, not a
        # view — Incremental.diff retains the previous epoch's dict, and
        # an aliased sub-dict would mutate in lockstep with the live map,
        # silently erasing the change from the delta (a profile set once
        # vanished from the mon's delta log this way)
        return {
            "epoch": self.epoch,
            "fsid": self.fsid,
            "crush": crush_to_dict(self.crush),
            "max_osd": self.max_osd,
            "osd_state": list(self.osd_state),
            "osd_weight": list(self.osd_weight),
            "osd_primary_affinity": (
                None if self.osd_primary_affinity is None
                else list(self.osd_primary_affinity)
            ),
            "osd_addrs": {str(k): v for k, v in self.osd_addrs.items()},
            "pools": {str(pid): asdict(p) for pid, p in self.pools.items()},
            "erasure_code_profiles": {
                k: dict(v) for k, v in self.erasure_code_profiles.items()
            },
            "pg_temp": {
                str(pg): list(osds) for pg, osds in self.pg_temp.items()
            },
            "primary_temp": {str(pg): o for pg, o in self.primary_temp.items()},
            "mgr_name": self.mgr_name,
            "mgr_addr": self.mgr_addr,
            "mgr_standbys": list(self.mgr_standbys),
            "mds_name": self.mds_name,
            "mds_addr": self.mds_addr,
            "mds_standbys": list(self.mds_standbys),
            "mds_ranks": [list(r) for r in self.mds_ranks],
            "mds_max": self.mds_max,
            "cluster_flags": sorted(self.cluster_flags),
            "accelmap": self.accelmap.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OSDMap":
        m = cls(crush_from_dict(d["crush"]))
        m.epoch = d["epoch"]
        m.fsid = d.get("fsid", "")
        m.max_osd = d["max_osd"]
        m.osd_state = list(d["osd_state"])
        m.osd_weight = list(d["osd_weight"])
        m.osd_primary_affinity = d.get("osd_primary_affinity")
        m.osd_addrs = {int(k): v for k, v in d.get("osd_addrs", {}).items()}
        for pid, pd in d["pools"].items():
            pool = Pool(**pd)
            # JSON stringifies the snapid keys
            pool.snaps = {int(k): v for k, v in pool.snaps.items()}
            m.pools[int(pid)] = pool
            m.pool_name[pool.name] = int(pid)
        m.erasure_code_profiles = {
            k: dict(v) for k, v in d.get("erasure_code_profiles", {}).items()
        }
        m.pg_temp = {
            PGid.parse(s): list(osds) for s, osds in d.get("pg_temp", {}).items()
        }
        m.primary_temp = {
            PGid.parse(s): o for s, o in d.get("primary_temp", {}).items()
        }
        m.mgr_name = d.get("mgr_name", "")
        m.mgr_addr = d.get("mgr_addr", "")
        m.mgr_standbys = [tuple(x) for x in d.get("mgr_standbys", [])]
        m.mds_name = d.get("mds_name", "")
        m.mds_addr = d.get("mds_addr", "")
        m.mds_standbys = [tuple(x) for x in d.get("mds_standbys", [])]
        m.mds_ranks = [list(x) for x in d.get("mds_ranks", [])]
        m.mds_max = int(d.get("mds_max", 1))
        m.cluster_flags = set(d.get("cluster_flags", []))
        m.accelmap = AccelMap.from_dict(d.get("accelmap"))
        return m


class Incremental:
    """Epoch delta between consecutive OSDMaps (reference:src/osd/
    OSDMap.h:111 ``class Incremental``).

    The reference's Incremental is a typed field-set (new_up_client,
    new_weight, new_pools, ...); here the map's canonical wire form is
    already a JSON-shaped dict, so the delta is STRUCTURAL: a recursive
    diff of the two dicts, recording leaf sets and deletions by path.
    That covers every present and future map field (pools, crush,
    pg_temp, mgr/mds seats) with one mechanism, and its size is
    O(changed entries) — the property that makes per-epoch distribution
    and storage scale with churn instead of cluster size.

    Wire form: ``{"epoch": E, "base": E-1, "set": [[path, value], ...],
    "del": [path, ...]}`` where path is a list of dict keys.  Lists and
    scalars are replaced wholesale (osd_state/osd_weight are int lists —
    cheap; crush replaces only when the topology actually changed).
    """

    def __init__(self, epoch: int, base_epoch: int,
                 sets: list, dels: list):
        self.epoch = epoch
        self.base_epoch = base_epoch
        self.sets = sets  # [(path list, new value)]
        self.dels = dels  # [path list]

    # -- construction --------------------------------------------------------

    @classmethod
    def diff(cls, old: dict, new: dict) -> "Incremental":
        """Delta producing ``new`` from ``old`` (both OSDMap.to_dict())."""
        sets: list = []
        dels: list = []

        def walk(path: list, a, b) -> None:
            if isinstance(a, dict) and isinstance(b, dict):
                for k in a:
                    if k not in b:
                        dels.append(path + [k])
                for k, bv in b.items():
                    if k not in a:
                        sets.append((path + [k], bv))
                    elif a[k] != bv:
                        walk(path + [k], a[k], bv)
            else:
                sets.append((list(path), b))

        walk([], old, new)
        return cls(int(new["epoch"]), int(old["epoch"]), sets, dels)

    # -- application ---------------------------------------------------------

    def apply_to_dict(self, d: dict) -> dict:
        for path in self.dels:
            node = d
            for k in path[:-1]:
                node = node[k]
            node.pop(path[-1], None)
        for path, value in self.sets:
            node = d
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = value
        return d

    # -- wire ----------------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "base": self.base_epoch,
            "set": [[list(p), v] for p, v in self.sets],
            "del": [list(p) for p in self.dels],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Incremental":
        return cls(
            int(d["epoch"]), int(d["base"]),
            [(list(p), v) for p, v in d["set"]],
            [list(p) for p in d["del"]],
        )


def advance_map(current: "OSDMap | None", epoch: int,
                full_dict: dict | None,
                incrementals: "list[dict] | None") -> "OSDMap | None":
    """Shared MOSDMapMsg application for every map consumer (OSD,
    client, mgr, mds — the reference's handle_osd_map incremental path,
    reference:src/osd/OSD.cc handle_osd_map).

    Applies the contiguous incremental chain when it reaches from
    ``current`` to ``epoch``; falls back to the full dict when present.
    Returns the advanced map, ``current`` when already up to date, or
    None when there is a gap the message cannot bridge (caller must
    request a full map)."""
    if current is not None and epoch <= current.epoch:
        return current
    m = current
    for inc_d in incrementals or []:
        inc = Incremental.from_dict(inc_d)
        if m is None or inc.base_epoch != m.epoch:
            continue  # chain does not touch our epoch (yet)
        m = m.apply_incremental(inc)
    if m is not None and m.epoch == epoch:
        return m
    if full_dict is not None:
        return OSDMap.from_dict(full_dict)
    return None
