"""ChurnPlanner: device-planned cluster churn at thousands-of-OSDs scale.

The port's own copy of ``ceph_tpu/osd/churn.py``.  The batched CRUSH
mapper (``crush/mapper_torch``, the ``crush_choose`` kernel on the
card) is the engine of churn *planning*: generate a large synthetic
cluster map (1k-10k OSDs under a multi-host crush tree), compute the
FULL pre- and post-churn PG->OSD mapping in one batched device pass per
pool (the ``pg_to_up_acting_osds`` pipeline of osd/osdmap.py with every
PG as one lane), and diff the two mappings into a :class:`ChurnPlan`:

- which PGs remap (the peering work the storm will trigger),
- expected shard/replica movement and bytes (the recovery work),
- peering-wave fan-in per surviving OSD (how many MOSDPGScan requests
  each member will serve when the new primaries peer),
- peering waves per new primary (how many PGs each must re-peer).

The per-PG pipeline stays on the planner's device: the placement seeds
(``_pps_vec``, the crush hashes' torch branch over int64 lanes holding
uint32 values, every sum masked to 32 bits), the rule, the up-state
lookup, the down/dne filtering with the stable left compaction of
replicated rows, the first-up primary, and the row diff of
:meth:`ChurnPlanner.diff`.  Only the changed rows come back to the host.

Bit-exactness contract: the device mapping equals the scalar
``OSDMap.pg_to_up_acting_osds`` for every PG of every supported pool
(:meth:`ChurnPlanner.verify_oracle` pins sampled PGs against the
scalar path), so a plan is *exactly* what the live daemons will compute
from the same map.

Supported maps (the device path): no primary-affinity table and rules
the batched mapper handles (``mapper_torch.supports``) — every map this
module generates qualifies.  ``pg_temp``/``primary_temp`` overlays are
applied on the host afterwards (they are O(churn) dicts, never
O(PGs)).  Other pools take the scalar pipeline per PG (``device=False``
in the result), so any map can be planned; that choice is made from the
map alone, and a fault inside the device path raises.

The planner runs on the card unless the caller passes ``device="cpu"``
(then the draw takes its plain torch version); without CUDA the default
raises ``DeviceUnavailableError``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

from ..crush import mapper_torch
from ..crush.hashes import crush_hash32_2
from ..crush.map import CrushMap
from ..device import resolve
from .osdmap import (
    CEPH_OSD_EXISTS,
    CEPH_OSD_UP,
    CRUSH_ITEM_NONE,
    FLAG_HASHPSPOOL,
    OSDMap,
    PGid,
    Pool,
)

NONE = CRUSH_ITEM_NONE
_M32 = 0xFFFFFFFF


# -- synthetic cluster maps ---------------------------------------------------


def synthetic_map(
    n_osds: int,
    osds_per_host: int = 16,
    *,
    replicated: "tuple[int, int] | None" = (3, 256),
    ec: "tuple[dict, int] | None" = None,
    seed_epoch: int = 1,
) -> OSDMap:
    """A large dev cluster: ``n_osds`` devices spread over
    ``ceil(n/osds_per_host)`` crush host buckets under one straw2 root,
    every OSD existing+up+in.

    ``replicated`` = (size, pg_num) adds a host-fault-domain replicated
    pool; ``ec`` = (profile dict, pg_num) adds an EC pool whose profile
    is validated through the plugin registry exactly like the mon does.
    Either may be None to skip that pool."""
    hosts: list[list[int]] = [
        list(range(i, min(i + osds_per_host, n_osds)))
        for i in range(0, n_osds, osds_per_host)
    ]
    m = OSDMap(CrushMap.hierarchical(hosts))
    m.epoch = seed_epoch
    m.set_max_osd(n_osds)
    for osd in range(n_osds):
        m.mark_up(osd)
        m.mark_in(osd)
    if replicated is not None:
        size, pg_num = replicated
        m.create_replicated_pool(
            "churn-rep", size=size, pg_num=pg_num, fault_domain_type=1
        )
    if ec is not None:
        profile, pg_num = ec
        m.set_erasure_code_profile("churn-ec-profile", profile)
        m.create_erasure_pool(
            "churn-ec", "churn-ec-profile", pg_num=pg_num,
            fault_domain_type=1,
        )
    return m


def apply_churn(
    m: OSDMap,
    *,
    kill: Iterable[int] = (),
    out: Iterable[int] = (),
    add: int = 0,
    rejoin: Iterable[int] = (),
) -> OSDMap:
    """The successor map one churn event produces: a COPY of ``m`` (the
    wire round trip, so nothing aliases) with ``kill`` marked down,
    ``out`` weighted out, ``rejoin`` marked up+in again, ``add`` fresh
    OSDs appended to the last (or a new) host bucket, and the epoch
    bumped — the same mutation order the mon's markdown/boot paths
    apply."""
    post = OSDMap.from_dict(m.to_dict())
    post.epoch = m.epoch + 1
    for osd in kill:
        post.mark_down(osd)
    for osd in out:
        post.mark_out(osd)
    for osd in rejoin:
        post.mark_up(osd)
        post.mark_in(osd)
    if add:
        first_new = post.max_osd
        new_ids = list(range(first_new, first_new + add))
        # new devices get their own host bucket (the common expansion
        # shape: a new chassis, not hot-plugged disks)
        root = post.crush.buckets[post.crush.root_id()]
        hid = post.crush.make_bucket(
            root.alg, 1, new_ids,
            [0x10000] * add, name=f"host-add{post.epoch}",
        )
        w = post.crush.buckets[hid].weight
        root.items.append(hid)
        root.item_weights.append(w)
        root.weight += w
        for osd in new_ids:
            post.mark_up(osd)
            post.mark_in(osd)
    return post


# -- the device mapping pipeline ----------------------------------------------


def _stable_mod_vec(x: torch.Tensor, b: int, bmask: int) -> torch.Tensor:
    """Vectorized ceph_stable_mod (reference:include/rados.h:84) over
    int64 lanes holding uint32 values."""
    masked = x & bmask
    return torch.where(masked < b, masked, x & (bmask >> 1))


def _pps_vec(pool: Pool, seeds: torch.Tensor) -> torch.Tensor:
    """Vectorized ``raw_pg_to_pps`` (reference:osd_types.cc:1357): the
    crush placement seed for every PG of the pool in one pass.  ``seeds``
    are int64 lanes; the result is int64 lanes in [0, 2^32), as numpy's
    uint32 arithmetic leaves them (the sum wraps)."""
    ps = _stable_mod_vec(seeds & _M32, pool.pgp_num, pool.pgp_num_mask)
    if pool.flags & FLAG_HASHPSPOOL:
        return crush_hash32_2(ps, pool.id & _M32)
    return (ps + pool.id) & _M32


def _int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2^32) -> int32 lanes holding the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


@dataclasses.dataclass
class PoolMapping:
    """One pool's full PG->OSD mapping on the planner's device:
    ``acting`` is [pg_num, width] int32 (CRUSH_ITEM_NONE holes;
    replicated rows compacted left), ``primary`` [pg_num] int32 (-1 = no
    primary).  ``device`` says the batched mapper produced it (False =
    the scalar pipeline, for maps it does not handle)."""

    pool_id: int
    acting: torch.Tensor
    primary: torch.Tensor
    device: bool

    def acting_of(self, seed: int) -> list[int]:
        return [int(o) for o in self.acting[seed].tolist()]


class ChurnPlanner:
    """Plan churn scenarios for one cluster map on a device: the card
    unless ``device="cpu"`` is passed (``DeviceUnavailableError`` without
    CUDA otherwise).

    The planner never mutates its map; :func:`apply_churn` produces the
    post-churn successor and :meth:`plan` diffs the two device
    mappings into a :class:`ChurnPlan`."""

    def __init__(self, osdmap: OSDMap, device=None):
        self.osdmap = osdmap
        self.device = resolve(device)

    # -- full-map computation ------------------------------------------------

    def map_pool(self, m: OSDMap, pool: Pool) -> PoolMapping:
        """The full (acting, primary) table for one pool — one batched
        device pass over every PG when the map/rule shape is supported,
        the scalar per-PG pipeline otherwise."""
        if self._device_ok(m, pool):
            return self._map_pool_device(m, pool)
        return self._map_pool_scalar(m, pool)

    def map_all(self, m: OSDMap | None = None) -> dict[int, PoolMapping]:
        m = m if m is not None else self.osdmap
        return {pid: self.map_pool(m, pool) for pid, pool in m.pools.items()}

    @staticmethod
    def _device_ok(m: OSDMap, pool: Pool) -> bool:
        """Whether the batched mapper serves this pool: decided from the
        map alone; an error raised while deciding propagates."""
        if m.osd_primary_affinity is not None and any(
            a != 0x10000 for a in m.osd_primary_affinity
        ):
            # the affinity re-draw is a per-PG scalar walk; none of the
            # maps this module generates set it
            return False
        ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        if ruleno < 0:
            return False
        return mapper_torch.supports(m.crush, ruleno)

    def _map_pool_device(self, m: OSDMap, pool: Pool) -> PoolMapping:
        ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        seeds = torch.arange(pool.pg_num, dtype=torch.int64, device=self.device)
        pps = _int32_bits(_pps_vec(pool, seeds))
        # the OSDMap's in/out weights are the rejection vector, exactly
        # like the scalar path (OSDMap.cc:1567); crush item ids can
        # exceed max_osd only on maps with gaps, which set_max_osd rules
        # out here
        raw = mapper_torch.vec_do_rule_lanes(
            m.crush, ruleno, pps, pool.size, list(m.osd_weight))
        acting, primary = self._raw_to_up_vec(m, pool, raw)
        self._apply_temp_overlays(m, pool, acting, primary)
        return PoolMapping(pool.id, acting, primary, device=True)

    def _map_pool_scalar(self, m: OSDMap, pool: Pool) -> PoolMapping:
        width = pool.size
        acting = np.full((pool.pg_num, width), NONE, dtype=np.int32)
        primary = np.full((pool.pg_num,), -1, dtype=np.int32)
        for seed in range(pool.pg_num):
            _u, _up, act, prim = m.pg_to_up_acting_osds(PGid(pool.id, seed))
            for i, o in enumerate(act[:width]):
                acting[seed, i] = o
            primary[seed] = prim
        return PoolMapping(pool.id, torch.from_numpy(acting).to(self.device),
                           torch.from_numpy(primary).to(self.device), device=False)

    @staticmethod
    def _raw_to_up_vec(
        m: OSDMap, pool: Pool, raw: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Vectorized ``_raw_to_up_osds`` on ``raw``'s device: down/dne
        filtering over the whole [pg_num, width] table (EC keeps
        positional holes, replicated compacts left), plus first-up
        primary selection."""
        n = max(1, m.max_osd)
        state = np.zeros(n, dtype=np.int32)
        state[: len(m.osd_state)] = np.asarray(m.osd_state, dtype=np.int32)
        up_bits = CEPH_OSD_UP | CEPH_OSD_EXISTS
        up_lut = torch.from_numpy((state & up_bits) == up_bits).to(raw.device)
        valid = (raw != NONE) & (raw >= 0) & (raw < n)
        safe = torch.where(valid, raw, 0).long()
        keep = valid & up_lut[safe]
        acting = torch.where(keep, raw, NONE)
        if pool.can_shift_osds():
            # compact each row left (stable): the reference's firstn
            # result drops down members and closes the gaps
            order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
            acting = acting.gather(1, order)
        filled = acting != NONE
        first = filled.to(torch.int32).argmax(dim=1, keepdim=True)  # first filled slot
        primary = torch.where(filled.any(dim=1), acting.gather(1, first)[:, 0], -1)
        return acting, primary.to(torch.int32)

    @staticmethod
    def _apply_temp_overlays(
        m: OSDMap, pool: Pool, acting: torch.Tensor, primary: torch.Tensor
    ) -> None:
        """pg_temp / primary_temp host overlay (O(overrides), not
        O(PGs)) — applied through the scalar path so the semantics can
        never drift from osdmap.py."""
        if not m.pg_temp and not m.primary_temp:
            return
        width = acting.shape[1]
        touched = {
            pg.seed for pg in list(m.pg_temp) + list(m.primary_temp)
            if pg.pool == pool.id and 0 <= pg.seed < acting.shape[0]
        }
        for seed in touched:
            _u, _up, act, prim = m.pg_to_up_acting_osds(PGid(pool.id, seed))
            row = (list(act[:width]) + [NONE] * width)[:width]
            acting[seed] = torch.tensor(row, dtype=torch.int32, device=acting.device)
            primary[seed] = prim

    # -- the oracle pin ------------------------------------------------------

    def verify_oracle(
        self, m: OSDMap | None = None, samples: int = 64,
        rng: "np.random.Generator | None" = None,
    ) -> int:
        """Bit-match sampled PGs of every pool against the scalar
        ``pg_to_up_acting_osds`` oracle.  Returns the number of PGs
        checked; raises AssertionError with the first divergence —
        a plan from a mapping that disagrees with what live daemons
        compute would 'predict' storms that never happen."""
        m = m if m is not None else self.osdmap
        rng = rng or np.random.default_rng(0)
        checked = 0
        for pool in m.pools.values():
            mapping = self.map_pool(m, pool)
            take = min(samples, pool.pg_num)
            seeds = rng.choice(pool.pg_num, size=take, replace=False)
            idx = torch.as_tensor(seeds, dtype=torch.int64, device=self.device)
            rows = mapping.acting.index_select(0, idx).tolist()
            prims = mapping.primary.index_select(0, idx).tolist()
            width = mapping.acting.shape[1]
            for seed, got, got_primary in zip(seeds, rows, prims):
                seed = int(seed)
                _u, _up, act, prim = m.pg_to_up_acting_osds(
                    PGid(pool.id, seed)
                )
                want = (list(act[:width]) + [NONE] * width)[:width]
                assert got == want, (
                    f"pool {pool.id} pg {seed}: device {got} != "
                    f"oracle {want}"
                )
                assert got_primary == prim, (
                    f"pool {pool.id} pg {seed}: device primary "
                    f"{got_primary} != oracle {prim}"
                )
                checked += 1
        return checked

    # -- the plan ------------------------------------------------------------

    def plan(
        self,
        post: OSDMap,
        *,
        bytes_per_pg: "Mapping[int, int] | int" = 0,
    ) -> "ChurnPlan":
        """Diff this planner's map against its churned successor.

        ``bytes_per_pg`` scales the movement estimate: bytes of logical
        data per PG (int for all pools, or {pool_id: bytes}).  EC pools
        move ``bytes/k`` per remapped shard slot; replicated pools move
        the full PG bytes per new member."""
        return self.diff(self.map_all(self.osdmap), self.map_all(post), post,
                         bytes_per_pg=bytes_per_pg)

    def diff(
        self,
        pre_maps: Mapping[int, PoolMapping],
        post_maps: Mapping[int, PoolMapping],
        post: OSDMap,
        *,
        bytes_per_pg: "Mapping[int, int] | int" = 0,
    ) -> "ChurnPlan":
        """:meth:`plan` from the two maps' mappings (``map_all`` of this
        planner's map and of ``post``): the rows that differ are found on
        the device, and only those come back to the host."""
        remapped: dict[int, list[dict]] = {}
        moved_shards = 0
        movement_bytes = 0
        fan_in: dict[int, int] = {}
        waves: dict[int, int] = {}
        device = True
        for pid, pre in pre_maps.items():
            pool = self.osdmap.pools[pid]
            postm = post_maps.get(pid)
            if postm is None:
                continue
            device = device and pre.device and postm.device
            k = self._pool_k(pool)
            per_pg = (
                bytes_per_pg.get(pid, 0)
                if isinstance(bytes_per_pg, Mapping) else int(bytes_per_pg)
            )
            changed = torch.nonzero(
                (pre.acting != postm.acting).any(dim=1)
                | (pre.primary != postm.primary)
            )[:, 0]
            width = pre.acting.shape[1]
            # one copy back: [changed, pre row | post row | pre primary |
            # post primary]
            rows = torch.cat([
                pre.acting.index_select(0, changed),
                postm.acting.index_select(0, changed),
                pre.primary.index_select(0, changed)[:, None],
                postm.primary.index_select(0, changed)[:, None],
            ], dim=1).tolist()
            entries = []
            for seed, row in zip(changed.tolist(), rows):
                pre_row = row[:width]
                post_row = row[width:2 * width]
                if pool.can_shift_osds():
                    moved = [
                        o for o in post_row
                        if o != NONE and o not in pre_row
                    ]
                    shard_bytes = per_pg
                else:
                    # positional: a slot whose holder changed must be
                    # rebuilt on the new holder
                    moved = [
                        post_row[i] for i in range(len(post_row))
                        if post_row[i] != NONE and post_row[i] != pre_row[i]
                    ]
                    shard_bytes = per_pg // max(1, k)
                moved_shards += len(moved)
                movement_bytes += shard_bytes * len(moved)
                prim = row[2 * width + 1]
                if prim >= 0:
                    waves[prim] = waves.get(prim, 0) + 1
                    # the new primary scans every post-acting member
                    # (MOSDPGScan fan-in; its own shard scans locally)
                    for o in post_row:
                        if o != NONE and o != prim:
                            fan_in[o] = fan_in.get(o, 0) + 1
                entries.append({
                    "seed": seed,
                    "pre": pre_row,
                    "post": post_row,
                    "pre_primary": row[2 * width],
                    "post_primary": prim,
                    "moved": moved,
                })
            if entries:
                remapped[pid] = entries
        return ChurnPlan(
            pre_epoch=self.osdmap.epoch,
            post_epoch=post.epoch,
            remapped=remapped,
            moved_shards=moved_shards,
            movement_bytes=movement_bytes,
            fan_in=fan_in,
            waves=waves,
            device=device,
        )

    def _pool_k(self, pool: Pool) -> int:
        if not pool.is_erasure():
            return 1
        # k from the stored profile (no codec instantiation per plan);
        # size-1 (m=1) when the profile went missing
        profile = self.osdmap.get_erasure_code_profile(
            pool.erasure_code_profile
        )
        try:
            return max(1, int(profile.get("k", pool.size - 1)))
        except (TypeError, ValueError):
            return max(1, pool.size - 1)


@dataclasses.dataclass
class ChurnPlan:
    """The device-planned churn outcome (see module docstring)."""

    pre_epoch: int
    post_epoch: int
    # pool id -> [{"seed", "pre", "post", "pre_primary", "post_primary",
    #              "moved"}]
    remapped: dict[int, list[dict]]
    moved_shards: int
    movement_bytes: int
    fan_in: dict[int, int]   # osd -> expected MOSDPGScan requests
    waves: dict[int, int]    # new primary -> PGs it must re-peer
    device: bool

    def remapped_pgs(self, pool_id: int | None = None) -> set[str]:
        """The predicted remap set as ``"pool.seedhex"`` PG names —
        comparable to what a live cluster's maps/peering produce."""
        out: set[str] = set()
        for pid, entries in self.remapped.items():
            if pool_id is not None and pid != pool_id:
                continue
            for e in entries:
                out.add(str(PGid(pid, e["seed"])))
        return out

    def summary(self) -> dict:
        n_remapped = sum(len(v) for v in self.remapped.values())
        return {
            "pre_epoch": self.pre_epoch,
            "post_epoch": self.post_epoch,
            "pgs_remapped": n_remapped,
            "moved_shards": self.moved_shards,
            "movement_bytes": self.movement_bytes,
            "peering_waves": dict(sorted(self.waves.items())),
            "scan_fan_in": dict(sorted(self.fan_in.items())),
            "max_fan_in": max(self.fan_in.values(), default=0),
            "device": self.device,
        }
