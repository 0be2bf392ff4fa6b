"""Batched CRUSH for HIERARCHICAL maps (chooseleaf and chained rules) on
torch lanes.

Counterpart of ``ceph_tpu/crush/mapper_jax_hier.py``: multi-level straw2
hierarchies, the hosts×racks maps whose bulk simulation is the
reference's target (reference:src/crush/mapper.c:421
crush_choose_firstn recursive descent + chooseleaf, :612
crush_choose_indep; rule interpreter :854).

Design
------
Per-map tables (:class:`MapTables`: padded int32 [B, I] items, 16.16
weights and their reciprocals, child rows and child types, a [B] size
and an id -> row lookup) let one draw evaluate straw2 for a *different
bucket per lane*:
the routed draw ``crush_torch.straw2`` reads each lane's row itself (on
the card, the ``crush_straw2`` kernel).  The descent from the TAKE root
to the target type is a loop bounded by the map's depth; the firstn
retry ladder (per-lane ftotal), the chooseleaf inner recursion
(single-rep firstn at type 0 with vary_r/stable semantics), and indep's
round-global retries (each round's reps drawn at once) are masked
loops over [X] lanes that stay on the device — the exact control flow
of the scalar mapper, one mask per branch.  Each loop reads one flag
back to the host per level or round, to stop when no lane is left.
These loops are the step engine: on the card, a single-step rule
(:func:`fused_rule`) runs instead as one ``crush_choose`` launch, and
they remain its plain version and the chained rules' engine.

The draw is exact, so every lane is bit-identical to ``crush_do_rule``.
What the reference needs only because its TPU draw is an f32
approximation is not ported: the packed one-hot matmul row fetch, the
error budgets and ambiguity flags, and the numpy exact engines
(``np_choose_*_hier``, ``np_do_rule_hier``, ``_np_chain``) that re-run
flagged lanes on the host.

Supported shape (``supports_hier``), as the reference's:
- every bucket straw2 (weights below 2^31); acyclic, bounded depth;
- one TAKE -> one CHOOSE[LEAF]_FIRSTN/INDEP -> EMIT (any target type);
- modern tunables (choose_local_tries == choose_local_fallback_tries
  == 0); chooseleaf_vary_r / chooseleaf_stable fully supported;
- CHAINED rules — TAKE -> CHOOSE_INDEP -> ... -> CHOOSE[LEAF]_INDEP ->
  EMIT, the LRC per-layer shape
  (reference:src/erasure-code/lrc/ErasureCodeLrc.cc:44) — each later
  step one flattened [X*width] run rooted at the previous step's
  buckets.  The scalar interpreter skips a previous slot that holds no
  bucket and clamps the last region at ``result_max``; the chain engine
  does both on the device (the reference re-runs such lanes on the
  host).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import crush_torch, gf_cuda
from .map import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_TAKE,
    CrushMap,
)

_NONE = CRUSH_ITEM_NONE
_UNDEF = 0x7FFFFFFE  # CRUSH_ITEM_UNDEF
_LANE = torch.int32

_CHOOSE_OPS = (
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
)


# -- per-map device tables ---------------------------------------------------


class MapTables:
    """Padded int32 bucket tables on one device (host-built; cached on
    the map object per device by :func:`tables_for`), with each straw2
    weight's reciprocal (``crush_torch.recip_table``) beside the weights
    and the rows' sizes also on the host (``sizes``)."""

    def __init__(self, cmap: CrushMap, device: torch.device):
        bids = sorted(cmap.buckets)
        self.row_of = {bid: i for i, bid in enumerate(bids)}
        B = len(bids)
        I = max((len(cmap.buckets[b].items) for b in bids), default=1) or 1
        items = np.full((B, I), _NONE, dtype=np.int32)
        weights = np.zeros((B, I), dtype=np.int32)
        child_row = np.full((B, I), -1, dtype=np.int32)
        child_type = np.zeros((B, I), dtype=np.int32)
        size = np.zeros(B, dtype=np.int32)
        for bi, bid in enumerate(bids):
            b = cmap.buckets[bid]
            size[bi] = len(b.items)
            for ii, it in enumerate(b.items):
                items[bi, ii] = it
                if it < 0 and it in cmap.buckets:
                    child_row[bi, ii] = self.row_of[it]
                    child_type[bi, ii] = cmap.buckets[it].type
            if b.alg == CRUSH_BUCKET_STRAW2:
                weights[bi, :len(b.items)] = b.item_weights
        self.B, self.I = B, I
        self.sizes = size.tolist()
        # dense bucket-id -> table-row lookup (ids are negative: index
        # -1-id); -1 = not a bucket.  Lets a chained CHOOSE step resolve
        # the previous step's output ids to rows on the device.
        max_idx = max((-1 - bid for bid in bids), default=0)
        id2row = np.full(max_idx + 1, -1, dtype=np.int32)
        for bid in bids:
            id2row[-1 - bid] = self.row_of[bid]
        depths: dict[int, int] = {}
        self.depth = max((_bucket_depth(cmap, b, depths) for b in bids), default=0)

        def dev(a):
            return torch.from_numpy(a).to(device)

        self.rows = crush_torch.BucketRows(
            dev(items), dev(weights), dev(crush_torch.recip_table(weights)), dev(child_row),
            dev(child_type), dev(size), crush_torch.ln_table(device),
        )
        self.id2row = dev(id2row)


def _bucket_depth(cmap: CrushMap, bid: int, depth: dict[int, int]) -> int:
    """Levels of buckets below bucket ``bid`` (0: it holds only
    devices), memoised in ``depth``."""
    if bid in depth:
        return depth[bid]
    depth[bid] = 0  # cycle guard (supports_hier rejects cycles)
    best = 0
    for it in cmap.buckets[bid].items:
        if it < 0 and it in cmap.buckets:
            best = max(best, 1 + _bucket_depth(cmap, it, depth))
    depth[bid] = best
    return best


def _layout(cmap: CrushMap) -> tuple:
    """Everything :class:`MapTables` reads from the map's buckets."""
    return tuple(
        (bid, b.type, b.alg, tuple(b.items), tuple(getattr(b, "item_weights", ())))
        for bid, b in sorted(cmap.buckets.items()))


def tables_for(cmap: CrushMap, device: torch.device) -> MapTables:
    """The map's tables on ``device``, rebuilt when its buckets changed
    since they were made (a host added, device-class shadow trees
    populated): the cache holds the bucket layout it was built from."""
    cache = getattr(cmap, "_torch_tables", None)
    if cache is None:
        cache = cmap._torch_tables = {}
    layout = _layout(cmap)
    hit = cache.get(device)
    if hit is None or hit[0] != layout:
        hit = cache[device] = (layout, MapTables(cmap, device))
    return hit[1]


def lanes_of(xs, device: torch.device) -> torch.Tensor:
    """Host inputs -> int32 lanes holding their uint32 bits on ``device``."""
    xs_np = np.ascontiguousarray(np.asarray(xs, dtype=np.uint32))
    return torch.from_numpy(xs_np.view(np.int32)).to(device)


# -- batched primitives ------------------------------------------------------


def _descend(T: MapTables, x, rows0, r, want_type: int):
    """Drill from per-lane root buckets to the first item of want_type
    (the retry_bucket descent of mapper.c:421/:612, minus empty/wrong-type
    handling which the callers mask).  Returns
    (item, item_row, resolved, dead, empty_hit)."""
    X = x.shape[0]
    cur = rows0
    item = torch.full((X,), _NONE, dtype=_LANE, device=x.device)
    item_row = torch.full((X,), -1, dtype=_LANE, device=x.device)
    resolved = torch.zeros(X, dtype=torch.bool, device=x.device)
    dead = torch.zeros_like(resolved)
    empty_hit = torch.zeros_like(resolved)
    live = torch.ones_like(resolved)
    for _d in range(T.depth + 1):
        if _d and not bool(live.any()):
            break  # every lane resolved, dead or empty: no level left to draw
        it, crow, t, empty = crush_torch.straw2(T.rows, x, cur, r)
        live = ~resolved & ~dead & ~empty_hit
        empty_hit = empty_hit | (live & empty)
        live = live & ~empty
        hit = live & (t == want_type)
        item = torch.where(hit, it, item)
        item_row = torch.where(hit, crow, item_row)
        resolved = resolved | hit
        godeep = live & ~hit & (it < 0) & (crow >= 0)
        dead = dead | (live & ~hit & ~godeep)
        cur = torch.where(godeep, crow, cur)
        live = godeep
    dead = dead | (~resolved & ~dead & ~empty_hit)  # depth exhausted
    return item, item_row, resolved, dead, empty_hit


def _collides(out, outpos, item):
    """item already in out[:, :outpos]? ([X,W], [X], [X]) -> [X] bool."""
    cols = torch.arange(out.shape[1], device=out.device)[None, :]
    return ((out == item[:, None]) & (cols < outpos[:, None])).any(dim=1)


# -- chooseleaf inner recursion (single-rep firstn at type 0) ---------------


def _leaf_firstn(T, x, sub_rows, rep2, sub_r, out2, outpos, reweight,
                 recurse_tries: int, want):
    """The recursive leaf step of crush_choose_firstn (mapper.c:995-1012
    via the python port): one rep (index rep2), parent_r=sub_r, descend
    to a device, collide against out2[:, :outpos], is_out rejection.
    Returns (leaf, ok) for lanes in ``want``."""
    leaf = torch.full_like(x, _NONE)
    done = torch.zeros_like(want)
    failed = torch.zeros_like(want)
    ftotal = torch.zeros_like(x)
    # recurse_tries is 1 under modern tunables (chooseleaf_descend_once);
    # per-lane ftotal keeps r2 on the scalar ladder
    for _t in range(recurse_tries):
        live = want & ~done & ~failed & (ftotal < recurse_tries)
        r2 = rep2 + sub_r + ftotal
        item, _row, resolved, dead, _empty = _descend(T, x, sub_rows, r2, 0)
        coll = _collides(out2, outpos, item)
        rej = resolved & (coll | crush_torch.is_out(x, reweight, item))
        ok_now = live & resolved & ~rej
        leaf = torch.where(ok_now, item, leaf)
        done = done | ok_now
        # wrong-type terminal inside the leaf descent = inner skip_rep:
        # the inner rep is abandoned, the leaf fails for good
        failed = failed | (live & dead)
        retry = live & ~ok_now & ~dead
        ftotal = ftotal + retry.to(_LANE)
    return leaf, done


# -- firstn ------------------------------------------------------------------


def choose_firstn_hier(T: MapTables, x, root_row, reweight, *, numrep: int, width: int,
                       tries: int, recurse_tries: int, want_type: int, leaf: bool,
                       vary_r: int, stable: int):
    """Batched crush_choose_firstn over a hierarchy (mapper.c:421).

    ``root_row`` is a table row or an [X] tensor of rows.  Returns
    (out [X,width], out2 [X,width], outpos [X]); out2 is the leaf vector
    when ``leaf`` (chooseleaf), else == out."""
    X = x.shape[0]
    dev = x.device
    out = torch.full((X, width), _NONE, dtype=_LANE, device=dev)
    out2 = torch.full_like(out, _NONE)
    outpos = torch.zeros(X, dtype=_LANE, device=dev)
    roots = torch.as_tensor(root_row, dtype=_LANE, device=dev).expand(X).contiguous()
    slots = torch.arange(width, device=dev)[None, :]
    no = torch.zeros(X, dtype=torch.bool, device=dev)

    for rep in range(numrep):
        active = outpos < width
        ftotal = torch.zeros(X, dtype=_LANE, device=dev)
        while True:
            live = active & (ftotal < tries)
            if not bool(live.any()):
                break
            r = rep + ftotal
            item, item_row, resolved, dead, empty = _descend(T, x, roots, r, want_type)
            coll = _collides(out, outpos, item)
            if leaf:
                sub_r = (r >> (vary_r - 1)) if vary_r else torch.zeros_like(r)
                rep2 = torch.zeros_like(outpos) if stable else outpos
                want_leaf = live & resolved & ~coll
                leaf_item, leaf_ok = _leaf_firstn(
                    T, x, item_row, rep2, sub_r, out2, outpos, reweight, recurse_tries,
                    want_leaf)
                rej_leaf = want_leaf & ~leaf_ok
            else:
                leaf_item = item
                rej_leaf = no
            if want_type == 0 and not leaf:
                rej_out = resolved & ~coll & crush_torch.is_out(x, reweight, item)
            else:
                rej_out = no
            reject = empty | rej_leaf | rej_out
            ok = live & resolved & ~coll & ~reject
            wmask = (slots == outpos.clamp(max=width - 1)[:, None]) & ok[:, None]
            out = torch.where(wmask, item[:, None], out)
            out2 = torch.where(wmask, leaf_item[:, None], out2)
            outpos = outpos + ok.to(_LANE)
            active = active & ~ok & ~(live & dead)  # dead = skip_rep
            ftotal = ftotal + (live & ~ok & ~dead).to(_LANE)
    return out, out2, outpos


# -- indep -------------------------------------------------------------------


def _leaf_indep(T, x, sub_rows, rep, parent_r, reweight, numrep: int,
                recurse_tries: int, want):
    """Leaf recursion of crush_choose_indep (mapper.c:426-449 via the
    python port): left=1 at slot ``rep`` (per lane), type 0, its own
    retry rounds.
    The inner call's collision scope is only its own slot — which it
    resets to UNDEF on entry — so there is NO cross-slot leaf collision
    check (distinctness comes from the outer subtree collision), and a
    failed inner attempt is retried fresh by the next outer round.
    Returns (leaf, ok)."""
    leaf = torch.full_like(x, _NONE)
    done = torch.zeros_like(want)
    deadf = torch.zeros_like(want)
    for ft2 in range(recurse_tries):
        live = want & ~done & ~deadf
        r2 = rep + parent_r + numrep * ft2
        item, _row, resolved, dead, _empty = _descend(T, x, sub_rows, r2, 0)
        rej = resolved & crush_torch.is_out(x, reweight, item)
        ok_now = live & resolved & ~rej
        leaf = torch.where(ok_now, item, leaf)
        done = done | ok_now
        # wrong-type terminal: the inner call gives up (slot NONE) for
        # THIS attempt; the outer round retries with a fresh inner call
        deadf = deadf | (live & dead)
    return leaf, done


def choose_indep_hier(T: MapTables, x, root_row, reweight, *, numrep: int, out_size: int,
                      tries: int, recurse_tries: int, want_type: int, leaf: bool):
    """Batched crush_choose_indep over a hierarchy (mapper.c:612).

    ``root_row``: a table row (all lanes from one TAKE bucket) or an [X]
    tensor of rows (chained CHOOSE: each lane descends from ITS
    previous-step bucket).  A rep's descent, leaf and rejection depend on
    its r alone, not on what the other reps picked, so each round draws
    every rep at once, over [out_size * X] lanes, and then takes the
    picks rep by rep as the scalar loop does.  Returns (out
    [X,out_size], out2).  Holes are NONE."""
    X = x.shape[0]
    dev = x.device
    out = torch.full((X, out_size), _UNDEF, dtype=_LANE, device=dev)
    out2 = torch.full_like(out, _UNDEF)
    roots = torch.as_tensor(root_row, dtype=_LANE, device=dev).expand(X).contiguous()
    reps = torch.arange(out_size, dtype=_LANE, device=dev).repeat_interleave(X)
    x_all, roots_all = x.repeat(out_size), roots.repeat(out_size)
    ftotal = 0
    while ftotal < tries and bool((out == _UNDEF).any()):
        r = reps + numrep * ftotal
        item, item_row, resolved, dead, _empty = _descend(T, x_all, roots_all, r, want_type)
        ok_all = resolved
        leaf_item = item
        if leaf:
            leaf_item, leaf_ok = _leaf_indep(
                T, x_all, item_row, reps, r, reweight, numrep, recurse_tries, resolved)
            ok_all = ok_all & leaf_ok
        if want_type == 0 and not leaf:
            ok_all = ok_all & ~crush_torch.is_out(x_all, reweight, item)
        item, leaf_item, dead, ok_all = (
            t.view(out_size, X) for t in (item, leaf_item, dead, ok_all))
        for rep in range(out_size):
            need = out[:, rep] == _UNDEF
            # permanent NONE: wrong-type terminal (depth dead-ends)
            perm = need & dead[rep]
            # collide against every slot of this call's region
            coll = (out == item[rep, :, None]).any(dim=1)
            ok = need & ok_all[rep] & ~coll
            out[:, rep] = torch.where(ok, item[rep], torch.where(perm, _NONE, out[:, rep]))
            out2[:, rep] = torch.where(ok, leaf_item[rep],
                                       torch.where(perm, _NONE, out2[:, rep]))
        ftotal += 1
    out = torch.where(out == _UNDEF, _NONE, out)
    out2 = torch.where(out2 == _UNDEF, _NONE, out2)
    return out, out2


# -- the rule interpreter -----------------------------------------------------


def _rule_shape(cmap: CrushMap, ruleno: int):
    """(take_bucket_id, [choose_steps...], tries, leaf_tries, vary_r,
    stable) or None if the rule is not one TAKE -> CHOOSE+ -> EMIT
    chain.  Multi-step chains (the LRC per-layer rules: TAKE ->
    CHOOSE_INDEP locality -> CHOOSELEAF_INDEP domain -> EMIT,
    reference:src/erasure-code/lrc/ErasureCodeLrc.cc:44 ruleset_steps)
    return more than one choose step."""
    if ruleno < 0 or ruleno >= len(cmap.rules) or cmap.rules[ruleno] is None:
        return None
    t = cmap.tunables
    tries = t.choose_total_tries + 1
    leaf_tries = 0
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable
    take = None
    chooses: list = []
    stage = 0
    for s in cmap.rules[ruleno].steps:
        if s.op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if s.arg1 > 0:
                tries = s.arg1
            continue
        if s.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if s.arg1 > 0:
                leaf_tries = s.arg1
            continue
        if s.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if s.arg1 >= 0:
                vary_r = s.arg1
            continue
        if s.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if s.arg1 >= 0:
                stable = s.arg1
            continue
        if s.op in (
            CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
            CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
        ):
            if s.arg1 > 0:
                return None
            continue
        if stage == 0 and s.op == CRUSH_RULE_TAKE:
            take = s.arg1
            stage = 1
        elif stage == 1 and s.op in _CHOOSE_OPS:
            chooses.append(s)
        elif stage == 1 and s.op == CRUSH_RULE_EMIT and chooses:
            stage = 3
        else:
            return None
    if stage != 3 or take is None or not chooses:
        return None
    return take, chooses, tries, leaf_tries, vary_r, stable


def int32_weights(bucket) -> bool:
    """The bucket's weights fit the kernel's int32 tables."""
    return all(0 <= w < 1 << 31 for w in getattr(bucket, "item_weights", ()))


def supports_hier(cmap: CrushMap, ruleno: int) -> bool:
    """True if vec_do_rule_hier handles this (map, rule) bit-exactly."""
    t = cmap.tunables
    if t.choose_local_tries != 0 or t.choose_local_fallback_tries != 0:
        return False
    shape = _rule_shape(cmap, ruleno)
    if shape is None:
        return False
    take, chooses, _tries, _lt, vary_r, _stable = shape
    if take not in cmap.buckets:
        return False
    if vary_r < 0 or vary_r > 3:
        return False
    if len(chooses) > 1:
        # chained steps (LRC per-layer rules): supported when every step
        # is INDEP (firstn chains compact their output — different osize
        # algebra), intermediates select BUCKET types with a positive
        # count
        indep_ops = (CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP)
        if any(c.op not in indep_ops for c in chooses):
            return False
        if any(c.arg1 <= 0 for c in chooses):
            return False
        for c in chooses[:-1]:
            if c.op != CRUSH_RULE_CHOOSE_INDEP or c.arg2 == 0:
                return False
    choose = chooses[-1]
    leaf = choose.op in (
        CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP
    )
    if leaf and choose.arg2 == 0:
        return False  # chooseleaf to type 0 is not a real shape
    # every bucket straw2, acyclic, devices in range
    seen: set[int] = set()
    max_devices = cmap.max_devices  # a walk over every bucket: once, not per device

    def walk(bid: int) -> bool:
        if bid in seen:
            return False  # cycle
        seen.add(bid)
        b = cmap.buckets.get(bid)
        if b is None or b.alg != CRUSH_BUCKET_STRAW2 or not int32_weights(b):
            return False
        for it in b.items:
            if it >= 0:
                if it >= max_devices:
                    return False
            elif it in cmap.buckets:
                if not walk(it):
                    return False
            else:
                return False
        seen.discard(bid)  # path-scoped for DAG-shared subtrees
        return True

    return walk(take)


def reweight_lanes(cmap: CrushMap, weight, device) -> torch.Tensor:
    """The device in/out weights (16.16) as an int32 tensor on ``device``."""
    if weight is None:
        weight = cmap.get_weights()
    return torch.tensor(np.asarray(weight, dtype=np.int64), dtype=_LANE, device=device)


def _hier_engine(cmap, ruleno, x, result_max, weight):
    """Run the hierarchical engine on lanes ``x``: out [X, W] on their
    device, or None (degenerate numrep)."""
    take, chooses, tries, leaf_tries, vary_r, stable = _rule_shape(cmap, ruleno)
    t = cmap.tunables
    T = tables_for(cmap, x.device)
    rw = reweight_lanes(cmap, weight, x.device)
    root_row = T.row_of[take]

    if len(chooses) > 1:
        return _chain_engine(T, x, rw, root_row, chooses, tries, leaf_tries, result_max)

    choose = chooses[0]
    firstn = choose.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
    leaf = choose.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP)
    numrep = choose.arg1 if choose.arg1 > 0 else choose.arg1 + result_max
    if numrep <= 0:
        return None
    recurse_tries = _recurse_tries(t, firstn, tries, leaf_tries)
    if firstn:
        # firstn result is compact (no holes): the engine writes
        # sequentially per lane, so rows are already left-packed
        out, out2, _outpos = choose_firstn_hier(
            T, x, root_row, rw, numrep=numrep, width=min(numrep, result_max),
            tries=tries, recurse_tries=recurse_tries, want_type=choose.arg2,
            leaf=leaf, vary_r=vary_r, stable=stable)
    else:
        out, out2 = choose_indep_hier(
            T, x, root_row, rw, numrep=numrep, out_size=min(numrep, result_max),
            tries=tries, recurse_tries=recurse_tries, want_type=choose.arg2,
            leaf=leaf)
    return out2 if leaf else out


def _recurse_tries(t, firstn: bool, tries: int, leaf_tries: int) -> int:
    """The leaf step's tries, as crush_do_rule picks them for a firstn
    or an indep step (``crush_do_rule``, crush/mapper.py:558-563, 610)
    under tunables ``t``."""
    if not firstn:
        return leaf_tries or 1
    if leaf_tries:
        return leaf_tries
    return 1 if t.chooseleaf_descend_once else tries


class FusedRule(NamedTuple):
    """A single-step rule as the ``crush_choose`` kernel takes it: its
    first ``gf_cuda.CHOOSE_RULE_INTS`` ints, in this order, are the
    kernel's ``Rule`` (``csrc/crush_choose.cu``).  ``take_row`` is the
    TAKE bucket's table row, ``width`` the output's slots
    (``min(numrep, result_max)``), ``depth`` the levels of buckets below
    the TAKE bucket, which bounds a descent; ``widest`` and ``row_gcd``
    are the most items of a row the rule may draw over (the TAKE
    bucket's or a bucket's below it) and the greatest common divisor of
    those rows' sizes, which the wrapper reads to pick the kernel's
    tile."""

    take_row: int
    firstn: int
    leaf: int
    numrep: int
    width: int
    tries: int
    recurse_tries: int
    want_type: int
    vary_r: int
    stable: int
    depth: int
    widest: int
    row_gcd: int


def _path_sizes(cmap: CrushMap, take: int) -> list[int]:
    """The sizes of bucket ``take`` and of every bucket below it."""
    seen, todo = {take}, [take]
    while todo:
        for it in cmap.buckets[todo.pop()].items:
            if it < 0 and it in cmap.buckets and it not in seen:
                seen.add(it)
                todo.append(it)
    return [len(cmap.buckets[b].items) for b in seen]


def fused_rule(cmap: CrushMap, ruleno: int, result_max: int) -> FusedRule | None:
    """The rule as the ``crush_choose`` kernel takes it, or None when the
    kernel does not take it: a rule :func:`supports_hier` refuses
    (legacy local tries included), a chain of more than one choose step
    (the LRC rules, left to the step engine), a degenerate numrep, more
    than ``gf_cuda.CHOOSE_MAX_WIDTH`` slots, or a row of
    ``gf_cuda.CHOOSE_MAX_SLOTS`` items or more on its path.  Read from
    the same :func:`_rule_shape` and leaf tries as :func:`_hier_engine`,
    so the kernel and the step engine run one rule."""
    if not supports_hier(cmap, ruleno):
        return None
    take, chooses, tries, leaf_tries, vary_r, stable = _rule_shape(cmap, ruleno)
    if len(chooses) != 1:
        return None
    choose = chooses[0]
    firstn = choose.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
    leaf = choose.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP)
    numrep = choose.arg1 if choose.arg1 > 0 else choose.arg1 + result_max
    width = min(numrep, result_max)
    if numrep <= 0 or not 1 <= width <= gf_cuda.CHOOSE_MAX_WIDTH:
        return None
    sizes = _path_sizes(cmap, take)
    if max(sizes) >= gf_cuda.CHOOSE_MAX_SLOTS:
        return None
    return FusedRule(
        sorted(cmap.buckets).index(take), int(firstn), int(leaf), numrep, width, tries,
        _recurse_tries(cmap.tunables, firstn, tries, leaf_tries), choose.arg2, vary_r,
        stable, _bucket_depth(cmap, take, {}), max(sizes), math.gcd(*sizes))


def _chain_engine(T, x, rw, root_row, chooses, tries, leaf_tries, result_max):
    """Chained INDEP steps on the device (the LRC per-layer rules).

    Scalar semantics (mapper.c do_rule CHOOSE loop + the pinned
    crush/mapper.py): each later step runs crush_choose_indep once PER
    BUCKET of the previous step's output, with outpos=0 and parent_r=0 —
    an independent run rooted at that bucket — and the per-bucket
    regions concatenate.  The k-th bucket's region starts at
    ``min(k*n, result_max)`` and holds ``min(n, result_max - start)``
    slots; a previous slot that is NONE or a device is skipped.  So each
    step is one flattened [X*width] run (and, where ``result_max`` cuts
    a region short, one more run with the shorter region), whose regions
    are scattered to their compacted places; what the scalar would not
    write stays NONE."""
    X = x.shape[0]
    dev = x.device
    first = chooses[0]
    width = min(first.arg1, result_max)
    cur, _o2 = choose_indep_hier(
        T, x, root_row, rw, numrep=first.arg1, out_size=width, tries=tries,
        recurse_tries=1, want_type=first.arg2, leaf=False)
    nrow = T.id2row.shape[0]
    for step in chooses[1:]:
        leaf_s = step.op == CRUSH_RULE_CHOOSELEAF_INDEP
        n_s = step.arg1
        is_bucket = cur < 0  # NONE is positive, devices are >= 0
        rows = torch.where(is_bucket, torch.take(T.id2row, (-1 - cur).clamp(0, nrow - 1).long()), -1)
        valid = rows >= 0                                       # [X, width]
        rank = torch.cumsum(valid, dim=1, dtype=_LANE) - valid.to(_LANE)
        region = (result_max - rank * n_s).clamp(0, n_s)        # slots this bucket fills
        x_flat = x.repeat_interleave(width)
        rows_flat = torch.where(valid, rows, 0).reshape(-1)

        def run(out_size):
            o, o2 = choose_indep_hier(
                T, x_flat, rows_flat, rw, numrep=n_s, out_size=out_size, tries=tries,
                recurse_tries=leaf_tries or 1, want_type=step.arg2, leaf=leaf_s)
            return (o2 if leaf_s else o).reshape(X, width, out_size)

        use = run(n_s)
        short = result_max % n_s
        if width * n_s > result_max and short:
            cut = torch.full_like(use, _NONE)
            cut[:, :, :short] = run(short)
            use = torch.where((region < n_s)[:, :, None], cut, use)
        new_width = min(width * n_s, result_max)
        t = torch.arange(n_s, device=dev)
        dest = torch.where(valid[:, :, None] & (t < region[:, :, None]),
                           rank[:, :, None] * n_s + t, new_width)
        nxt = torch.full((X, new_width + 1), _NONE, dtype=_LANE, device=dev)
        nxt.scatter_(1, dest.reshape(X, -1).long(), use.reshape(X, -1))
        cur = nxt[:, :new_width]
        width = new_width
    return cur


def vec_do_rule_hier(cmap: CrushMap, ruleno: int, xs, result_max: int,
                     weight=None, device=None) -> np.ndarray:
    """Batched crush_do_rule over a hierarchical map; bit-identical to the
    scalar mapper for supported (map, rule) shapes."""
    from ..device import resolve

    if not supports_hier(cmap, ruleno):
        raise ValueError("map/rule shape not supported by the hier vec path")
    x = lanes_of(xs, resolve(device))
    out = _hier_engine(cmap, ruleno, x, result_max, weight)
    if out is None:
        return np.zeros((x.shape[0], 0), dtype=np.int32)
    return out.cpu().numpy()
