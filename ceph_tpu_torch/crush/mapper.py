"""CRUSH scalar mapper — the bit-exact placement oracle of the port.

The port's own copy of ``ceph_tpu/crush/mapper.py`` (plain Python, no
array library).  It re-implements the core mapping algorithm
(reference:src/crush/mapper.c): bucket choosers for all five
algorithms, the fixed-point ``crush_ln`` (straw2), weight-based
rejection, the depth-first ``choose_firstn`` and breadth-first
positionally-stable ``choose_indep`` descent loops, and the ``do_rule``
step interpreter.

This is the *oracle* path: plain-Python integers, one x at a time.
The batched torch paths (:mod:`ceph_tpu_torch.crush.mapper_torch` for
flat maps, :mod:`ceph_tpu_torch.crush.mapper_torch_hier` for
hierarchies and multi-step chains) map millions of x values at once and
are checked against *this* module; ``CrushTester`` takes it for map and
rule shapes the batched paths do not support.
"""

from __future__ import annotations

from typing import Sequence

from .hashes import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln_tables import LL_TBL, RH_LH_TBL
from .map import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    Bucket,
    CrushMap,
    ListBucket,
    StrawBucket,
    Straw2Bucket,
    TreeBucket,
)

_U32 = 0xFFFFFFFF
_S64_MIN = -(1 << 63)


def crush_ln(xin: int) -> int:
    """2^44 * log2(xin + 1) in fixed point (reference:mapper.c:248)."""
    x = (xin + 1) & _U32
    iexpon = 15
    if not (x & 0x18000):
        bits = 16 - (x & 0x1FFFF).bit_length()
        x = (x << bits) & _U32
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]
    lh = RH_LH_TBL[index1 + 1 - 256]
    xl64 = (x * rh) >> 48
    result = iexpon << 44
    lh += LL_TBL[xl64 & 0xFF]
    return result + (lh >> 4)


class _PermWork:
    """Per-bucket permutation state (reference crush_work_bucket)."""

    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int):
        self.perm_x = 0
        self.perm_n = 0
        self.perm = [0] * size


class Workspace:
    """Scratch state for one sequence of do_rule calls on a fixed map
    (reference:mapper.c:812 crush_init_workspace)."""

    def __init__(self, cmap: CrushMap):
        self.work = {bid: _PermWork(b.size) for bid, b in cmap.buckets.items()}

    def reset(self) -> None:
        for w in self.work.values():
            w.perm_x = 0
            w.perm_n = 0


def bucket_perm_choose(bucket: Bucket, work: _PermWork, x: int, r: int) -> int:
    """Pseudo-random permutation choose (reference:mapper.c:73)."""
    size = bucket.size
    pr = r % size
    if work.perm_x != (x & _U32) or work.perm_n == 0:
        work.perm_x = x & _U32
        if pr == 0:
            s = crush_hash32_3(x & _U32, bucket.id & _U32, 0) % size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: see mapper.c:90
            return bucket.items[s]
        for i in range(size):
            work.perm[i] = i
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        for i in range(1, size):
            work.perm[i] = i
        work.perm[work.perm[0]] = 0
        work.perm_n = 1

    while work.perm_n <= pr:
        p = work.perm_n
        if p < size - 1:
            i = crush_hash32_3(x & _U32, bucket.id & _U32, p) % (size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def bucket_list_choose(bucket: ListBucket, x: int, r: int) -> int:
    """reference:mapper.c:141."""
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(
            x & _U32, bucket.items[i] & _U32, r & _U32, bucket.id & _U32
        )
        w &= 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_tree_choose(bucket: TreeBucket, x: int, r: int) -> int:
    """reference:mapper.c:195."""
    n = bucket.num_nodes >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (
            crush_hash32_4(x & _U32, n & _U32, r & _U32, bucket.id & _U32) * w
        ) >> 32
        # descend left or right of the weight split
        h = 0
        m = n
        while (m & 1) == 0:
            h += 1
            m >>= 1
        left = n - (1 << (h - 1))
        if t < bucket.node_weights[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: StrawBucket, x: int, r: int) -> int:
    """reference:mapper.c:227."""
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = crush_hash32_3(x & _U32, bucket.items[i] & _U32, r & _U32)
        draw = (draw & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_straw2_choose(bucket: Straw2Bucket, x: int, r: int) -> int:
    """Exponential-draw selection via fixed-point ln (reference:mapper.c:302)."""
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        w = bucket.item_weights[i]
        if w:
            u = crush_hash32_3(x & _U32, bucket.items[i] & _U32, r & _U32)
            u &= 0xFFFF
            ln = crush_ln(u) - 0x1000000000000
            # div64_s64 truncates toward zero; ln <= 0 so negate-divide
            draw = -((-ln) // w)
        else:
            draw = _S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def crush_bucket_choose(bucket: Bucket, work: _PermWork, x: int, r: int) -> int:
    """reference:mapper.c:350."""
    if bucket.size == 0:
        raise ValueError(f"empty bucket {bucket.id}")
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r)
    return bucket.items[0]


def is_out(weight: Sequence[int], item: int, x: int) -> bool:
    """Probabilistic rejection of reweighted/out devices (mapper.c:385)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x & _U32, item & _U32) & 0xFFFF) >= w


def crush_choose_firstn(
    cmap: CrushMap,
    work: Workspace,
    bucket: Bucket,
    weight: Sequence[int],
    x: int,
    numrep: int,
    type: int,
    out: list[int],
    outpos: int,
    out_size: int,
    tries: int,
    recurse_tries: int,
    local_retries: int,
    local_fallback_retries: int,
    recurse_to_leaf: bool,
    vary_r: int,
    stable: int,
    out2: list[int] | None,
    parent_r: int,
) -> int:
    """Depth-first selection of numrep distinct items (mapper.c:421)."""
    max_devices = cmap.max_devices
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = 0
        while True:  # retry_descent
            retry_descent = False
            in_b = bucket
            flocal = 0
            while True:  # retry_bucket
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal

                if in_b.size == 0:
                    reject = True
                else:
                    if (
                        local_fallback_retries > 0
                        and flocal >= (in_b.size >> 1)
                        and flocal > local_fallback_retries
                    ):
                        item = bucket_perm_choose(
                            in_b, work.work[in_b.id], x, r
                        )
                    else:
                        item = crush_bucket_choose(
                            in_b, work.work[in_b.id], x, r
                        )
                    if item >= max_devices:
                        skip_rep = True
                        break

                    itemtype = cmap.buckets[item].type if (
                        item < 0 and item in cmap.buckets
                    ) else 0
                    if itemtype != type:
                        if item >= 0 or item not in cmap.buckets:
                            skip_rep = True
                            break
                        in_b = cmap.buckets[item]
                        retry_bucket = True
                        continue

                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break

                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if (
                                crush_choose_firstn(
                                    cmap,
                                    work,
                                    cmap.buckets[item],
                                    weight,
                                    x,
                                    1 if stable else outpos + 1,
                                    0,
                                    out2,
                                    outpos,
                                    count,
                                    recurse_tries,
                                    0,
                                    local_retries,
                                    local_fallback_retries,
                                    False,
                                    vary_r,
                                    stable,
                                    None,
                                    sub_r,
                                )
                                <= outpos
                            ):
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(weight, item, x)

                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (
                        local_fallback_retries > 0
                        and flocal <= in_b.size + local_fallback_retries
                    ):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                if not retry_bucket:
                    break
            if skip_rep or not retry_descent:
                break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def crush_choose_indep(
    cmap: CrushMap,
    work: Workspace,
    bucket: Bucket,
    weight: Sequence[int],
    x: int,
    left: int,
    numrep: int,
    type: int,
    out: list[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: list[int] | None,
    parent_r: int,
) -> None:
    """Breadth-first positionally-stable selection for EC (mapper.c:612)."""
    max_devices = cmap.max_devices
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF

    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_b = bucket
            while True:
                r = rep + parent_r
                if (
                    in_b.alg == CRUSH_BUCKET_UNIFORM
                    and in_b.size % numrep == 0
                ):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal

                if in_b.size == 0:
                    break
                item = crush_bucket_choose(in_b, work.work[in_b.id], x, r)
                if item >= max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break

                itemtype = cmap.buckets[item].type if item < 0 else 0
                if itemtype != type:
                    if item >= 0 or item not in cmap.buckets:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_b = cmap.buckets[item]
                    continue

                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break

                if recurse_to_leaf:
                    if item < 0:
                        crush_choose_indep(
                            cmap,
                            work,
                            cmap.buckets[item],
                            weight,
                            x,
                            1,
                            numrep,
                            0,
                            out2,
                            rep,
                            recurse_tries,
                            0,
                            False,
                            None,
                            r,
                        )
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item

                if itemtype == 0 and is_out(weight, item, x):
                    break

                out[rep] = item
                left -= 1
                break
        ftotal += 1

    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def crush_do_rule(
    cmap: CrushMap,
    ruleno: int,
    x: int,
    result_max: int,
    weight: Sequence[int] | None = None,
    workspace: Workspace | None = None,
) -> list[int]:
    """Interpret a rule's steps for input x (reference:mapper.c:854).

    Returns the result vector (length <= result_max; may contain
    CRUSH_ITEM_NONE holes for indep/EC rules).
    """
    if ruleno < 0 or ruleno >= len(cmap.rules) or cmap.rules[ruleno] is None:
        return []
    if weight is None:
        weight = cmap.get_weights()
    cw = workspace or Workspace(cmap)

    t = cmap.tunables
    choose_tries = t.choose_total_tries + 1  # off-by-one compat, mapper.c:875
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    rule = cmap.rules[ruleno]
    result: list[int] = []
    w: list[int] = []
    o = [0] * result_max
    c = [0] * result_max

    for step in rule.steps:
        op = step.op
        if op == CRUSH_RULE_TAKE:
            arg = step.arg1
            if (0 <= arg < cmap.max_devices) or arg in cmap.buckets:
                w = [arg]
            continue
        if op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
            continue

        if op in (
            CRUSH_RULE_CHOOSELEAF_FIRSTN,
            CRUSH_RULE_CHOOSE_FIRSTN,
            CRUSH_RULE_CHOOSELEAF_INDEP,
            CRUSH_RULE_CHOOSE_INDEP,
        ):
            if not w:
                continue
            firstn = op in (
                CRUSH_RULE_CHOOSELEAF_FIRSTN,
                CRUSH_RULE_CHOOSE_FIRSTN,
            )
            recurse_to_leaf = op in (
                CRUSH_RULE_CHOOSELEAF_FIRSTN,
                CRUSH_RULE_CHOOSELEAF_INDEP,
            )
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi not in cmap.buckets:
                    continue  # probably CRUSH_ITEM_NONE
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    # out/out2 offset by osize with relative outpos=0, so
                    # collision scope and the recursive numrep=outpos+1
                    # match the C pointer arithmetic (mapper.c:995-1012)
                    o_sub = o[osize:]
                    c_sub = c[osize:]
                    placed = crush_choose_firstn(
                        cmap,
                        cw,
                        cmap.buckets[wi],
                        weight,
                        x,
                        numrep,
                        step.arg2,
                        o_sub,
                        0,
                        result_max - osize,
                        choose_tries,
                        recurse_tries,
                        choose_local_retries,
                        choose_local_fallback_retries,
                        recurse_to_leaf,
                        vary_r,
                        stable,
                        c_sub,
                        0,
                    )
                    o[osize:] = o_sub
                    c[osize:] = c_sub
                    osize += placed
                else:
                    out_size = min(numrep, result_max - osize)
                    # o/c offset views: operate on slices then write back
                    o_sub = o[osize:]
                    c_sub = c[osize:]
                    crush_choose_indep(
                        cmap,
                        cw,
                        cmap.buckets[wi],
                        weight,
                        x,
                        out_size,
                        numrep,
                        step.arg2,
                        o_sub,
                        0,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf,
                        c_sub,
                        0,
                    )
                    o[osize:] = o_sub
                    c[osize:] = c_sub
                    osize += out_size
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w = o[:osize]
            o = list(o)  # fresh scratch for the next step
            continue

        if op == CRUSH_RULE_EMIT:
            for item in w:
                if len(result) >= result_max:
                    break
                result.append(item)
            w = []
            continue

    return result
