"""Batched CRUSH placement on torch lanes: map a batch of inputs at once.

Counterpart of ``ceph_tpu/crush/mapper_jax.py``.  The reference's bulk
placement simulation is a scalar x-loop — ``crushtool --test`` calls
``crush_do_rule`` once per input (reference:src/crush/CrushTester.cc:648,
mapper reference:src/crush/mapper.c:854).  Here the whole batch of x
values is one set of [X] lanes on the device.

On the card, a single-step rule (TAKE -> one CHOOSE[LEAF] -> EMIT, which
``mapper_torch_hier.fused_rule`` describes) is one launch of the
``crush_choose`` kernel: a tile of threads a lane runs the scalar
mapper's whole choose step (reps, tries, descent, collisions,
``is_out``, chooseleaf's leaf step).  A chained rule (the LRC rules,
``mapper_torch_hier.chain_rules``) is one launch a step, each later
step's lanes rooted at the previous step's buckets, with the regions
compacted between launches by torch programs.  CPU lanes of such rules
take the kernel's plain version, :func:`crush_choose_plain`: the step
engine's loops.

The step engine (:func:`_step_engine`; rules of more than 32 slots take
it on the card too): the rjenkins hashes, the
exact straw2 draw (on the card the ``crush_straw2`` kernel, routed by
``ops/crush_torch.py``), weight rejection (reference:mapper.c:385), and
the firstn/indep retry loops (reference:mapper.c:421, :612) as masked
tensor programs.  The retry loops run on the host, one step per try
(firstn: a rep's try; indep: a round of every rep at once), and stop
early once no lane is active: one flag read back a step.

Bit-exactness contract: for supported maps the output equals
:func:`ceph_tpu_torch.crush.mapper.crush_do_rule` for every x, and so
the reference's scalar mapper and its JAX vector path
(tests/test_torch_crush_vec.py).

The draw is exact (int64 fixed point and table gathers), so what the
reference needs only because the TPU draws in f32 is not ported:
``straw2_choose_approx``, ``_qa_kernel``, ``measured_error_budget`` and
the error budgets, the ambiguity flags, and the numpy exact engines
(``np_choose_firstn``, ``np_choose_indep``) that re-ran flagged lanes
on the host.

Supported shape (the dev/bench topology — ``CrushMap.flat``):
- single-level rule: TAKE <straw2 bucket of devices> + CHOOSE_FIRSTN/
  CHOOSE_INDEP type 0 + EMIT;
- tunables with ``choose_local_tries == 0`` and
  ``choose_local_fallback_tries == 0`` (bobtail and every later profile);
  the legacy locals/fallback retries depend on stateful
  ``bucket_perm_choose`` scratch, which has no batched equivalent —
  ``supports()`` reports False and callers fall back to the scalar
  mapper.
Hierarchies (chooseleaf, chained LRC rules) route to
:mod:`.mapper_torch_hier`.

Entry points take ``device=None`` (the card; ``"cpu"`` on request) and
return host numpy, as the reference's do; :func:`vec_rule_stats` brings
back only the counts.  :func:`vec_do_rule_lanes` takes lanes already on
a device and leaves its result there, for callers that go on computing
on the device (the churn planner).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..ops import crush_cuda, crush_torch
from ..ops.profiler import profiler
from .map import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
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
from .mapper_torch_hier import (
    FusedRule,
    _chain_engine,
    _hier_engine,
    chain_rules,
    choose_firstn_hier,
    choose_indep_plain,
    fused_rule,
    int32_weights,
    lanes_of,
    reweight_lanes,
    supports_hier,
    tables_for,
)

_LANE = torch.int32

# SET_* steps that are no-ops for a flat (non-chooseleaf) rule
_LEAF_ONLY_SET_OPS = (
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
)


# -- choose loops ------------------------------------------------------------


def choose_firstn(T, x, rows, reweight, numrep: int, out_size: int, tries: int):
    """Batched flat firstn (reference:mapper.c:421 with modern tunables:
    every failure re-descends with r = rep + ftotal).

    ``rows`` [X] holds the take bucket's table row on every lane.
    Returns [X, min(numrep, out_size)] device ids with CRUSH_ITEM_NONE in
    unfilled tail slots."""
    X = x.shape[0]
    width = min(numrep, out_size)
    out = torch.full((X, width), CRUSH_ITEM_NONE, dtype=_LANE, device=x.device)
    outpos = torch.zeros(X, dtype=_LANE, device=x.device)
    slots = torch.arange(width, device=x.device)[None, :]
    for rep in range(numrep):
        active = outpos < width  # lanes already full skip this rep (count==0)
        item = torch.full_like(x, CRUSH_ITEM_NONE)
        ftotal = 0
        while ftotal < tries and bool(active.any()):
            r = torch.full_like(x, rep + ftotal)
            cand, _crow, _ctype, empty = crush_torch.straw2(T.rows, x, rows, r)
            collide = (out == cand[:, None]).any(dim=1)
            reject = empty | crush_torch.is_out(x, reweight, cand)
            ok = active & ~collide & ~reject
            item = torch.where(ok, cand, item)
            active = active & ~ok
            ftotal += 1
        accepted = (outpos < width) & ~active
        wmask = (slots == outpos.clamp(max=width - 1)[:, None]) & accepted[:, None]
        out = torch.where(wmask, item[:, None], out)
        outpos = outpos + accepted.to(_LANE)
    return out


def choose_indep(T, x, rows, reweight, numrep: int, out_size: int, tries: int):
    """Batched flat indep (reference:mapper.c:612): positionally stable,
    r = rep + numrep*ftotal (numrep = the rule's replica count even when
    out_size is clamped by result_max), holes stay CRUSH_ITEM_NONE.

    A rep's draw depends on its r alone, not on what the other reps
    picked, so each round draws every rep at once, over [out_size * X]
    lanes, and then takes the picks rep by rep as the scalar loop does.
    Returns [X, out_size] ids."""
    X = x.shape[0]
    out = torch.full((X, out_size), CRUSH_ITEM_NONE, dtype=_LANE, device=x.device)
    filled = torch.zeros(out.shape, dtype=torch.bool, device=x.device)
    reps = torch.arange(out_size, dtype=_LANE, device=x.device).repeat_interleave(X)
    x_all, rows_all = x.repeat(out_size), rows.repeat(out_size)
    ftotal = 0
    while ftotal < tries and not bool(filled.all()):
        cand, _crow, _ctype, empty = crush_torch.straw2(
            T.rows, x_all, rows_all, reps + numrep * ftotal)
        reject = (empty | crush_torch.is_out(x_all, reweight, cand)).view(out_size, X)
        cand = cand.view(out_size, X)
        for rep in range(out_size):
            # same-round earlier picks are visible to later positions
            collide = (out == cand[rep, :, None]).any(dim=1)
            ok = ~filled[:, rep] & ~collide & ~reject[rep]
            out[:, rep] = torch.where(ok, cand[rep], out[:, rep])
            filled[:, rep] |= ok
        ftotal += 1
    return out


# -- rule interpreter over the batch -----------------------------------------


def supports(cmap: CrushMap, ruleno: int) -> bool:
    """True if vec_do_rule handles this (map, rule) bit-exactly — either
    the flat path here or the hierarchical engine (mapper_torch_hier.py,
    chooseleaf included)."""
    return _supports_flat(cmap, ruleno) or supports_hier(cmap, ruleno)


def _supports_flat(cmap: CrushMap, ruleno: int) -> bool:
    """The single-level straw2 shape the flat loops handle."""
    t = cmap.tunables
    if t.choose_local_tries != 0 or t.choose_local_fallback_tries != 0:
        return False
    if ruleno < 0 or ruleno >= len(cmap.rules) or cmap.rules[ruleno] is None:
        return False
    steps = cmap.rules[ruleno].steps
    stage = 0  # expect TAKE -> CHOOSE -> EMIT (SET_* tunable steps ok)
    take_bucket = None
    for s in steps:
        if s.op == CRUSH_RULE_SET_CHOOSE_TRIES or s.op in _LEAF_ONLY_SET_OPS:
            continue  # tries handled; chooseleaf knobs are no-ops here
        if s.op in (
            CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
            CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
        ):
            if s.arg1 > 0:
                return False  # would enable the perm-choose fallback paths
            continue
        if stage == 0 and s.op == CRUSH_RULE_TAKE:
            take_bucket = s.arg1
            stage = 1
        elif stage == 1 and s.op in (
            CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP
        ) and s.arg2 == 0:
            stage = 2
        elif stage == 2 and s.op == CRUSH_RULE_EMIT:
            stage = 3
        else:
            return False
    if stage != 3 or take_bucket is None:
        return False
    bucket = cmap.buckets.get(take_bucket)
    if bucket is None or bucket.alg != CRUSH_BUCKET_STRAW2 or not int32_weights(bucket):
        return False
    return all(i >= 0 for i in bucket.items)


def _flat_engine(cmap, ruleno, x, result_max, weight):
    """Run the flat choose loops on lanes ``x``: out [X, W] on their
    device, or None (degenerate numrep)."""
    tries = cmap.tunables.choose_total_tries + 1
    take = None
    numrep = result_max
    firstn = True
    for s in cmap.rules[ruleno].steps:
        if s.op == CRUSH_RULE_TAKE:
            take = s.arg1
        elif s.op == CRUSH_RULE_SET_CHOOSE_TRIES and s.arg1 > 0:
            tries = s.arg1
        elif s.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP):
            firstn = s.op == CRUSH_RULE_CHOOSE_FIRSTN
            numrep = s.arg1 if s.arg1 > 0 else s.arg1 + result_max
    if numrep <= 0:
        return None
    T = tables_for(cmap, x.device)
    rows = torch.full_like(x, T.row_of[take])  # the flat path passes one row
    fn = choose_firstn if firstn else choose_indep
    return fn(T, x, rows, reweight_lanes(cmap, weight, x.device),
              numrep, min(numrep, result_max), tries)


def crush_choose_plain(T, rule: FusedRule, x, reweight, roots=None):
    """Plain version of the ``crush_choose`` kernel: the step engine's
    loops for ``rule`` (the flat loops for a TAKE of devices choosing
    devices, the hierarchical ones otherwise) with the routed draw.
    ``roots`` (int32 [X] table rows, -1 for none), for a chain's later
    step (``rule.take_row`` -1, indep), starts each lane from its own
    root.  Returns [X, rule.width] int32 with CRUSH_ITEM_NONE holes."""
    if (roots is not None) != (rule.take_row < 0) or (roots is not None and rule.firstn):
        raise ValueError("per-lane roots go with an indep rule of take_row -1, and only there")
    if roots is None and rule.depth == 0 and rule.want_type == 0 and not rule.leaf:
        fn = choose_firstn if rule.firstn else choose_indep
        return fn(T, x, torch.full_like(x, rule.take_row), reweight, rule.numrep,
                  rule.width, rule.tries)
    if not rule.firstn:
        return choose_indep_plain(T, rule, x, reweight, roots)
    out, out2, _outpos = choose_firstn_hier(
        T, x, rule.take_row, reweight, numrep=rule.numrep, width=rule.width,
        tries=rule.tries, recurse_tries=rule.recurse_tries, want_type=rule.want_type,
        leaf=bool(rule.leaf), vary_r=rule.vary_r, stable=rule.stable)
    return out2 if rule.leaf else out


def choose(T, rule: FusedRule, x, reweight, roots=None):
    """The routed choose step: CPU lanes take :func:`crush_choose_plain`,
    CUDA lanes the ``crush_choose`` kernel (which raises on what it
    cannot run)."""
    if x.device.type == "cpu":
        return crush_choose_plain(T, rule, x, reweight, roots)
    return crush_cuda.crush_choose(T, rule, x, reweight, roots=roots)


def _engine(cmap, ruleno, x, result_max, weight):
    """A rule that :func:`fused_rule` takes runs as one routed choose
    step (on the card, one ``crush_choose`` launch), a chain that
    :func:`chain_rules` takes as one routed choose a step (and one more
    a region ``result_max`` cuts short); any other rule the batched
    path supports takes :func:`_step_engine`.  Decided from the map and
    rule before any launch."""
    rule = fused_rule(cmap, ruleno, result_max)
    if rule is not None:
        return choose(tables_for(cmap, x.device), rule, x,
                      reweight_lanes(cmap, weight, x.device))
    steps = chain_rules(cmap, ruleno, result_max)
    if steps is not None:
        return _chain_engine(tables_for(cmap, x.device), x,
                             reweight_lanes(cmap, weight, x.device), steps, result_max, choose)
    return _step_engine(cmap, ruleno, x, result_max, weight)


def _step_engine(cmap, ruleno, x, result_max, weight):
    """The step engine: the choose loops one try (and level) a step,
    each draw through ``crush_torch.straw2`` (on the card the
    ``crush_straw2`` kernel).  Rules of more than
    ``gf_cuda.CHOOSE_MAX_WIDTH`` slots (or with a row of
    ``gf_cuda.CHOOSE_MAX_SLOTS`` items) take it; the comparisons on the
    card call it directly for any rule."""
    if _supports_flat(cmap, ruleno):
        return _flat_engine(cmap, ruleno, x, result_max, weight)
    if supports_hier(cmap, ruleno):
        return _hier_engine(cmap, ruleno, x, result_max, weight)
    raise ValueError("map/rule shape not supported by the vectorized path")


def vec_rule_stats(cmap: CrushMap, ruleno: int, xs, result_max: int,
                   weight=None, device=None) -> tuple[dict[int, int], int]:
    """Profiled entry over :func:`_vec_rule_stats` — every bulk-sim
    call reports into the kernel profiler (ops.profiler): wall time,
    first-call behaviour keyed on the lane count, and batch shapes."""
    xs_np = np.asarray(xs, dtype=np.uint32)
    with profiler().timed(
        "crush_vec_stats", (ruleno, xs_np.shape, result_max),
        nbytes=xs_np.size * 4, shape=xs_np.shape,
    ):
        return _vec_rule_stats(cmap, ruleno, xs_np, result_max, weight, resolve(device))


def _vec_rule_stats(cmap, ruleno, xs, result_max, weight, device):
    """Bulk-sim statistics computed on the device: ({item: count},
    bad_mappings).  The CrushTester path: placements are bincounted on
    the device and only the counts come back.  Identical numbers to
    counting vec_do_rule's output."""
    out = _engine(cmap, ruleno, lanes_of(xs, device), result_max, weight)
    if out is None:
        return {}, 0
    width = out.shape[1]
    # item ids span [-max_buckets, max_devices): shift into bincount range
    offset = max(1, cmap.max_buckets)
    length = offset + cmap.max_devices
    placed = out != CRUSH_ITEM_NONE
    idx = torch.where(placed, out.long() + offset, length).reshape(-1)
    counts = torch.bincount(idx, minlength=length + 1)[:length].cpu().numpy()
    bad = int((placed.sum(dim=1) < width).sum())
    return {i - offset: int(c) for i, c in enumerate(counts) if c}, bad


def vec_do_rule(cmap: CrushMap, ruleno: int, xs, result_max: int,
                weight=None, device=None) -> np.ndarray:
    """Profiled entry over :func:`_vec_do_rule` (see vec_rule_stats)."""
    xs_np = np.asarray(xs, dtype=np.uint32)
    with profiler().timed(
        "crush_vec_rule", (ruleno, xs_np.shape, result_max),
        nbytes=xs_np.size * 4, shape=xs_np.shape,
    ):
        return _vec_do_rule(cmap, ruleno, xs_np, result_max, weight, resolve(device))


def vec_do_rule_lanes(cmap: CrushMap, ruleno: int, x: torch.Tensor,
                      result_max: int, weight=None) -> torch.Tensor:
    """:func:`vec_do_rule` on int32 lanes ``x`` (the uint32 inputs'
    bits) already on a device: the [X, numrep] int32 result stays on
    that device.  Profiled under the same ``crush_vec_rule`` tap."""
    shape = tuple(x.shape)
    with profiler().timed(
        "crush_vec_rule", (ruleno, shape, result_max),
        nbytes=x.numel() * 4, shape=shape,
    ):
        return _do_rule_lanes(cmap, ruleno, x, result_max, weight)


def _do_rule_lanes(cmap, ruleno, x, result_max, weight) -> torch.Tensor:
    """Batched crush_do_rule over lanes ``x`` (reference:mapper.c:854
    x-loop collapsed to one set of lanes).

    Returns [X, numrep] int32 on ``x``'s device (CRUSH_ITEM_NONE holes);
    bit-identical to the scalar mapper for supported maps (check with
    :func:`supports`).  Hierarchical maps (chooseleaf included) route to
    the multi-level engine in mapper_torch_hier.py."""
    out = _engine(cmap, ruleno, x, result_max, weight)
    if out is None:
        return torch.zeros((x.shape[0], 0), dtype=_LANE, device=x.device)
    return out


def _vec_do_rule(cmap, ruleno, xs, result_max, weight, device) -> np.ndarray:
    """:func:`_do_rule_lanes` from host inputs to host numpy."""
    return _do_rule_lanes(cmap, ruleno, lanes_of(xs, device), result_max, weight).cpu().numpy()
