"""The CRUSH Hopper kernels' wrappers: ``crush_straw2`` and ``crush_choose``.

``csrc/crush_straw2.cu`` draws straw2 over a bucket row per lane,
exactly as ``bucket_straw2_choose`` does; it replaces the f32 draw of the
reference's CRUSH XLA programs (``straw2_choose_approx``,
``ceph_tpu/crush/mapper_jax.py:280``; ``_straw2_rows``,
``ceph_tpu/crush/mapper_jax_hier.py:189``).  ``csrc/crush_choose.cu``
runs a single-step rule's whole choose step per lane (firstn or indep,
chooseleaf included), as the scalar mapper does, a tile of
:func:`choose_tile` threads a lane, and one step of a chained rule with
each lane rooted at a bucket of its own; it replaces the reference's
``choose_firstn``/``choose_indep`` programs and their hierarchical
twins.  Both are built and loaded by ``gf_cuda``'s machinery
(``nvcc`` into ``ceph_tpu_torch/build/`` at first use, bound with
``ctypes``) and count their launches in ``gf_cuda.launches``.  The
routing (CPU lanes -> the plain versions) lives in ``crush_torch``
(the draw) and ``crush.mapper_torch`` (the choose step).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf_cuda


def _check_lanes(lanes: int, dev, **named) -> None:
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("the CUDA kernels take CUDA tensors")
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != lanes:
            raise ValueError(f"{name}: expected int32 lanes [{lanes}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: lanes must be contiguous and on {dev}")


def _check_tables(T, dev) -> None:
    """``T``, a ``crush_torch.BucketRows``, whole and on ``dev``."""
    for t in T:
        want = torch.int64 if t is T.ln or t is T.recip else torch.int32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"bucket tables must be contiguous {want} on {dev}")
    B, I = T.items.shape
    if (B == 0 or I == 0 or T.ln.shape[0] != gf_cuda.LN_ENTRIES
            or T.recip.shape != T.items.shape):
        raise ValueError("bucket tables need a row, a slot, the reciprocals and the "
                         "whole ln tables")


def crush_straw2(T, x: torch.Tensor, rows: torch.Tensor, r: torch.Tensor):
    """straw2 over each lane's bucket row on the card: int32 lanes ``x``,
    ``rows``, ``r`` -> ``(item, child_row, child_type, empty)``, as
    ``crush_torch.straw2_plain`` returns them.  ``T`` is a
    ``crush_torch.BucketRows`` on the lanes' device."""
    lanes = x.shape[0] if isinstance(x, torch.Tensor) else 0
    _check_lanes(lanes, getattr(x, "device", None), x=x, rows=rows, r=r)
    _check_tables(T, x.device)
    B, I = T.items.shape
    out = torch.empty((3, lanes), dtype=torch.int32, device=x.device)
    empty = torch.empty(lanes, dtype=torch.bool, device=x.device)
    if lanes == 0:
        return out[0], out[1], out[2], empty
    launch = gf_cuda._lib("crush_straw2").crush_straw2_launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(), rows.data_ptr(), r.data_ptr(), T.items.data_ptr(),
            T.weights.data_ptr(), T.recip.data_ptr(), T.child_row.data_ptr(),
            T.child_type.data_ptr(), T.size.data_ptr(), T.ln.data_ptr(), B, I, lanes,
            out.data_ptr(), empty.data_ptr(), stream,
        )
    gf_cuda._launched("crush_straw2", rc)
    return out[0], out[1], out[2], empty


def choose_tile(T, rule) -> int:
    """The threads a lane (one of ``gf_cuda.CHOOSE_TILES``) that
    ``crush_choose`` runs ``rule`` with: 8 when 8 divides the size of
    every row on the rule's path (``rule.row_gcd``), else 4, so that no
    thread of a tile idles in a round of draws and a warp holds 4 or 8
    lanes.  On the card that tile was the fastest of the four, or within
    5 % of it, on each case of ``chip_smoke.py`` phases 7 and 8; the
    take row's size rounded up to a power of two was up to 1.6 times
    slower (PERF.md).  Raises on a rule the kernel does not take: a
    width outside [1, ``gf_cuda.CHOOSE_MAX_WIDTH``], or a row of
    ``gf_cuda.CHOOSE_MAX_SLOTS`` items or more on its path (the tile's
    key keeps a slot in 15 bits).  A take row of -1 is a chain's later
    step (roots per lane).  Host-side: ``T`` is a
    ``mapper_torch_hier.MapTables`` on any device."""
    if not 1 <= rule.width <= gf_cuda.CHOOSE_MAX_WIDTH:
        raise ValueError(f"crush_choose takes 1 to {gf_cuda.CHOOSE_MAX_WIDTH} slots, "
                         f"not {rule.width}")
    if not -1 <= rule.take_row < T.B:
        raise ValueError(f"take row {rule.take_row} outside the map's {T.B} rows")
    if rule.widest >= gf_cuda.CHOOSE_MAX_SLOTS:
        raise ValueError(f"crush_choose takes rows of fewer than {gf_cuda.CHOOSE_MAX_SLOTS} "
                         f"items, not {rule.widest}")
    return 8 if rule.row_gcd % 8 == 0 else 4


def crush_choose(T, rule, x: torch.Tensor, reweight: torch.Tensor,
                 draws: torch.Tensor | None = None, tile: int | None = None,
                 roots: torch.Tensor | None = None) -> torch.Tensor:
    """One rule's choose step over int32 lanes ``x`` on the card ->
    [lanes, rule.width] int32 with CRUSH_ITEM_NONE holes, as
    ``mapper_torch.crush_choose_plain`` returns it.  ``T`` is the map's
    ``mapper_torch_hier.MapTables`` on the lanes' device, ``rule`` a
    ``mapper_torch_hier.FusedRule`` of that map and ``reweight`` the
    int32 in/out weights (16.16) on the device.  ``roots``, int32 lanes
    of table rows (-1: no bucket, a row of NONE and no draw), starts
    each lane's indep choose from its own root: a chain's later step,
    whose ``rule.take_row`` is -1.  The kernel adds the draws it made to
    ``draws``, an int64 [1] tensor on the device, when one is given (the
    wrapper allocates one otherwise).  ``tile``, the threads a lane, is
    :func:`choose_tile`'s unless given (for a measurement)."""
    lanes = x.shape[0] if isinstance(x, torch.Tensor) else 0
    dev = getattr(x, "device", None)
    _check_lanes(lanes, dev, x=x)
    if roots is not None:
        _check_lanes(lanes, dev, roots=roots)
        if rule.firstn:
            raise ValueError("crush_choose runs per-lane roots through indep only")
    if (roots is not None) != (rule.take_row < 0):
        raise ValueError("a rule of take_row -1 takes per-lane roots, and only it")
    if (not isinstance(reweight, torch.Tensor) or reweight.device != dev
            or reweight.dtype != torch.int32 or reweight.dim() != 1
            or not reweight.is_contiguous()):
        raise ValueError(f"reweight must be a contiguous int32 vector on {dev}")
    _check_tables(T.rows, dev)
    chosen = choose_tile(T, rule)  # raises on a rule the kernel does not take
    if tile is None:
        tile = chosen
    elif tile not in gf_cuda.CHOOSE_TILES:
        raise ValueError(f"crush_choose runs a tile of {gf_cuda.CHOOSE_TILES} threads, "
                         f"not {tile}")
    if draws is None:
        draws = torch.zeros(1, dtype=torch.int64, device=dev)
    elif (draws.device != dev or draws.dtype != torch.int64 or draws.numel() != 1
            or not draws.is_contiguous()):
        raise ValueError(f"draws must be one int64 on {dev}")
    out = torch.empty((lanes, rule.width), dtype=torch.int32, device=dev)
    if lanes == 0:
        return out
    packed = np.asarray(rule[:gf_cuda.CHOOSE_RULE_INTS], dtype=np.int32)
    if packed.shape != (gf_cuda.CHOOSE_RULE_INTS,):
        raise ValueError(f"a rule is {gf_cuda.CHOOSE_RULE_INTS} ints, got {packed.shape}")
    R = T.rows
    launch = gf_cuda._lib("crush_choose").crush_choose_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = launch(
            x.data_ptr(), None if roots is None else roots.data_ptr(), R.items.data_ptr(),
            R.weights.data_ptr(), R.recip.data_ptr(), R.child_row.data_ptr(),
            R.child_type.data_ptr(), R.size.data_ptr(),
            rule.widest if roots is not None else T.sizes[rule.take_row], R.ln.data_ptr(),
            reweight.data_ptr(), reweight.shape[0], T.I, lanes, packed.ctypes.data,
            out.data_ptr(), draws.data_ptr(), tile, stream,
        )
    gf_cuda._launched("crush_choose", rc)
    return out
