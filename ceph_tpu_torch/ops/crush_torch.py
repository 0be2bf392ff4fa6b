"""CRUSH's batched primitives on torch lanes: the plain versions and the
routed straw2 draw.

Counterpart of the primitives of ``ceph_tpu/crush/mapper_jax.py``
(``hash32_2``, ``hash32_3``, ``crush_ln``, ``is_out``) and of the
per-lane bucket draw ``_straw2_rows`` of ``mapper_jax_hier.py``.  Lanes
are int32 tensors: ``x`` holds the uint32 input bits, ``rows`` a bucket
row per lane, ``r`` the replica number per lane.

The draw is exact, as ``bucket_straw2_choose`` (reference:
src/crush/mapper.c:302) defines it: for each item of the lane's bucket
``u = hash32_3(x, item, r) & 0xffff``, ``ln = crush_ln(u) - 2^48`` and
the draw ``ln / w`` truncated toward zero when ``w > 0``, else S64_MIN;
the first maximum wins.  The reference approximates the draw in f32 on
the TPU (no fast vector gather for the ln tables) and re-runs the lanes
it flags on the host; here the ln tables are gathered exactly, so there
are no flags and no host re-run.  The kernels divide by each weight's
reciprocal (:func:`recip_table`, :func:`div_by_recip_plain`); the plain
draw keeps ``//`` as the definition.

Routing (:func:`straw2`): a tensor on the CPU takes the plain version
:func:`straw2_plain`; a tensor on CUDA takes the Hopper kernel
``csrc/crush_straw2.cu`` (through ``crush_cuda``) or raises.  There is
no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..crush import ln_tables
# batched crush_hash32_2 / _3 (reference:hash.c:37, :48): a tensor
# operand takes the hashes' torch branch, int64 lanes in [0, 2^32)
from ..crush.hashes import crush_hash32_2 as hash32_2
from ..crush.hashes import crush_hash32_3 as hash32_3
from . import crush_cuda

LANE = torch.int32
S64_MIN = -(1 << 63)
_U64_MAX = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_RH_LH = len(ln_tables.RH_LH_TBL)
# int64 elements of one [lanes, items] intermediate of the plain draw;
# larger batches go through in chunks of lanes
_PLAIN_CHUNK = 1 << 24

_ln_cache: dict[torch.device, torch.Tensor] = {}
_ln_lock = threading.Lock()


class BucketRows(NamedTuple):
    """A map's buckets as padded int32 rows on one device, the tables
    the straw2 draw reads: ``items``, ``weights`` (16.16), ``recip`` (the
    weights' reciprocals of :func:`recip_table`, uint64 bits in int64),
    ``child_row`` (-1 for a device) and ``child_type`` (0 for a device),
    each [B, I]; ``size`` [B]; ``ln`` the int64 ln tables of
    :func:`ln_table`."""

    items: torch.Tensor
    weights: torch.Tensor
    recip: torch.Tensor
    child_row: torch.Tensor
    child_type: torch.Tensor
    size: torch.Tensor
    ln: torch.Tensor


def ln_table(device) -> torch.Tensor:
    """``RH_LH_TBL`` then ``LL_TBL`` as one int64 tensor on ``device``,
    made once per device."""
    device = torch.device(device)
    t = _ln_cache.get(device)
    if t is None:
        with _ln_lock:
            t = _ln_cache.get(device)
            if t is None:
                t = torch.tensor(ln_tables.RH_LH_TBL + ln_tables.LL_TBL,
                                 dtype=torch.int64, device=device)
                _ln_cache[device] = t
    return t


def recip_table(weights) -> np.ndarray:
    """Each weight's reciprocal ``floor((2^64 - 1) / w)`` as uint64 bits
    in int64 (0 where ``w`` is 0), for weights in [0, 2^31): the table the
    kernels divide by (``csrc/crush_draw.cuh``), made once per map."""
    w = np.asarray(weights, dtype=np.uint64)
    recip = np.where(w > 0, np.uint64(_U64_MAX) // np.maximum(w, np.uint64(1)), np.uint64(0))
    return recip.astype(np.uint64).view(np.int64)


def _mul32(a: torch.Tensor, b: torch.Tensor):
    """``a * b`` for int64 ``a``, ``b`` in [0, 2^32): (its high 32 bits,
    its low 32 bits), exact in int64 by a 16-bit split of ``a``."""
    lo = (a & 0xFFFF) * b                       # < 2^48
    hi = (a >> 16) * b + (lo >> 16)             # < 2^48 + 2^32
    return hi >> 16, ((hi & 0xFFFF) << 16) | (lo & 0xFFFF)


def div_by_recip_plain(n: torch.Tensor, w: torch.Tensor, recip: torch.Tensor) -> torch.Tensor:
    """``n // w`` as the kernels compute it, step by step in int64: ``q``
    the high 64 bits of the 128-bit product ``n * recip`` (from 32-bit
    limbs, as ``__umul64hi``), then one correction ``q += n - q*w >= w``.
    For n in [0, 2^48], w in [1, 2^31) and ``recip`` from
    :func:`recip_table` (uint64 bits in int64); the proof that one
    correction is enough is in ``csrc/crush_draw.cuh``."""
    n, w, recip = (torch.as_tensor(t, dtype=torch.int64) for t in (n, w, recip))
    a0, a1 = n & _M32, (n >> 32) & _M32
    b0, b1 = recip & _M32, (recip >> 32) & _M32
    h00, _ = _mul32(a0, b0)
    h01, l01 = _mul32(a0, b1)
    h10, l10 = _mul32(a1, b0)
    h11, l11 = _mul32(a1, b1)
    mid = h00 + l01 + l10                       # the product's bits 32..63, and carries
    q = ((h11 << 32) | l11) + h01 + h10 + (mid >> 32)
    return q + (n - q * w >= w).to(torch.int64)


def crush_ln(u: torch.Tensor, table: torch.Tensor | None = None) -> torch.Tensor:
    """Batched fixed-point 2^44*log2(u+1) (reference:mapper.c:248), exact
    in int64, for ``u`` in [0, 0xffff].

    ``(x * rh) >> 48`` needs 65 bits; it is taken as a 24/24 split of
    ``rh``, exact in int64 (``mapper_jax.py:164-167``)."""
    if table is None:
        table = ln_table(u.device)
    x = u.to(torch.int64) + 1  # 1..0x10000
    bit_length = torch.frexp(x.double())[1].to(torch.int64)  # exact below 2^53
    bits = torch.where((x & 0x18000) == 0, 16 - bit_length, 0)
    x = x << bits
    index1 = (x >> 8) << 1
    rh = torch.take(table, index1 - 256)
    lh = torch.take(table, index1 + 1 - 256)
    xl64 = (x * (rh >> 24) + ((x * (rh & 0xFFFFFF)) >> 24)) >> 24
    lh = lh + torch.take(table, _RH_LH + (xl64 & 0xFF))
    return ((15 - bits) << 44) + (lh >> 4)


def is_out(x: torch.Tensor, reweight: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
    """Batched probabilistic rejection (reference:mapper.c:385): an item
    outside the reweight vector is out, a weight of 0x10000 or more is
    in, 0 is out, else in with probability w / 0x10000."""
    n = reweight.shape[0]
    if n == 0:
        return torch.ones_like(item, dtype=torch.bool)
    inside = (item >= 0) & (item < n)
    w = torch.where(inside, torch.take(reweight, item.clamp(0, n - 1).long()), 0)
    hashed = hash32_2(x, item) & 0xFFFF
    return torch.where(w >= 0x10000, False, torch.where(w == 0, True, hashed >= w))


def straw2_plain(T: BucketRows, x: torch.Tensor, rows: torch.Tensor,
                 r: torch.Tensor):
    """Plain version of the ``crush_straw2`` kernel: straw2 over each
    lane's bucket row.  Returns ``(item, child_row, child_type, empty)``:
    the winning slot's entries (slot 0's, the padding, for a size-0
    bucket) and whether the bucket is empty.  Rows outside [0, B) read
    row 0 or B-1, as the kernel does (the callers mask those lanes)."""
    B, I = T.items.shape
    X = x.shape[0]
    out = torch.empty((3, X), dtype=LANE, device=x.device)
    empty = torch.empty(X, dtype=torch.bool, device=x.device)
    step = max(1, _PLAIN_CHUNK // I)
    slots = torch.arange(I, device=x.device)
    for s in range(0, X, step):
        row = rows[s:s + step].long().clamp(0, B - 1)
        n = torch.take(T.size, row).long()
        items = T.items.index_select(0, row)                    # [X, I]
        w = T.weights.index_select(0, row).long()
        u = hash32_3(x[s:s + step, None], items, r[s:s + step, None]) & 0xFFFF
        neg_ln = (1 << 48) - crush_ln(u, T.ln)                   # -ln >= 0
        draw = torch.where(w > 0, -(neg_ln // w.clamp(min=1)), S64_MIN)
        draw = torch.where(slots < n[:, None], draw, S64_MIN)   # padding never wins
        high = draw.argmax(dim=1, keepdim=True)                  # first maximum
        out[0, s:s + step] = items.gather(1, high)[:, 0]
        out[1, s:s + step] = T.child_row.index_select(0, row).gather(1, high)[:, 0]
        out[2, s:s + step] = T.child_type.index_select(0, row).gather(1, high)[:, 0]
        empty[s:s + step] = n == 0
    return out[0], out[1], out[2], empty


def straw2(T: BucketRows, x: torch.Tensor, rows: torch.Tensor, r: torch.Tensor):
    """The routed draw: CPU lanes take :func:`straw2_plain`, CUDA lanes
    the ``crush_straw2`` kernel (which raises on what it cannot run)."""
    if x.device.type == "cpu":
        return straw2_plain(T, x, rows, r)
    return crush_cuda.crush_straw2(T, x, rows, r)
