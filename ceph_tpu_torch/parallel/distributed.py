"""Distributed EC pipeline: lane-split encode + gathered reconstruction.

Counterpart of ``ceph_tpu/parallel/distributed.py``: the multi-device
data path (the analog of the reference's k+m shard fan-out over the
cluster messenger, reference:src/osd/ECBackend.cc:1902-1926, and of
recovery gathers, reference:src/osd/ECBackend.cc:2187):

- encode: stripes split over the lanes of a mesh; each lane encodes its
  stripes on its own device (no copies between lanes — placement
  parallelism).
- degraded read / recovery: survivor rows arrive split over the gather
  axis, each lane holding its row block of its byte slice; the blocks
  are copied onto the device that rebuilds the slice (the reference's
  ``all_gather`` inside ``shard_map``) and the missing rows are rebuilt
  there by the recovery matrix.

One process drives every lane.  A copy between lanes is
``Tensor.copy_`` with ``non_blocking=True`` on the current stream: a
device-to-device copy when the lanes share a card, a peer copy when they
do not.  ``encode_sharding`` (the reference's ``NamedSharding`` for the
step's input) has no counterpart: the step takes host data and splits it
over the lanes itself.

The lane helpers :func:`encode_lanes` and :func:`gather_rebuild` are
shared with :class:`~ceph_tpu_torch.parallel.engine.MeshEcEngine`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import matrices as mx
from ..ops.gf import gf
from ..ops.gf_torch import GFMatmul, bytes_to_u32, u32_to_bytes
from .mesh import DeviceMesh


def _recovery_rows(parity: np.ndarray, k: int, w: int, present: list[int],
                   missing: list[int]) -> np.ndarray:
    """[len(missing), k] GF matrix over the first-k survivors."""
    G = gf(w)
    R = mx.decode_matrix(parity, k, w, present[:k])
    rows = []
    for r in missing:
        if r < k:
            rows.append(R[r])
        else:
            rows.append(G.matmul(parity[r - k][None, :], R)[0])
    return np.stack(rows)


def lane_engines(matrix: np.ndarray, w: int, lanes) -> dict:
    """One ``GFMatmul`` per distinct device of ``lanes``: lanes that name
    the same device share its tables."""
    return {dev: GFMatmul(matrix, w, dev) for dev in dict.fromkeys(lanes)}


def _host_tensor(block: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(block)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy wants writable memory
    return torch.from_numpy(arr)


def encode_lanes(lanes: list, engines: dict, m: int,
                 d3: np.ndarray) -> np.ndarray:
    """Parity of the host stripes ``d3`` [S, k, C] (S a multiple of the
    lane count, C of 4), split evenly over ``lanes``: each lane's stripes
    go to its device, are laid out as [k, S/n*C] rows there, and that
    device's engine computes their parity.  Returns host [m, S*C], each
    parity shard's bytes in stripe order."""
    S, k, C = d3.shape
    sl = S // len(lanes)
    outs = []
    for i, dev in enumerate(lanes):
        x = _host_tensor(d3[i * sl:(i + 1) * sl]).to(dev, non_blocking=True)
        flat = x.permute(1, 0, 2).reshape(k, sl * C)
        outs.append(engines[dev](bytes_to_u32(flat)))
    parity = np.empty((m, S * C), dtype=np.uint8)
    for i, p in enumerate(outs):
        parity[:, i * sl * C:(i + 1) * sl * C] = u32_to_bytes(p).cpu().numpy()
    return parity


def gather_rebuild(mesh: DeviceMesh, rows_ax: str, engines: dict | None,
                   surv: np.ndarray) -> np.ndarray | None:
    """Rebuild missing rows from host survivors ``surv`` [k_p, L] laid
    over ``mesh``: rows split over the ``rows_ax`` axis, bytes over the
    other.  Lane (r, c) of the gather receives its row block r of byte
    slice c; the gather copies every block of slice c onto the slice's
    first lane, where ``engines[device]`` rebuilds the slice.  Returns
    host [missing, L]; with ``engines=None`` only the gather runs (the
    cost probe), and nothing is returned once it has finished.

    The reference computes each rebuilt slice on every member of the
    gather axis, a replicated result with identical bytes; here each
    slice is rebuilt once."""
    grid = mesh.devices.T if rows_ax == "shard" else mesh.devices
    rows_sz, cols_sz = grid.shape
    k_p, L = surv.shape
    rb, cb = k_p // rows_sz, L // cols_sz
    gathered = []
    for c in range(cols_sz):
        cols = slice(c * cb, (c + 1) * cb)
        target = grid[0, c]
        g = torch.empty((k_p, cb), dtype=torch.uint8, device=target)
        # each lane's own rows arrive from the host; the target's land
        # in place
        g[:rb].copy_(_host_tensor(surv[:rb, cols]), non_blocking=True)
        held = [
            (r, _host_tensor(surv[r * rb:(r + 1) * rb, cols]).to(
                grid[r, c], non_blocking=True))
            for r in range(1, rows_sz)
        ]
        # the gather: the other members' blocks onto the target
        for r, block in held:
            g[r * rb:(r + 1) * rb].copy_(block, non_blocking=True)
        gathered.append((target, g))
    if engines is None:
        for dev in dict.fromkeys(t for t, _ in gathered):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return None
    rebuilt = [engines[t](bytes_to_u32(g)) for t, g in gathered]
    out = np.empty((rebuilt[0].shape[0], L), dtype=np.uint8)
    for c, r in enumerate(rebuilt):
        out[:, c * cb:(c + 1) * cb] = u32_to_bytes(r).cpu().numpy()
    return out


def make_ec_step(
    mesh: DeviceMesh,
    parity_matrix: np.ndarray,
    w: int = 8,
    erased: tuple[int, ...] = (0,),
):
    """Build a distributed step: encode all stripes, then rebuild
    ``erased`` chunk rows from survivors gathered over 'shard'.

    Input: data [S, k, C] uint8 (numpy, or a tensor); S divisible by the
    pg axis, C by 4, k by the shard axis.  The stripes split over 'pg'
    (each pg row encodes on its first lane); for the reconstruct each
    lane (p, s) holds survivor rows block s of stripe block p, and lane
    (p, 0) gathers and rebuilds them.  Returns (full [S, k+m, C],
    rebuilt [S, len(erased), C]) on the host, numpy for numpy input and
    CPU tensors for a tensor."""
    parity_matrix = np.asarray(parity_matrix)
    m, k = parity_matrix.shape
    n = k + m
    present = [r for r in range(n) if r not in erased]
    if len(present) < k:
        raise ValueError("too many erasures")
    RM = _recovery_rows(parity_matrix, k, w, present, list(erased))
    pg, shard = mesh.devices.shape
    if k % shard:
        raise ValueError(f"k={k} survivor rows do not split over a shard "
                         f"axis of {shard}")
    firsts = list(mesh.devices[:, 0])
    enc = lane_engines(parity_matrix, w, firsts)
    dec = lane_engines(RM, w, firsts)
    use = present[:k]

    def step(data):
        as_tensor = isinstance(data, torch.Tensor)
        d3 = data.cpu().numpy() if as_tensor else np.asarray(data, np.uint8)
        S, kk, C = d3.shape
        if kk != k or S % pg or C % 4:
            raise ValueError(
                f"data {d3.shape} does not fit k={k}, a pg axis of {pg} "
                f"and 4-byte lanes")
        parity = encode_lanes(firsts, enc, m, d3)
        full = np.concatenate(
            [d3, parity.reshape(m, S, C).transpose(1, 0, 2)], axis=1)
        surv = np.ascontiguousarray(
            full[:, use, :].transpose(1, 0, 2)).reshape(k, S * C)
        rebuilt = np.ascontiguousarray(
            gather_rebuild(mesh, "shard", dec, surv)
            .reshape(len(erased), S, C).transpose(1, 0, 2))
        if as_tensor:
            return torch.from_numpy(full), torch.from_numpy(rebuilt)
        return full, rebuilt

    return step
