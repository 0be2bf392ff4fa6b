"""Mesh construction helpers.

Counterpart of ``ceph_tpu/parallel/mesh.py``.  The reference's mesh is a
``jax.sharding.Mesh``; here it is a :class:`DeviceMesh`, a [pg, shard]
grid of ``torch.device`` lanes under the same axis names.  One process
drives every lane: a lane is a place where work runs, and two lanes may
name the same device.

``shard_map_compat`` is not ported: it is a JAX version shim (the two
spellings of ``shard_map``'s replication opt-out), and nothing here is
traced, so there is nothing to shim.

Device rule (shared with :class:`~ceph_tpu_torch.parallel.engine.MeshEcEngine`
through :func:`mesh_devices`):

- no device, or a CUDA device: the CUDA cards, the first ``n_devices``
  of them, or all of them when ``n_devices`` is 0 or None; without CUDA,
  ``DeviceUnavailableError``;
- ``device="cpu"``: ``n_devices`` lanes of the CPU, or
  :data:`CPU_LANES` (8, the reference tests' virtual device count) when
  ``n_devices`` is 0 or None.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import DeviceUnavailableError

# CPU lanes when no count is given: the reference's tests run jax on 8
# virtual CPU devices
CPU_LANES = 8


def mesh_devices(n_devices: int | None = None,
                 device=None) -> list[torch.device]:
    """The lanes of a mesh slice, by the module's device rule."""
    kind = None if device is None else torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (int(n_devices) if n_devices
                                         else CPU_LANES)
    if kind not in (None, "cuda"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA is not available; pass device='cpu' to run the mesh on "
            "the host"
        )
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[: int(n_devices)] if n_devices else devs


class DeviceMesh:
    """A 2-D grid of lanes with named axes: ``devices[p, s]`` is the
    ``torch.device`` of lane (p, s)."""

    def __init__(self, devices, axis_names: tuple[str, str] = ("pg", "shard")):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def ec_shard_axis(k: int, n_devices: int) -> int:
    """Size of the EC mesh's 'shard' (chunk-layout) axis: the largest
    divisor of gcd(k, n) not exceeding 4, so survivor rows shard evenly
    for the reconstruct gather while most of the device count stays on
    the 'pg' axis for stripe/byte parallelism (an over-wide shard axis
    buys layout, not compute — encode work is stripe-sharded, and the
    reconstruct rebuild is byte-sharded over 'pg').

    Returns 1 when gcd(k, n) == 1 (prime k vs the device count) — the
    degenerate case MeshEcEngine's reconstruct handles by gathering
    over 'pg' instead."""
    g = math.gcd(int(k), int(n_devices))
    for cand in (4, 3, 2):
        if g % cand == 0:
            return cand
    return 1


def make_mesh(
    n_devices: int | None = None,
    shard_parallelism: int | None = None,
    axis_names: tuple[str, str] = ("pg", "shard"),
    device=None,
) -> DeviceMesh:
    """2-D mesh (pg, shard) over the lanes :func:`mesh_devices` gives
    for ``n_devices`` and ``device``.

    ``shard_parallelism`` is the size of the chunk-sharding axis (must
    divide both n_devices and, at use sites, the k of the code); default:
    largest power of two <= min(4, n_devices).
    """
    devices = mesh_devices(n_devices, device)
    n = len(devices)
    if shard_parallelism is None:
        shard_parallelism = 1
        while (
            shard_parallelism * 2 <= 4
            and n % (shard_parallelism * 2) == 0
        ):
            shard_parallelism *= 2
    if n % shard_parallelism != 0:
        raise ValueError(
            f"shard_parallelism={shard_parallelism} does not divide {n} devices"
        )
    pg = n // shard_parallelism
    grid = [devices[p * shard_parallelism:(p + 1) * shard_parallelism]
            for p in range(pg)]
    return DeviceMesh(grid, axis_names)
