"""MeshEcEngine: the OSD's EC hot ops executed over a mesh of lanes.

Counterpart of ``ceph_tpu/parallel/engine.py``, with the same public
methods, errors, padding and alignment rules, program-cache keys and
profiler families.  The reference is single-controller: one process
owns a ``jax.sharding.Mesh`` of shape (pg, shard) and runs ``shard_map``
programs over it, and the dispatcher's worker thread calls
``encode_batch`` / ``decode_batch`` and gets the bytes back.  The port
keeps that contract: one process, a [pg, shard] grid of
``torch.device`` lanes (:class:`~ceph_tpu_torch.parallel.mesh.DeviceMesh`).

- **encode** splits the stripes evenly over ALL pg x shard lanes; each
  lane's slice goes to its device, where that device's ``GFMatmul``
  computes its parity (the ``gf_matmul`` kernel on CUDA, the plain
  version on the CPU).  The reference then lays the k+m rows across
  ``shard`` by a sharding constraint; here the rows return to the host,
  so that reshard has no counterpart.
- **reconstruct** starts from survivor rows split over ``shard`` with
  the byte dimension split over ``pg``: each lane receives its row block
  of its byte slice.  The gather copies every block of a byte slice
  onto the device that rebuilds it (``Tensor.copy_``, non-blocking, on
  the current stream: device-to-device on one card, a peer copy across
  cards), and the cached recovery matrix rebuilds the missing rows —
  the MOSDECSubOpRead round-trips of reference:src/osd/ECBackend.cc:2187
  become one gather, and the rebuild stays pg-parallel.
- **prime-k degeneracy**: when ``gcd(k, n) == 1`` the ``shard`` axis
  collapses to 1; reconstruct then splits the survivor ROWS over ``pg``
  (zero-padded to a row multiple, with matching zero recovery-matrix
  columns), so the gather still crosses lanes.

Not ``torch.distributed``: a process group is a multi-process SPMD
model, where every rank runs its part of each collective.  The OSD calls
this engine in-process from one dispatcher thread, which cannot drive
peer ranks without becoming a different architecture; one process
copying between its own devices keeps the reference's contract.

Device rule: ``MeshEcEngine(devices=None, n_devices=None, device=None)``
and :func:`get_mesh_engine` resolve their lanes lazily, at the first
``mesh_for`` (construction, ``supports`` and ``routes`` never touch a
device).  With no device, the CUDA cards: the first ``n_devices``, or
all of them when that is 0; without CUDA, ``DeviceUnavailableError``.
With ``device="cpu"``, ``n_devices`` lanes of the CPU, or 8 when that is
0 (the reference tests' virtual device count).  An explicit ``devices``
list may repeat a device: its lanes share that device's ``GFMatmul``
tables.

Byte contract: outputs are bit-identical to the host path
(:func:`ceph_tpu_torch.osd.ec_util.encode` / ``decode_concat``) — GF
algebra is exact and reconstruction of an MDS code is unique.

Batching contract (the dispatcher lane): :meth:`encode_batch` /
:meth:`decode_batch` take PRE-ALIGNED batches — the microbatch
dispatcher pads the coalesced stripe count to ``mesh_size x bucket``
(ec_dispatch.bucket_stripes_aligned), so lanes stay balanced and the
program cache holds O(#buckets x #mesh-slices) entries.  The per-op
:meth:`encode` / :meth:`decode` wrappers pad internally.

Every call reports into the process kernel profiler under its own
engine family (``mesh_encode`` / ``mesh_reconstruct`` /
``mesh_gather``), keyed on (mesh shape, codec matrix, padded batch
shape), timed on the host clock around the whole call, its copies to
and from the lanes included.

Engine support is matrix codecs (:class:`MatrixErasureCode`: isa +
jerasure reed_sol families, w=8 and w=16); bitmatrix/LRC/SHEC codecs
take the other lanes.
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from ..device import resolve
from ..utils.buffers import as_u8
from .distributed import (
    _recovery_rows,
    encode_lanes,
    gather_rebuild,
    lane_engines,
)
from .mesh import DeviceMesh, ec_shard_axis, mesh_devices


# ONE mesh call in flight per process: every dispatcher executor thread
# and the failover canary route through this lock.  The lanes are one
# host resource, so concurrent calls had nothing to win, and a call's
# copies between lanes must not interleave with another call's on the
# same streams.  A genuinely wedged device call holding the lock
# starves later launches into their deadline failovers — the breaker's
# job, exactly as for a wedged single-device call.
_MESH_EXEC_LOCK = threading.Lock()


class MeshEcEngine:
    """Per-lane program cache + mesh factory for the EC data path."""

    def __init__(self, devices=None, max_programs: int = 64,
                 n_devices: int | None = None, device=None):
        # lane acquisition is LAZY (first mesh_for call): this
        # constructor runs inside OSD.__init__, and supports() and
        # construction must never touch a device.  ``n_devices`` bounds
        # the slice (osd_ec_mesh_devices; 0/None = every card, or 8 CPU
        # lanes for device="cpu"), resolved at the same lazy point.
        self._given = list(devices) if devices is not None else None
        self._devices: list[torch.device] | None = None
        self._n_devices = int(n_devices) if n_devices else None
        self._device = device
        self.max_programs = max_programs
        self._programs: dict = {}
        self._meshes: dict[int, tuple] = {}
        self._lock = threading.Lock()

    @property
    def devices(self) -> list[torch.device]:
        if self._devices is None:
            if self._given is not None:
                self._devices = [resolve(d) for d in self._given]
            else:
                self._devices = mesh_devices(self._n_devices, self._device)
        return self._devices

    # -- capability ----------------------------------------------------------
    def supports(self, ec_impl) -> bool:
        from ..models.matrix_codec import MatrixErasureCode

        # exactly the plain MDS matrix family (isa + jerasure reed_sol):
        # subclasses override decode semantics (SHEC's shingle matrix is
        # non-MDS — any-k-survivors reconstruction does not hold; the
        # bitmatrix family packetizes), so they take the other lanes
        return (
            type(ec_impl) is MatrixErasureCode
            and getattr(ec_impl, "matrix", None) is not None
        )

    def routes(self, sinfo, ec_impl) -> bool:
        """May the DISPATCHER route this (geometry, codec) to the mesh
        lane?  supports() plus the 32-bit-lane alignment the lanes'
        engines need — one predicate shared with the OSD router so the
        lane gates cannot drift.  Never touches a device."""
        return self.supports(ec_impl) and sinfo.chunk_size % 4 == 0

    # -- mesh factory --------------------------------------------------------
    def mesh_for(self, k: int):
        """(mesh, pg_size, shard_size): 'shard' is the chunk-layout
        axis (bounded divisor of gcd(k, n) — see mesh.ec_shard_axis);
        'pg' takes the rest of the lanes for stripe parallelism."""
        with self._lock:
            got = self._meshes.get(k)
            if got is not None:
                return got
        devs = self.devices
        n = len(devs)
        shard = ec_shard_axis(k, n)
        pg = n // shard
        mesh = DeviceMesh([devs[p * shard:(p + 1) * shard] for p in range(pg)])
        with self._lock:
            self._meshes[k] = (mesh, pg, shard)
        return mesh, pg, shard

    def mesh_key(self, k: int) -> tuple[int, int]:
        """(pg, shard) — the mesh-slice dimension of a dispatcher batch
        key; pg * shard is the stripe-alignment quantum."""
        _mesh, pg, shard = self.mesh_for(k)
        return pg, shard

    def reconstruct_axis(self, k: int) -> str:
        """Which mesh axis the reconstruct gather crosses: 'shard'
        normally, 'pg' on the prime-k degeneracy (gcd(k, n) == 1)."""
        _mesh, pg, shard = self.mesh_for(k)
        return "shard" if shard > 1 else "pg"

    def _cached(self, key, build):
        with self._lock:
            fn = self._programs.get(key)
        if fn is None:
            fn = build()
            with self._lock:
                if len(self._programs) >= self.max_programs:
                    self._programs.pop(next(iter(self._programs)))
                self._programs[key] = fn
        return fn

    @staticmethod
    def _mkey(ec_impl):
        return (
            ec_impl.w,
            tuple(tuple(int(v) for v in row) for row in ec_impl.matrix),
        )

    @staticmethod
    def _bucket(n: int, quantum: int) -> int:
        """Round n up to quantum * 2^j — bounds the program cache under
        the OSD's naturally varied op sizes."""
        units = max(1, -(-n // quantum))
        return quantum * (1 << max(0, math.ceil(math.log2(units))))

    def _profiler(self):
        from ..ops.profiler import profiler

        return profiler()

    # -- encode --------------------------------------------------------------
    def encode(self, sinfo, ec_impl, data) -> dict[int, np.ndarray]:
        """Per-op twin of :func:`ceph_tpu_torch.osd.ec_util.encode` —
        same contract, same bytes; pads the stripe batch to a
        mesh-aligned bucket internally (zero stripes encode to zero
        parity columnwise) and slices back."""
        buf = as_u8(data)
        if buf.size % sinfo.stripe_width != 0:
            raise ValueError(
                f"data size {buf.size} not a multiple of "
                f"stripe_width {sinfo.stripe_width}"
            )
        k = ec_impl.get_data_chunk_count()
        S = buf.size // sinfo.stripe_width
        C = sinfo.chunk_size
        _mesh, pg, shard = self.mesh_for(k)
        S_p = self._bucket(S, pg * shard)
        if S_p != S:
            buf = np.concatenate(
                [buf, np.zeros((S_p - S) * sinfo.stripe_width,
                               dtype=np.uint8)]
            )
        full = self.encode_batch(sinfo, ec_impl, buf)
        if S_p == S:
            return full
        return {i: v[: S * C] for i, v in full.items()}

    def encode_batch(self, sinfo, ec_impl, data) -> dict[int, np.ndarray]:
        """Mesh-aligned batch encode: same contract and bytes as
        :func:`ceph_tpu_torch.osd.ec_util.encode`, split over every
        lane; the stripe count must already be a multiple of the mesh
        size (the dispatcher lane pads to mesh_size x bucket)."""
        buf = as_u8(data)
        if buf.size % sinfo.stripe_width != 0:
            raise ValueError(
                f"data size {buf.size} not a multiple of "
                f"stripe_width {sinfo.stripe_width}"
            )
        k = ec_impl.get_data_chunk_count()
        m = ec_impl.get_coding_chunk_count()
        if k != sinfo.k:
            raise ValueError(f"codec k={k} != stripe k={sinfo.k}")
        C = sinfo.chunk_size
        if C % 4 != 0:
            raise ValueError(f"chunk_size {C} not a multiple of 4")
        S = buf.size // sinfo.stripe_width
        mesh, pg, shard = self.mesh_for(k)
        n = pg * shard
        if S % n != 0:
            raise ValueError(
                f"mesh batch of {S} stripes not aligned to the "
                f"{pg}x{shard} mesh (pad to a multiple of {n})"
            )
        d3 = buf.reshape(S, k, C)
        mk = self._mkey(ec_impl)
        step = self._cached(
            ("enc", mk, S, C),
            lambda: self._build_encode(ec_impl, mesh, m),
        )
        with _MESH_EXEC_LOCK:
            parity = self._profiler().call_jitted(
                "mesh_encode", ((pg, shard), mk, S, C), step, (d3,),
                nbytes=buf.size, shape=(S, k, C),
            )  # [m, S*C]
        out = {i: np.ascontiguousarray(d3[:, i, :]).reshape(S * C)
               for i in range(k)}
        out.update({k + j: parity[j] for j in range(m)})
        return out

    def _build_encode(self, ec_impl, mesh, m):
        lanes = list(mesh.devices.flat)
        return functools.partial(
            encode_lanes, lanes,
            lane_engines(ec_impl.matrix, ec_impl.w, lanes), m,
        )

    # -- reconstruct ---------------------------------------------------------
    def decode(
        self, sinfo, ec_impl, chunks, want=None
    ) -> dict[int, np.ndarray]:
        """Per-op twin of :func:`ceph_tpu_torch.osd.ec_util.decode`:
        pads the shard buffers to a mesh-aligned bucket and slices
        back."""
        k = ec_impl.get_data_chunk_count()
        if want is None:
            want = list(range(k))
        arrs = {int(r): as_u8(np.asarray(v)) for r, v in chunks.items()}
        sizes = {a.size for a in arrs.values()}
        if len(sizes) != 1:
            raise ValueError(f"shard buffers differ in size: {sizes}")
        L = next(iter(sizes))
        if L % sinfo.chunk_size != 0:
            raise ValueError(
                f"shard buffer size {L} not a multiple of "
                f"chunk_size {sinfo.chunk_size}"
            )
        if not any(r not in arrs for r in want):
            return {r: arrs[r] for r in want}
        _mesh, pg, shard = self.mesh_for(k)
        quantum = 4 * pg * shard  # 32-bit lanes x the byte-split axis
        L_p = self._bucket(max(L, quantum), quantum)
        if L_p != L:
            arrs = {
                r: np.concatenate(
                    [a, np.zeros(L_p - L, dtype=np.uint8)]
                )
                for r, a in arrs.items()
            }
        decoded = self.decode_batch(sinfo, ec_impl, arrs, want=want)
        if L_p == L:
            return decoded
        return {r: v[:L] for r, v in decoded.items()}

    def decode_batch(
        self, sinfo, ec_impl, chunks, want=None
    ) -> dict[int, np.ndarray]:
        """Mesh-aligned batch reconstruct: survivor rows enter split
        over the gather axis ('shard', or 'pg' on the prime-k
        degeneracy), are gathered onto each byte slice's rebuilding
        lane, and the missing rows rebuild pg-parallel over the byte
        dimension.  Shard buffers must be mesh-slice aligned (see
        :meth:`routes` + the dispatcher padding)."""
        k = ec_impl.get_data_chunk_count()
        if want is None:
            want = list(range(k))
        present = sorted(chunks)
        arrs = {int(r): as_u8(np.asarray(v)) for r, v in chunks.items()}
        sizes = {a.size for a in arrs.values()}
        if len(sizes) != 1:
            raise ValueError(f"shard buffers differ in size: {sizes}")
        L = next(iter(sizes))
        missing = [r for r in want if r not in arrs]
        out = {r: arrs[r] for r in want if r in arrs}
        if not missing:
            return out
        if len(present) < k:
            raise ValueError(
                f"cannot decode: {len(present)} survivors < k={k}"
            )
        use = present[:k]
        mesh, pg, shard = self.mesh_for(k)
        rows_ax = "shard" if shard > 1 else "pg"
        rows_sz = shard if shard > 1 else pg
        cols_sz = pg if shard > 1 else shard
        if L % (4 * cols_sz) != 0:
            raise ValueError(
                f"shard buffer size {L} not aligned to the mesh slice "
                f"(need a multiple of {4 * cols_sz})"
            )
        k_p = -(-k // rows_sz) * rows_sz
        surv = np.stack([arrs[r] for r in use])
        if k_p != k:
            # prime-k fallback: zero survivor rows + zero recovery
            # columns — GF-exact no-ops that make the pg gather even
            surv = np.concatenate(
                [surv, np.zeros((k_p - k, L), dtype=np.uint8)], axis=0
            )
        mk = self._mkey(ec_impl)
        step = self._cached(
            ("dec", mk, tuple(use), tuple(missing), L),
            lambda: self._build_reconstruct(
                ec_impl, mesh, use, missing, rows_ax, k_p
            ),
        )
        with _MESH_EXEC_LOCK:
            rebuilt = self._profiler().call_jitted(
                "mesh_reconstruct",
                ((pg, shard), mk, tuple(use), tuple(missing), L),
                step, (surv,), nbytes=k * L, shape=(k_p, L),
            )  # [len(missing), L]
        for i, r in enumerate(missing):
            out[r] = rebuilt[i]
        return out

    def _build_reconstruct(self, ec_impl, mesh, use, missing,
                           rows_ax, k_p):
        k, w = ec_impl.get_data_chunk_count(), ec_impl.w
        RM = _recovery_rows(
            np.asarray(ec_impl.matrix), k, w, list(use), list(missing)
        )
        if k_p != k:
            RM = np.concatenate(
                [RM, np.zeros((RM.shape[0], k_p - k), dtype=RM.dtype)],
                axis=1,
            )
        return functools.partial(
            gather_rebuild, mesh, rows_ax,
            lane_engines(RM, w, list(mesh.devices.flat)),
        )

    def decode_concat(self, sinfo, ec_impl, chunks) -> bytes:
        """Mesh twin of :func:`ceph_tpu_torch.osd.ec_util.decode_concat`."""
        k = ec_impl.get_data_chunk_count()
        decoded = self.decode(sinfo, ec_impl, chunks, want=list(range(k)))
        L = decoded[0].size
        S = L // sinfo.chunk_size
        stack = np.stack([decoded[i] for i in range(k)])
        arr = stack.reshape(k, S, sinfo.chunk_size).transpose(1, 0, 2)
        return np.ascontiguousarray(arr).tobytes()

    # -- the gather cost probe -----------------------------------------------
    def probe_gather(self, k: int, L: int) -> None:
        """Run the reconstruct's gather ALONE (no recovery matmul) at
        the given survivor geometry, reporting into the profiler as the
        ``mesh_gather`` engine — it splits the gather's cost out of the
        reconstruct number.  ``L`` must be mesh-slice aligned (a
        multiple of 4 * pg * shard covers every layout)."""
        mesh, pg, shard = self.mesh_for(k)
        rows_ax = "shard" if shard > 1 else "pg"
        rows_sz = shard if shard > 1 else pg
        cols_sz = pg if shard > 1 else shard
        if L % max(1, cols_sz) != 0:
            raise ValueError(
                f"gather probe length {L} not a multiple of {cols_sz}"
            )
        k_p = -(-k // rows_sz) * rows_sz
        surv = np.zeros((k_p, L), dtype=np.uint8)
        step = self._cached(
            ("gather", k_p, L),
            lambda: functools.partial(gather_rebuild, mesh, rows_ax, None),
        )
        with _MESH_EXEC_LOCK:
            self._profiler().call_jitted(
                "mesh_gather", ((pg, shard), k_p, L), step, (surv,),
                nbytes=k * L, shape=(k_p, L),
            )


# process-global engines keyed by slice size (None = every device) and
# device kind: one mesh + program cache shared by every in-process
# daemon on the same slice — the lanes are a host resource, and N
# daemons pinning the SAME osd_ec_mesh_devices must not each build
# their own tables
_ENGINES: dict[tuple, MeshEcEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_mesh_engine(n_devices: int | None = None,
                    device=None) -> MeshEcEngine:
    """Process-global engine for a device slice: daemons pinning the
    same ``osd_ec_mesh_devices`` on the same kind of device share one
    program cache; different slices get their own engine.  ``device``
    follows the module's device rule (None or a CUDA device: the cards;
    ``"cpu"``: CPU lanes)."""
    n = int(n_devices) if n_devices else None
    kind = "cpu" if (device is not None
                     and torch.device(device).type == "cpu") else "cuda"
    with _ENGINES_LOCK:
        eng = _ENGINES.get((n, kind))
        if eng is None:
            eng = _ENGINES[(n, kind)] = MeshEcEngine(
                n_devices=n, device="cpu" if kind == "cpu" else None)
        return eng
