"""The ``crush_straw2`` Hopper kernel's wrapper.

``csrc/crush_straw2.cu`` draws straw2 over a bucket row per lane,
exactly as ``bucket_straw2_choose`` does; it replaces the f32 draw of the
reference's CRUSH XLA programs (``straw2_choose_approx``,
``ceph_tpu/crush/mapper_jax.py:280``; ``_straw2_rows``,
``ceph_tpu/crush/mapper_jax_hier.py:189``).  It is built and loaded by
``gf_cuda``'s machinery (``nvcc`` into ``ceph_tpu_torch/build/`` at
first use, bound with ``ctypes``) and counts its launches in
``gf_cuda.launches["crush_straw2"]``.  The routing (CPU lanes -> the
plain version) lives in ``crush_torch``.
"""

from __future__ import annotations

import torch

from . import gf_cuda


def crush_straw2(T, x: torch.Tensor, rows: torch.Tensor, r: torch.Tensor):
    """straw2 over each lane's bucket row on the card: int32 lanes ``x``,
    ``rows``, ``r`` -> ``(item, child_row, child_type, empty)``, as
    ``crush_torch.straw2_plain`` returns them.  ``T`` is a
    ``crush_torch.BucketRows`` on the lanes' device."""
    lanes = x.shape[0] if isinstance(x, torch.Tensor) else 0
    for name, t in (("x", x), ("rows", rows), ("r", r)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("the CUDA kernels take CUDA tensors")
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != lanes:
            raise ValueError(f"{name}: expected int32 lanes [{lanes}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: lanes must be contiguous and on {x.device}")
    B, I = T.items.shape
    for t in T:
        want = torch.int64 if t is T.ln else torch.int32
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"bucket tables must be contiguous {want} on {x.device}")
    if B == 0 or I == 0 or T.ln.shape[0] != gf_cuda.LN_ENTRIES:
        raise ValueError("bucket tables need a row, a slot and the whole ln tables")
    out = torch.empty((3, lanes), dtype=torch.int32, device=x.device)
    empty = torch.empty(lanes, dtype=torch.bool, device=x.device)
    if lanes == 0:
        return out[0], out[1], out[2], empty
    launch = gf_cuda._lib("crush_straw2").crush_straw2_launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(), rows.data_ptr(), r.data_ptr(), T.items.data_ptr(),
            T.weights.data_ptr(), T.child_row.data_ptr(), T.child_type.data_ptr(),
            T.size.data_ptr(), T.ln.data_ptr(), B, I, lanes, out.data_ptr(),
            empty.data_ptr(), stream,
        )
    gf_cuda._launched("crush_straw2", rc)
    return out[0], out[1], out[2], empty
