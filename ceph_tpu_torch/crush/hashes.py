"""CRUSH's rjenkins1 32-bit integer hash, backend-generic.

The port's own copy of ``ceph_tpu/crush/hashes.py``.  Robert Jenkins'
96-bit mix (burtleburtle.net/bob/hash/evahash.html) as used by CRUSH
(reference:src/crush/hash.c:12-90).  Deterministic integer math only —
adds, xors, shifts on uint32 — so one schedule serves three backends:

- plain Python ints (masked to 32 bits) for the scalar oracle mapper;
- numpy uint32 arrays (wraparound arithmetic) for host bulk work;
- torch tensors for the batched placement path.  torch has no ``>>``,
  ``<<`` or ``-`` for uint32, so tensor operands are carried as int64
  holding the 32-bit value, masked after each step that can leave
  [0, 2^32); the result is an int64 tensor in [0, 2^32).

The reference's copy picks its array module by the array's module name
and hands anything that is not jax to numpy, a tensor included; here a
tensor always takes the torch branch and never reaches numpy.

The arity-N entry points mix operands in the exact (a,b,…,x,y) schedule of
the reference so outputs are bit-identical (reference:hash.c:26-90).
"""

from __future__ import annotations

CRUSH_HASH_RJENKINS1 = 0
CRUSH_HASH_SEED = 1315423911

_M32 = 0xFFFFFFFF


def _mix_int(a: int, b: int, c: int) -> tuple[int, int, int]:
    """One crush_hashmix round on Python ints (reference:hash.c:12)."""
    a = (a - b - c) & _M32; a ^= c >> 13
    b = (b - c - a) & _M32; b ^= (a << 8) & _M32
    c = (c - a - b) & _M32; c ^= b >> 13
    a = (a - b - c) & _M32; a ^= c >> 12
    b = (b - c - a) & _M32; b ^= (a << 16) & _M32
    c = (c - a - b) & _M32; c ^= b >> 5
    a = (a - b - c) & _M32; a ^= c >> 3
    b = (b - c - a) & _M32; b ^= (a << 10) & _M32
    c = (c - a - b) & _M32; c ^= b >> 15
    return a, b, c


def _mix_arr(a, b, c):
    """One crush_hashmix round on numpy uint32 arrays: unsigned dtypes
    wrap on subtraction and shift, matching C uint32 semantics."""
    a = (a - b - c) ^ (c >> 13)
    b = (b - c - a) ^ (a << 8)
    c = (c - a - b) ^ (b >> 13)
    a = (a - b - c) ^ (c >> 12)
    b = (b - c - a) ^ (a << 16)
    c = (c - a - b) ^ (b >> 5)
    a = (a - b - c) ^ (c >> 3)
    b = (b - c - a) ^ (a << 10)
    c = (c - a - b) ^ (b >> 15)
    return a, b, c


def _mix_tensor(a, b, c):
    """One crush_hashmix round on int64 tensors holding uint32 values:
    each difference is masked back into [0, 2^32) before it is shifted
    right, each left shift after it is XORed in."""
    a = ((a - b - c) & _M32) ^ (c >> 13)
    b = ((b - c - a) ^ (a << 8)) & _M32
    c = ((c - a - b) & _M32) ^ (b >> 13)
    a = ((a - b - c) & _M32) ^ (c >> 12)
    b = ((b - c - a) ^ (a << 16)) & _M32
    c = ((c - a - b) & _M32) ^ (b >> 5)
    a = ((a - b - c) & _M32) ^ (c >> 3)
    b = ((b - c - a) ^ (a << 10)) & _M32
    c = ((c - a - b) & _M32) ^ (b >> 15)
    return a, b, c


def _is_plain_int(*vals) -> bool:
    return all(isinstance(v, int) for v in vals)


def crush_hash32(a):
    """1-arg rjenkins1 (reference:hash.c:26)."""
    if _is_plain_int(a):
        h = (CRUSH_HASH_SEED ^ a) & _M32
        b, x, y = a, 231232, 1232
        b, x, h = _mix_int(b, x, h)
        y, a, h = _mix_int(y, a, h)
        return h
    return _hash_arr_n((a,), [("b", "x"), ("y", "a")],
                       {"a": a, "b": a})


def crush_hash32_2(a, b):
    """2-arg rjenkins1 (reference:hash.c:37)."""
    if _is_plain_int(a, b):
        h = (CRUSH_HASH_SEED ^ a ^ b) & _M32
        x, y = 231232, 1232
        a, b, h = _mix_int(a, b, h)
        x, a, h = _mix_int(x, a, h)
        b, y, h = _mix_int(b, y, h)
        return h
    return _hash_arr_n((a, b), [("a", "b"), ("x", "a"), ("b", "y")],
                       {"a": a, "b": b})


def crush_hash32_3(a, b, c):
    """3-arg rjenkins1 (reference:hash.c:48) — the mapper's workhorse."""
    if _is_plain_int(a, b, c):
        h = (CRUSH_HASH_SEED ^ a ^ b ^ c) & _M32
        x, y = 231232, 1232
        a, b, h = _mix_int(a, b, h)
        c, x, h = _mix_int(c, x, h)
        y, a, h = _mix_int(y, a, h)
        b, x, h = _mix_int(b, x, h)
        y, c, h = _mix_int(y, c, h)
        return h
    return _hash_arr_n(
        (a, b, c),
        [("a", "b"), ("c", "x"), ("y", "a"), ("b", "x"), ("y", "c")],
        {"a": a, "b": b, "c": c})


def crush_hash32_4(a, b, c, d):
    """4-arg rjenkins1 (reference:hash.c:61)."""
    if _is_plain_int(a, b, c, d):
        h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d) & _M32
        x, y = 231232, 1232
        a, b, h = _mix_int(a, b, h)
        c, d, h = _mix_int(c, d, h)
        a, x, h = _mix_int(a, x, h)
        y, b, h = _mix_int(y, b, h)
        c, x, h = _mix_int(c, x, h)
        y, d, h = _mix_int(y, d, h)
        return h
    return _hash_arr_n(
        (a, b, c, d),
        [("a", "b"), ("c", "d"), ("a", "x"), ("y", "b"), ("c", "x"),
         ("y", "d")],
        {"a": a, "b": b, "c": c, "d": d})


def crush_hash32_5(a, b, c, d, e):
    """5-arg rjenkins1 (reference:hash.c:75)."""
    if _is_plain_int(a, b, c, d, e):
        h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e) & _M32
        x, y = 231232, 1232
        a, b, h = _mix_int(a, b, h)
        c, d, h = _mix_int(c, d, h)
        e, x, h = _mix_int(e, x, h)
        y, a, h = _mix_int(y, a, h)
        b, x, h = _mix_int(b, x, h)
        y, c, h = _mix_int(y, c, h)
        d, x, h = _mix_int(d, x, h)
        y, e, h = _mix_int(y, e, h)
        return h
    return _hash_arr_n(
        (a, b, c, d, e),
        [("a", "b"), ("c", "d"), ("e", "x"), ("y", "a"), ("b", "x"),
         ("y", "c"), ("d", "x"), ("y", "e")],
        {"a": a, "b": b, "c": c, "d": d, "e": e})


def _hash_arr_n(operands, schedule, named):
    """Array-backend hash: named operand registers + x/y constants.

    numpy arrays wrap as uint32; torch tensors are carried as int64
    (see the module docstring).  Scalars broadcast against whatever
    array operand is present.
    """
    sample = next(v for v in operands if hasattr(v, "dtype"))
    if _is_tensor(sample):
        import torch

        def cast(v):
            if _is_tensor(v):
                return v.to(torch.int64) & _M32
            return torch.tensor(v & _M32, dtype=torch.int64, device=sample.device)

        mix = _mix_tensor
    else:
        import numpy as np

        def cast(v):
            if hasattr(v, "dtype"):
                return v.astype(np.uint32)
            return np.asarray(v & _M32, dtype=np.uint32)

        mix = _mix_arr

    reg = {k: cast(v) for k, v in named.items()}
    reg["x"] = cast(231232)
    reg["y"] = cast(1232)
    h = cast(CRUSH_HASH_SEED)
    for v in operands:
        h = h ^ cast(v)
    for lhs, rhs in schedule:
        a, b, h = mix(reg[lhs], reg[rhs], h)
        reg[lhs], reg[rhs] = a, b
    return h


def _is_tensor(v) -> bool:
    """A torch tensor, recognised without importing torch."""
    return type(v).__module__.startswith("torch")
