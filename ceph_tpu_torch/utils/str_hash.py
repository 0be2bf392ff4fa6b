"""Object-name string hashes (reference:src/common/ceph_hash.cc).

The port's own copy of ``ceph_tpu/utils/str_hash.py``.

``ceph_str_hash_rjenkins`` maps an object name to its placement seed (ps)
— the first step of client addressing (reference:src/osd/OSDMap.cc:1506
via pg_pool_t::hash_key).  Bit-identical to the reference so object→PG
assignments match a real cluster given the same map.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF

CEPH_STR_HASH_LINUX = 0x1
CEPH_STR_HASH_RJENKINS = 0x2


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
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


def ceph_str_hash_rjenkins(data: bytes | str) -> int:
    """reference:ceph_hash.cc:21 (Jenkins 96-bit mix over 12-byte blocks)."""
    if isinstance(data, str):
        data = data.encode()
    k = data
    length = len(k)
    a = 0x9E3779B9
    b = a
    c = 0
    i = 0
    ln = length
    while ln >= 12:
        a = (a + (k[i] | (k[i + 1] << 8) | (k[i + 2] << 16) | (k[i + 3] << 24))) & _M32
        b = (b + (k[i + 4] | (k[i + 5] << 8) | (k[i + 6] << 16) | (k[i + 7] << 24))) & _M32
        c = (c + (k[i + 8] | (k[i + 9] << 8) | (k[i + 10] << 16) | (k[i + 11] << 24))) & _M32
        a, b, c = _mix(a, b, c)
        i += 12
        ln -= 12
    c = (c + length) & _M32
    if ln >= 11:
        c = (c + (k[i + 10] << 24)) & _M32
    if ln >= 10:
        c = (c + (k[i + 9] << 16)) & _M32
    if ln >= 9:
        c = (c + (k[i + 8] << 8)) & _M32
    if ln >= 8:
        b = (b + (k[i + 7] << 24)) & _M32
    if ln >= 7:
        b = (b + (k[i + 6] << 16)) & _M32
    if ln >= 6:
        b = (b + (k[i + 5] << 8)) & _M32
    if ln >= 5:
        b = (b + k[i + 4]) & _M32
    if ln >= 4:
        a = (a + (k[i + 3] << 24)) & _M32
    if ln >= 3:
        a = (a + (k[i + 2] << 16)) & _M32
    if ln >= 2:
        a = (a + (k[i + 1] << 8)) & _M32
    if ln >= 1:
        a = (a + k[i]) & _M32
    a, b, c = _mix(a, b, c)
    return c


def ceph_str_hash_linux(data: bytes | str) -> int:
    """Linux dcache hash (reference:ceph_hash.cc:84)."""
    if isinstance(data, str):
        data = data.encode()
    h = 0
    for ch in data:
        h = ((h + (ch << 4) + (ch >> 4)) * 11) & _M32
    return h


def ceph_str_hash(type: int, data: bytes | str) -> int:
    if type == CEPH_STR_HASH_LINUX:
        return ceph_str_hash_linux(data)
    if type == CEPH_STR_HASH_RJENKINS:
        return ceph_str_hash_rjenkins(data)
    raise ValueError(f"unknown str hash type {type}")
