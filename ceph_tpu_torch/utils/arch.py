"""Host compiler flags for the port's native engine.

Counterpart of ``host_march_flags`` in ``ceph_tpu/utils/arch.py``: the
host-side native build asks here instead of hardcoding ``-march=native``
(mirrors the reference's per-arch compile-unit split,
reference:src/erasure-code/jerasure/CMakeLists.txt).  The device probe
of that module is ``ceph_tpu_torch.device``.
"""

from __future__ import annotations

import functools
import subprocess


@functools.lru_cache(maxsize=None)
def host_march_flags() -> tuple[str, ...]:
    """Compiler flags for the native engine; falls back past
    unsupported -march values (old cross toolchains)."""
    for flags in (("-march=native",), ("-mcpu=native",), ()):
        try:
            r = subprocess.run(
                ["g++", *flags, "-E", "-x", "c++", "-", "-o", "/dev/null"],
                input="", capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            return flags
    return ()


@functools.lru_cache(maxsize=None)
def host_target() -> str:
    """What ``g++`` with :func:`host_march_flags` compiles for on this
    host (its resolved ``-march`` and instruction-set switches).  A build
    keyed on this is never loaded on a host whose CPU lacks what it was
    compiled with, as a build keyed on the flags alone could be (the
    same ``-march=native`` means another CPU on another machine)."""
    try:
        r = subprocess.run(
            ["g++", *host_march_flags(), "-Q", "--help=target"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout
