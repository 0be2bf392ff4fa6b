"""Device probe: the port runs on the card unless the caller asks for
the CPU.

Counterpart of the ``jax.devices()`` probe in ``ceph_tpu/utils/arch.py``.
There, a failed probe quietly leaves a host-only mode; here it raises,
so that no entry point lands on the CPU unless asked to with
``device="cpu"``.
"""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device (by default CUDA) is not present."""


def default_device() -> torch.device:
    """The current CUDA device; raises when CUDA is absent."""
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> :func:`default_device`; ``"cpu"`` or ``"cuda[:n]"`` ->
    that device, checked to exist."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
