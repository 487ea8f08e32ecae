"""Device selection for the port (counterpart of ``soundkit_tpu/utils/backend.py``).

The caller names the device. A CUDA device that is not there raises:
nothing falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cpu' or 'cuda'")
    return dev


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Device of ``tensors`` for a kernel launch; raises unless they
    are all contiguous and on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel needs a CUDA device")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    return dev


def launch_check(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` from a kernel's C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
