"""Device selection for the port (counterpart of ``soundkit_tpu/utils/backend.py``).

Entry points run on the card unless the caller names the CPU. A CUDA
device that is not there raises: nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(name) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cpu' or 'cuda'")
    return dev


def tensor_device(name) -> torch.device:
    """``name`` as the device of a new tensor: a CUDA device must be
    there (as :func:`resolve_device` checks); others pass through."""
    dev = torch.device(name)
    return resolve_device(dev) if dev.type == "cuda" else dev


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Device of ``tensors`` for a kernel launch; raises unless they
    are all contiguous and on one CUDA device."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: non-contiguous input")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel needs a CUDA device")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    return dev


def launch_check(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` from a kernel's C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


@contextlib.contextmanager
def ieee_fp32():
    """Float32 matrix products in IEEE float32 inside the block, never
    TF32, whatever the caller set (``allow_tf32``,
    ``set_float32_matmul_precision``); the caller's settings come back
    on exit. The reference pins float32 for the same products
    (``jax.default_matmul_precision("float32")``)."""
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32
