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


def _precision_nodes() -> list:
    """The backends whose ``fp32_precision`` the guard sets, each before
    the children that setting it sets too (cuDNN before its convolutions
    and RNNs); empty on torch versions without that attribute."""
    cudnn = torch.backends.cudnn
    nodes = (torch.backends.cuda.matmul, cudnn, getattr(cudnn, "conv", None),
             getattr(cudnn, "rnn", None))
    if not all(n is not None and hasattr(n, "fp32_precision") for n in nodes):
        return []
    return list(nodes)


def _read(getter):
    """``getter()``, or None where torch refuses to read a flag (a state
    set through both its older and its newer precision API)."""
    try:
        return getter()
    except RuntimeError:
        return None


@contextlib.contextmanager
def ieee_fp32():
    """Float32 matrix products and cuDNN convolutions in IEEE float32
    inside the block, never TF32, whatever the caller set
    (``set_float32_matmul_precision``, ``allow_tf32``, and the
    ``fp32_precision`` attributes of the torch versions that have them);
    the caller's settings come back on exit, after an exception too. The
    reference pins float32 for the same products and convolutions
    (``jax.default_matmul_precision("float32")``, ``Precision.HIGHEST``).
    A flag torch refuses to read on entry (the caller mixed the two APIs)
    is restored through the ``fp32_precision`` attributes alone."""
    cudnn = torch.backends.cudnn
    precision = _read(torch.get_float32_matmul_precision)
    tf32 = _read(lambda: torch.backends.cuda.matmul.allow_tf32)
    conv_tf32 = _read(lambda: cudnn.allow_tf32)
    nodes = _precision_nodes()
    saved = [n.fp32_precision for n in nodes]
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    for n in nodes:
        n.fp32_precision = "ieee"
    try:
        yield
    finally:
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        if conv_tf32 is not None:
            cudnn.allow_tf32 = conv_tf32
        for n, v in zip(nodes, saved):
            n.fp32_precision = v
