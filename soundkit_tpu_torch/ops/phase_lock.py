"""Identity phase locking and resynthesis of the phase vocoder (K17):
every bin takes its nearest spectral peak's synthesis rotation
(Laroche & Dolson 1999), then the spectrum is rebuilt from the
magnitudes (counterpart of the peak test, ``lax.cummax`` /
``lax.cummin`` fills, gathers and ``mag * exp(1j * syn)`` of
``soundkit_tpu/ops/stretch.py::stretch_batch_device``).

:func:`phase_lock` takes ``mag``, ``phase`` and ``syn`` (the accumulated
synthesis phase) f32 [..., K] and returns the complex64 spectrum [...,
K]: per row, ``nearest`` (:func:`nearest_peak_plain`: a peak is ``mag[k]
>= mag[k-1]`` and ``mag[k] > mag[k+1]``, -inf past both ends; a tie
between the peaks before and after goes to the one before), then
``syn' = phase + (syn[nearest] - phase[nearest])`` and ``mag (cos syn' +
i sin syn')``.

For CUDA tensors it launches ``csrc/phase_lock.cu`` and counts
``phase_lock.launches``; with ``with_nearest`` it also returns the
kernel's ``nearest`` (int32). The kernel's ``nearest`` and ``syn'`` are
the plain version's; it rotates by ``syn'`` reduced by pi/2 in float64,
so its spectrum lies within ``2^-22 mag`` of float64 ``cos`` / ``sin`` of
``syn'`` but no longer has torch's float32 ``cos`` / ``sin`` bits. For
CPU tensors it takes :func:`phase_lock_plain`, the reference's ops in
torch.
"""
from __future__ import annotations

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

#: bins a row the kernel takes at most (``K_MAX`` of ``csrc/phase_lock.cu``)
K_MAX = 1280


def nearest_peak_plain(mag: torch.Tensor) -> torch.Tensor:
    """Index of the nearest local spectral maximum per bin [..., K],
    int32, as the reference finds it (forward max-fill, backward
    min-fill)."""
    K = mag.shape[-1]
    neg = torch.full_like(mag[..., :1], -torch.inf)
    lo = torch.cat([neg, mag[..., :-1]], -1)
    hi = torch.cat([mag[..., 1:], neg], -1)
    is_peak = (mag >= lo) & (mag > hi)
    kk = torch.arange(K, dtype=torch.int32, device=mag.device)
    big = 2 * K
    ffill = torch.cummax(torch.where(is_peak, kk, -1), dim=-1).values
    bfill = torch.flip(torch.cummin(torch.flip(torch.where(is_peak, kk, big), (-1,)),
                                    dim=-1).values, (-1,))
    dist_f = torch.where(ffill >= 0, kk - ffill, big)
    dist_b = torch.where(bfill < big, bfill - kk, big)
    return torch.clamp(torch.where(dist_f <= dist_b, ffill, bfill), 0, K - 1).to(torch.int32)


def phase_lock_plain(mag, phase, syn, with_nearest: bool = False):
    """:func:`phase_lock` in plain torch, op for op the reference's."""
    nearest = nearest_peak_plain(mag)
    idx = nearest.long()
    rot = torch.take_along_dim(syn, idx, -1) - torch.take_along_dim(phase, idx, -1)
    s = phase + rot
    spec = torch.complex(mag * torch.cos(s), mag * torch.sin(s))
    return (spec, nearest) if with_nearest else spec


def phase_lock(mag, phase, syn, with_nearest: bool = False):
    """K17 (see the module's docstring) -> complex64 [..., K] (and the
    int32 ``nearest`` with ``with_nearest``). On the card the three f32
    inputs share one shape and one CUDA device and are contiguous, with
    K <= K_MAX; anything else raises."""
    if mag.device.type == "cpu":
        return phase_lock_plain(mag, phase, syn, with_nearest)
    dev = check_cuda("phase_lock", mag, phase, syn)
    K = mag.shape[-1]
    if phase.shape != mag.shape or syn.shape != mag.shape or not 0 < K <= K_MAX:
        raise ValueError(f"phase_lock: mag{tuple(mag.shape)} phase{tuple(phase.shape)} "
                         f"syn{tuple(syn.shape)}; want one shape [..., K], K <= {K_MAX}")
    if any(t.dtype != torch.float32 for t in (mag, phase, syn)):
        raise TypeError("phase_lock: mag, phase and syn must be float32")
    spec = torch.empty(mag.shape, dtype=torch.complex64, device=dev)
    nearest = torch.empty(mag.shape, dtype=torch.int32, device=dev) if with_nearest else None
    rows = mag.numel() // K
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_phase_lock(
        mag.data_ptr(), phase.data_ptr(), syn.data_ptr(), spec.data_ptr(),
        nearest.data_ptr() if with_nearest else None, rows, K, stream)
    launch_check("phase_lock", rc)
    phase_lock.launches += 1
    return (spec, nearest) if with_nearest else spec


phase_lock.launches = 0
