"""Windowed-sinc polyphase resampler (counterpart of
``soundkit_tpu/ops/resample.py``).

The host half is the JAX package's, verbatim: the rubato-equivalent
polyphase bank (``design_polyphase``: sinc_len 256, f_cutoff 0.95,
squared Blackman-Harris), the length contract ``out_len`` (after T input
frames, ``ceil(T L / M)`` outputs), the numpy one-shot ``resample_np``
and the conv embedding ``_conv_kernel``.

The device half is :func:`resample` (one-shot, ``[B, n]`` ->
``[B, ceil(n L / M)]``) and :func:`resample_stateful` (chunked, with a
carried ``[B, 255]`` input history; ``n L % M == 0``), both over the
polyphase FIR

    y[b, c L + p] = sum_{q < 256} taps_rev[p, q] * xpad[b, c M + off[p] + q]

with ``xpad`` the input after 255 samples of history (zeros for the
one-shot form) and zeros past its end. For CUDA tensors
:func:`polyphase_fir` launches K15, ``csrc/resample.cu``, and counts
``polyphase_fir.launches``; every output sums its 256 taps in the order
``q = 0 .. 255`` with fused multiply-adds, so an output's bits depend only
on its 256 inputs, and chunked equals one-shot bit for bit. For CPU
tensors :func:`polyphase_fir_plain` is the reference's lowering: one
``conv1d`` of stride M with L output channels over the bank embedded in
``[L, 1, 256 + M - 1]``, in IEEE float32 (``utils.device.ieee_fp32``: the
reference convolves at ``Precision.HIGHEST``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, ieee_fp32, launch_check, tensor_device

SINC_LEN = 256
CUTOFF = 0.95


def _blackman_harris2(x: np.ndarray) -> np.ndarray:
    """Squared 4-term Blackman-Harris over x in [0, 1] (rubato BlackmanHarris2)."""
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    w = (
        a0
        - a1 * np.cos(2 * np.pi * x)
        + a2 * np.cos(4 * np.pi * x)
        - a3 * np.cos(6 * np.pi * x)
    )
    return w * w


@functools.lru_cache(maxsize=64)
def design_polyphase(
    in_rate: int, out_rate: int, sinc_len: int = SINC_LEN, cutoff: float = CUTOFF
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Design the polyphase bank for in_rate -> out_rate.

    Returns ``(taps_rev, offsets, L, M)`` where ``taps_rev[p, q]`` are
    the phase-p taps ordered for correlation (y[c*L+p] =
    sum_q taps_rev[p, q] * xpad[c*M + offsets[p] + q]) over input
    padded on the left with ``sinc_len - 1`` zeros, and ``offsets[p] =
    floor(p*M/L)``.
    """
    g = math.gcd(in_rate, out_rate)
    L, M = out_rate // g, in_rate // g
    S = sinc_len
    K = S * L

    j = np.arange(K, dtype=np.float64)
    t = (j - K / 2) / L  # tap position in input-sample units
    c = cutoff * min(1.0, L / M)  # anti-alias cutoff rel. input Nyquist
    proto = c * np.sinc(c * t) * _blackman_harris2(j / K)

    taps_rev = np.zeros((L, S), dtype=np.float64)
    offsets = np.zeros(L, dtype=np.int64)
    for p in range(L):
        r = (p * M) % L
        offsets[p] = (p * M) // L
        # y[k] = sum_q proto[r + L*q] * x[i0 - q]  (see derivation in ops notes)
        phase = proto[r::L][:S]
        taps_rev[p] = phase[::-1]
        s = taps_rev[p].sum()
        if abs(s) > 1e-12:
            taps_rev[p] /= s  # exact unity DC gain per phase

    return taps_rev.astype(np.float32), offsets, L, M


def out_len(total_in: int, L: int, M: int) -> int:
    """ceil(total_in * L / M): outputs producible after total_in frames."""
    return (total_in * L + M - 1) // M


def resample_np(x: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """One-shot host resample. x: [channels, n] f32 -> [channels, n_out]."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    if in_rate == out_rate:
        return x.copy()
    taps_rev, offsets, L, M = design_polyphase(in_rate, out_rate)
    S = taps_rev.shape[1]
    n = x.shape[1]
    n_out = out_len(n, L, M)
    n_cycles = (n_out + L - 1) // L

    # left pad S-1 (history), right pad so every window is in bounds
    need = (n_cycles - 1) * M + int(offsets.max()) + S
    right = max(0, need - (n - 1) - (S - 1) - 1)
    xp = np.pad(x, ((0, 0), (S - 1, right)))

    wins = np.lib.stride_tricks.sliding_window_view(xp, S, axis=1)  # [C, P, S]
    out = np.empty((x.shape[0], n_cycles, L), dtype=np.float32)
    for p in range(L):
        sel = wins[:, int(offsets[p]) :: 1, :][:, : n_cycles * M : M, :]
        out[:, :, p] = np.einsum("cns,s->cn", sel[:, :n_cycles], taps_rev[p])
    return out.reshape(x.shape[0], n_cycles * L)[:, :n_out]


# ---------------------------------------------------------------------------
# device path: one strided conv with L output channels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _conv_kernel(in_rate: int, out_rate: int) -> Tuple[np.ndarray, int, int, int]:
    """Embed the polyphase bank into a [L, 1, S + M - 1] conv kernel."""
    taps_rev, offsets, L, M = design_polyphase(in_rate, out_rate)
    S = taps_rev.shape[1]
    Kc = S + M - 1
    kern = np.zeros((L, 1, Kc), dtype=np.float32)
    for p in range(L):
        o = int(offsets[p])
        kern[p, 0, o : o + S] = taps_rev[p]
    return kern, L, M, Kc


#: K15's launch shape (``csrc/resample.cu``): cycles a thread sums, outputs a
#: block aims at, and the floats of input a block may stage (48 KB)
CYCLES_PER_THREAD = 4
TILE_OUTPUTS = 2048
TILE_FLOATS = 12288


@functools.lru_cache(maxsize=64)
def _kernel_bank(in_rate: int, out_rate: int, device: torch.device):
    """K15's bank on ``device``: the taps transposed to [SINC_LEN, L]
    (phase-minor, so that neighbouring threads read neighbouring taps) and
    the phase offsets as int32 [L]."""
    taps_rev, offsets, _, _ = design_polyphase(in_rate, out_rate)
    return (torch.from_numpy(np.ascontiguousarray(taps_rev.T)).to(device),
            torch.from_numpy(offsets.astype(np.int32)).to(device))


@functools.lru_cache(maxsize=64)
def _conv_weight(in_rate: int, out_rate: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_conv_kernel(in_rate, out_rate)[0]).to(device)


def tile_cycles(L: int, M: int, n_cycles: int) -> int:
    """Cycles (of L outputs and M inputs) a K15 block takes: about
    TILE_OUTPUTS outputs, at most TILE_FLOATS staged inputs, a multiple of
    CYCLES_PER_THREAD, spread evenly over the blocks of a row."""
    R = CYCLES_PER_THREAD
    want = -(-TILE_OUTPUTS // L)
    cap = max(R, (TILE_FLOATS - SINC_LEN + 1) // M // R * R)
    ct = max(R, min(-(-want // R) * R, cap))
    n_cycles = max(n_cycles, 1)
    tiles = -(-n_cycles // ct)
    per = -(-n_cycles // tiles)
    return -(-per // R) * R


def conv_input(x, hist: Optional[torch.Tensor], in_rate: int, out_rate: int,
               n_out: int) -> torch.Tensor:
    """The reference's convolution input for ``n_out`` outputs: ``hist ++
    x`` (zeros for ``hist=None``), padded on the right so that every
    window is in bounds, as [B, 1, N]."""
    _, L, M, Kc = _conv_kernel(in_rate, out_rate)
    n_cycles = (n_out + L - 1) // L
    if hist is None:
        hist = torch.zeros((x.shape[0], SINC_LEN - 1), dtype=x.dtype, device=x.device)
    xa = torch.cat([hist, x], dim=1)
    need = (n_cycles - 1) * M + Kc
    return F.pad(xa, (0, max(0, need - xa.shape[1])))[:, None, :]


def polyphase_fir_plain(x, hist: Optional[torch.Tensor], in_rate: int, out_rate: int,
                        n_out: int) -> torch.Tensor:
    """The polyphase FIR (see the module's docstring) as the reference
    lowers it: one ``conv1d`` of stride M over :func:`conv_input` with the
    ``[L, 1, S + M - 1]`` bank in IEEE float32, the cycles interleaved ->
    [B, n_out]."""
    _, L, M, _ = _conv_kernel(in_rate, out_rate)
    n_cycles = (n_out + L - 1) // L
    with ieee_fp32():
        out = F.conv1d(conv_input(x, hist, in_rate, out_rate, n_out),
                       _conv_weight(in_rate, out_rate, x.device), stride=M)
    out = out[:, :, :n_cycles]
    return out.transpose(1, 2).reshape(x.shape[0], n_cycles * L)[:, :n_out]


def polyphase_fir(x, hist: Optional[torch.Tensor], in_rate: int, out_rate: int,
                  n_out: int) -> torch.Tensor:
    """K15: the polyphase FIR (see the module's docstring) -> [B, n_out]
    f32. ``x`` f32 [B, n] and ``hist`` f32 [B, 255] (or None: zeros) on
    one CUDA device, contiguous; anything else raises."""
    if x.device.type == "cpu":
        return polyphase_fir_plain(x, hist, in_rate, out_rate, n_out)
    hists = () if hist is None else (hist,)
    dev = check_cuda("polyphase_fir", x, *hists)
    B, n = x.shape
    if hist is not None and hist.shape != (B, SINC_LEN - 1):
        raise ValueError(f"polyphase_fir: hist{tuple(hist.shape)}, want [{B}, {SINC_LEN - 1}]")
    if any(t.dtype != torch.float32 for t in (x, *hists)):
        raise TypeError("polyphase_fir: x and hist must be float32")
    taps_t, offsets = _kernel_bank(in_rate, out_rate, dev)
    L = taps_t.shape[1]
    M = in_rate // math.gcd(in_rate, out_rate)
    ct = tile_cycles(L, M, (n_out + L - 1) // L)
    out = torch.empty((B, n_out), dtype=torch.float32, device=dev)
    if B == 0 or n_out == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_resample(
        x.data_ptr(), hist.data_ptr() if hist is not None else None, taps_t.data_ptr(),
        offsets.data_ptr(), out.data_ptr(), B, n, L, M, n_out, ct, stream)
    launch_check("polyphase_fir", rc)
    polyphase_fir.launches += 1
    return out


polyphase_fir.launches = 0


def resample(x, in_rate: int, out_rate: int):
    """Batched device resample. x: [streams, n] f32 -> [streams, n_out]
    with ``n_out = ceil(n L / M)`` (K15 on the card, the conv on the CPU)."""
    if in_rate == out_rate:
        return x
    _, _, L, M = design_polyphase(in_rate, out_rate)
    return polyphase_fir(x, None, in_rate, out_rate, out_len(x.shape[-1], L, M))


def resample_stateful(x, hist, in_rate: int, out_rate: int):
    """Carried-state chunked resample: ``x`` [B, n] f32 chunk, ``hist``
    [B, SINC_LEN-1] carried input history (zeros for the first chunk).
    Requires ``n * L % M == 0``; then the chunks' outputs, concatenated,
    equal the one-shot :func:`resample` of the concatenated input.

    Returns (out [B, n*L//M], new_hist [B, SINC_LEN-1])."""
    if in_rate == out_rate:
        return x, hist
    _, _, L, M = design_polyphase(in_rate, out_rate)
    S = SINC_LEN
    n = x.shape[-1]
    if (n * L) % M != 0:
        raise ValueError(f"chunk length {n} must satisfy n*{L} % {M} == 0")
    out = polyphase_fir(x, hist, in_rate, out_rate, n * L // M)
    new_hist = x[:, n - (S - 1):] if n >= S - 1 else torch.cat([hist, x], dim=1)[:, -(S - 1):]
    return out, new_hist.contiguous()


def resample_init_state(B: int, device="cuda") -> torch.Tensor:
    """Zero input history [B, SINC_LEN-1] f32 on ``device`` (the
    reference returns numpy zeros; here a tensor where the chunks live)."""
    return torch.zeros((B, SINC_LEN - 1), dtype=torch.float32, device=tensor_device(device))
