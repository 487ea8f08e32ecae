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
from typing import NamedTuple, Optional, Tuple

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


#: K15's tiling (``csrc/resample.cu``): phases a group (a thread's outputs of
#: one super-cycle), warps a block at most and (where a row has them) at
#: least, the shared memory under which RC is chosen (two blocks an SM), and
#: the most a block may take (the card's 227 KB)
GROUP_PHASES = 8
MAX_WARPS = 16
MIN_WARPS = 4
SMEM_TARGET = 113 * 1024
SMEM_LIMIT = 227 * 1024
#: shared memory under which a block takes more slabs: smaller blocks, more
#: of them an SM, overlap one block's staging with another's sums
SLAB_SMEM = 48 * 1024
#: super-cycles a thread sums (the kernel's instances)
CYCLES_PER_THREAD = (8, 4, 2, 1)


def max_warps(rc: int) -> int:
    """Warps a K15 block may have at ``rc`` super-cycles a thread (its 64
    accumulators at rc = 8 take up to 255 registers: 8 warps)."""
    return MAX_WARPS // 2 if rc == 8 else MAX_WARPS


def super_cycle(L: int) -> int:
    """Cycles K15 takes as one super-cycle: enough that a group of
    GROUP_PHASES phases fills (8 / gcd(L, 8) under 16 phases, else 1)."""
    return 1 if L >= 16 else GROUP_PHASES // math.gcd(L, GROUP_PHASES)


@functools.lru_cache(maxsize=64)
def band_bank(in_rate: int, out_rate: int):
    """K15's banded bank for in_rate -> out_rate.

    Super-cycle ``g`` (:func:`super_cycle`) gives ``Lq = g L`` phases and
    ``Mq = g M`` inputs, super-phase ``r L + p`` at offset ``r M + off[p]``
    with phase p's taps. Group ``k`` holds super-phases ``8k .. 8k + 7``
    (past ``Lq``: zero columns), from ``base[k] = off'[8k]``:

        W[k, j, i] = taps_rev[p_i, j - d_i] for 0 <= j - d_i < 256, else 0,

    ``d_i = off'[8k + i] - base[k]``, j < ``band[k] = d_last + 256``, so
    that output ``c Lq + 8k + i`` is ``sum_j W[k, j, i] xpad[c Mq + base[k]
    + j]``, its 256 taps in the order q = 0 .. 255 between zero products.

    Returns ``(W f32 [G, band_max, 8], meta int32 [G, 2] (base, band), g,
    Lq, Mq, offp int64 [Lq])``."""
    taps_rev, offsets, L, M = design_polyphase(in_rate, out_rate)
    S = taps_rev.shape[1]
    g = super_cycle(L)
    Lq, Mq = g * L, g * M
    offp = (np.arange(g)[:, None] * M + offsets[None, :]).reshape(-1)
    P = GROUP_PHASES
    G = -(-Lq // P)
    meta = np.zeros((G, 2), dtype=np.int32)
    for k in range(G):
        last = min(P * k + P, Lq) - 1
        meta[k] = offp[P * k], offp[last] - offp[P * k] + S
    band_max = int(meta[:, 1].max())
    W = np.zeros((G, band_max, P), dtype=np.float32)
    for sp in range(Lq):
        k, i = divmod(sp, P)
        d = int(offp[sp] - meta[k, 0])
        W[k, d:d + S, i] = taps_rev[sp % L]
    return W, meta, g, Lq, Mq, offp


class K15Plan(NamedTuple):
    """K15's launch for one call: the super-cycle (``Lq`` outputs from
    ``Mq`` inputs), ``pitch`` (the shared words a super-cycle takes,
    :func:`k15_pitch`), ``G`` groups in ``chunks`` of
    ``GB`` a block, ``S`` slabs of ``32 RC`` super-cycles a block (``ct``
    super-cycles a tile), ``RC`` super-cycles a thread, ``tiles`` a row,
    ``threads`` and ``smem`` bytes a block, and ``WS`` 1 where the block
    stages its groups' bank rows in shared memory after its tile."""
    Lq: int
    Mq: int
    pitch: int
    G: int
    band_max: int
    GB: int
    chunks: int
    S: int
    RC: int
    ct: int
    tiles: int
    threads: int
    smem: int
    WS: int


def k15_pitch(Mq: int) -> int:
    """Shared words K15 gives a super-cycle of ``Mq`` inputs: ``Mq`` made
    odd, so that its 32 lanes, a super-cycle apart, read 32 banks."""
    return Mq | 1


def _tile_smem(meta: np.ndarray, Mq: int, pitch: int, GB: int, ct: int) -> int:
    """Shared bytes of a block of ``ct`` super-cycles and ``GB`` groups: the
    input span (in the pitched layout) or the output tile, the larger."""
    G = meta.shape[0]
    reach = max(int(meta[min(k + GB, G) - 1].sum()) - int(meta[k, 0]) for k in range(0, G, GB))
    span = (ct - 1) * Mq + reach
    span_words = span + (span // Mq + 1) * (pitch - Mq)
    return 4 * (-(-max(span_words, ct * (GB * GROUP_PHASES + 4)) // 4) * 4)


def k15_plan(in_rate: int, out_rate: int, n_out: int, rc: Optional[int] = None,
             slabs: Optional[int] = None, ws: Optional[int] = None) -> K15Plan:
    """K15's launch for ``n_out`` outputs a row: every group of a chunk in
    one block (at most MAX_WARPS groups a chunk), ``RC`` the most
    super-cycles a thread that a row fills and whose block of MIN_WARPS
    warps (or one slab) SMEM_TARGET holds (or ``rc``), then as many slabs
    as the row needs, :func:`max_warps` allows and SLAB_SMEM holds (or
    ``slabs``), the tiles of a row even; the chunk's bank rows go to
    shared memory after the tile where the two fit a block (or as ``ws``
    says)."""
    W, meta, _, Lq, Mq, _ = band_bank(in_rate, out_rate)
    G, band_max = meta.shape[0], W.shape[1]
    pitch = k15_pitch(Mq)
    chunks = -(-G // MAX_WARPS)
    GB = -(-G // chunks)
    ncp = max(1, -(-n_out // Lq))
    if rc is None:
        rc = next((r for r in CYCLES_PER_THREAD if 32 * r <= ncp and GB <= max_warps(r)
                   and _tile_smem(meta, Mq, pitch, GB, 32 * r * min(
                       max(1, MIN_WARPS // GB), -(-ncp // (32 * r)))) <= SMEM_TARGET), 1)
    if rc not in CYCLES_PER_THREAD:
        raise ValueError(f"k15_plan: rc {rc} not in {CYCLES_PER_THREAD}")
    wbytes = GB * band_max * GROUP_PHASES * 4
    if ws is None:
        ws = int(_tile_smem(meta, Mq, pitch, GB, 32 * rc) + wbytes <= SMEM_LIMIT)
    if slabs is None:
        slabs = max(1, min(max_warps(rc) // GB, -(-ncp // (32 * rc))))
        while slabs > 1 and (_tile_smem(meta, Mq, pitch, GB, slabs * 32 * rc) + ws * wbytes
                             > SLAB_SMEM):
            slabs -= 1
        tiles = -(-ncp // (slabs * 32 * rc))
        slabs = -(-ncp // (tiles * 32 * rc))
    ct = slabs * 32 * rc
    smem = _tile_smem(meta, Mq, pitch, GB, ct) + ws * wbytes
    if slabs * GB > max_warps(rc) or smem > SMEM_LIMIT:
        raise ValueError(f"k15_plan: {slabs} slabs x {GB} groups, {smem} shared bytes")
    return K15Plan(Lq, Mq, pitch, G, band_max, GB, chunks, slabs, rc, ct, -(-ncp // ct),
                   32 * slabs * GB, smem, ws)


@functools.lru_cache(maxsize=64)
def _kernel_bank(in_rate: int, out_rate: int, device: torch.device):
    """K15's banded bank (:func:`band_bank`) on ``device``: W f32 [G,
    band_max, 8] and the groups' (base, band) int32 [G, 2]."""
    W, meta = band_bank(in_rate, out_rate)[:2]
    return torch.from_numpy(W).to(device), torch.from_numpy(meta).to(device)


@functools.lru_cache(maxsize=64)
def _conv_weight(in_rate: int, out_rate: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_conv_kernel(in_rate, out_rate)[0]).to(device)


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


def launch_k15(x, hist: Optional[torch.Tensor], in_rate: int, out_rate: int, n_out: int,
               plan: K15Plan) -> torch.Tensor:
    """K15 on checked CUDA tensors with the launch ``plan`` (any plan that
    :func:`k15_plan` can give, for these rates) -> [B, n_out] f32; counts
    nothing (:func:`polyphase_fir` counts its launches)."""
    B, n = x.shape
    bank, meta = _kernel_bank(in_rate, out_rate, x.device)
    out = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    if B == 0 or n_out == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.kernels().skt_resample(
        x.data_ptr(), hist.data_ptr() if hist is not None else None, bank.data_ptr(),
        meta.data_ptr(), out.data_ptr(), B, n, plan.Lq, plan.Mq, plan.pitch, n_out, plan.G,
        plan.band_max, plan.GB, plan.S, plan.RC, plan.smem, plan.WS, stream)
    launch_check("polyphase_fir", rc)
    return out


def polyphase_fir(x, hist: Optional[torch.Tensor], in_rate: int, out_rate: int,
                  n_out: int) -> torch.Tensor:
    """K15: the polyphase FIR (see the module's docstring) -> [B, n_out]
    f32. ``x`` f32 [B, n] and ``hist`` f32 [B, 255] (or None: zeros) on
    one CUDA device, contiguous; anything else raises."""
    if x.device.type == "cpu":
        return polyphase_fir_plain(x, hist, in_rate, out_rate, n_out)
    hists = () if hist is None else (hist,)
    check_cuda("polyphase_fir", x, *hists)
    B, n = x.shape
    if hist is not None and hist.shape != (B, SINC_LEN - 1):
        raise ValueError(f"polyphase_fir: hist{tuple(hist.shape)}, want [{B}, {SINC_LEN - 1}]")
    if any(t.dtype != torch.float32 for t in (x, *hists)):
        raise TypeError("polyphase_fir: x and hist must be float32")
    out = launch_k15(x, hist, in_rate, out_rate, n_out, k15_plan(in_rate, out_rate, n_out))
    if B and n_out:
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
