"""Batched CELT synthesis for 20 ms Opus CELT frames in PyTorch
(counterpart of ``soundkit_tpu/ops/celt_batch.py``).

One step takes the denormalized spectra of ``[B, C]`` lanes, as the
host parse writes them, to 48 kHz PCM:

- the long (960) and short (8 x 120) low-overlap IMDCTs as plain float32
  products (:func:`celt_imdct`; a matmul and an einsum with its eight
  overlapping adds), run in IEEE float32 whatever the caller's TF32
  settings (:func:`utils.device.ieee_fp32`), as the reference pins
  float32; the long or short result is selected per lane by its
  transient flag;
- then the overlap-add with the carried 120-sample lap, the comb
  postfilter and the de-emphasis, with the validity mask: K11
  (``ops.celt_postfilter.celt_postfilter``) on the card, its plain
  version on the CPU.

:func:`celt_synth_step` is the decoder's step; :func:`celt_synth_step_plain`
is the same step with K11's plain version on any device (the reference's
``_celt_synth_step`` and the masked ``where`` of
``models/opus_batch.py``), the path the tests hold to the JAX package.
:func:`dequant_wire` turns the int16 wire with per-band scales back into
spectra, and :func:`pad_wire` widens a wire trimmed to the coded band
end back to 960 bins.

``N``, ``NB_SHORT``, ``HIST``, ``_bases``, ``_win2`` and
:func:`pack_comb_params` are verbatim copies of the reference's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch.codecs.opus_celt import (
    OVERLAP,
    _imdct_matrix,
    tables,
)
from soundkit_tpu_torch.utils.device import ieee_fp32

N = 960          # 20 ms at 48 kHz
NB_SHORT = 120
HIST = 1200      # comb history (> max period 1024 + taps)


@functools.lru_cache(maxsize=1)
def _bases():
    """(long [960, 1080], short [120, 240]) IMDCT bases as f32."""
    return (
        _imdct_matrix(N).astype(np.float32),
        _imdct_matrix(NB_SHORT).astype(np.float32),
    )


@functools.lru_cache(maxsize=1)
def _win2():
    w = tables()["celt_window"].astype(np.float32)
    return (w * w).astype(np.float32)


def pack_comb_params(pf_state, pf_period, pf_gain, pf_tapset,
                     taps) -> np.ndarray:
    """Per-lane comb parameter vector for one frame.

    pf_state = (period_old, period, gain_old, gain, tapset_old,
    tapset) captured BEFORE the frame's rotation (the
    codecs/opus_celt.py ``last_parse['pf_state']`` tuple); pf_* are
    this frame's decoded values. Layout (16 floats):
      [T_a0, T_a1, ga0*, gb0*] stage A old/current periods + 2x3
      premultiplied tap gains, then [T_b0, T_b1, gc0*, gd0*] for
      stage B (current -> new).
    """
    p_old, p_cur, g_old, g_cur, t_old, t_cur = pf_state
    out = np.zeros(16, dtype=np.float32)
    out[0] = max(p_old, 15)
    out[1] = max(p_cur, 15)
    out[2:5] = g_old * taps[t_old]
    out[5:8] = g_cur * taps[t_cur]
    out[8] = max(p_cur, 15)
    out[9] = max(pf_period, 15)
    out[10:13] = g_cur * taps[t_cur]
    out[13:16] = pf_gain * taps[pf_tapset]
    return out


@functools.lru_cache(maxsize=8)
def imdct_bases(device: torch.device):
    """The long [960, 1080] and short [120, 240] bases of :func:`_bases`
    as float32 tensors on ``device``."""
    return tuple(torch.from_numpy(m).to(device) for m in _bases())


def celt_imdct(freq, short_flag):
    """The IMDCT of one frame for all lanes: ``freq`` f32 [B, C, 960]
    (a transient frame carries its 8 short MDCTs interleaved, bin k of
    block b at ``8 k + b``), ``short_flag`` [B] (1: eight short blocks)
    -> f32 [B, C, 1080], the long or the short result per lane."""
    B, C, _ = freq.shape
    long_m, short_m = imdct_bases(freq.device)
    flat = freq.reshape(B * C, N)
    with ieee_fp32():
        full_long = flat @ long_m
        blocks = flat.reshape(B * C, NB_SHORT, 8)
        short_pcm = torch.einsum("ikb,kt->ibt", blocks, short_m)  # [B*C, 8, 240]
    full_short = torch.zeros((B * C, N + OVERLAP), dtype=freq.dtype, device=freq.device)
    for b in range(8):
        full_short[:, b * NB_SHORT: b * NB_SHORT + 2 * NB_SHORT] += short_pcm[:, b]
    short = (short_flag == 1).reshape(B, 1).expand(B, C).reshape(B * C, 1)
    return torch.where(short, full_short, full_long).reshape(B, C, N + OVERLAP)


def celt_synth_step(freq, short_flag, comb_params, valid, ola, hist, emph, pcm_out=None):
    """One lockstep 20 ms frame for all lanes.

    freq:        [B, C, 960] f32 denormalized spectra
    short_flag:  [B] int32, 1 = transient (8 short blocks)
    comb_params: [B, 16] f32, :func:`pack_comb_params`' layout
    valid:       [B] bool; an invalid lane gives silence and keeps its
                 state bit for bit
    ola:         [B, C, 120] f32 carried overlap
    hist:        [B, C, 1200] f32 carried filtered history
    emph:        [B, C] f32 de-emphasis memory

    Returns (pcm [B, C, 960] f32, new_ola, new_hist, new_emph), the PCM
    into ``pcm_out`` where given: the IMDCT glue, then K11 on a CUDA
    device and its plain version on the CPU."""
    from soundkit_tpu_torch.ops.celt_postfilter import celt_postfilter

    return celt_postfilter(celt_imdct(freq, short_flag), comb_params, valid, ola, hist, emph,
                           pcm_out=pcm_out)


def celt_synth_step_plain(freq, short_flag, comb_params, valid, ola, hist, emph):
    """:func:`celt_synth_step` with K11's plain version on any device."""
    from soundkit_tpu_torch.ops.celt_postfilter import celt_postfilter_plain

    return celt_postfilter_plain(celt_imdct(freq, short_flag), comb_params, valid, ola, hist,
                                 emph)


def dequant_wire(qfreq, scales, band_idx):
    """The int16 wire's spectra: ``qfreq`` i16 [..., C, W] times the
    scale of each bin's band, ``scales`` f32 [..., 21] indexed by
    ``band_idx`` i64 [W] -> f32 [..., C, W]."""
    return qfreq.to(torch.float32) * scales[..., band_idx].unsqueeze(-2)


def pad_wire(freq):
    """``freq`` [..., W] zero-padded to the frame's 960 bins."""
    w = freq.shape[-1]
    return freq if w == N else torch.nn.functional.pad(freq, (0, N - w))
