"""AAC-LC numeric decode: dequant, stereo tools, TNS, IMDCT, windows.

Parity target: the reference's ``AacDsp``
(soundkit-aac-lc/src/dsp.rs): ``imdct_fast`` (:476-535), sine/KBD
windows (:542-549), long/short overlap-add sequences (:198-338), TNS
inverse lattice (tns.rs), M/S + intensity
(decoder.rs:253-319), pow-4/3 dequantization (dsp.rs:397-431).

This module holds the numpy reference implementation used by the host
single-stream path and as ground truth; the batched TPU path
(``ops.aac_batch``) reuses the same window/IMDCT matrices as jnp
constants with matmul-based IMDCT (the MXU kernel of the north star).

All math follows the ISO textbook definitions:
  IMDCT:  z[n] = (2/N) * sum_k X[k] cos(2*pi/N * (n + n0) * (k + 1/2)),
          n0 = (N/2 + 1) / 2
  KBD window: cumulative-Kaiser-sum square root, alpha = 4 (long),
          6 (short)
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs.aac_lc import (
    AacFrame,
    ChannelElement,
    EIGHT_SHORT_SEQUENCE,
    ESC_BT,
    IcsData,
    INTENSITY_BT,
    INTENSITY_BT2,
    LONG_START_SEQUENCE,
    LONG_STOP_SEQUENCE,
    NOISE_BT,
    ONLY_LONG_SEQUENCE,
    ZERO_BT,
)

TNS_MAX_ORDER = 20


@functools.lru_cache(maxsize=8)
def imdct_matrix(n_coefs: int) -> np.ndarray:
    """[N, n_coefs] IMDCT matrix, N = 2*n_coefs."""
    N = 2 * n_coefs
    n0 = (n_coefs + 1) / 2.0
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(n_coefs, dtype=np.float64)[None, :]
    return (2.0 / N) * np.cos(2.0 * np.pi / N * (n + n0) * (k + 0.5))


@functools.lru_cache(maxsize=8)
def sine_window(n: int) -> np.ndarray:
    """Ascending half of the sine window (n values)."""
    return np.sin(np.pi / (2 * n) * (np.arange(n) + 0.5))


@functools.lru_cache(maxsize=8)
def kbd_window(n: int, alpha: float) -> np.ndarray:
    """Ascending half of the Kaiser-Bessel derived window (n values)."""
    kaiser = np.kaiser(n + 1, np.pi * alpha)
    cum = np.cumsum(kaiser)
    return np.sqrt(cum[:n] / cum[n])


def half_window(shape: int, n: int) -> np.ndarray:
    if shape:  # 1 = KBD
        return kbd_window(n, 4.0 if n == 1024 else 6.0)
    return sine_window(n)


def dequantize(ics: IcsData) -> np.ndarray:
    """quant int -> float spectrum [1024] (window-major for short)."""
    q = ics.quant.astype(np.float64)
    x = np.sign(q) * np.abs(q) ** (4.0 / 3.0)
    # expand per-band scale to lines
    scale = np.zeros(1024)
    short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
    wbase = 0
    for g in range(ics.num_window_groups):
        for s in range(ics.max_sfb):
            cb = ics.band_type[g, s]
            if cb == ZERO_BT or cb >= NOISE_BT:
                continue
            lo = int(ics.swb_offset[s])
            hi = int(ics.swb_offset[s + 1])
            for w in range(ics.group_lens[g]):
                off = (wbase + w) * 128 if short else 0
                scale[off + lo : off + hi] = ics.scale[g, s]
        wbase += ics.group_lens[g]
    return x * scale


def apply_pns(ics: IcsData, coef: np.ndarray, rng: np.random.Generator) -> None:
    """Perceptual noise substitution: fill NOISE_BT bands with scaled
    noise.  RNG differs from other decoders by construction; energy
    matches."""
    short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
    wbase = 0
    for g in range(ics.num_window_groups):
        for s in range(ics.max_sfb):
            if ics.band_type[g, s] != NOISE_BT:
                continue
            lo = int(ics.swb_offset[s])
            hi = int(ics.swb_offset[s + 1])
            for w in range(ics.group_lens[g]):
                off = (wbase + w) * 128 if short else 0
                n = hi - lo
                noise = rng.standard_normal(n)
                energy = np.sqrt(np.sum(noise**2)) or 1.0
                coef[off + lo : off + hi] = noise / energy * ics.scale[g, s] * np.sqrt(n)
        wbase += ics.group_lens[g]


def apply_ms(cpe: ChannelElement, coef0: np.ndarray, coef1: np.ndarray) -> None:
    """Mid/side butterflies (decoder.rs:253-319 equivalent)."""
    if cpe.ms_mask is None:
        return
    ics0, ics1 = cpe.ics
    short = ics0.window_sequence == EIGHT_SHORT_SEQUENCE
    wbase = 0
    for g in range(ics0.num_window_groups):
        for s in range(min(ics0.max_sfb, cpe.ms_mask.shape[1])):
            if not cpe.ms_mask[g, s]:
                continue
            bt0 = ics0.band_type[g, s]
            bt1 = ics1.band_type[g, s]
            if bt0 >= NOISE_BT or bt1 >= NOISE_BT:
                continue
            lo = int(ics0.swb_offset[s])
            hi = int(ics0.swb_offset[s + 1])
            for w in range(ics0.group_lens[g]):
                off = (wbase + w) * 128 if short else 0
                m = coef0[off + lo : off + hi].copy()
                sd = coef1[off + lo : off + hi]
                coef0[off + lo : off + hi] = m + sd
                coef1[off + lo : off + hi] = m - sd
        wbase += ics0.group_lens[g]


def apply_intensity(cpe: ChannelElement, coef0: np.ndarray, coef1: np.ndarray) -> None:
    """Intensity stereo: right = left * 2^(-is_pos/4) with phase."""
    ics1 = cpe.ics[1]
    short = ics1.window_sequence == EIGHT_SHORT_SEQUENCE
    wbase = 0
    for g in range(ics1.num_window_groups):
        for s in range(ics1.max_sfb):
            bt = ics1.band_type[g, s]
            if bt not in (INTENSITY_BT, INTENSITY_BT2):
                continue
            c = -1.0 if bt == INTENSITY_BT2 else 1.0
            if cpe.ms_mask is not None and s < cpe.ms_mask.shape[1] and cpe.ms_mask[g, s]:
                c = -c
            lo = int(ics1.swb_offset[s])
            hi = int(ics1.swb_offset[s + 1])
            for w in range(ics1.group_lens[g]):
                off = (wbase + w) * 128 if short else 0
                coef1[off + lo : off + hi] = (
                    coef0[off + lo : off + hi] * c * ics1.scale[g, s]
                )
        wbase += ics1.group_lens[g]


def _lpc_from_parcor(parcor: np.ndarray) -> np.ndarray:
    order = len(parcor)
    lpc = np.zeros(order)
    for m in range(order):
        k = parcor[m]
        new = lpc.copy()
        new[m] = k
        for i in range(m):
            new[i] = lpc[i] + k * lpc[m - 1 - i]
        lpc = new
    return lpc


def apply_tns(ics: IcsData, coef: np.ndarray, tns_max_bands: int) -> None:
    """All-pole (decode-side) TNS filtering per window."""
    if not any(ics.tns):
        return
    short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
    mmax = min(tns_max_bands, ics.max_sfb)
    for w in range(ics.num_windows):
        bottom = ics.num_swb
        for f in ics.tns[w]:
            top = bottom
            bottom = max(0, top - f.length)
            order = min(f.order, TNS_MAX_ORDER)
            if order == 0:
                continue
            lpc = _lpc_from_parcor(f.coefs[:order])
            start = int(ics.swb_offset[min(bottom, mmax)])
            end = int(ics.swb_offset[min(top, mmax)])
            size = end - start
            if size <= 0:
                continue
            off = w * 128 if short else 0
            seg_start = off + start
            if f.direction:
                idxs = range(size - 1, -1, -1)
                inc = -1
                base = off + end - 1
            else:
                inc = 1
                base = seg_start
            # sequential AR filter
            for m in range(size):
                pos = base + m * inc
                acc = coef[pos]
                for i in range(1, min(m, order) + 1):
                    acc -= coef[pos - i * inc] * lpc[i - 1]
                coef[pos] = acc


class ChannelSynth:
    """Per-channel IMDCT + windowing + overlap-add with carried state
    (the DspChannel delay line, dsp.rs:143-172)."""

    def __init__(self) -> None:
        self.saved = np.zeros(1024)
        self.prev_shape = 0

    def process(self, ics: IcsData, coef: np.ndarray) -> np.ndarray:
        seq = ics.window_sequence
        shape = ics.window_shape
        long_asc_prev = half_window(self.prev_shape, 1024)
        long_desc = half_window(shape, 1024)[::-1]
        short_asc_prev = half_window(self.prev_shape, 128)
        short_asc = half_window(shape, 128)
        short_desc = half_window(shape, 128)[::-1]

        if seq == EIGHT_SHORT_SEQUENCE:
            z = np.zeros(2048)
            M = imdct_matrix(128)
            for i in range(8):
                sub = M @ coef[i * 128 : (i + 1) * 128]
                wa = short_asc_prev if i == 0 else short_asc
                sub = sub * np.concatenate([wa, short_desc])
                z[448 + i * 128 : 448 + i * 128 + 256] += sub
        else:
            z = imdct_matrix(1024) @ coef
            if seq == ONLY_LONG_SEQUENCE:
                w = np.concatenate([long_asc_prev, long_desc])
            elif seq == LONG_START_SEQUENCE:
                w = np.concatenate(
                    [long_asc_prev, np.ones(448), short_desc, np.zeros(448)]
                )
            elif seq == LONG_STOP_SEQUENCE:
                w = np.concatenate(
                    [np.zeros(448), short_asc_prev, np.ones(448), long_desc]
                )
            else:
                raise ValueError("bad window sequence")
            z = z * w

        out = self.saved + z[:1024]
        self.saved = z[1024:].copy()
        self.prev_shape = shape
        return out


class AacLcSynth:
    """Full-frame numeric decode over parsed elements."""

    def __init__(self, sr_index: int) -> None:
        from soundkit_tpu_torch.codecs.aac_lc import _tables

        t = _tables()
        self.tns_max_long = int(t["tns_max_1024"][sr_index])
        self.tns_max_short = int(t["tns_max_128"][sr_index])
        self.synths: List[ChannelSynth] = []
        self._rng = np.random.default_rng(0)

    def _synth(self, i: int) -> ChannelSynth:
        while len(self.synths) <= i:
            self.synths.append(ChannelSynth())
        return self.synths[i]

    def process_frame(self, frame: AacFrame) -> np.ndarray:
        """Returns [channels, 1024] float in int16 scale domain / 32768."""
        outputs = []
        ch_idx = 0
        for el in frame.elements:
            if el.kind in ("SCE", "LFE"):
                ics = el.ics[0]
                coef = dequantize(ics)
                apply_pns(ics, coef, self._rng)
                tmax = (
                    self.tns_max_short
                    if ics.window_sequence == EIGHT_SHORT_SEQUENCE
                    else self.tns_max_long
                )
                apply_tns(ics, coef, tmax)
                outputs.append(self._synth(ch_idx).process(ics, coef))
                ch_idx += 1
            else:  # CPE
                ics0, ics1 = el.ics
                c0 = dequantize(ics0)
                c1 = dequantize(ics1)
                apply_pns(ics0, c0, self._rng)
                apply_pns(ics1, c1, self._rng)
                apply_ms(el, c0, c1)
                apply_intensity(el, c0, c1)
                for ics, coef in ((ics0, c0), (ics1, c1)):
                    tmax = (
                        self.tns_max_short
                        if ics.window_sequence == EIGHT_SHORT_SEQUENCE
                        else self.tns_max_long
                    )
                    apply_tns(ics, coef, tmax)
                outputs.append(self._synth(ch_idx).process(ics0, c0))
                outputs.append(self._synth(ch_idx + 1).process(ics1, c1))
                ch_idx += 2
        return np.stack(outputs) / 32768.0
