"""Opus HYBRID mode encoder (SILK-WB low band + CELT start-band-17
high band sharing one range coder, RFC 6716 §3.1 configs 12-15) —
completes the owned encode mode matrix: with opus_celt_enc (music) and
opus_silk_enc (NB/MB/WB voice) every Opus coding mode now encodes
through owned code in both layers.

The frame layout mirrors the owned decoder's hybrid read order
(opus_core._decode_hybrid_frame): SILK-WB superframe first, then — iff
37 bits of slack remain, exactly the decoder's guard — a zero
redundancy flag at logp 12, then the CELT frame with start band 17 on
the same coder.  Packets are near-CBR: each frame's byte budget is the bitrate
target, raised when a loud SILK frame cannot fit under it — the
closed-loop pulse quantizer has a rate floor of roughly 2*rms pulses
per sample (the normative gain table caps at 0.25 full scale per
unit pulse), so hot program material can run up to ~30% above target
while conversational levels sit at it.  A per-frame rate loop steers
the SILK share back toward the target.  The budget is fixed BEFORE
the coder writes a symbol — a scratch first pass measures the SILK
size — so every tell-conditional flag read by the decoder is
mirrored exactly.  (A rate-distortion NSQ would tighten the CBR; the
packets are conformant either way.)

The CELT input is delayed by the SILK path's round-trip latency
(decimation FIR + the decoder's 48 kHz resampler) so both layers add
coherently in the decoder's sum.

Parity reference: the reference encodes via pure-Rust libopus-rs
(soundkit-opus/src/lib.rs:96-293); here the hybrid assembly is owned.
"""
from __future__ import annotations

import numpy as np

from soundkit_tpu_torch.codecs.opus_enc_rc import RangeEncoder
from soundkit_tpu_torch.codecs.opus_celt_enc import (
    CELT_EMPH_COEFF,
    CeltEncoder,
    OVERLAP,
    detect_transient,
)
from soundkit_tpu_torch.codecs.opus_silk_enc import (
    SilkEncoder,
    SilkStereoEncoder,
)
from soundkit_tpu_torch.codecs.opus_tables import tables


class OpusHybridEncoder:
    """Opus packet encoder, hybrid mode (SWB/FB voice, 20 ms code-0
    CBR packets, mono or stereo).

    push() buffers float PCM at 48 kHz; each packet encodes the
    SILK-WB layer from the decimated low band and the CELT layer
    (bands 17+) from the full-rate signal on one range coder."""

    # 20 ms hybrid TOC configs: 13 = SWB, 15 = FB
    _CONFIGS = {"swb": 13, "fb": 15}
    # measured SILK round-trip delay at 48 kHz (decimation FIR group
    # delay + the decoder-side libswresample delay); the CELT input is
    # delayed by this so the decoder's silk48 + celt sum aligns
    SILK_PATH_DELAY = 36

    def __init__(self, bandwidth: str = "swb", bit_rate: int = 32000,
                 channels: int = 1):
        if channels not in (1, 2):
            raise ValueError("opus supports 1 or 2 channels")
        if bandwidth not in self._CONFIGS:
            raise ValueError("hybrid bandwidth must be 'swb' or 'fb'")
        self.bandwidth = bandwidth
        self.channels = channels
        self.bit_rate = bit_rate
        self.frame_size = 960
        self.bytes_per_frame = max(
            20, int(round(bit_rate * 0.02 / 8.0)) - 1)
        t = tables()
        self._band_end = int(
            t["celt_band_end"][3 if bandwidth == "swb" else 4])
        self._silk = (SilkEncoder(2) if channels == 1
                      else SilkStereoEncoder(2))
        # (the native SILK encoder cannot hand its open coder to the
        # CELT layer yet, so hybrid runs the Python SILK encoder)
        self._celt = CeltEncoder(channels)
        # anti-alias decimation FIR at 48k -> 16k (matches
        # OpusSilkEncoder's WB path)
        taps = 72
        n = np.arange(-taps // 2, taps // 2 + 1)
        h = np.sinc((0.92 / 3.0) * n) * np.hamming(taps + 1)
        self._fir = h / np.sum(h)
        self._hist48 = np.zeros((taps, channels))
        self._pend16 = np.zeros((0, channels))      # silk feed
        self._emph_mem = np.zeros(channels)
        self._emph_pend = np.zeros((channels, 0))
        self._started = False
        # the CELT high band (bands 17+, 2 at SWB / 4 at FB) is
        # cheap; SILK gets the rest of the budget
        self._celt_bytes = 10 + 3 * (self._band_end - 17)
        self._silk_share = max(
            0.3, 1.0 - (self._celt_bytes + 2) / self.bytes_per_frame)
        # initial rate-loop gain (lambda scales with the SILK rate:
        # a 28 kbps WB stream sits at ~1.0)
        self._lambda = float(np.clip(
            self._silk_share * bit_rate / 28000.0, 0.15, 4.0))
        self._toc = ((self._CONFIGS[bandwidth] << 3)
                     | ((1 if channels == 2 else 0) << 2))

    def _decimate(self, x48: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self._hist48, x48], axis=0)
        n_out = len(x48) // 3
        if n_out:
            y = np.stack([
                np.convolve(buf[:, c], self._fir, mode="valid")[2::3][:n_out]
                for c in range(self.channels)
            ], axis=1)
        else:
            y = np.zeros((0, self.channels))
        self._hist48 = buf[len(buf) - len(self._fir) + 1:]
        return y

    def _silk_state(self):
        e = self._silk
        if self.channels == 1:
            encs = (e,)
        else:
            encs = (e.mid, e.side)
        snap = [(x.log_gain, x.coded, x.prev_voiced,
                 x.prev_nlsf.copy(), x.output.copy(),
                 x.lpc_history.copy(), x._xhist.copy()) for x in encs]
        if self.channels == 2:
            snap.append((list(e.w), e._mhist.copy(), e._dhist.copy()))
        return snap

    def _silk_restore(self, snap):
        e = self._silk
        encs = (e,) if self.channels == 1 else (e.mid, e.side)
        for x, st in zip(encs, snap):
            (x.log_gain, x.coded, x.prev_voiced, nlsf, out, lpch,
             xh) = st
            x.prev_nlsf = nlsf.copy()
            x.output = out.copy()
            x.lpc_history = lpch.copy()
            x._xhist = xh.copy()
        if self.channels == 2:
            w, mh, dh = snap[2]
            e.w = list(w)
            e._mhist = mh.copy()
            e._dhist = dh.copy()

    def _preemph(self, pcm: np.ndarray) -> np.ndarray:
        v = pcm.T * 32768.0
        prev = np.concatenate([self._emph_mem[:, None], v[:, :-1]],
                              axis=1)
        if v.shape[1]:
            self._emph_mem = v[:, -1].copy()
        return v - CELT_EMPH_COEFF * prev

    def push(self, pcm: np.ndarray):
        """[n, channels] (or flat interleaved) float PCM at 48 kHz ->
        list of hybrid Opus packets."""
        pcm = np.asarray(pcm, dtype=np.float64).reshape(
            -1, self.channels)
        if len(pcm) % 3:
            pcm = np.concatenate(
                [pcm, np.zeros((3 - len(pcm) % 3, self.channels))],
                axis=0)
        self._pend16 = np.concatenate(
            [self._pend16, self._decimate(pcm)], axis=0)
        # celt feed: the same pcm delayed by the silk path latency
        d = self.SILK_PATH_DELAY
        if self._started is False:
            self._started = True
            pcm_delayed = np.concatenate(
                [np.zeros((d, self.channels)), pcm], axis=0)
        else:
            pcm_delayed = pcm
        self._emph_pend = np.concatenate(
            [self._emph_pend, self._preemph(pcm_delayed)], axis=1)

        out = []
        N = self.frame_size
        fl = 320  # WB 20 ms at 16 kHz
        target_bits = self.bytes_per_frame * 8
        while (self._pend16.shape[0] >= fl
               and self._emph_pend.shape[1] >= N + OVERLAP):
            frame16 = self._pend16[:fl]
            self._pend16 = self._pend16[fl:]
            win48 = self._emph_pend[:, :N + OVERLAP]
            self._emph_pend = self._emph_pend[:, N:]

            # pass 1: measure the SILK layer's size on a scratch
            # coder (deterministic — the closed-loop state is restored
            # and the same symbols re-emit in pass 2)
            snap = self._silk_state()
            lam = self._lambda
            self._silk.target_pulse = float(
                np.clip(3.0 * lam, 0.3, 24.0))
            scratch = RangeEncoder(1275)
            if self.channels == 1:
                self._silk.encode_superframe(scratch, frame16[:, 0])
            else:
                self._silk.encode_superframe(scratch, frame16[:, 0],
                                             frame16[:, 1])
            silk_bits = scratch.tell()
            self._silk_restore(snap)
            # pass 2: the packet budget is the CBR target, raised when
            # the SILK floor exceeds it (CELT keeps >= 10 bytes)
            nbytes = max(self.bytes_per_frame,
                         (silk_bits + 37 + 7) // 8 + self._celt_bytes)
            rc = RangeEncoder(nbytes)
            if self.channels == 1:
                self._silk.encode_superframe(rc, frame16[:, 0])
            else:
                self._silk.encode_superframe(rc, frame16[:, 0],
                                             frame16[:, 1])
            # redundancy flag: emitted iff the decoder will read it
            if rc.tell() + 37 <= rc.total_bits:
                rc.enc_bit_logp(0, 12)
            transient = bool(detect_transient(win48, N, 8))
            self._celt.encode_frame(rc, win48, N, start=17,
                                    end=self._band_end,
                                    transient=transient)
            payload = rc.finalize()
            out.append(bytes([self._toc]) + payload)
            # steer SILK toward its share of the frame budget (too
            # many bits -> lower the pulse target, as OpusSilkEncoder)
            self._lambda = float(np.clip(
                lam * (self._silk_share * target_bits
                       / max(silk_bits, 1.0)) ** 0.25
                * (self.bytes_per_frame / nbytes) ** 0.5,
                0.02, 8.0))
        return out

    def flush(self):
        need48 = (self.frame_size + OVERLAP
                  - self._emph_pend.shape[1] + 3)
        need16 = 320 - self._pend16.shape[0]
        need = max(need48, need16 * 3, 0) + 3
        return self.push(np.zeros((need, self.channels)))
