"""RFC 6716 §4.2 SILK layer decoder (owned code, no libopus).

Decodes the LP layer of an Opus packet: header VAD/LBRR flags, frame
type, subframe gains, NLSF VQ (stage-1/2 + backward prediction +
stabilization + interpolation), LSF->LPC conversion with the mandated
fixed-point arithmetic, pitch lags and the 5-tap LTP filter, the
shell-coded excitation, and the LTP + LPC synthesis filters.  Output
is float PCM at the SILK internal rate (8/12/16 kHz); the caller
resamples to 48 kHz (utils/swr.py mirrors the oracle's resampler).

Data tables come from the extracted RFC set (opus_tables.py).
Parity reference: soundkit-opus/src/lib.rs wraps libopus; this is a
from-scratch implementation of the normative decode chain.
"""
from __future__ import annotations

import numpy as np

from soundkit_tpu_torch.codecs.opus_rc import RangeDecoder, ilog
from soundkit_tpu_torch.codecs.opus_tables import tables

LTP_ORDER = 5
SILK_HISTORY = 322
SILK_MAX_LAG = 288 + LTP_ORDER // 2


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x & 0x80000000 else x


def _mulh(a: int, b: int) -> int:
    """High 32 bits of a signed 32x32 multiply."""
    return _i32((a * b) >> 32)


def _round_mull(a: int, b: int, s: int) -> int:
    return _i32((((a * b) >> (s - 1)) + 1) >> 1)


def _sat32(x: int) -> int:
    return max(-0x80000000, min(0x7FFFFFFF, x))


class SilkFrame:
    __slots__ = ("coded", "log_gain", "nlsf", "lpc", "output",
                 "lpc_history", "primarylag", "prev_voiced")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.coded = False
        self.log_gain = 0
        self.nlsf = np.zeros(16, dtype=np.int64)
        self.lpc = np.zeros(16)
        self.output = np.zeros(2 * SILK_HISTORY)
        self.lpc_history = np.zeros(2 * SILK_HISTORY)
        self.primarylag = 0
        self.prev_voiced = False


class SilkDecoder:
    """Stateful SILK decoder for one stream, mono or stereo (mid/side
    prediction weights, midonly flag, LBRR parse, L/R unmix)."""

    def __init__(self) -> None:
        t = tables()
        self.t = t
        self.frames = [SilkFrame(), SilkFrame()]
        self.nlsf_interp_factor = 4
        self.wb = False
        self.bandwidth = 0
        self.subframes = 0
        self.sflength = 0
        self.flength = 0
        self.stereo_weights = [0.0, 0.0]
        self.prev_stereo_weights = [0.0, 0.0]
        self.midonly = 0

    def flush(self) -> None:
        for f in self.frames:
            f.reset()
        self.stereo_weights = [0.0, 0.0]
        self.prev_stereo_weights = [0.0, 0.0]
        self.midonly = 0

    # ------------------------------------------------------------------
    def decode_superframe(self, rc: RangeDecoder, bandwidth: int,
                          coded_channels: int, duration_ms: int
                          ) -> np.ndarray:
        """Decode one SILK superframe -> [n, channels] float at the
        internal rate (bandwidth: 0=NB 1=MB 2=WB)."""
        nb_frames = 1 + (duration_ms > 20) + (duration_ms > 40)
        self.subframes = duration_ms // nb_frames // 5
        self.sflength = 20 * (bandwidth + 2)
        self.flength = self.sflength * self.subframes
        self.bandwidth = bandwidth
        self.wb = bandwidth == 2
        if getattr(self, "_prev_channels", 0) < coded_channels:
            # side-channel state starts fresh when the stream becomes
            # stereo
            self.frames[1].reset()
        self._prev_channels = coded_channels

        # header bits: per channel, VAD flags then the LBRR flag
        active = []
        redundancy = []
        for c in range(coded_channels):
            active.append([bool(rc.dec_bit_logp(1))
                           for _ in range(nb_frames)])
            redundancy.append(bool(rc.dec_bit_logp(1)))
        lbrr = [[False] * nb_frames for _ in range(coded_channels)]
        for c in range(coded_channels):
            if redundancy[c]:
                if nb_frames == 1:
                    lbrr[c][0] = True
                else:
                    model = (self.t["silk_model_lbrr_flags_40"]
                             if nb_frames == 2
                             else self.t["silk_model_lbrr_flags_60"])
                    # these models carry a leading-0 cdf entry, so
                    # dec_cdf returns the 1-based flag pattern already
                    flags = rc.dec_cdf(model)
                    for j in range(nb_frames):
                        lbrr[c][j] = bool((flags >> j) & 1)
        # LBRR frames: decoded in place exactly as the oracle does
        # (state carries into the regular frames), output discarded
        for j in range(nb_frames):
            for c in range(coded_channels):
                if lbrr[c][j]:
                    # the side-channel LBRR flag reads as 0 for mono
                    # streams (the oracle's zero-initialized array)
                    side_lbrr = coded_channels == 2 and lbrr[1][j]
                    active1 = 0 if (c == 0 and not side_lbrr) else 1
                    # libopus condCoding: an LBRR frame is coded
                    # conditionally iff the same channel's previous
                    # frame in this packet also carried LBRR
                    ind = not (j > 0 and lbrr[c][j - 1])
                    self._decode_frame(rc, c, coded_channels, True, j,
                                       active1, lbrr=True,
                                       independent=ind)
            self.midonly = 0
        out = []
        flen = self.flength
        for j in range(nb_frames):
            chans = []
            for c in range(coded_channels):
                if c == 1 and self.midonly:
                    # side frame absent from the bitstream
                    if self.frames[1].coded:
                        self.frames[1].reset()
                    chans.append(np.zeros(flen))
                    break
                act1 = active[1][j] if coded_channels == 2 else 1
                pcm = self._decode_frame(rc, c, coded_channels,
                                         active[c][j], j, int(act1))
                chans.append(pcm[:, 0] if pcm.ndim == 2 else pcm)
            if coded_channels == 2:
                out.append(self._unmix(flen))
            else:
                out.append(chans[0].reshape(-1, 1))
            self.midonly = 0
        return np.concatenate(out, axis=0)

    def _unmix(self, flen: int) -> np.ndarray:
        """Mid/side -> L/R with the low-pass predictor and the 8 ms
        weight interpolation, on the 1-sample-delayed grid."""
        t = self.t
        base = SILK_HISTORY - flen - 2
        mid = self.frames[0].output[base:base + flen + 2]
        side = self.frames[1].output[base:base + flen + 2]
        n1 = int(t["silk_stereo_interp_len"][self.bandwidth])
        w0p, w1p = self.prev_stereo_weights
        w0, w1 = self.stereo_weights
        c = np.arange(flen, dtype=np.float64)
        i0 = np.where(c < n1, w0p + c * (w0 - w0p) / n1, w0)
        i1 = np.where(c < n1, w1p + c * (w1 - w1p) / n1, w1)
        p0 = 0.25 * (mid[:-2] + 2.0 * mid[1:-1] + mid[2:])
        m1 = mid[1:-1]
        s1 = side[1:-1]
        left = np.clip((1.0 + i1) * m1 + s1 + i0 * p0, -1.0, 1.0)
        right = np.clip((1.0 - i1) * m1 - s1 - i0 * p0, -1.0, 1.0)
        self.prev_stereo_weights = list(self.stereo_weights)
        return np.stack([left, right], axis=1)

    # ------------------------------------------------------------------
    def _decode_frame(self, rc: RangeDecoder, channel: int,
                      coded_channels: int, active: bool,
                      frame_num: int, active1: int = 1,
                      lbrr: bool = False,
                      independent: Optional[bool] = None) -> np.ndarray:
        if independent is None:
            independent = frame_num == 0
        t = self.t
        frame = self.frames[channel]
        order = 16 if self.wb else 10
        sfl = self.sflength

        # stereo prediction weights + mid-only flag (mid channel only)
        if coded_channels == 2 and channel == 0:
            n = rc.dec_cdf(t["silk_model_stereo_s1"])
            wi0 = rc.dec_cdf(t["silk_model_stereo_s2"]) + 3 * (n // 5)
            ws0 = rc.dec_cdf(t["silk_model_stereo_s3"])
            wi1 = rc.dec_cdf(t["silk_model_stereo_s2"]) + 3 * (n % 5)
            ws1 = rc.dec_cdf(t["silk_model_stereo_s3"])
            wtab = t["silk_stereo_weights"]
            w = []
            for wi, ws in ((wi0, ws0), (wi1, ws1)):
                lo = int(wtab[wi])
                hi = int(wtab[wi + 1])
                w.append(lo + (((hi - lo) * 6554) >> 16) * (ws * 2 + 1))
            self.stereo_weights = [(w[0] - w[1]) / 8192.0,
                                   w[1] / 8192.0]
            self.midonly = (rc.dec_cdf(t["silk_model_mid_only"])
                            if active1 == 0 else 0)

        # frame type
        if active:
            ftype = rc.dec_cdf(t["silk_model_frame_type_active"])
            qoffset_high = ftype & 1
            voiced = bool(ftype >> 1)
            sigtype = 2 if voiced else 1
        else:
            ftype = rc.dec_cdf(t["silk_model_frame_type_inactive"])
            qoffset_high = ftype & 1
            voiced = False
            sigtype = 0

        # subframe gains
        gains = np.zeros(self.subframes)
        log_gain = frame.log_gain
        for i in range(self.subframes):
            if i == 0 and (independent or not frame.coded):
                x = rc.dec_cdf(t["silk_model_gain_highbits"][sigtype])
                log_gain = (x << 3) | rc.dec_cdf(
                    t["silk_model_gain_lowbits"])
                if frame.coded:
                    log_gain = max(log_gain, frame.log_gain - 16)
            else:
                delta = rc.dec_cdf(t["silk_model_gain_delta"])
                log_gain = min(
                    max(max(2 * delta - 16, log_gain + delta - 4), 0), 63
                )
            frame.log_gain = log_gain
            # 2**(x/128) via the mandated fixed-point approximation
            lg = ((log_gain * 0x1D1C71) >> 16) + 2090
            ipart = lg >> 7
            fpart = lg & 127
            lingain = (1 << ipart) + (
                (((-174 * fpart * (128 - fpart)) >> 16) + fpart)
                * ((1 << ipart) >> 7)
            )
            gains[i] = lingain / 65536.0

        # LSF / LPC
        lpc_leadin, lpc, has_leadin = self._decode_lpc(
            rc, frame, order, voiced
        )

        # pitch lags + LTP filter
        pitchlag = np.zeros(self.subframes, dtype=np.int64)
        ltptaps = np.zeros((self.subframes, LTP_ORDER))
        if voiced:
            lag_absolute = independent or not frame.prev_voiced
            primarylag = 0
            if not lag_absolute:
                delta = rc.dec_cdf(t["silk_model_pitch_delta"])
                if delta:
                    primarylag = frame.primarylag + delta - 9
                else:
                    lag_absolute = True
            if lag_absolute:
                low_models = (
                    t["silk_model_pitch_lowbits_nb"],
                    t["silk_model_pitch_lowbits_mb"],
                    t["silk_model_pitch_lowbits_wb"],
                )
                highbits = rc.dec_cdf(t["silk_model_pitch_highbits"])
                lowbits = rc.dec_cdf(low_models[self.bandwidth])
                primarylag = (
                    int(t["silk_pitch_min_lag"][self.bandwidth])
                    + highbits * int(t["silk_pitch_scale"][self.bandwidth])
                    + lowbits
                )
            frame.primarylag = primarylag
            if self.subframes == 2:
                if self.bandwidth == 0:
                    offsets = t["silk_pitch_offset_nb10ms"][
                        rc.dec_cdf(t["silk_model_pitch_contour_nb10ms"])]
                else:
                    offsets = t["silk_pitch_offset_mbwb10ms"][
                        rc.dec_cdf(t["silk_model_pitch_contour_mbwb10ms"])]
            else:
                if self.bandwidth == 0:
                    offsets = t["silk_pitch_offset_nb20ms"][
                        rc.dec_cdf(t["silk_model_pitch_contour_nb20ms"])]
                else:
                    offsets = t["silk_pitch_offset_mbwb20ms"][
                        rc.dec_cdf(t["silk_model_pitch_contour_mbwb20ms"])]
            lo = int(t["silk_pitch_min_lag"][self.bandwidth])
            hi = int(t["silk_pitch_max_lag"][self.bandwidth])
            for i in range(self.subframes):
                pitchlag[i] = min(max(primarylag + int(offsets[i]), lo), hi)

            filter_sel = (
                t["silk_model_ltp_filter0_sel"],
                t["silk_model_ltp_filter1_sel"],
                t["silk_model_ltp_filter2_sel"],
            )
            filter_taps = (
                t["silk_ltp_filter0_taps"],
                t["silk_ltp_filter1_taps"],
                t["silk_ltp_filter2_taps"],
            )
            ltpfilter = rc.dec_cdf(t["silk_model_ltp_filter"])
            for i in range(self.subframes):
                index = rc.dec_cdf(filter_sel[ltpfilter])
                ltptaps[i] = filter_taps[ltpfilter][index] / 128.0

        # LTP scale factor
        if voiced and independent:
            ltpscale = int(t["silk_ltp_scale_factor"][
                rc.dec_cdf(t["silk_model_ltp_scale_index"])]) / 16384.0
        else:
            ltpscale = 15565.0 / 16384.0

        # excitation
        excitation = self._decode_excitation(
            rc, qoffset_high, int(active), int(voiced)
        )

        flength = self.flength
        if lbrr:
            # LBRR frames are parsed only: the synthesis tail and the
            # output history are skipped, but ALL parse-visible state
            # persists (libopus decode_indices updates LastGainIndex,
            # prevNLSF, lagPrev AND ec_prevSignalType) so a following
            # conditionally-coded LBRR frame keys off this one
            frame.prev_voiced = voiced
            frame.coded = True
            return np.zeros(flength)
        # synthesis
        residual = np.zeros(SILK_MAX_LAG + flength)
        residual[SILK_MAX_LAG:] = excitation
        dst = frame.output
        lpch = frame.lpc_history
        base = SILK_HISTORY  # frame start inside the history buffers
        for i in range(self.subframes):
            coeff = lpc_leadin if (i < 2 and has_leadin) else lpc
            r0 = SILK_MAX_LAG + i * sfl       # resptr base
            d0 = base + i * sfl               # dst base
            if voiced:
                if i < 2 or self.nlsf_interp_factor == 4:
                    out_end = -i * sfl
                    rescale = ltpscale
                else:
                    out_end = -(i - 2) * sfl
                    rescale = 1.0
                start = -int(pitchlag[i]) - LTP_ORDER // 2
                for j in range(start, out_end):
                    v = dst[d0 + j]
                    v -= float(np.dot(coeff[:order],
                                      dst[d0 + j - order:d0 + j][::-1]))
                    residual[r0 + j] = (
                        min(max(v, -1.0), 1.0) * rescale / gains[i]
                    )
                if out_end:
                    rescale2 = gains[i - 1] / gains[i]
                    residual[r0 + out_end:r0] *= rescale2
                # LTP synthesis
                lag = int(pitchlag[i])
                for j in range(sfl):
                    s = residual[r0 + j]
                    off = r0 + j - lag + LTP_ORDER // 2
                    s += float(np.dot(ltptaps[i],
                                      residual[off - LTP_ORDER + 1:off + 1][::-1]))
                    residual[r0 + j] = s
            # LPC synthesis
            g = gains[i]
            for j in range(sfl):
                s = residual[r0 + j] * g
                s += float(np.dot(coeff[:order],
                                  lpch[d0 + j - order:d0 + j][::-1]))
                lpch[d0 + j] = s
                dst[d0 + j] = min(max(s, -1.0), 1.0)

        frame.prev_voiced = voiced
        # the oracle emits with a 2-sample delay
        # (output + SILK_HISTORY - flength - 2)
        out = dst[base - 2:base + flength - 2].copy()
        frame.lpc_history[:SILK_HISTORY] = frame.lpc_history[flength:flength + SILK_HISTORY]
        frame.output[:SILK_HISTORY] = frame.output[flength:flength + SILK_HISTORY]
        frame.coded = True
        return out

    # ------------------------------------------------------------------
    def _decode_lpc(self, rc: RangeDecoder, frame: SilkFrame,
                    order: int, voiced: bool):
        t = self.t
        wb = self.wb
        lsf_i1 = rc.dec_cdf(
            t["silk_model_lsf_s1"][1 if wb else 0][1 if voiced else 0]
        )
        sel = (t["silk_lsf_s2_model_sel_wb"] if wb
               else t["silk_lsf_s2_model_sel_nbmb"])[lsf_i1]
        lsf_i2 = np.zeros(order, dtype=np.int64)
        for i in range(order):
            lsf_i2[i] = rc.dec_cdf(t["silk_model_lsf_s2"][sel[i]]) - 4
            if lsf_i2[i] == -4:
                lsf_i2[i] -= rc.dec_cdf(t["silk_model_lsf_s2_ext"])
            elif lsf_i2[i] == 4:
                lsf_i2[i] += rc.dec_cdf(t["silk_model_lsf_s2_ext"])

        # undo the backward prediction
        qstep = 9830 if wb else 11796
        wsel = (t["silk_lsf_weight_sel_wb"] if wb
                else t["silk_lsf_weight_sel_nbmb"])[lsf_i1]
        pred = (t["silk_lsf_pred_weights_wb"] if wb
                else t["silk_lsf_pred_weights_nbmb"])
        res = np.zeros(order, dtype=np.int64)
        for i in range(order - 1, -1, -1):
            v = int(lsf_i2[i]) * 1024
            if lsf_i2[i] < 0:
                v += 102
            elif lsf_i2[i] > 0:
                v -= 102
            v = (v * qstep) >> 16
            if i + 1 < order:
                v += (int(res[i + 1]) * int(pred[wsel[i]][i])) >> 8
            res[i] = v

        # reconstruct NLSF (Q15) with the mandated sqrt approximation
        codebook = (t["silk_lsf_codebook_wb"] if wb
                    else t["silk_lsf_codebook_nbmb"])[lsf_i1]
        nlsf = np.zeros(order, dtype=np.int64)
        for i in range(order):
            cur = int(codebook[i])
            prev = int(codebook[i - 1]) if i else 0
            nxt = int(codebook[i + 1]) if i + 1 < order else 256
            weight_sq = (1024 // (cur - prev) + 1024 // (nxt - cur)) << 16
            ipart = ilog(weight_sq)
            fpart = (weight_sq >> (ipart - 8)) & 127
            y = (32768 if (ipart & 1) else 46214) >> ((32 - ipart) >> 1)
            weight = y + ((213 * fpart * y) >> 16)
            # C truncating division: res can be negative
            num = int(res[i]) * 16384
            value = cur * 128 + (
                -((-num) // weight) if num < 0 else num // weight
            )
            nlsf[i] = min(max(value, 0), 32767)

        spacing = (t["silk_lsf_min_spacing_wb"] if wb
                   else t["silk_lsf_min_spacing_nbmb"])
        _stabilize_lsf(nlsf, order, spacing)

        lpc = np.zeros(16)
        lpc_leadin = np.zeros(16)
        has_leadin = False
        if self.subframes == 4:
            offset = rc.dec_cdf(t["silk_model_lsf_interpolation_offset"])
            if offset != 4 and frame.coded:
                has_leadin = True
                if offset != 0:
                    nlsf_leadin = frame.nlsf[:order] + (
                        (nlsf - frame.nlsf[:order]) * offset >> 2
                    )
                    _lsf2lpc(nlsf_leadin, lpc_leadin, order, t)
                else:
                    lpc_leadin[:] = frame.lpc
            else:
                offset = 4
            self.nlsf_interp_factor = offset
            _lsf2lpc(nlsf, lpc, order, t)
        else:
            self.nlsf_interp_factor = 4
            _lsf2lpc(nlsf, lpc, order, t)

        frame.nlsf[:order] = nlsf
        frame.lpc[:] = lpc
        return lpc_leadin, lpc, has_leadin

    # ------------------------------------------------------------------
    def _decode_excitation(self, rc: RangeDecoder, qoffset_high: int,
                           active: int, voiced: int) -> np.ndarray:
        t = self.t
        seed = rc.dec_cdf(t["silk_model_lcg_seed"])
        shellblocks = int(
            t["silk_shell_blocks"][self.bandwidth][self.subframes >> 2]
        )
        ratelevel = rc.dec_cdf(t["silk_model_exc_rate"][voiced])

        pulsecount = np.zeros(shellblocks, dtype=np.int64)
        lsbcount = np.zeros(shellblocks, dtype=np.int64)
        for i in range(shellblocks):
            p = rc.dec_cdf(t["silk_model_pulse_count"][ratelevel])
            if p == 17:
                lsb = 0
                while p == 17:
                    lsb += 1
                    if lsb == 10:
                        break
                    p = rc.dec_cdf(t["silk_model_pulse_count"][9])
                if lsb == 10:
                    p = rc.dec_cdf(t["silk_model_pulse_count"][10])
                lsbcount[i] = lsb
            pulsecount[i] = p

        loc_model = t["silk_model_pulse_location"]

        def count_children(model: int, total: int):
            if total == 0:
                return 0, 0
            off = ((total - 1 + 5) * (total - 1)) >> 1
            a = rc.dec_cdf(loc_model[model][off:])
            return a, total - a

        exc = np.zeros(shellblocks * 16, dtype=np.int64)
        for i in range(shellblocks):
            if pulsecount[i] == 0:
                continue
            loc = exc[16 * i:16 * (i + 1)]
            b1 = count_children(0, int(pulsecount[i]))
            for bi, bv in enumerate(b1):
                b2 = count_children(1, bv)
                for ci, cv in enumerate(b2):
                    b3 = count_children(2, cv)
                    for di, dv in enumerate(b3):
                        d1, d2 = count_children(3, dv)
                        k = bi * 8 + ci * 4 + di * 2
                        loc[k] = d1
                        loc[k + 1] = d2

        # LSBs
        for i in range(shellblocks * 16):
            for _ in range(int(lsbcount[i >> 4])):
                exc[i] = (exc[i] << 1) | rc.dec_cdf(
                    t["silk_model_excitation_lsb"])

        # signs
        sign_model = t["silk_model_excitation_sign"]
        for i in range(shellblocks * 16):
            if exc[i] != 0:
                m = sign_model[active + voiced][qoffset_high][
                    min(int(pulsecount[i >> 4]), 6)]
                if rc.dec_cdf(m) == 0:
                    exc[i] = -exc[i]

        # assemble in Q23 with the pseudorandom inversion
        qoff = int(t["silk_quant_offset"][voiced][qoffset_high])
        out = np.zeros(shellblocks * 16)
        for i in range(shellblocks * 16):
            value = int(exc[i])
            e = _i32((value * 256) | qoff)
            if value < 0:
                e += 20
            elif value > 0:
                e -= 20
            seed = (196314165 * seed + 907633515) & 0xFFFFFFFF
            if seed & 0x80000000:
                e = -e
            seed = (seed + value) & 0xFFFFFFFF
            out[i] = e / 8388608.0
        return out[:self.flength]


# ----------------------------------------------------------------------
def _snapshot(f: SilkFrame):
    return (f.coded, f.log_gain, f.nlsf.copy(), f.lpc.copy(),
            f.output.copy(), f.lpc_history.copy(), f.primarylag,
            f.prev_voiced)


def _restore(f: SilkFrame, s) -> None:
    (f.coded, f.log_gain, nlsf, lpc, output, lpch, f.primarylag,
     f.prev_voiced) = s
    f.nlsf[:] = nlsf
    f.lpc[:] = lpc
    f.output[:] = output
    f.lpc_history[:] = lpch


def _stabilize_lsf(nlsf: np.ndarray, order: int, spacing) -> None:
    """Enforce minimum spacing; 20 gentle passes then the sort-based
    fallback (RFC 6716 normative procedure)."""
    min_delta = [int(x) for x in spacing]
    for _ in range(20):
        min_diff = 0
        k = 0
        for i in range(order + 1):
            low = int(nlsf[i - 1]) if i else 0
            high = int(nlsf[i]) if i != order else 32768
            diff = (high - low) - min_delta[i]
            if diff < min_diff:
                min_diff = diff
                k = i
        if min_diff == 0:
            return
        if k == 0:
            nlsf[0] = min_delta[0]
        elif k == order:
            nlsf[order - 1] = 32768 - min_delta[order]
        else:
            min_center = sum(min_delta[:k]) + (min_delta[k] >> 1)
            max_center = (32768
                          - sum(min_delta[k + 1:order + 1])
                          - (min_delta[k] >> 1))
            center_val = int(nlsf[k - 1]) + int(nlsf[k])
            center_val = (center_val >> 1) + (center_val & 1)
            center_val = min(max_center, max(min_center, center_val))
            nlsf[k - 1] = center_val - (min_delta[k] >> 1)
            nlsf[k] = nlsf[k - 1] + min_delta[k]
    # fallback: insertion sort + push apart
    vals = sorted(int(x) for x in nlsf[:order])
    for i, v in enumerate(vals):
        nlsf[i] = v
    if nlsf[0] < min_delta[0]:
        nlsf[0] = min_delta[0]
    for i in range(1, order):
        nlsf[i] = max(int(nlsf[i]),
                      min(int(nlsf[i - 1]) + min_delta[i], 32767))
    if nlsf[order - 1] > 32768 - min_delta[order]:
        nlsf[order - 1] = 32768 - min_delta[order]
    for i in range(order - 2, -1, -1):
        if nlsf[i] > nlsf[i + 1] - min_delta[i + 1]:
            nlsf[i] = nlsf[i + 1] - min_delta[i + 1]


def _lsp2poly(lsp, pol, half_order: int) -> None:
    """Q16 polynomial build with the oracle's wrapping int32
    arithmetic (large LSP sets overflow by design)."""
    pol[0] = 65536
    pol[1] = _i32(-int(lsp[0]))
    for i in range(1, half_order):
        pol[i + 1] = _i32(
            _i32(pol[i - 1] * 2) - _round_mull(int(lsp[2 * i]), pol[i], 16)
        )
        for j in range(i, 1, -1):
            pol[j] = _i32(
                pol[j] + pol[j - 2]
                - _round_mull(int(lsp[2 * i]), pol[j - 1], 16)
            )
        pol[1] = _i32(pol[1] - int(lsp[2 * i]))


def _is_lpc_stable(lpc, order: int) -> bool:
    dc_resp = int(np.sum(lpc[:order]))
    if dc_resp > 4095:
        return False
    row = [int(x) * 4096 for x in lpc[:order]]  # Q24
    totalinvgain = 1 << 30
    k = order - 1
    while True:
        if abs(row[k]) > 16773022:
            return False
        rc = _i32(-(row[k] * 128))
        gaindiv = (1 << 30) - _mulh(rc, rc)
        totalinvgain = _i32(_mulh(totalinvgain, gaindiv) << 2)
        if k == 0:
            return totalinvgain >= 107374
        # approximate 1/gaindiv (the oracle's wrapping 32-bit forms)
        fbits = ilog(gaindiv)
        gain = ((1 << 29) - 1) // (gaindiv >> (fbits + 1 - 16))
        error = _i32((1 << 29)
                     - _i32((_i32(gaindiv << (15 + 16 - fbits))
                             * gain) >> 16))
        gain = _i32(_i32(gain << 16) + (_i32(error * gain) >> 13))
        nrow = [0] * k
        for j in range(k):
            x = _sat32(row[j] - _round_mull(row[k - j - 1], rc, 31))
            r = ((x * gain) >> (fbits - 1))
            r = (r + 1) >> 1
            if r != _i32(r):
                return False  # result overflows int32 => unstable
            nrow[j] = r
        row = nrow
        k -= 1


def _lsf2lpc(nlsf, lpcf, order: int, t) -> None:
    cosine = t["silk_cosine"]
    ordering = (t["silk_lsf_ordering_wb"] if order == 16
                else t["silk_lsf_ordering_nbmb"])
    lsp = [0] * order
    for k in range(order):
        index = int(nlsf[k]) >> 8
        offset = int(nlsf[k]) & 255
        k2 = int(ordering[k])
        v = int(cosine[index]) * 256
        v += (int(cosine[index + 1]) - int(cosine[index])) * offset
        lsp[k2] = (v + 4) >> 3
    half = order >> 1
    p = [0] * (half + 1)
    q = [0] * (half + 1)
    _lsp2poly(lsp, p, half)
    _lsp2poly(lsp[1:], q, half)
    lpc32 = [0] * order
    for k in range(half):
        p_tmp = _i32(p[k + 1] + p[k])
        q_tmp = _i32(q[k + 1] - q[k])
        lpc32[k] = _i32(-q_tmp - p_tmp)
        lpc32[order - k - 1] = _i32(q_tmp - p_tmp)

    lpc16 = [0] * order
    for it in range(10):
        maxabs = 0
        kmax = 0
        for j in range(order):
            x = abs(lpc32[j])
            if x > maxabs:
                maxabs = x
                kmax = j
        maxabs = (maxabs + 16) >> 5  # Q17 -> Q12
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_base = chirp = (
                65470 - ((maxabs - 32767) << 14)
                // ((maxabs * (kmax + 1)) >> 2)
            )
            for k in range(order):
                lpc32[k] = _round_mull(lpc32[k], chirp, 16)
                chirp = (chirp_base * chirp + 32768) >> 16
        else:
            break
    else:
        it = 10
    if it == 9 and maxabs > 32767:
        it = 10
    if it == 10:
        for k in range(order):
            x = (lpc32[k] + 16) >> 5
            lpc16[k] = max(-32768, min(32767, x))
            lpc32[k] = lpc16[k] * 32
    else:
        for k in range(order):
            lpc16[k] = (lpc32[k] + 16) >> 5

    for i in range(1, 17):
        if _is_lpc_stable(lpc16, order):
            break
        chirp_base = chirp = 65536 - (1 << i)
        for k in range(order):
            lpc32[k] = _round_mull(lpc32[k], chirp, 16)
            lpc16[k] = (lpc32[k] + 16) >> 5
            chirp = (chirp_base * chirp + 32768) >> 16

    for i in range(order):
        lpcf[i] = lpc16[i] / 4096.0
