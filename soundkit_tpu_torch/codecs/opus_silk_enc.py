"""RFC 6716 §4.2 SILK layer ENCODER (owned code, no libopus).

The mirror of the owned SILK decoder (opus_silk.py): LPC analysis +
LSF quantization against the extracted NLSF codebooks, open-loop
pitch search with the normative lag/contour coding, LTP codebook
search, subframe gain quantization, and a closed-loop excitation
quantizer that runs the decoder's synthesis arithmetic sample by
sample (rewhitening, LTP, LPC, the LCG sign dither and the quant
offset) so the encoder's reconstruction IS the decoder's output.

Every symbol is emitted through the exact interval the owned range
decoder reads (opus_enc_rc.RangeEncoder is its proven inverse), in
the exact read order of SilkDecoder._decode_frame; the NLSF
reconstruction, stabilization and LSF->LPC conversion are the
decoder's own functions, so the analysis filter used for the closed
loop equals the synthesis filter every conformant decoder derives.

Scope: mono, 20 ms frames, NB (8 kHz) / MB (12 kHz) / WB (16 kHz),
VBR with a feedback rate loop.  Together with the owned CELT encoder
(opus_celt_enc.py) this owns Opus encode in both coding layers.

Parity reference: the reference encodes via pure-Rust libopus-rs
(soundkit-opus/src/lib.rs:96-293, Cargo.toml:11-14); here the SILK
encode math is owned.

Port: ``OpusSilkEncoder`` takes ``native`` (default True), as
``OpusCeltEncoder`` does: True loads the port's build of
``native_src/src/silk_parse.cpp`` (``codecs/silk_native.NativeSilkEncoder``)
and raises when it cannot, where the JAX package falls back to the Python
encoder; False chooses the Python encoder. The rest is the JAX package's
code.
"""
from __future__ import annotations

import math

import numpy as np

from soundkit_tpu_torch.codecs.opus_enc_rc import RangeEncoder
from soundkit_tpu_torch.codecs.opus_silk import (
    LTP_ORDER,
    SILK_HISTORY,
    SILK_MAX_LAG,
    _lsf2lpc,
    _stabilize_lsf,
)
from soundkit_tpu_torch.codecs.opus_tables import tables


# ----------------------------------------------------------------------
# analysis helpers
# ----------------------------------------------------------------------

def _levinson(ac: np.ndarray, order: int) -> np.ndarray:
    """Levinson-Durbin; returns prediction coefficients a with
    x[n] ~= sum a_k x[n-k] (the decoder's positive-dot convention)."""
    a = np.zeros(order)
    err = ac[0]
    if err <= 0:
        return a
    for i in range(order):
        acc = ac[i + 1] - np.dot(a[:i], ac[i:0:-1])
        # reflection coefficient
        k = acc / err
        k = float(np.clip(k, -0.999, 0.999))
        new = a.copy()
        new[i] = k
        new[:i] = a[:i] - k * a[:i][::-1]
        a = new
        err *= 1.0 - k * k
        if err <= 0:
            break
    return a


def _cheb_eval(c, K: int, x: float) -> float:
    """C(x) = c[K] + 2*sum_{k=0}^{K-1} c[k]*T_{K-k}(x) via the
    Chebyshev recurrence (pure arithmetic, no libm — the C++ port
    evaluates the identical op sequence)."""
    t_prev = 1.0
    t_cur = x
    acc = c[K] + 2.0 * c[K - 1] * x
    for m in range(2, K + 1):
        t_next = 2.0 * x * t_cur - t_prev
        t_prev, t_cur = t_cur, t_next
        acc += 2.0 * c[K - m] * t_cur
    return acc


_NLSF_GRID = 1024


def _lpc_to_nlsf(a: np.ndarray, order: int) -> np.ndarray:
    """Prediction coeffs -> NLSF (Q15 normalized line spectral
    frequencies, 0..32768) via the P/Q symmetric decomposition and a
    deterministic cosine-grid sign scan + bisection in x = cos(w)
    (the classic LSF root finder; deflation per the standard
    P(z)=A(z)+z^-(N+1)A(1/z) construction).  No eigen solver — the
    same arithmetic runs in the native port."""
    K = order // 2
    A = [1.0] + [-float(a[k]) for k in range(order)] + [0.0]
    p = [0.0] * (K + 1)
    q = [0.0] * (K + 1)
    p[0] = 1.0
    q[0] = 1.0
    for k in range(1, K + 1):
        p[k] = A[k] + A[order + 1 - k] - p[k - 1]
        q[k] = A[k] - A[order + 1 - k] + q[k - 1]

    roots = []  # (omega, which)
    for which, c in ((0, p), (1, q)):
        xs = _NLSF_COS_GRID
        v_prev = _cheb_eval(c, K, xs[0])
        found = []
        for i in range(1, len(xs)):
            v = _cheb_eval(c, K, xs[i])
            if (v_prev < 0.0) != (v < 0.0) or v == 0.0:
                lo_x, hi_x = xs[i - 1], xs[i]
                lo_v = v_prev
                for _ in range(46):
                    mid = 0.5 * (lo_x + hi_x)
                    mv = _cheb_eval(c, K, mid)
                    if (lo_v < 0.0) != (mv < 0.0):
                        hi_x = mid
                    else:
                        lo_x = mid
                        lo_v = mv
                found.append(0.5 * (lo_x + hi_x))
            v_prev = v
        if len(found) != K:
            return np.array([])  # caller falls back to previous NLSF
        roots.extend((math.acos(max(-1.0, min(1.0, x))), which)
                     for x in found)
    roots.sort()
    # LSFs must interleave P,Q,P,Q,... in ascending frequency
    if any(w != (i % 2) for i, (_, w) in enumerate(roots)):
        return np.array([])
    nlsf = np.clip(np.round(np.array([r for r, _ in roots])
                            / math.pi * 32768.0),
                   1, 32767).astype(np.int64)
    for i in range(1, order):
        if nlsf[i] <= nlsf[i - 1]:
            nlsf[i] = nlsf[i - 1] + 1
    return nlsf


# descending x = cos(w) grid, w uniform over (0, pi); computed once and
# shared with the native port (pushed as a table) so both scan the
# same points
_NLSF_COS_GRID = [math.cos(math.pi * (i + 0.5) / _NLSF_GRID)
                  for i in range(_NLSF_GRID)]


def _cdf_cost_bits(cdf, sym: int) -> float:
    total = int(cdf[0])
    lo = int(cdf[sym]) if sym >= 1 else 0
    hi = int(cdf[sym + 1])
    return -math.log2(max(hi - lo, 1) / total)


# ----------------------------------------------------------------------
# core per-frame encoder (mono)
# ----------------------------------------------------------------------

class SilkEncoder:
    """Stateful mono SILK encoder for 20 ms frames at the internal
    rate (bandwidth 0=NB/8k, 1=MB/12k, 2=WB/16k).

    ``encode_superframe(rc, x)`` encodes one frame of ``flength``
    samples (float, +-1) into an open RangeEncoder and returns the
    encoder-side reconstruction (== the decoder's output for these
    bytes, 2-sample delayed like the decoder's emission grid)."""

    def __init__(self, bandwidth: int = 2, target_pulse: float = 3.0):
        t = tables()
        self.t = t
        self.bandwidth = bandwidth
        self.wb = bandwidth == 2
        self.order = 16 if self.wb else 10
        self.subframes = 4               # 20 ms
        self.sflength = 20 * (bandwidth + 2)
        self.flength = self.sflength * self.subframes
        self.target_pulse = target_pulse

        # decoder-mirror state (matches opus_silk.SilkFrame)
        self.log_gain = 0
        self.coded = False
        self.prev_voiced = False
        self.prev_nlsf = np.zeros(16, dtype=np.int64)
        self.output = np.zeros(2 * SILK_HISTORY)
        self.lpc_history = np.zeros(2 * SILK_HISTORY)

        # analysis-side input history (unquantized)
        self._xhist = np.zeros(SILK_MAX_LAG + self.order)

        # 2**(idx/...) linear gain table mirroring the decoder formula
        lin = []
        for idx in range(64):
            lg = ((idx * 0x1D1C71) >> 16) + 2090
            ipart = lg >> 7
            fpart = lg & 127
            lingain = (1 << ipart) + (
                (((-174 * fpart * (128 - fpart)) >> 16) + fpart)
                * ((1 << ipart) >> 7)
            )
            lin.append(lingain / 65536.0)
        self._lingain = np.array(lin)

    # -- parameter quantizers ------------------------------------------

    def _quant_gains(self, desired: np.ndarray):
        """Desired linear gains -> (symbols, effective gains) mirroring
        the decoder's absolute + delta state machine."""
        t = self.t
        syms = []
        gains = np.zeros(self.subframes)
        log_gain = self.log_gain
        for i in range(self.subframes):
            want = int(np.argmin(np.abs(self._lingain - desired[i])))
            if i == 0:
                # absolute (frame_num == 0 within 20 ms superframes)
                idx = want
                syms.append(("abs", idx >> 3, idx & 7))
                log_gain = idx
                if self.coded:
                    log_gain = max(log_gain, self.log_gain - 16)
            else:
                best_d, best_eff = 0, -1
                for d in range(41):
                    eff = min(max(max(2 * d - 16, log_gain + d - 4), 0), 63)
                    if best_eff < 0 or abs(eff - want) < abs(best_eff - want):
                        best_eff, best_d = eff, d
                syms.append(("delta", best_d))
                log_gain = best_eff
            gains[i] = self._lingain[log_gain]
            if i == 0:
                self._lg0 = log_gain
            self._lg_last = log_gain
        return syms, gains

    def _quant_nlsf(self, target: np.ndarray, voiced: bool):
        """Full NLSF quantization: stage-1 codebook search with exact
        stage-2 backward-prediction quantization per candidate.
        Returns (i1, I2 list, reconstructed+stabilized nlsf)."""
        t = self.t
        order = self.order
        wb = self.wb
        qstep = 9830 if wb else 11796
        codebooks = (t["silk_lsf_codebook_wb"] if wb
                     else t["silk_lsf_codebook_nbmb"])
        pred_tab = (t["silk_lsf_pred_weights_wb"] if wb
                    else t["silk_lsf_pred_weights_nbmb"])
        wsel_tab = (t["silk_lsf_weight_sel_wb"] if wb
                    else t["silk_lsf_weight_sel_nbmb"])

        def weights_for(cb):
            w = np.zeros(order, dtype=np.int64)
            for i in range(order):
                cur = int(cb[i])
                prev = int(cb[i - 1]) if i else 0
                nxt = int(cb[i + 1]) if i + 1 < order else 256
                weight_sq = (1024 // (cur - prev) + 1024 // (nxt - cur)) << 16
                ipart = weight_sq.bit_length()
                fpart = (weight_sq >> (ipart - 8)) & 127
                y = (32768 if (ipart & 1) else 46214) >> ((32 - ipart) >> 1)
                w[i] = y + ((213 * fpart * y) >> 16)
            return w

        def f_res(i2: int) -> int:
            v = i2 * 1024
            if i2 < 0:
                v += 102
            elif i2 > 0:
                v -= 102
            return (v * qstep) >> 16

        best = None
        for i1 in range(32):
            cb = codebooks[i1]
            w = weights_for(cb)
            wsel = wsel_tab[i1]
            # desired backward-prediction residuals
            res_des = [
                (int(target[i]) - int(cb[i]) * 128) * int(w[i]) / 16384.0
                for i in range(order)
            ]
            res_q = np.zeros(order, dtype=np.int64)
            i2s = np.zeros(order, dtype=np.int64)
            for i in range(order - 1, -1, -1):
                pred = 0
                if i + 1 < order:
                    pred = (int(res_q[i + 1])
                            * int(pred_tab[wsel[i]][i])) >> 8
                d = res_des[i] - pred
                guess = int(round(d * 65536.0 / (1024.0 * qstep)))
                bi, bv = 0, None
                for c in (guess - 1, guess, guess + 1):
                    c = max(-10, min(10, c))
                    v = f_res(c) + pred
                    if bv is None or abs(v - res_des[i]) < abs(bv - res_des[i]):
                        bv, bi = v, c
                i2s[i] = bi
                res_q[i] = f_res(bi) + pred
            # reconstruct exactly as the decoder does
            nlsf = np.zeros(order, dtype=np.int64)
            for i in range(order):
                num = int(res_q[i]) * 16384
                weight = int(w[i])
                value = int(cb[i]) * 128 + (
                    -((-num) // weight) if num < 0 else num // weight
                )
                nlsf[i] = min(max(value, 0), 32767)
            err = float(np.sum((nlsf - target) ** 2))
            if best is None or err < best[0]:
                best = (err, i1, i2s.copy(), nlsf.copy())
        _, i1, i2s, nlsf = best
        spacing = (t["silk_lsf_min_spacing_wb"] if wb
                   else t["silk_lsf_min_spacing_nbmb"])
        _stabilize_lsf(nlsf, order, spacing)
        return i1, i2s, nlsf

    # -- pitch / LTP ----------------------------------------------------

    def _pitch_search(self, res: np.ndarray):
        """Open-loop normalized autocorrelation over the LPC residual;
        ``res`` covers [SILK_MAX_LAG history | current frame].
        Returns (lag, normalized correlation)."""
        t = self.t
        lo = int(t["silk_pitch_min_lag"][self.bandwidth])
        scale = int(t["silk_pitch_scale"][self.bandwidth])
        hi = min(int(t["silk_pitch_max_lag"][self.bandwidth]),
                 lo + 32 * scale - 1)
        f = res[SILK_MAX_LAG:]
        n = len(f)
        e0 = float(np.dot(f, f)) + 1e-9
        best_lag, best_c = lo, 0.0
        for lag in range(lo, hi + 1):
            p = res[SILK_MAX_LAG - lag:SILK_MAX_LAG - lag + n]
            num = float(np.dot(f, p))
            den = math.sqrt(e0 * (float(np.dot(p, p)) + 1e-9))
            c = num / den if den > 0 else 0.0
            if c > best_c:
                best_c, best_lag = c, lag
        # sub-multiple preference against octave errors
        for div in (2, 3):
            cand = best_lag // div
            if cand >= lo:
                p = res[SILK_MAX_LAG - cand:SILK_MAX_LAG - cand + n]
                num = float(np.dot(f, p))
                den = math.sqrt(e0 * (float(np.dot(p, p)) + 1e-9))
                c = num / den if den > 0 else 0.0
                if c > 0.85 * best_c:
                    best_lag, best_c = cand, c
                    break
        return best_lag, best_c

    def _contour_search(self, res: np.ndarray, lag: int):
        """Per-subframe lag refinement + normative contour selection.

        Refines the frame-level lag per subframe by local correlation
        search, then picks the (primary lag, contour index) pair whose
        decoder-side per-subframe lags (clip(primary+offset)) best
        match, energy-weighted.  Returns (primary, contour_index,
        per-subframe lag array) with lags exactly as the decoder will
        reconstruct them (opus_silk.py:274-291)."""
        t = self.t
        lo = int(t["silk_pitch_min_lag"][self.bandwidth])
        scale = int(t["silk_pitch_scale"][self.bandwidth])
        hi_abs = lo + 32 * scale - 1
        hi = int(t["silk_pitch_max_lag"][self.bandwidth])
        offs = (t["silk_pitch_offset_nb20ms"] if self.bandwidth == 0
                else t["silk_pitch_offset_mbwb20ms"]).astype(np.int64)
        sfl = self.sflength
        sub_lag = np.zeros(self.subframes, dtype=np.int64)
        sub_w = np.zeros(self.subframes)
        for i in range(self.subframes):
            r0 = SILK_MAX_LAG + i * sfl
            f = res[r0:r0 + sfl]
            e0 = float(np.dot(f, f)) + 1e-9
            best_l, best_c = lag, -1.0
            for cand in range(max(lo, lag - 10), min(hi, lag + 10) + 1):
                p = res[r0 - cand:r0 - cand + sfl]
                num = float(np.dot(f, p))
                den = math.sqrt(e0 * (float(np.dot(p, p)) + 1e-9))
                c = num / den if den > 0 else 0.0
                if c > best_c:
                    best_c, best_l = c, cand
            sub_lag[i] = best_l
            sub_w[i] = e0 * max(best_c, 0.0)
        sub_w = sub_w / (np.sum(sub_w) + 1e-12)
        best = None
        for ci in range(len(offs)):
            p0 = int(round(float(np.dot(sub_w, sub_lag - offs[ci]))))
            for p in (p0 - 1, p0, p0 + 1):
                p = max(lo, min(hi_abs, p))
                eff = np.clip(p + offs[ci], lo, hi)
                err = float(np.dot(sub_w, (eff - sub_lag) ** 2))
                if best is None or err < best[0]:
                    best = (err, p, ci, eff.copy())
        _, primary, ci, eff = best
        return primary, ci, eff

    def _ltp_select(self, res: np.ndarray, lags: np.ndarray, corr: float):
        """Choose the LTP filter set by periodicity and the best
        codebook entry per subframe (least-squares over the open-loop
        residual).  Returns (period_index, [subframe tap indices])."""
        t = self.t
        period = 0 if corr < 0.65 else (1 if corr < 0.8 else 2)
        books = (t["silk_ltp_filter0_taps"], t["silk_ltp_filter1_taps"],
                 t["silk_ltp_filter2_taps"])[period]
        sfl = self.sflength
        idxs = []
        for i in range(self.subframes):
            r0 = SILK_MAX_LAG + i * sfl
            lag = int(lags[i])
            target = res[r0:r0 + sfl]
            # predictor matrix rows: res[j - lag + 2 - k], k = 0..4
            P = np.stack([
                res[r0 - lag + 2 - k:r0 - lag + 2 - k + sfl]
                for k in range(LTP_ORDER)
            ])  # [5, sfl]
            G = P @ P.T
            b = P @ target
            cand = books.astype(np.float64) / 128.0  # [n, 5]
            # E = t't - 2 c'b + c'Gc per codebook row
            e = -2.0 * cand @ b + np.einsum("nk,kl,nl->n", cand, G, cand)
            idxs.append(int(np.argmin(e)))
        return period, idxs

    # -- excitation quantizer (the decoder's synthesis, closed loop) ----

    def _quantize_frame(self, x: np.ndarray, gains: np.ndarray,
                        lpc: np.ndarray, voiced: bool, lags: np.ndarray,
                        ltptaps: np.ndarray, ltpscale: float,
                        qoff: int, seed: int):
        """Run the decoder's subframe synthesis with the quantizer in
        the loop.  Mutates self.output / self.lpc_history exactly as
        SilkDecoder._decode_frame does and returns the stored
        excitation values (pre-LCG-flip integers, decoder order)."""
        order = self.order
        sfl = self.sflength
        flength = self.flength
        residual = np.zeros(SILK_MAX_LAG + flength)
        dst = self.output
        lpch = self.lpc_history
        base = SILK_HISTORY
        values = np.zeros(flength, dtype=np.int64)
        coeff = lpc

        for i in range(self.subframes):
            r0 = SILK_MAX_LAG + i * sfl
            d0 = base + i * sfl
            g = gains[i]
            if voiced:
                out_end = -i * sfl          # nlsf_interp_factor == 4
                rescale = ltpscale
                start = -int(lags[i]) - LTP_ORDER // 2
                for j in range(start, out_end):
                    v = dst[d0 + j]
                    v -= float(np.dot(coeff[:order],
                                      dst[d0 + j - order:d0 + j][::-1]))
                    residual[r0 + j] = (
                        min(max(v, -1.0), 1.0) * rescale / g
                    )
                if out_end:
                    rescale2 = gains[i - 1] / g
                    residual[r0 + out_end:r0] *= rescale2
            for j in range(sfl):
                lpc_pred = float(np.dot(coeff[:order],
                                        lpch[d0 + j - order:d0 + j][::-1]))
                if voiced:
                    off = r0 + j - int(lags[i]) + LTP_ORDER // 2
                    ltp_pred = float(np.dot(
                        ltptaps[i],
                        residual[off - LTP_ORDER + 1:off + 1][::-1]))
                else:
                    ltp_pred = 0.0
                res_des = (x[i * sfl + j] - lpc_pred) / g
                e_des = res_des - ltp_pred
                # LCG dither state advances exactly like the decoder's
                seed = (196314165 * seed + 907633515) & 0xFFFFFFFF
                flip = bool(seed & 0x80000000)
                d23 = (-e_des if flip else e_des) * 8388608.0
                guess = int(math.floor((d23 - qoff) / 256.0))
                bv, be = 0, abs(qoff - d23)
                for c in (guess - 1, guess, guess + 1, guess + 2):
                    c = max(-4095, min(4095, c))
                    e23 = c * 256 + qoff
                    if c < 0:
                        e23 += 20
                    elif c > 0:
                        e23 -= 20
                    if abs(e23 - d23) < be:
                        be, bv = abs(e23 - d23), c
                seed = (seed + bv) & 0xFFFFFFFF
                e23 = bv * 256 + qoff
                if bv < 0:
                    e23 += 20
                elif bv > 0:
                    e23 -= 20
                e_q = (-e23 if flip else e23) / 8388608.0
                values[i * sfl + j] = bv
                residual[r0 + j] = e_q + ltp_pred
                s = residual[r0 + j] * g + lpc_pred
                lpch[d0 + j] = s
                dst[d0 + j] = min(max(s, -1.0), 1.0)

        out = dst[base - 2:base + flength - 2].copy()
        self.lpc_history[:SILK_HISTORY] = \
            self.lpc_history[flength:flength + SILK_HISTORY]
        self.output[:SILK_HISTORY] = \
            self.output[flength:flength + SILK_HISTORY]
        return values, out

    # -- symbol emission -------------------------------------------------

    def _encode_excitation(self, rc: RangeEncoder, values: np.ndarray,
                           seed0: int, voiced: bool, qoffset_high: int):
        t = self.t
        active = 1
        rc.enc_cdf(seed0, t["silk_model_lcg_seed"])
        shellblocks = int(
            t["silk_shell_blocks"][self.bandwidth][self.subframes >> 2]
        )
        assert shellblocks * 16 == self.flength
        mags = np.abs(values).astype(np.int64)

        # per-block lsb shift so the shell total stays <= 16
        lsbcount = np.zeros(shellblocks, dtype=np.int64)
        tops = np.zeros(shellblocks * 16, dtype=np.int64)
        pulses = np.zeros(shellblocks, dtype=np.int64)
        for b in range(shellblocks):
            blk = mags[16 * b:16 * (b + 1)]
            lsb = 0
            while int(np.sum(blk >> lsb)) > 16:
                lsb += 1
            lsbcount[b] = lsb
            tops[16 * b:16 * (b + 1)] = blk >> lsb
            pulses[b] = int(np.sum(blk >> lsb))

        # rate level: exact entropy cost of the count symbols
        pc_model = t["silk_model_pulse_count"]

        def count_syms(b):
            lsb, p = int(lsbcount[b]), int(pulses[b])
            if lsb == 0:
                return [(None, p)]  # (model override, symbol)
            syms = [(None, 17)]
            syms += [(9, 17)] * (lsb - 1)
            syms.append((10 if lsb == 10 else 9, p))
            return syms

        best_rl, best_cost = 0, None
        for rl in range(9):
            c = 0.0
            for b in range(shellblocks):
                for model, sym in count_syms(b):
                    c += _cdf_cost_bits(pc_model[rl if model is None
                                                 else model], sym)
            if best_cost is None or c < best_cost:
                best_cost, best_rl = c, rl
        rc.enc_cdf(best_rl, t["silk_model_exc_rate"][1 if voiced else 0])
        for b in range(shellblocks):
            for model, sym in count_syms(b):
                rc.enc_cdf(sym, pc_model[best_rl if model is None
                                         else model])

        # shell tree locations (decoder's count_children order)
        loc_model = t["silk_model_pulse_location"]

        def enc_split(model: int, left: int, total: int):
            if total == 0:
                return
            off = ((total - 1 + 5) * (total - 1)) >> 1
            rc.enc_cdf(left, loc_model[model][off:])

        for b in range(shellblocks):
            if pulses[b] == 0:
                continue
            tb = tops[16 * b:16 * (b + 1)]
            h8 = (int(tb[:8].sum()), int(tb[8:].sum()))
            enc_split(0, h8[0], int(pulses[b]))
            for bi, bv in enumerate(h8):
                q4 = (int(tb[8 * bi:8 * bi + 4].sum()),
                      int(tb[8 * bi + 4:8 * bi + 8].sum()))
                enc_split(1, q4[0], bv)
                for ci, cv in enumerate(q4):
                    base = 8 * bi + 4 * ci
                    p2 = (int(tb[base:base + 2].sum()),
                          int(tb[base + 2:base + 4].sum()))
                    enc_split(2, p2[0], cv)
                    for di, dv in enumerate(p2):
                        k = base + 2 * di
                        enc_split(3, int(tb[k]), dv)

        # LSBs, MSB-first per sample
        lsb_model = t["silk_model_excitation_lsb"]
        for i in range(shellblocks * 16):
            lsb = int(lsbcount[i >> 4])
            for b in range(lsb):
                bit = (int(mags[i]) >> (lsb - 1 - b)) & 1
                rc.enc_cdf(bit, lsb_model)

        # signs (decoder: symbol 0 negates)
        sign_model = t["silk_model_excitation_sign"]
        for i in range(shellblocks * 16):
            if mags[i] != 0:
                m = sign_model[active + int(voiced)][qoffset_high][
                    min(int(pulses[i >> 4]), 6)]
                rc.enc_cdf(0 if values[i] < 0 else 1, m)

    # -- frame entry ------------------------------------------------------

    def encode_superframe(self, rc: RangeEncoder, x: np.ndarray,
                          seed0: int = 0) -> np.ndarray:
        """Encode one mono 20 ms frame (header flags + frame payload)
        and return the reconstruction ([flength] float, the decoder's
        2-sample-delayed grid)."""
        # header: VAD flag + LBRR flag (mono, one frame per packet)
        rc.enc_bit_logp(1, 1)
        rc.enc_bit_logp(0, 1)
        return self._encode_frame(rc, x, seed0)

    def _encode_frame(self, rc: RangeEncoder, x: np.ndarray,
                      seed0: int = 0) -> np.ndarray:
        """Frame payload only (no superframe header bits): analysis,
        parameter quantization, closed-loop excitation, emission."""
        t = self.t
        order = self.order
        x = np.asarray(x, dtype=np.float64)
        assert x.shape == (self.flength,)

        # ----- analysis (open loop, on the unquantized input) -----
        xh = np.concatenate([self._xhist, x])
        # windowed autocorrelation over history tail + frame
        awin = xh[-(self.flength + order):]
        w = np.hanning(len(awin))
        xe = awin * w
        ac = np.array([
            float(np.dot(xe[: len(xe) - k], xe[k:])) for k in range(order + 1)
        ])
        ac[0] = ac[0] * 1.0001 + 1e-9
        a_raw = _levinson(ac, order)
        nlsf_t = _lpc_to_nlsf(a_raw, order)
        if nlsf_t.size == 0:
            nlsf_t = self.prev_nlsf[:order].copy()
            if not self.coded:
                nlsf_t = np.linspace(
                    2048, 30720, order).astype(np.int64)
        i1, i2s, nlsf_q = self._quant_nlsf(nlsf_t, True)
        lpc = np.zeros(16)
        _lsf2lpc(nlsf_q, lpc, order, t)

        # open-loop residual for pitch/LTP/gain decisions
        res_ol = np.zeros(SILK_MAX_LAG + self.flength)
        for j in range(-SILK_MAX_LAG, self.flength):
            idx = len(self._xhist) + j
            res_ol[SILK_MAX_LAG + j] = xh[idx] - float(
                np.dot(lpc[:order], xh[idx - order:idx][::-1]))

        lag, corr = self._pitch_search(res_ol)
        voiced = corr > 0.55
        period, tap_idx = (0, [0] * self.subframes)
        ltptaps = np.zeros((self.subframes, LTP_ORDER))
        primary, contour = lag, 0
        lags = np.full(self.subframes, lag, dtype=np.int64)
        if voiced:
            primary, contour, lags = self._contour_search(res_ol, lag)
            period, tap_idx = self._ltp_select(res_ol, lags, corr)
            books = (t["silk_ltp_filter0_taps"],
                     t["silk_ltp_filter1_taps"],
                     t["silk_ltp_filter2_taps"])[period]
            for i in range(self.subframes):
                ltptaps[i] = books[tap_idx[i]] / 128.0

        # subframe gains from the open-loop excitation energy
        sfl = self.sflength
        desired = np.zeros(self.subframes)
        for i in range(self.subframes):
            seg = res_ol[SILK_MAX_LAG + i * sfl:SILK_MAX_LAG + (i + 1) * sfl]
            if voiced:
                pred = res_ol[SILK_MAX_LAG + i * sfl - int(lags[i]):
                              SILK_MAX_LAG + (i + 1) * sfl - int(lags[i])]
                g_ltp = float(np.dot(ltptaps[i], ltptaps[i])) ** 0.5
                seg = seg - min(1.0, g_ltp) * pred * (
                    float(np.dot(seg, pred))
                    / (float(np.dot(pred, pred)) + 1e-9))
            rms = float(np.sqrt(np.mean(seg * seg) + 1e-12))
            desired[i] = max(rms * 32768.0 / self.target_pulse, 1.0)
        gain_syms, gains = self._quant_gains(desired)

        qoffset_high = 0
        ftype = (2 if voiced else 0) | qoffset_high
        rc.enc_cdf(ftype, t["silk_model_frame_type_active"])

        # gains
        for i, sym in enumerate(gain_syms):
            if sym[0] == "abs":
                sigtype = 2 if voiced else 1
                rc.enc_cdf(sym[1], t["silk_model_gain_highbits"][sigtype])
                rc.enc_cdf(sym[2], t["silk_model_gain_lowbits"])
            else:
                rc.enc_cdf(sym[1], t["silk_model_gain_delta"])

        # LSF stage 1 + stage 2 + interpolation offset
        rc.enc_cdf(i1, t["silk_model_lsf_s1"]
                   [1 if self.wb else 0][1 if voiced else 0])
        sel = (t["silk_lsf_s2_model_sel_wb"] if self.wb
               else t["silk_lsf_s2_model_sel_nbmb"])[i1]
        for i in range(order):
            i2 = int(i2s[i])
            bsym = max(-4, min(4, i2))
            rc.enc_cdf(bsym + 4, t["silk_model_lsf_s2"][sel[i]])
            if bsym == -4:
                rc.enc_cdf(-4 - i2, t["silk_model_lsf_s2_ext"])
            elif bsym == 4:
                rc.enc_cdf(i2 - 4, t["silk_model_lsf_s2_ext"])
        rc.enc_cdf(4, t["silk_model_lsf_interpolation_offset"])

        ltpscale = 15565.0 / 16384.0
        if voiced:
            # absolute lag (frame 0 of every 20 ms superframe)
            lo = int(t["silk_pitch_min_lag"][self.bandwidth])
            scale = int(t["silk_pitch_scale"][self.bandwidth])
            primary = max(lo, min(primary, lo + 32 * scale - 1))
            high, low = divmod(primary - lo, scale)
            low_models = (t["silk_model_pitch_lowbits_nb"],
                          t["silk_model_pitch_lowbits_mb"],
                          t["silk_model_pitch_lowbits_wb"])
            rc.enc_cdf(high, t["silk_model_pitch_highbits"])
            rc.enc_cdf(low, low_models[self.bandwidth])
            rc.enc_cdf(contour, t["silk_model_pitch_contour_nb20ms"]
                       if self.bandwidth == 0
                       else t["silk_model_pitch_contour_mbwb20ms"])
            filter_sel = (t["silk_model_ltp_filter0_sel"],
                          t["silk_model_ltp_filter1_sel"],
                          t["silk_model_ltp_filter2_sel"])
            rc.enc_cdf(period, t["silk_model_ltp_filter"])
            for i in range(self.subframes):
                rc.enc_cdf(tap_idx[i], filter_sel[period])
            rc.enc_cdf(0, t["silk_model_ltp_scale_index"])
            ltpscale = int(t["silk_ltp_scale_factor"][0]) / 16384.0

        # ----- closed-loop quantization (the decoder's synthesis) -----
        qoff = int(t["silk_quant_offset"][1 if voiced else 0][qoffset_high])
        values, recon = self._quantize_frame(
            x, gains, lpc, voiced, lags, ltptaps, ltpscale, qoff, seed0)

        self._encode_excitation(rc, values, seed0, voiced, qoffset_high)

        # advance decoder-mirror + analysis state
        self.prev_nlsf[:order] = nlsf_q
        self.prev_voiced = voiced
        self.log_gain = self._lg_last
        self.coded = True
        keep = SILK_MAX_LAG + self.order
        self._xhist = np.concatenate([self._xhist, x])[-keep:]
        return values, recon


# ----------------------------------------------------------------------
# stereo (mid/side) frame encoder
# ----------------------------------------------------------------------

class SilkStereoEncoder:
    """Stereo SILK encoder: mid/side split with the normative
    prediction-weight coding, one mid + one side frame per packet.

    Mirrors SilkDecoder's stereo read order exactly (opus_silk.py:
    106-124 header flags, 187-203 weights, 156-175 unmix): header VAD/
    LBRR flags for both channels, stereo weight symbols, mid frame,
    side frame.  The side target is computed against the DECODED mid
    (closed loop across channels) and the decoder's 8 ms weight
    interpolation, so the unmixed L/R equals the encoder's intent."""

    def __init__(self, bandwidth: int = 2, target_pulse: float = 3.0):
        self.mid = SilkEncoder(bandwidth, target_pulse)
        self.side = SilkEncoder(bandwidth, target_pulse)
        self.bandwidth = bandwidth
        self.flength = self.mid.flength
        self.t = self.mid.t
        self.w = [0.0, 0.0]          # last coded [w_p0, w_m] (decoder scale)
        self._mhist = np.zeros(2)    # true mid, last 2 samples
        self._dhist = np.zeros(2)    # true half-difference, last 2

    @property
    def target_pulse(self) -> float:
        return self.mid.target_pulse

    @target_pulse.setter
    def target_pulse(self, v: float) -> None:
        self.mid.target_pulse = v
        self.side.target_pulse = v

    def _quant_weight(self, target_q13: float):
        """Nearest representable stereo weight: (value_q13, wi, ws)."""
        wtab = self.t["silk_stereo_weights"]
        best = None
        for wi in range(15):
            lo, hi = int(wtab[wi]), int(wtab[wi + 1])
            step = ((hi - lo) * 6554) >> 16
            for ws in range(5):
                v = lo + step * (ws * 2 + 1)
                if best is None or abs(v - target_q13) < abs(best[0]
                                                             - target_q13):
                    best = (v, wi, ws)
        return best

    def encode_superframe(self, rc: RangeEncoder, xl: np.ndarray,
                          xr: np.ndarray, seed0: int = 0) -> None:
        t = self.t
        fl = self.flength
        xl = np.asarray(xl, dtype=np.float64)
        xr = np.asarray(xr, dtype=np.float64)
        assert xl.shape == (fl,) and xr.shape == (fl,)
        m = 0.5 * (xl + xr)
        d = 0.5 * (xl - xr)

        # header: VAD + LBRR per channel (both active, no LBRR)
        for _ in range(2):
            rc.enc_bit_logp(1, 1)
            rc.enc_bit_logp(0, 1)

        # ----- weight estimation (open loop, true mid) -----
        # unmix grid k=0..fl-1: m1[k]=m[k-1], p0[k]=lowpass centered
        # at k-1, target dd[k]=d[k-1]
        mx = np.concatenate([self._mhist, m])      # m[-2..fl)
        dx = np.concatenate([self._dhist, d])
        m1 = mx[1:fl + 1]
        p0 = 0.25 * (mx[:fl] + 2.0 * mx[1:fl + 1] + mx[2:fl + 2])
        dd = dx[1:fl + 1]
        G = np.array([[float(np.dot(m1, m1)), float(np.dot(m1, p0))],
                      [float(np.dot(m1, p0)), float(np.dot(p0, p0))]])
        b = np.array([float(np.dot(m1, dd)), float(np.dot(p0, dd))])
        try:
            wm, wp = np.linalg.solve(G + 1e-9 * np.eye(2), b)
        except np.linalg.LinAlgError:
            wm, wp = 0.0, 0.0
        w1v, wi1, ws1 = self._quant_weight(
            float(np.clip(wm * 8192.0, -13732, 13732)))
        w0v, wi0, ws0 = self._quant_weight(
            float(np.clip(wp * 8192.0 + w1v, -13732, 13732)))
        n_sym = 5 * (wi0 // 3) + (wi1 // 3)
        rc.enc_cdf(n_sym, t["silk_model_stereo_s1"])
        rc.enc_cdf(wi0 % 3, t["silk_model_stereo_s2"])
        rc.enc_cdf(ws0, t["silk_model_stereo_s3"])
        rc.enc_cdf(wi1 % 3, t["silk_model_stereo_s2"])
        rc.enc_cdf(ws1, t["silk_model_stereo_s3"])
        # (mid-only flag is only coded when the side VAD flag is 0)
        w_new = [(w0v - w1v) / 8192.0, w1v / 8192.0]

        # ----- mid frame -----
        self.mid._encode_frame(rc, m, seed0)

        # ----- side target against the decoded mid + interpolation ---
        # decoded mid at relative position t' lives at
        # mid.output[SILK_HISTORY - fl + t'] after the history shift
        base = SILK_HISTORY - fl
        ms = self.mid.output[base - 2:base + fl]      # t' = -2..fl-1
        ms = np.concatenate([ms, ms[-1:]])            # extrapolate t'=fl
        n1 = int(t["silk_stereo_interp_len"][self.bandwidth])
        k = np.arange(1, fl + 1, dtype=np.float64)    # k = t'+1
        w0p, w1p = self.w
        i0 = np.where(k < n1, w0p + k * (w_new[0] - w0p) / n1, w_new[0])
        i1 = np.where(k < n1, w1p + k * (w_new[1] - w1p) / n1, w_new[1])
        ms_t = ms[2:fl + 2]                           # t' = 0..fl-1
        p0_dec = 0.25 * (ms[1:fl + 1] + 2.0 * ms[2:fl + 2] + ms[3:fl + 3])
        x_side = d - i1 * ms_t - i0 * p0_dec

        # ----- side frame -----
        self.side._encode_frame(rc, x_side, seed0)

        self.w = w_new
        self._mhist = m[-2:].copy()
        self._dhist = d[-2:].copy()


# ----------------------------------------------------------------------
# 48 kHz Opus packet encoder (SILK-only modes)
# ----------------------------------------------------------------------

class OpusSilkEncoder:
    """Opus packet encoder, SILK-only mono modes (NB/MB/WB, 20 ms
    code-0 VBR packets) — the voice counterpart of OpusCeltEncoder.

    push() buffers float PCM at 48 kHz, decimates to the SILK
    internal rate with a carried-history polyphase FIR, and emits one
    packet per complete 20 ms frame with a feedback rate loop nudging
    the per-frame gain floor toward ``bit_rate``."""

    _CONFIGS = {0: 1, 1: 5, 2: 9}   # 20 ms TOC configs per bandwidth

    def __init__(self, bandwidth: str = "wb", bit_rate: int = 24000,
                 channels: int = 1, native: bool = True):
        if channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        bw = {"nb": 0, "mb": 1, "wb": 2}[bandwidth]
        self.bandwidth = bw
        self.channels = channels
        self.rate = (8000, 12000, 16000)[bw]
        self.decim = 48000 // self.rate
        self.bit_rate = bit_rate
        self._enc = (SilkEncoder(bw) if channels == 1
                     else SilkStereoEncoder(bw))
        # native frame encoder (byte-identical C++ port); a library
        # that fails to build or load raises
        self._native = None
        if native:
            from soundkit_tpu_torch.codecs.silk_native import NativeSilkEncoder
            self._native = NativeSilkEncoder(bw, channels)
        self.frame_size = 960            # 20 ms at 48 kHz
        self._toc = (self._CONFIGS[bw] << 3) | (4 if channels == 2 else 0)
        # anti-alias decimation FIR: Hamming-windowed sinc, linear
        # phase, unity DC gain (no scipy dependency)
        taps = 24 * self.decim
        n = np.arange(taps + 1) - taps / 2.0
        cutoff = 0.92 / self.decim          # fraction of Nyquist
        h = np.sinc(cutoff * n) * np.hamming(taps + 1)
        self._fir = h / np.sum(h)
        self._hist48 = np.zeros((taps, channels))
        self._pend = np.zeros((0, channels))
        self._lambda = 1.0               # rate-loop gain multiplier

    def _decimate(self, x48: np.ndarray) -> np.ndarray:
        """[n, ch] 48 kHz -> [n/decim, ch] at the internal rate."""
        buf = np.concatenate([self._hist48, x48], axis=0)
        n_out = len(x48) // self.decim
        if n_out:
            y = np.stack([
                np.convolve(buf[:, c], self._fir, mode="valid")[
                    self.decim - 1::self.decim][:n_out]
                for c in range(self.channels)
            ], axis=1)
        else:
            y = np.zeros((0, self.channels))
        self._hist48 = buf[len(buf) - len(self._fir) + 1:]
        return y

    def push(self, pcm: np.ndarray):
        pcm = np.asarray(pcm, dtype=np.float64)
        pcm = pcm.reshape(-1, self.channels)
        if len(pcm) % self.decim:
            pad = self.decim - len(pcm) % self.decim
            pcm = np.concatenate(
                [pcm, np.zeros((pad, self.channels))], axis=0)
        self._pend = np.concatenate(
            [self._pend, self._decimate(pcm)], axis=0)
        out = []
        fl = self._enc.flength
        target_bits = self.bit_rate * 0.02
        while len(self._pend) >= fl:
            frame = self._pend[:fl]
            self._pend = self._pend[fl:]
            tp = float(np.clip(3.0 * self._lambda, 0.6, 24.0))
            if self._native is not None:
                payload = self._native.encode_frame(frame, tp)
            else:
                self._enc.target_pulse = tp
                rc = RangeEncoder(1275)
                if self.channels == 1:
                    self._enc.encode_superframe(rc, frame[:, 0])
                else:
                    self._enc.encode_superframe(rc, frame[:, 0],
                                                frame[:, 1])
                rc.finalize()
                payload = bytes(rc.buf[:rc.offs])
            out.append(bytes([self._toc]) + payload)
            bits = len(payload) * 8
            # feedback VBR loop: too many bits -> lower the pulse
            # target (larger gains -> smaller excitation values)
            self._lambda *= (max(target_bits, 1.0) / bits) ** 0.25
            self._lambda = float(np.clip(self._lambda, 0.1, 10.0))
        return out

    def flush(self):
        if len(self._pend) == 0:
            return []
        need = self._enc.flength - len(self._pend)
        return self.push(np.zeros(((need + 1) * self.decim,
                                   self.channels)))
