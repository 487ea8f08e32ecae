"""RFC 6716 §4.3 CELT layer ENCODER (owned code, no libopus).

The mirror of the owned decoder (opus_celt.py): forward low-overlap
MDCT + pre-emphasis, band energy quantization (Laplace coarse + raw
fine/finalize bits), the same bit-allocation interpolation (reused
from the decoder through a decision-injecting coder adapter so the
bit accounting is symmetric by construction), PVQ band quantization
with theta splitting (triangular / uniform / step pdfs), stereo
mid/side splitting and intensity projection, and spreading rotation.

Encoder decisions (all stream-valid, each encoded through the exact
interval the decoder reads): transient detection with carried
inter-frame context feeding short MDCT blocks, content-adaptive
allocation trim (energy-weighted spectral slope,
``alloc_trim_analysis``), per-band dynalloc boosts toward the
frame's spectral peaks (``dynalloc_analysis``) — together worth
~9 dB mean premix SNR over the fixed trim-5/no-boost round-3
encoder, putting the owned path ~4 dB ABOVE the libopus shim at the
same measured kbps (benchmarks/PREMIX_BENCH.json).  Spread NORMAL,
no comb postfilter, dual-stereo off; CBR packets.  The encoder
reconstructs the decoded spectrum as it goes (libopus-style
resynthesis) so fold sources and energy predictors stay in lockstep
with any conformant decoder.  Hooks (``trim_fn``/``boosts_fn``/
``tf_fn``/``spread_fn``/``intra_fn``) override any decision for
experiments.

Parity reference: the reference encodes via pure-Rust libopus-rs
(soundkit-opus/src/lib.rs:96-293, Cargo.toml:11-14); here the CELT
encode math is owned.

Port: ``OpusCeltEncoder(native=True)`` loads the port's build of
``native_src/src/celt_parse.cpp`` (``codecs/celt_native.NativeCeltEncoder``)
and raises when it cannot, where the JAX package falls back to the Python
encoder; ``native=False`` chooses the Python encoder. The rest is the JAX
package's code.
"""
from __future__ import annotations

import math

import numpy as np

from soundkit_tpu_torch.codecs.opus_celt import (
    BITRES,
    CELT_EMPH_COEFF,
    CeltDecoder,
    NB_BANDS,
    OVERLAP,
    SPREAD_NORMAL,
    _bitexact_cos,
    _bitexact_log2tan,
    _deinterleave_hadamard,
    _exp_rotation,
    _extract_collapse_mask,
    _frac_mul16,
    _get_pulses,
    _haar1,
    _imdct_matrix,
    _interleave_hadamard,
    _lcg,
    _renormalise,
    _sdiv,
)
from soundkit_tpu_torch.codecs.opus_enc_rc import RangeEncoder, laplace_encode


class _AllocCoder:
    """Adapter injected into the decoder's ``_compute_allocation``:
    each of its three in-band reads (band skip, intensity, dual
    stereo) encodes this encoder's scripted decision and returns it,
    so the shared allocation code drives both directions with one
    bit-exact control flow.

    ``skip_to`` scripts the band-skip loop: trailing bands above it
    are skipped (their bits redistribute to the occupied spectrum —
    the big win on band-limited sources, where static allocation
    would otherwise burn CBR bits coding empty bands).  The skip
    question for band j arrives without band context, but the loop
    walks down from ``end - 1`` one band per answered 0, so the band
    is inferred by counting."""

    def __init__(self, enc: RangeEncoder, end: int = NB_BANDS,
                 skip_to: int = -1):
        self._enc = enc
        self._saw_uint = False
        self._end = end
        self._skip_to = skip_to
        self._skip_asked = 0

    def dec_bit_logp(self, logp: int) -> int:
        if not self._saw_uint:
            # skip loop: keep band j when j <= skip_to (or always,
            # when no skip target is scripted)
            j = self._end - 1 - self._skip_asked
            self._skip_asked += 1
            v = 1 if (self._skip_to < 0 or j <= self._skip_to) else 0
            self._enc.enc_bit_logp(v, logp)
            return v
        # dual-stereo flag: off
        self._enc.enc_bit_logp(0, logp)
        return 0

    def dec_uint(self, ft: int) -> int:
        # intensity offset: code every stereo band as coupled stereo
        self._saw_uint = True
        t = ft - 1
        self._enc.enc_uint(t, ft)
        return t


class CeltEncoder(CeltDecoder):
    """Stateful CELT layer encoder for one stream (mono or stereo).

    Subclasses the decoder for its tables, allocation machinery, PVQ
    enumeration and energy state; adds the encode direction."""

    def __init__(self, channels: int):
        super().__init__(channels)

    # -- energy ------------------------------------------------------------
    def _coarse_energy_enc(self, rc: RangeEncoder, start: int, end: int,
                           intra: bool, LM: int, band_log_e: np.ndarray,
                           C: int) -> None:
        prob = self.e_prob[LM][1 if intra else 0]
        if intra:
            coef = 0.0
            beta = 1.0 - 4915.0 / 32768.0
        else:
            coef = float(self.alpha_coef[LM])
            beta = float(self.beta_coef[LM])
        budget = rc.total_bits
        prev = [0.0, 0.0]
        for i in range(start, end):
            for c in range(C):
                x = float(band_log_e[c, i])
                f = x - coef * max(-9.0, self.oldE[c, i]) - prev[c]
                qi = int(math.floor(0.5 + f))
                tell = rc.tell()
                if budget - tell >= 15:
                    pi = 2 * min(i, 20)
                    qi = laplace_encode(rc, qi, int(prob[pi]) << 7,
                                        int(prob[pi + 1]) << 6)
                elif budget - tell >= 2:
                    qi = max(-1, min(1, qi))
                    sym = 2 * qi ^ -(1 if qi < 0 else 0)
                    rc.enc_cdf(sym, self.energy_small)
                elif budget - tell >= 1:
                    qi = min(0, max(-1, qi))
                    rc.enc_bit_logp(-qi, 1)
                else:
                    qi = -1
                q = float(qi)
                self.oldE[c, i] = coef * max(-9.0, self.oldE[c, i]) \
                    + prev[c] + q
                prev[c] = prev[c] + beta * q

    def _fine_energy_enc(self, rc: RangeEncoder, start: int, end: int,
                         fine_quant, band_log_e: np.ndarray, C: int) -> None:
        for i in range(start, end):
            if fine_quant[i] <= 0:
                continue
            frac = 1 << int(fine_quant[i])
            for c in range(C):
                err = float(band_log_e[c, i]) - self.oldE[c, i]
                q2 = int(math.floor((err + 0.5) * frac))
                q2 = max(0, min(frac - 1, q2))
                rc.rawbits(q2, int(fine_quant[i]))
                self.oldE[c, i] += (q2 + 0.5) / frac - 0.5

    def _finalize_energy_enc(self, rc: RangeEncoder, start: int, end: int,
                             fine_quant, fine_priority, bits_left: int,
                             band_log_e: np.ndarray, C: int) -> None:
        for prio in (0, 1):
            i = start
            while i < end and bits_left >= C:
                if (fine_quant[i] >= 8  # MAX_FINE_BITS
                        or fine_priority[i] != prio):
                    i += 1
                    continue
                for c in range(C):
                    err = float(band_log_e[c, i]) - self.oldE[c, i]
                    q2 = 1 if err > 0 else 0
                    rc.rawbits(q2, 1)
                    self.oldE[c, i] += (q2 - 0.5) / (1 << (int(fine_quant[i]) + 1))
                bits_left -= C
                i += 1

    # -- PVQ ------------------------------------------------------------------
    def _icwrs(self, n: int, y: np.ndarray) -> int:
        """Codeword index of a pulse vector: the exact inverse of
        _PVQ.cwrsi (libopus cwrs.c icwrs algorithm over the same
        U(n,k) recurrence)."""
        U = self.pvq.U
        j = n - 1
        i = 1 if y[j] < 0 else 0
        k = abs(int(y[j]))
        while j > 0:
            j -= 1
            i += U(n - j, k)
            k += abs(int(y[j]))
            if y[j] < 0:
                i += U(n - j, k + 1)
        return i

    @staticmethod
    def _pvq_search(x: np.ndarray, K: int) -> np.ndarray:
        """Nearest PVQ codepoint: projection then greedy pulse fill
        maximizing correlation^2 / energy."""
        n = len(x)
        signs = np.where(x < 0, -1, 1).astype(np.int64)
        ax = np.abs(x)
        iy = np.zeros(n, dtype=np.int64)
        s = float(ax.sum())
        left = K
        if s > 1e-12 and K > (n >> 1):
            iy = np.floor(ax * (K / s)).astype(np.int64)
            left = K - int(iy.sum())
        xy = float(np.dot(ax, iy))
        yy = float(np.dot(iy, iy))
        for _ in range(left):
            # gain of adding a pulse at j: (xy+ax[j])^2 / (yy+2*iy[j]+1)
            num = (xy + ax) ** 2
            den = yy + 2.0 * iy + 1.0
            j = int(np.argmax(num / den))
            iy[j] += 1
            xy += ax[j]
            yy += 2.0 * iy[j] - 1.0
        return iy * signs

    def _alg_quant(self, X: np.ndarray, N: int, K: int, spread: int,
                   B: int, rc: RangeEncoder, gain: float) -> int:
        _exp_rotation(X[:N], N, 1, B, K, spread)
        iy = self._pvq_search(X[:N], K)
        rc.enc_uint(self._icwrs(N, iy), self.pvq.V(N, K))
        Ryy = float(np.dot(iy, iy))
        X[:N] = iy * (gain / math.sqrt(Ryy))
        _exp_rotation(X[:N], N, -1, B, K, spread)
        return _extract_collapse_mask(iy, N, B)

    # -- theta ---------------------------------------------------------------
    @staticmethod
    def _itheta_full(X: np.ndarray, Y: np.ndarray, N: int,
                     stereo: bool) -> int:
        if stereo:
            m = 0.5 * (X[:N] + Y[:N])
            s = 0.5 * (X[:N] - Y[:N])
            emid = float(np.dot(m, m))
            eside = float(np.dot(s, s))
        else:
            emid = float(np.dot(X[:N], X[:N]))
            eside = float(np.dot(Y[:N], Y[:N]))
        return int(math.floor(
            0.5 + 16384.0 * (2.0 / math.pi)
            * math.atan2(math.sqrt(eside), math.sqrt(emid))
        ))

    @staticmethod
    def _stereo_split(X: np.ndarray, Y: np.ndarray, N: int) -> None:
        s = math.sqrt(0.5)
        l = s * X[:N].copy()
        r = s * Y[:N].copy()
        X[:N] = l + r
        Y[:N] = r - l

    def _intensity_stereo(self, ctx, X: np.ndarray, Y: np.ndarray,
                          N: int) -> None:
        """Replace the mid with the energy-weighted L/R projection
        (the side is not coded)."""
        i = ctx["band"]
        left = float(ctx["bandE"][0, i])
        right = float(ctx["bandE"][1, i])
        norm = 1e-15 + math.sqrt(1e-15 + left * left + right * right)
        a1 = left / norm
        a2 = right / norm
        X[:N] = a1 * X[:N] + a2 * Y[:N]

    def _compute_theta_enc(self, ctx, X: np.ndarray, Y, N: int, b: int,
                           B: int, B0: int, LM: int, fill: int,
                           stereo: bool = False):
        """Encode-side twin of the decoder's _compute_theta: chooses
        itheta from the operand energies, encodes it through the same
        pdf, and applies the stereo split / intensity projection."""
        rc: RangeEncoder = ctx["rc"]
        band = ctx["band"]
        pulse_cap = self.logN[band] + LM * (1 << BITRES)
        offset = (pulse_cap >> 1) - (16 if (stereo and N == 2) else 4)
        qn = self._compute_qn(N, b, offset, pulse_cap, stereo)
        if stereo and band >= ctx["intensity"]:
            qn = 1
        itheta_full = self._itheta_full(X, Y, N, stereo) \
            if Y is not None else 0
        tell = rc.tell_frac()
        itheta = 0
        inv = 0
        if qn != 1:
            itheta = (itheta_full * qn + 8192) >> 14
            if stereo and N > 2:
                rc.enc_uint_step(itheta, qn >> 1)
            elif B0 > 1 or stereo:
                rc.enc_uint(itheta, qn + 1)
            else:
                rc.enc_uint_tri(itheta, qn)
            itheta = (itheta * 16384) // qn
            if stereo:
                if itheta == 0:
                    self._intensity_stereo(ctx, X, Y, N)
                else:
                    self._stereo_split(X, Y, N)
        elif stereo:
            if (b > 2 << BITRES
                    and ctx["remaining_bits"] > 2 << BITRES):
                inv = 1 if itheta_full > 8192 else 0
                if inv:
                    Y[:N] = -Y[:N]
                self._intensity_stereo(ctx, X, Y, N)
                rc.enc_bit_logp(inv, 2)
            else:
                inv = 0
                self._intensity_stereo(ctx, X, Y, N)
            itheta = 0
        qalloc = rc.tell_frac() - tell
        if itheta == 0:
            delta = -16384
            fill &= (1 << B) - 1
        elif itheta == 16384:
            delta = 16384
            fill &= ((1 << B) - 1) << B
        else:
            imid = _bitexact_cos(itheta)
            iside = _bitexact_cos(16384 - itheta)
            delta = _frac_mul16((N - 1) << 7,
                                _bitexact_log2tan(iside, imid))
        return itheta, delta, fill, qalloc, inv

    # -- band quantization ------------------------------------------------------
    def _quant_band_n1_enc(self, ctx, X, Y, lowband_out) -> int:
        rc: RangeEncoder = ctx["rc"]
        x = X
        for _ in range(2 if Y is not None else 1):
            sign = 0
            if ctx["remaining_bits"] >= 1 << BITRES:
                sign = 1 if x[0] < 0 else 0
                rc.rawbits(sign, 1)
                ctx["remaining_bits"] -= 1 << BITRES
            x[0] = -1.0 if sign else 1.0
            x = Y
        if lowband_out is not None:
            lowband_out[0] = X[0]
        return 1

    def _quant_partition_enc(self, ctx, X: np.ndarray, N: int, b: int,
                             B: int, lowband, LM: int, gain: float,
                             fill: int) -> int:
        band = ctx["band"]
        off = self.cache_index[(LM + 1) * NB_BANDS + band]
        cache = self.cache_bits[off:]
        if LM != -1 and b > int(cache[int(cache[0])]) + 12 and N > 2:
            B0 = B
            N >>= 1
            Y = X[N:]
            LM -= 1
            if B == 1:
                fill = (fill & 1) | (fill << 1)
            B = (B + 1) >> 1
            itheta, delta, fill, qalloc, _inv = self._compute_theta_enc(
                ctx, X, Y, N, b, B, B0, LM, fill
            )
            if itheta == 0:
                imid, iside = 32767, 0
            elif itheta == 16384:
                imid, iside = 0, 32767
            else:
                imid = _bitexact_cos(itheta)
                iside = _bitexact_cos(16384 - itheta)
            mid = imid / 32768.0
            side = iside / 32768.0
            if B0 > 1 and (itheta & 0x3FFF):
                if itheta > 8192:
                    delta -= delta >> (4 - LM)
                else:
                    delta = min(0, delta + (N << BITRES >> (5 - LM)))
            b -= qalloc
            mbits = max(0, min(b, _sdiv(b - delta, 2)))
            sbits = b - mbits
            ctx["remaining_bits"] -= qalloc
            rebalance = ctx["remaining_bits"]
            if mbits >= sbits:
                cm = self._quant_partition_enc(
                    ctx, X, N, mbits, B, lowband, LM, gain * mid, fill
                )
                rebalance = mbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 0:
                    sbits += rebalance - (3 << BITRES)
                next_lb = lowband[N:] if lowband is not None else None
                cm |= self._quant_partition_enc(
                    ctx, Y, N, sbits, B, next_lb, LM, gain * side,
                    fill >> B,
                ) << (B0 >> 1)
            else:
                next_lb = lowband[N:] if lowband is not None else None
                cm = self._quant_partition_enc(
                    ctx, Y, N, sbits, B, next_lb, LM, gain * side,
                    fill >> B,
                ) << (B0 >> 1)
                rebalance = sbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 16384:
                    mbits += rebalance - (3 << BITRES)
                cm |= self._quant_partition_enc(
                    ctx, X, N, mbits, B, lowband, LM, gain * mid, fill
                )
            return cm
        # leaf: PVQ or fold (identical fill path to the decoder —
        # it reads no bits, and the LCG seed is range-state-locked)
        q = self._bits2pulses(band, LM, b)
        curr_bits = self._pulses2bits(band, LM, q)
        ctx["remaining_bits"] -= curr_bits
        while ctx["remaining_bits"] < 0 and q > 0:
            ctx["remaining_bits"] += curr_bits
            q -= 1
            curr_bits = self._pulses2bits(band, LM, q)
            ctx["remaining_bits"] -= curr_bits
        if q != 0:
            K = _get_pulses(q)
            return self._alg_quant(X, N, K, ctx["spread"], B,
                                   ctx["rc"], gain)
        cm_mask = (1 << B) - 1
        fill &= cm_mask
        if not fill:
            X[:N] = 0.0
            return 0
        if lowband is None:
            seed = ctx["seed"]
            for j in range(N):
                seed = _lcg(seed)
                X[j] = float(np.int32(np.uint32(seed)) >> 20)
            ctx["seed"] = seed
            cm = cm_mask
        else:
            seed = ctx["seed"]
            for j in range(N):
                seed = _lcg(seed)
                tmp = 1.0 / 256.0
                if not (seed & 0x8000):
                    tmp = -tmp
                X[j] = lowband[j] + tmp
            ctx["seed"] = seed
            cm = fill
        _renormalise(X[:N], gain)
        return cm

    def _quant_band_enc(self, ctx, X: np.ndarray, N: int, b: int, B: int,
                        lowband, LM: int, lowband_out, gain: float,
                        lowband_scratch, fill: int) -> int:
        N0 = N
        N_B = N // B
        B0 = B
        time_divide = 0
        recombine = 0
        longBlocks = B0 == 1
        if N == 1:
            return self._quant_band_n1_enc(ctx, X, None, lowband_out)
        tf_change = ctx["tf_change"]
        if tf_change > 0:
            recombine = tf_change
        if (
            lowband_scratch is not None and lowband is not None
            and (recombine or ((N_B & 1) == 0 and tf_change < 0) or B0 > 1)
        ):
            lowband_scratch[:N] = lowband[:N]
            lowband = lowband_scratch
        # encode side: X is transformed INTO the coding domain here
        # (the decoder converts back with the undo passes below)
        for k in range(recombine):
            _haar1(X, N >> k, 1 << k)
            if lowband is not None:
                _haar1(lowband, N >> k, 1 << k)
            fill = (
                int(self.bit_interleave[fill & 0xF])
                | int(self.bit_interleave[fill >> 4]) << 2
            )
        B >>= recombine
        N_B <<= recombine
        while (N_B & 1) == 0 and tf_change < 0:
            _haar1(X, N_B, B)
            if lowband is not None:
                _haar1(lowband, N_B, B)
            fill |= fill << B
            B <<= 1
            N_B >>= 1
            time_divide += 1
            tf_change += 1
        B0 = B
        N_B0 = N_B
        if B0 > 1:
            _deinterleave_hadamard(X, N_B >> recombine,
                                   B0 << recombine, longBlocks)
            if lowband is not None:
                _deinterleave_hadamard(lowband, N_B >> recombine,
                                       B0 << recombine, longBlocks)
        ctx["B0"] = B0
        cm = self._quant_partition_enc(ctx, X, N, b, B, lowband, LM,
                                       gain, fill)
        # resynthesis: rebuild the decoded X (identical undo passes)
        if B0 > 1:
            _interleave_hadamard(X, N_B >> recombine,
                                 B0 << recombine, longBlocks)
        B = B0
        N_B = N_B0
        while time_divide > 0:
            B >>= 1
            N_B <<= 1
            cm |= cm >> B
            _haar1(X, N_B, B)
            time_divide -= 1
        for k in range(recombine):
            cm = int(self.bit_deinterleave[cm])
            _haar1(X, N0 >> k, 1 << k)
        B <<= recombine
        if lowband_out is not None:
            n = math.sqrt(N0)
            lowband_out[:N0] = n * X[:N0]
        cm &= (1 << B) - 1
        return cm

    def _quant_band_stereo_enc(self, ctx, X: np.ndarray, Y: np.ndarray,
                               N: int, b: int, B: int, lowband, LM: int,
                               lowband_out, lowband_scratch,
                               fill: int) -> int:
        if N == 1:
            return self._quant_band_n1_enc(ctx, X, Y, lowband_out)
        rc: RangeEncoder = ctx["rc"]
        orig_fill = fill
        itheta, delta, fill, qalloc, inv = self._compute_theta_enc(
            ctx, X, Y, N, b, B, B, LM, fill, stereo=True
        )
        b -= qalloc
        if itheta == 0:
            imid, iside = 32767, 0
        elif itheta == 16384:
            imid, iside = 0, 32767
        else:
            imid = _bitexact_cos(itheta)
            iside = _bitexact_cos(16384 - itheta)
        mid = imid / 32768.0
        side = iside / 32768.0
        if N == 2:
            mbits = b
            sbits = (1 << BITRES) if itheta not in (0, 16384) else 0
            mbits -= sbits
            c = itheta > 8192
            ctx["remaining_bits"] -= qalloc + sbits
            x2, y2 = (Y, X) if c else (X, Y)
            sign = 0
            if sbits:
                sign = 1 if (x2[0] * y2[1] - x2[1] * y2[0]) < 0 else 0
                rc.rawbits(sign, 1)
            sign = 1 - 2 * sign
            cm = self._quant_band_enc(ctx, x2, N, mbits, B, lowband, LM,
                                      lowband_out, 1.0, lowband_scratch,
                                      orig_fill)
            y2[0] = -sign * x2[1]
            y2[1] = sign * x2[0]
            X[0] = mid * X[0]
            X[1] = mid * X[1]
            Y[0] = side * Y[0]
            Y[1] = side * Y[1]
            tmp = X[0]
            X[0] = tmp - Y[0]
            Y[0] = tmp + Y[0]
            tmp = X[1]
            X[1] = tmp - Y[1]
            Y[1] = tmp + Y[1]
        else:
            mbits = max(0, min(b, _sdiv(b - delta, 2)))
            sbits = b - mbits
            ctx["remaining_bits"] -= qalloc
            rebalance = ctx["remaining_bits"]
            if mbits >= sbits:
                cm = self._quant_band_enc(ctx, X, N, mbits, B, lowband,
                                          LM, lowband_out, 1.0,
                                          lowband_scratch, fill)
                rebalance = mbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 0:
                    sbits += rebalance - (3 << BITRES)
                cm |= self._quant_band_enc(ctx, Y, N, sbits, B, None, LM,
                                           None, side, None, fill >> B)
            else:
                cm = self._quant_band_enc(ctx, Y, N, sbits, B, None, LM,
                                          None, side, None, fill >> B)
                rebalance = sbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 16384:
                    mbits += rebalance - (3 << BITRES)
                cm |= self._quant_band_enc(ctx, X, N, mbits, B, lowband,
                                           LM, lowband_out, 1.0,
                                           lowband_scratch, fill)
            self._stereo_merge(X, Y, mid, N)
        if inv:
            Y[:N] = -Y[:N]
        return cm

    def _quant_all_bands_enc(self, rc: RangeEncoder, start: int, end: int,
                             X_: np.ndarray, Y_, bandE, pulses,
                             shortBlocks: bool, spread: int, tf_res,
                             total_bits: int, balance: int, LM: int,
                             codedBands: int, intensity: int,
                             dual_stereo: int):
        """Encode-side twin of the decoder's band loop; X_/Y_ hold the
        normalized (unit-norm per band) spectrum on entry and the
        decoded spectrum on exit."""
        C = 1 if Y_ is None else 2
        M = 1 << LM
        eBands = self.eBands
        B = M if shortBlocks else 1
        norm_offset = M * eBands[start]
        norm_size = M * eBands[NB_BANDS - 1] - norm_offset
        norm = np.zeros(norm_size)
        norm2 = np.zeros(norm_size) if C == 2 else None
        lowband_scratch = np.zeros(M * 176)
        collapse_masks = np.zeros((C, NB_BANDS), dtype=np.int64)
        lowband_offset = 0
        update_lowband = True
        ctx = {
            "rc": rc,
            "spread": spread,
            "seed": self.rng,
            "remaining_bits": 0,
            "band": 0,
            "tf_change": 0,
            "B0": B,
            "intensity": intensity,
            "bandE": bandE,
        }
        for i in range(start, end):
            last = i == end - 1
            effective_lowband = -1
            X = X_[M * eBands[i]:]
            Y = Y_[M * eBands[i]:] if C == 2 else None
            N = M * (eBands[i + 1] - eBands[i])
            tell = rc.tell_frac()
            if i != start:
                balance -= tell
            remaining_bits = total_bits - tell - 1
            ctx["remaining_bits"] = remaining_bits
            ctx["band"] = i
            if i <= codedBands - 1:
                curr_balance = _sdiv(balance, min(3, codedBands - i))
                b = max(0, min(16383, min(remaining_bits + 1,
                                          int(pulses[i]) + curr_balance)))
            else:
                b = 0
            if (M * eBands[i] - N >= M * eBands[start]
                    and (update_lowband or lowband_offset == 0)):
                lowband_offset = i
            tf_change = int(tf_res[i])
            ctx["tf_change"] = tf_change
            if lowband_offset != 0 and (
                spread != 3 or B > 1 or tf_change < 0  # SPREAD_AGGRESSIVE
            ):
                effective_lowband = int(max(
                    0, M * eBands[lowband_offset] - norm_offset - N
                ))
                fold_start = lowband_offset
                while True:
                    fold_start -= 1
                    if M * eBands[fold_start] <= (effective_lowband
                                                  + norm_offset):
                        break
                fold_end = lowband_offset - 1
                while True:
                    fold_end += 1
                    if M * eBands[fold_end] >= (effective_lowband
                                                + norm_offset + N):
                        break
                x_cm = y_cm = 0
                fold_i = fold_start
                while True:
                    x_cm |= int(collapse_masks[0][fold_i])
                    y_cm |= int(collapse_masks[C - 1][fold_i])
                    fold_i += 1
                    if fold_i >= fold_end:
                        break
            else:
                x_cm = y_cm = (1 << B) - 1
            lowband = (norm[effective_lowband:]
                       if effective_lowband != -1 else None)
            lowband2 = (
                norm2[effective_lowband:]
                if (C == 2 and effective_lowband != -1) else None
            )
            lowband_out = (
                None if last
                else norm[M * eBands[i] - norm_offset:]
            )
            lowband_out2 = (
                None if (last or C == 1)
                else norm2[M * eBands[i] - norm_offset:]
            )
            if dual_stereo and i == intensity:
                dual_stereo = 0
                upto = M * eBands[i] - norm_offset
                norm[:upto] = 0.5 * (norm[:upto] + norm2[:upto])
            if dual_stereo:
                x_cm = self._quant_band_enc(
                    ctx, X, N, b // 2, B, lowband, LM, lowband_out, 1.0,
                    lowband_scratch, x_cm,
                )
                y_cm = self._quant_band_enc(
                    ctx, Y, N, b // 2, B, lowband2, LM, lowband_out2,
                    1.0, lowband_scratch, y_cm,
                )
            else:
                if C == 2:
                    x_cm = self._quant_band_stereo_enc(
                        ctx, X, Y, N, b, B, lowband, LM, lowband_out,
                        lowband_scratch, x_cm | y_cm,
                    )
                else:
                    x_cm = self._quant_band_enc(
                        ctx, X, N, b, B, lowband, LM, lowband_out, 1.0,
                        lowband_scratch, x_cm | y_cm,
                    )
                y_cm = x_cm
            collapse_masks[0][i] = x_cm
            collapse_masks[C - 1][i] = y_cm
            balance += int(pulses[i]) + tell
            update_lowband = b > (N << BITRES)
        self.rng = ctx["seed"]
        return collapse_masks

    # -- frame ---------------------------------------------------------------
    def encode_frame(self, rc: RangeEncoder, x: np.ndarray,
                     frame_size: int, start: int = 0,
                     end: int = NB_BANDS,
                     transient: bool = False) -> None:
        """Encode one CELT frame into ``rc``.

        ``x``: [C, frame_size + OVERLAP] pre-emphasized celt-domain
        samples (float PCM * 32768 through the pre-emphasis filter);
        the OVERLAP tail is the lookahead into the next frame.
        ``transient`` selects 8 short MDCT blocks (pre-echo control on
        attacks; the caller decides, see detect_transient)."""
        C = self.channels
        LM = {120: 0, 240: 1, 480: 2, 960: 3}[frame_size]
        if LM == 0:
            transient = False  # no short split exists at 2.5 ms
        N = frame_size
        M = 1 << LM
        eBands = self.eBands
        total = rc.total_bits

        tell = rc.tell()
        if tell == 1:
            rc.enc_bit_logp(0, 15)  # not silence
        if start == 0 and rc.tell() + 16 <= total:
            rc.enc_bit_logp(0, 1)   # no comb postfilter
        if LM > 0 and rc.tell() + 3 <= total:
            rc.enc_bit_logp(1 if transient else 0, 3)
        else:
            # the decoder cannot read the flag: force long blocks
            transient = False
        intra = False
        if rc.tell() + 3 <= total:
            intra_fn = getattr(self, "intra_fn", None)
            if intra_fn is not None:
                intra = bool(intra_fn(self, transient))
            rc.enc_bit_logp(1 if intra else 0, 3)

        # forward MDCT + band energies: one long block, or M short
        # blocks interleaved bin-wise (the decoder's freq[c, b::B]
        # layout, opus_celt._synthesize)
        if transient:
            NB = N // M
            mat = _imdct_matrix(NB)
            freq = np.zeros((C, N))
            for b in range(M):
                seg = x[:, b * NB : b * NB + NB + OVERLAP]
                freq[:, b::M] = (seg @ mat.T) * (2.0 / NB)
        else:
            mat = _imdct_matrix(N)
            freq = (x[:, : N + OVERLAP] @ mat.T) * (2.0 / N)  # 4/L, L=2N
        bandE = np.zeros((C, NB_BANDS))
        band_log_e = np.full((C, NB_BANDS), -28.0)
        Xn = np.zeros((C, M * eBands[NB_BANDS] + 200))
        for c in range(C):
            for i in range(start, end):
                lo, hi = M * eBands[i], M * eBands[i + 1]
                e = math.sqrt(float(np.dot(freq[c, lo:hi], freq[c, lo:hi])))
                bandE[c, i] = e
                if e > 1e-27:
                    band_log_e[c, i] = max(
                        -28.0, math.log2(e) - float(self.eMeans[i])
                    )
                    Xn[c, lo:hi] = freq[c, lo:hi] / e

        self._coarse_energy_enc(rc, start, end, intra, LM,
                                band_log_e, C)

        # per-band time-frequency resolution: encode the decoder's
        # exact toggle pattern (curr ^= bit per band); the desired
        # per-band changed flags come from the caller's analysis
        # (self.tf_fn), default all-zero.  libopus tf_encode budget
        # semantics: the tf_select bit is reserved up front
        it = 1 if transient else 0
        want_tf = None
        tf_fn = getattr(self, "tf_fn", None)
        if tf_fn is not None:
            want_tf = tf_fn(band_log_e, start, end, C, LM, transient)
        changed = np.zeros(NB_BANDS, dtype=np.int64)
        tf_res = np.zeros(NB_BANDS, dtype=np.int64)
        logp = 2 if transient else 4
        budget = total
        tell = rc.tell()
        tf_changed = 0
        curr = 0
        tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
        budget -= tf_select_rsv
        for i in range(start, end):
            if tell + logp <= budget:
                w = int(want_tf[i]) & 1 if want_tf is not None else 0
                rc.enc_bit_logp(w ^ curr, logp)
                curr = w
                tell = rc.tell()
                tf_changed |= curr
            changed[i] = curr
            logp = 4 if transient else 5
        tf_select = 0
        if (tf_select_rsv
                and self.tf_select_tab[LM][it][0][tf_changed]
                != self.tf_select_tab[LM][it][1][tf_changed]):
            sel_fn = getattr(self, "tf_sel", None)
            if sel_fn is not None:
                tf_select = int(sel_fn) & 1
            rc.enc_bit_logp(tf_select, 1)
        for i in range(start, end):
            tf_res[i] = self.tf_select_tab[LM][it][tf_select][changed[i]]

        spread = SPREAD_NORMAL
        spread_fn = getattr(self, "spread_fn", None)
        if spread_fn is not None:
            spread = int(spread_fn(Xn, band_log_e, start, end, C, M))
        if rc.tell() + 4 <= total:
            rc.enc_cdf(spread, self.spread_icdf)
        else:
            spread = SPREAD_NORMAL

        cap = np.zeros(NB_BANDS, dtype=np.int64)
        for i in range(NB_BANDS):
            cap[i] = (
                (int(self.static_caps[LM][C - 1][i]) + 64)
                * C * (eBands[i + 1] - eBands[i]) << LM
            ) >> 2

        # dynalloc band boosts: encode each band's boost in the
        # decoder's exact escalating-cost bit pattern (opus_celt.py
        # decode_frame dynalloc loop); ``boosts`` comes from the
        # caller's analysis (self.boosts, quanta units per band)
        offsets = np.zeros(NB_BANDS, dtype=np.int64)
        total_bits_8 = total << BITRES
        tell_frac = rc.tell_frac()
        dynalloc_logp = 6
        total_boost = 0
        boosts_fn = getattr(self, "boosts_fn", None)
        if boosts_fn is not None:
            want = boosts_fn(band_log_e, start, end, C, LM)
        else:
            want = dynalloc_analysis(band_log_e, start, end, C)
        for i in range(start, end):
            width = C * (eBands[i + 1] - eBands[i]) << LM
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dyn_loop = dynalloc_logp
            boost = 0
            w = int(want[i]) if want is not None else 0
            while (tell_frac + (dyn_loop << BITRES)
                   < total_bits_8 - total_boost
                   and boost < cap[i]):
                flag = 1 if boost < w * quanta else 0
                rc.enc_bit_logp(flag, dyn_loop)
                tell_frac = rc.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_boost += quanta
                dyn_loop = 1
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)
            offsets[i] = boost

        alloc_trim = 5
        if rc.tell_frac() + (6 << BITRES) <= total_bits_8 - total_boost:
            trim_fn = getattr(self, "trim_fn", None)
            if trim_fn is not None:
                alloc_trim = int(trim_fn(band_log_e, start, end, C, LM))
            else:
                alloc_trim = alloc_trim_analysis(band_log_e, start,
                                                 end, C)
            rc.enc_cdf(alloc_trim, self.trim_icdf)

        bits_8 = (total << BITRES) - rc.tell_frac() - 1
        anti_collapse_rsv = (
            (1 << BITRES)
            if (transient and LM >= 2 and bits_8 >= (LM + 2) << BITRES)
            else 0
        )
        bits_8 -= anti_collapse_rsv

        # skip trailing empty bands (band-limited sources): their bits
        # redistribute to the occupied spectrum
        skip_to = start
        for i in range(start, end):
            if band_log_e[:C, i].max() > -20.0:
                skip_to = i
        shim = _AllocCoder(rc, end, skip_to)
        (pulses, fine_quant, fine_priority, codedBands, balance,
         intensity, dual_stereo) = self._compute_allocation(
            start, end, offsets, cap, alloc_trim, bits_8, shim, LM, C
        )

        self._fine_energy_enc(rc, start, end, fine_quant,
                              band_log_e, C)

        self._quant_all_bands_enc(
            rc, start, end, Xn[0], Xn[1] if C == 2 else None, bandE,
            pulses, transient, spread, tf_res,
            (total << BITRES) - anti_collapse_rsv, balance, LM,
            codedBands, intensity, dual_stereo,
        )

        if anti_collapse_rsv > 0:
            # anti-collapse off: the decoded spectrum then equals the
            # encoder's resynthesis exactly (no decoder-side noise
            # injection into collapsed short blocks)
            rc.rawbits(0, 1)

        self._finalize_energy_enc(rc, start, end, fine_quant,
                                  fine_priority, total - rc.tell(),
                                  band_log_e, C)

        self._post_frame_energy(start, end, transient, C)
        self.rng = int(rc.rng) & 0xFFFFFFFF


def alloc_trim_analysis(band_log_e: np.ndarray, start: int, end: int,
                        C: int) -> int:
    """Content-adaptive allocation trim: the energy-weighted spectral
    slope (log-energy per band index) tilts the bit allocation toward
    where the energy lives — steeply falling spectra (voice, most
    music) trim high (more bits low), rising spectra trim low.
    Worth ~1 dB mean on the premix corpus over the fixed trim 5;
    libopus role: alloc_trim_analysis (decision re-derived, not
    ported)."""
    e = band_log_e[:C, start:end].max(0)
    i = np.arange(start, end, dtype=np.float64)
    w = np.maximum(e - e.max() + 30.0, 0.0)  # ignore silent bands
    sw = float(w.sum())
    if sw <= 0.0:
        return 5
    im = float((i * w).sum()) / sw
    em = float((e * w).sum()) / sw
    den = float(((i - im) ** 2 * w).sum())
    slope = float(((i - im) * (e - em) * w).sum()) / max(den, 1e-9)
    return int(np.clip(math.floor(5.0 - 6.0 * slope + 0.5), 0, 10))


def dynalloc_analysis(band_log_e: np.ndarray, start: int, end: int,
                      C: int) -> np.ndarray:
    """Per-band dynalloc boost request (quanta units): waterfilling
    toward the frame's spectral peaks — every band within 8 (log2
    energy units) of the loudest gets boost proportional to its
    prominence.  PVQ noise scales with band energy, so concentrating
    bits where the energy is lifts waveform SNR ~4 dB mean on the
    premix corpus; libopus role: dynalloc_analysis (decision
    re-derived, not ported)."""
    e = band_log_e[:C].max(0)
    emax = float(e[start:end].max())
    if emax <= -27.0:  # silent frame: nothing to boost
        return np.zeros(NB_BANDS, dtype=np.int64)
    want = np.maximum(e - (emax - 8.0), 0.0) / 1.5
    return np.clip(np.floor(want), 0, 6).astype(np.int64)


def detect_transient(frame: np.ndarray, N: int, M: int,
                     prev_e: float = None) -> bool:
    """Attack detector for the short-block decision: block energies of
    the first difference (a crude high-pass, so bass sustain doesn't
    trigger) across the M short blocks; transient when a block jumps
    well above the level of the blocks before it (pre-echo risk).
    ``prev_e`` is the previous frame's last-block energy so an attack
    landing on block 0 still flags (without it, a burst at the frame
    start spreads pre-echo over the whole 20 ms)."""
    if M < 2:
        return False
    d = np.diff(frame[:, :N], axis=1)
    NB = (N - 1) // M
    eb = np.array([
        float((d[:, b * NB : (b + 1) * NB] ** 2).sum()) for b in range(M)
    ]) + 1e-9
    peak = int(np.argmax(eb))
    if peak == 0:
        return prev_e is not None and eb[0] > 24.0 * max(prev_e, 1e-9)
    head = eb[:peak].mean()
    if prev_e is not None:
        head = (eb[:peak].sum() + prev_e) / (peak + 1)
    return eb[peak] > 24.0 * head


def block_tail_energy(frame: np.ndarray, N: int, M: int) -> float:
    """Last short block's first-difference energy (detect_transient's
    carried ``prev_e``)."""
    if M < 2:
        return 1e-9
    d = np.diff(frame[:, :N], axis=1)
    NB = (N - 1) // M
    return float((d[:, (M - 1) * NB : M * NB] ** 2).sum()) + 1e-9


_MDCT_WIN = {}


def _forward_mdct(frames: np.ndarray, N: int) -> np.ndarray:
    """Forward low-overlap MDCT of [..., N+OVERLAP] support samples
    -> [..., N] spectra, scaled like CeltEncoder.encode_frame's
    ``(x @ mat.T) * (2/N)``.

    O(N log N) via the standard fold + DCT-IV (scipy.fft) — equal to
    the dense matmul to ~4e-13 relative; falls back to the matmul
    when scipy is unavailable."""
    try:
        import scipy.fft as sf
    except ImportError:
        mat = _imdct_matrix(N)
        return (frames @ mat.T) * (2.0 / N)
    if N not in _MDCT_WIN:
        from soundkit_tpu_torch.codecs.opus_celt import tables

        w = tables()["celt_window"].astype(np.float64)
        win = np.zeros(N + OVERLAP)
        win[:OVERLAP] = w
        win[OVERLAP:N] = 1.0
        win[N:] = w[::-1]
        _MDCT_WIN[N] = win
    win = _MDCT_WIN[N]
    pad = (N - OVERLAP) // 2
    L = 2 * N
    a = np.zeros(frames.shape[:-1] + (L,))
    a[..., pad : pad + N + OVERLAP] = frames * win
    half = N // 2
    idx = np.arange(half)
    u = np.empty(frames.shape[:-1] + (N,))
    u[..., :half] = -a[..., 3 * half + idx] - a[..., 3 * half - 1 - idx]
    u[..., half:] = a[..., idx] - a[..., N - 1 - idx]
    return sf.dct(u, type=4, axis=-1) * (1.0 / N)


class OpusCeltEncoder:
    """Opus packet encoder, CELT fullband mode (the mode libopus uses
    for 48 kHz music): CBR code-0 packets, 2.5/5/10/20 ms frames.

    push() buffers interleaved float PCM at 48 kHz and emits one
    packet per complete frame (one frame of codec delay: the MDCT
    lookahead is OVERLAP samples)."""

    # CELT fullband TOC configs by frame size
    _CONFIGS = {120: 28, 240: 29, 480: 30, 960: 31}

    def __init__(self, channels: int = 2, bit_rate: int = 96000,
                 frame_size: int = 960, native: bool = True):
        if channels not in (1, 2):
            raise ValueError("opus supports 1 or 2 channels")
        if frame_size not in self._CONFIGS:
            raise ValueError(f"unsupported CELT frame size {frame_size}")
        self.channels = channels
        self.frame_size = frame_size
        self.bytes_per_frame = max(
            12, int(round(bit_rate * frame_size / 48000.0 / 8.0)) - 1
        )
        # encode backend: the C++ port (native_src/src/celt_parse.cpp
        # skt_celt_enc_frame, byte-identical to the Python encoder and
        # ~100x faster); a library that fails to build or load raises
        self._native = None
        if native:
            from soundkit_tpu_torch.codecs.celt_native import (
                NativeCeltEncoder,
            )

            self._native = NativeCeltEncoder(channels)
        self._celt = None if self._native is not None \
            else CeltEncoder(channels)
        self._pend = np.zeros((channels, 0))
        self._emph_mem = np.zeros(channels)
        self._prev_be = None  # last block energy (transient context)
        self._toc = (self._CONFIGS[frame_size] << 3) \
            | ((1 if channels == 2 else 0) << 2)

    def _preemph(self, pcm: np.ndarray) -> np.ndarray:
        """[n, C] float PCM -> [C, n] celt-domain (x*32768 through the
        pre-emphasis zero, the inverse of the decoder's de-emphasis)."""
        v = pcm.T * 32768.0
        prev = np.concatenate([self._emph_mem[:, None], v[:, :-1]], axis=1)
        if v.shape[1]:
            self._emph_mem = v[:, -1].copy()
        return v - CELT_EMPH_COEFF * prev

    def push(self, pcm: np.ndarray):
        """Interleaved or [n, C] float PCM at 48 kHz -> list of Opus
        packets (one per complete frame)."""
        pcm = np.asarray(pcm, dtype=np.float64)
        if pcm.ndim == 1:
            pcm = pcm.reshape(-1, self.channels)
        self._pend = np.concatenate(
            [self._pend, self._preemph(pcm)], axis=1
        )
        out = []
        N = self.frame_size
        if self._native is not None:
            # batch the forward MDCTs of every complete frame into one
            # BLAS matmul (identical math to CeltEncoder.encode_frame),
            # then range-code each frame natively
            nf = 0
            while self._pend.shape[1] >= (nf + 1) * N + OVERLAP:
                nf += 1
            if nf:
                frames = np.stack([
                    self._pend[:, f * N : f * N + N + OVERLAP]
                    for f in range(nf)
                ])  # [F, C, N+OVERLAP]
                M = N // 120
                trans = []
                for f in range(nf):
                    trans.append(M >= 2 and detect_transient(
                        frames[f], N, M, self._prev_be))
                    self._prev_be = block_tail_energy(frames[f], N, M)
                long_idx = [f for f in range(nf) if not trans[f]]
                short_idx = [f for f in range(nf) if trans[f]]
                freq = np.zeros((nf, frames.shape[1], N))
                if long_idx:
                    freq[long_idx] = _forward_mdct(frames[long_idx], N)
                if short_idx:
                    # all transient frames' short blocks in ONE
                    # batched transform, bin-interleaved back into the
                    # decoder's freq[c, b::M] layout
                    segs = np.stack([
                        frames[f][:, b * 120 : b * 120 + 240]
                        for f in short_idx for b in range(M)
                    ])
                    fs = _forward_mdct(segs, 120)
                    for j, f in enumerate(short_idx):
                        for b in range(M):
                            freq[f][:, b::M] = fs[j * M + b]
                for f in range(nf):
                    payload = self._native.encode_frame(
                        freq[f], N, self.bytes_per_frame,
                        transient=trans[f],
                    )
                    out.append(bytes([self._toc]) + payload)
                self._pend = self._pend[:, nf * N:]
            return out
        while self._pend.shape[1] >= N + OVERLAP:
            frame = self._pend[:, : N + OVERLAP]
            tr = detect_transient(frame, N, N // 120, self._prev_be)
            self._prev_be = block_tail_energy(frame, N, N // 120)
            rc = RangeEncoder(self.bytes_per_frame)
            self._celt.encode_frame(rc, frame, N, transient=tr)
            out.append(bytes([self._toc]) + rc.finalize())
            self._pend = self._pend[:, N:]
        return out

    def flush(self):
        """Pad the tail with silence to emit the remaining samples."""
        if self._pend.shape[1] == 0:
            return []
        n = self._pend.shape[1]
        pad = self.frame_size + OVERLAP - n
        if pad > 0:
            pcm = np.zeros((((pad + self.frame_size - 1)
                             // self.frame_size) * self.frame_size,
                            self.channels))
            return self.push(pcm)
        return []
